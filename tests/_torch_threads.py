"""One torch CPU thread for a test module of the port.

The suite runs its files on several xdist workers that share the host's
cores, and torch's default of one intra-op thread a core in every worker
oversubscribes them many times over: its thread pools then spend their
time waiting for each other (a train step of seconds alone took minutes
among the other workers).  A module imports the fixture to run its tests
on one thread, and the previous count comes back after the module:

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
