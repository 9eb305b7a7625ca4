"""CPU tests of the benchmark.  Tests marked ``card`` run the benchmark on
a CUDA device and skip without one (decided inside the test)."""

import pytest
import torch

torch.set_num_threads(4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    return torch
