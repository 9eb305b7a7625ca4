"""Data-parallel runtime of the port over `torch.distributed` (counterpart
of `occnet_tpu/parallel`): the process group (`multihost`) and the data
layout (`mesh`).  The JAX package's `batch_sharding` and
`replicated_sharding` have no counterpart: a rank is one device (see
`mesh`)."""

from occnet_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
)
from occnet_tpu_torch.parallel.multihost import (  # noqa: F401
    allgather_host,
    barrier,
    global_batch,
    initialize,
    process_shard,
)
