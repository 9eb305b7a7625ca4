"""Multi-process runtime of the port over `torch.distributed` (counterpart
of `occnet_tpu/parallel`): the process group (`multihost`), the (data,
model) layout (`mesh`) and BEV-query sharding over the model axis
(`qshard`).  The JAX package's `batch_sharding` and `replicated_sharding`
have no counterpart: a rank is one device (see `mesh`)."""

from occnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
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
