"""Multi-process runtime of the port over `torch.distributed` (counterpart
of `occnet_tpu/parallel/multihost.py`).

The JAX package runs one jitted program over a batch sharded on the mesh's
``data`` axis; here each process (a rank, launched by `torchrun` or
`tools/dist_train.sh`) holds one device and its part of the global batch,
and the collectives below make the step global:

- `initialize()` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) in place of the JAX
  package's ``JAX_*`` variables and joins the process group: NCCL on the
  card, gloo on the CPU by default, with a timeout on every collective.
  Without a launcher's environment it returns False and does nothing, as
  the JAX package does on a single host.
- `process_shard()` gives (rank, world size) for the sharded index
  samplers (`data/sampler.py`).
- `global_batch()` puts the rank's part of the global batch on its device.
- `allgather_host()` gathers numpy leaves from every rank onto every rank,
  int64 and float64 exactly (torch's collectives carry 64-bit types, so the
  JAX package's hi / lo split is not needed).
- `barrier()` waits for every rank.
- `all_reduce_sum()` is a differentiable all-reduce (its backward
  all-reduces the gradient), for the global batch statistics of the
  norms; `all_reduce_()` and `all_reduce_mean_()` reduce in place without
  autograd, for loss normalisers, metrics and gradients.  Each takes a
  ``group`` (default: the world), the data or model group of a
  (data, model) layout (`parallel.mesh`).

With no process group, or at world size 1, every function here is the
identity, so single-process arithmetic is unchanged.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900      # every collective of the group, and each wait


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_shard() -> Tuple[int, int]:
    """(shard index, shard count) for host-side data loading: the rank and
    the world size, (0, 1) without a process group."""
    return rank(), world_size()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> bool:
    """Join the process group that torchrun's environment describes and
    return True; return False, doing nothing, when ``WORLD_SIZE`` is unset
    (no launcher).  ``backend`` defaults to NCCL when a card is visible and
    gloo otherwise; NCCL without a card raises.  Under NCCL the rank's card
    is ``cuda:LOCAL_RANK`` (made current); under gloo ranks may share a
    card (``cuda:LOCAL_RANK % device_count``).  ``timeout_s`` (default
    ``OCCNET_DIST_TIMEOUT_S`` or 900 s) bounds every collective: a rank
    that stops answering makes the others raise, never wait forever."""
    if is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl" and not cuda:
        raise RuntimeError("--distributed with the NCCL backend needs a CUDA "
                           "device and none is available; pass "
                           "--dist-backend gloo to run the ranks on the CPU")
    if cuda:
        n = torch.cuda.device_count()
        if backend == "nccl" and local_rank() >= n:
            raise RuntimeError(f"NCCL rank with LOCAL_RANK {local_rank()} "
                               f"but {n} visible CUDA device(s): NCCL takes "
                               f"one device a rank (gloo may share one)")
        torch.cuda.set_device(local_rank() % n)
    if timeout_s is None:
        timeout_s = float(os.environ.get("OCCNET_DIST_TIMEOUT_S",
                                         DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_device(device="cuda") -> torch.device:
    """The rank's device of type ``device``: its current card for "cuda"
    (see `initialize`), the CPU for "cpu".  NCCL ranks cannot run on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if is_initialized() and dist.get_backend() == "nccl":
        raise RuntimeError("the NCCL backend reduces CUDA tensors only; "
                           "use --dist-backend gloo with --device cpu")
    return device


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def global_batch(local_batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The rank's part of the global batch (numpy leaves, leading dim =
    local batch) as tensors on ``device``; other leaves pass through."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v
            for k, v in local_batch.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _collective_device() -> torch.device:
    """Where host tensors go for a collective: NCCL reduces on the card,
    gloo on the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_host(tree: Any) -> Any:
    """Gather a tree (dicts, lists, tuples) of numpy arrays from every rank:
    each leaf becomes an array with a leading rank axis (every rank's leaf
    must have the same shape and dtype).  Integer and float64 leaves are
    exact.  Without a process group the leaves come back as they are (no
    rank axis), as the JAX package returns them on one process."""
    if world_size() == 1:
        return _tree_map(np.asarray, tree)
    dev = _collective_device()

    def gather(x):
        x = np.ascontiguousarray(x)
        is_bool = x.dtype == np.bool_
        t = torch.from_numpy(x.astype(np.uint8) if is_bool else x).to(dev)
        parts = [torch.empty_like(t) for _ in range(world_size())]
        dist.all_gather(parts, t)
        out = torch.stack(parts).cpu().numpy()
        return out.astype(np.bool_) if is_bool else out

    return _tree_map(gather, tree)


def barrier(name: str = "barrier") -> None:
    """Wait for every rank (``name`` labels the call site, as in JAX)."""
    del name
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def group_size(group=None) -> int:
    """The number of ranks of ``group`` (None: the whole world); 1 without
    a process group."""
    return dist.get_world_size(group) if is_initialized() else 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks whose backward sums the incoming gradient
    over them: each rank's loss depends on the sum through every rank's
    share, so the gradient of the sum of the ranks' losses with respect to
    one rank's input is the sum of their gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (None: the
    world); ``x`` itself on one rank."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``x`` over the ranks of ``group``, outside autograd;
    returns x."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     divisor: Optional[int] = None) -> None:
    """Sum each tensor over the ranks of ``group`` in place and divide it by
    ``divisor`` (default: the group's size) with one all-reduce per dtype
    (a flat buffer of all of them): the gradient average of data-parallel
    training."""
    world = group_size(group)
    divisor = world if divisor is None else divisor
    if world == 1 and divisor == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if world > 1:
            dist.all_reduce(flat, group=group)
        flat.div_(divisor)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Make every rank's parameters and buffers equal to rank ``src``'s."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)
