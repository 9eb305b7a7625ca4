"""The (data, model) layout of the port's ranks (counterpart of
`occnet_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a (data, model) mesh: the batch is
sharded over ``data``, and with ``model.bev_shard_axis = "model"`` the BEV
queries of the encoder are sharded over ``model`` (`BEVFormerEncoder.
shard_q`).  Here a rank is one device, and `make_mesh(dp, mp)` places rank r
at (r // mp, r % mp), the position JAX's ``reshape(dp, mp)`` gives device r:

- ``data_group``: the ranks with this rank's ``model_rank`` (dp of them),
  over which batch statistics, loss normalisers and metrics reduce;
- ``model_group``: the ranks with this rank's ``data_rank`` (mp
  consecutive ranks), which hold the same samples and, sharded, one block
  of BEV rows each (`parallel.qshard`).

At mp = 1 the data group is the whole world (the default group, ``None``),
so every collective is the one of the data-parallel runtime.  A replicated
value is every rank's own copy.

`active(mesh)` makes a layout the one the train step's collectives read
(`data_axis`, `current`); outside it the data axis is the whole world and
nothing is sharded, so an evaluation between steps runs unsharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch.distributed as dist

from occnet_tpu_torch.parallel.multihost import is_initialized, world_size
from occnet_tpu_torch.parallel.multihost import rank as process_rank

SHARD_AXES = ("", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) layout and its two groups
    (``None`` is the default group; ``model_group`` is ``None`` at
    mp = 1)."""
    dp: int
    mp: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.mp}


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The (data, model) layout over the process group: ``dp`` = -1 takes
    world // mp.  Raises ValueError unless dp x mp is the world size, and
    RuntimeError for mp > 1 without a process group.  Every rank must call
    it (it creates the subgroups at mp > 1)."""
    if mp < 1:
        raise ValueError(f"mesh mp={mp} must be >= 1")
    if mp > 1 and not is_initialized():
        raise RuntimeError(f"a model axis of mp={mp} needs a process group "
                           f"of dp x mp ranks (torchrun, --distributed); "
                           f"none is initialised")
    n = world_size()
    if dp == -1:
        if n % mp:
            raise ValueError(f"mesh mp={mp} does not divide {n} ranks")
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"mesh dp={dp} x mp={mp} != {n} ranks (one device "
                         f"a rank)")
    r = process_rank()
    data_rank, model_rank = divmod(r, mp)
    if mp == 1:
        return Mesh(dp, 1, r, 0)
    # every rank creates every group, in one order (`new_group`'s rule)
    data_groups = [dist.new_group([d * mp + m for d in range(dp)])
                   for m in range(mp)]
    model_groups = [dist.new_group([d * mp + m for m in range(mp)])
                    for d in range(dp)]
    return Mesh(dp, mp, data_rank, model_rank, data_groups[model_rank],
                model_groups[data_rank])


_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make ``mesh`` the layout of the collectives inside the block (the
    train step's; None keeps the whole world as the data axis)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    """The active layout, None outside `active`."""
    return _ACTIVE


def data_axis() -> Tuple[Any, int]:
    """(group, size) of the data axis the batch statistics, loss
    normalisers and metrics reduce over: the active layout's data group,
    else the whole world."""
    if _ACTIVE is None:
        return None, world_size()
    return _ACTIVE.data_group, _ACTIVE.dp


def check_layout(model_cfg, mesh: Mesh) -> bool:
    """Raise ValueError for a ``bev_shard_axis`` other than "" or "model",
    or, when it shards (mp > 1 and "model"), a ``bev_h`` that mp does not
    divide.  Returns whether the encoder's queries are sharded."""
    axis = model_cfg.bev_shard_axis
    if axis not in SHARD_AXES:
        raise ValueError(f"model.bev_shard_axis={axis!r}: the port shards "
                         f"over {SHARD_AXES[1]!r} or not at all ('')")
    sharded = mesh.mp > 1 and axis == "model"
    if sharded and model_cfg.bev_h % mesh.mp:
        raise ValueError(f"model.bev_h={model_cfg.bev_h} rows do not split "
                         f"over mp={mesh.mp} model ranks")
    return sharded


def shard_batch(batch: Dict[str, Any], dp: Union[int, Mesh],
                rank: Optional[int] = None) -> Dict[str, Any]:
    """This rank's (or ``rank``'s) slice of a global host batch dict: each
    leaf's leading axis split into ``dp`` equal parts.  Given a `Mesh`, the
    parts are the data ranks' and the slice is this rank's data rank's
    (every model rank of a data rank holds the same samples)."""
    if isinstance(dp, Mesh):
        dp, rank = dp.dp, dp.data_rank if rank is None else rank
    rank = process_rank() if rank is None else rank
    out = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch of {v.shape[0]} does not split over "
                             f"{dp} data-parallel ranks")
        b = v.shape[0] // dp
        out[k] = v[rank * b:(rank + 1) * b]
    return out
