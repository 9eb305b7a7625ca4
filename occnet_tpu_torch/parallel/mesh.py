"""The data-parallel layout of the port (counterpart of `occnet_tpu/
parallel/mesh.py`).

The JAX package lays its devices out as a (data, model) mesh and shards the
batch over ``data`` (`Mesh`, `batch_sharding`, `replicated_sharding`).  Here
a rank is one device, so the layout is the data axis alone: ``dp`` ranks,
each holding 1 / dp of every global batch, and a replicated value is simply
every rank's own copy.  The ``model`` axis (BEV-query sharding,
``bev_shard_axis`` with ``mp > 1``) is not carried: ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from occnet_tpu_torch.parallel.multihost import process_shard, world_size

MP_ROADMAP = ("BEV-query sharding over a model axis (mp > 1, "
              "bev_shard_axis) is not ported: ROADMAP Queue 1 item 7")


def make_mesh(dp: int = -1, mp: int = 1) -> int:
    """The data-parallel width over the process group: ``dp`` = -1 takes
    every rank, any other ``dp`` must equal the world size; ``mp`` > 1
    raises (see the module doc)."""
    if mp != 1:
        raise NotImplementedError(MP_ROADMAP)
    n = world_size()
    if dp not in (-1, n):
        raise ValueError(f"mesh dp={dp} != {n} ranks (one device a rank)")
    return n


def shard_batch(batch: Dict[str, Any], dp: int,
                rank: Optional[int] = None) -> Dict[str, Any]:
    """This rank's (or ``rank``'s) slice of a global host batch dict: each
    leaf's leading axis split into ``dp`` equal parts."""
    rank = process_shard()[0] if rank is None else rank
    out = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch of {v.shape[0]} does not split over "
                             f"{dp} data-parallel ranks")
        b = v.shape[0] // dp
        out[k] = v[rank * b:(rank + 1) * b]
    return out
