"""Deterministic sharded index samplers (a copy of
`occnet_tpu/data/sampler.py`, which the port does not import).

- `shuffled_shard_indices` ~ the reference's DistributedGroupSampler
  (`group_sampler.py:14-109`): epoch-seeded permutation, padded to an equal
  per-shard count, strided assignment.
- `contiguous_shard_indices` ~ the reference's non-shuffling
  DistributedSampler (`distributed_sampler.py:8-41`): each shard gets a
  contiguous index block, the order the test CLI's results keep.
"""

from __future__ import annotations

import numpy as np


def shuffled_shard_indices(n: int, num_shards: int, shard: int,
                           epoch: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed + epoch)
    idx = rng.permutation(n)
    per_shard = -(-n // num_shards)
    total = per_shard * num_shards
    if total > n:
        idx = np.concatenate([idx, idx[: total - n]])
    return idx[shard::num_shards]



def contiguous_shard_indices(n: int, num_shards: int,
                             shard: int) -> np.ndarray:
    per_shard = -(-n // num_shards)
    total = per_shard * num_shards
    idx = np.arange(n)
    if total > n:
        idx = np.concatenate([idx, idx[: total - n]])
    return idx[shard * per_shard: (shard + 1) * per_shard]
