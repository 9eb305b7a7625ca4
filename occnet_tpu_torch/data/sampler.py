"""Deterministic sharded index sampler (a copy of `shuffled_shard_indices`
from `occnet_tpu/data/sampler.py`, which the port does not import).

`shuffled_shard_indices` ~ the reference's DistributedGroupSampler
(`group_sampler.py:14-109`): epoch-seeded permutation, padded to an equal
per-shard count, strided assignment.
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

