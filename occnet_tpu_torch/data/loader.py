"""Asynchronous prefetching data loader (a copy of `occnet_tpu/data/loader.py`,
which the port does not import).

Replaces the reference's torch `DataLoader` + worker-seeding machinery
(`datasets/builder.py:19-118`): a thread pool decodes/preprocesses samples
ahead of the training step, with per-sample deterministic RNG (seeded by
(seed, epoch, index) — the reference's worker_init_fn seeding :96-101 made
deterministic rather than per-worker), and a bounded prefetch queue that
overlaps host preprocessing with device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, indices: Sequence[int],
                 seed: int = 0, epoch: int = 0, training: bool = True,
                 num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = list(indices)
        self.seed = seed
        self.epoch = epoch
        self.training = training
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.indices) // self.batch_size

    def _load_one(self, idx: int) -> dict:
        rng = None
        if self.training:
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch * 9176 + int(idx))
                % (2 ** 31))
        return self.dataset.get_sample(int(idx), rng)

    def __iter__(self) -> Iterator[dict]:
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = []
                for b in range(n_batches):
                    idxs = self.indices[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                    futures.append([pool.submit(self._load_one, i)
                                    for i in idxs])
                    # bound the number of outstanding batches
                    while len(futures) > self.prefetch and not stop.is_set():
                        samples = [f.result() for f in futures.pop(0)]
                        out_q.put(self.dataset.collate(samples))
                for fs in futures:
                    if stop.is_set():
                        break
                    out_q.put(self.dataset.collate([f.result() for f in fs]))
            out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
