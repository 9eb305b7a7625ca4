"""Ray-metric evaluation loop (port of `occnet_tpu/training/eval_loop.py`):
inference over a dataset, each frame's prediction and ground truth rendered
along the simulated LiDAR fan, RayIoU / mAVE / OccScore at the end.  The
train CLI calls it between epochs (the reference's eval hook).

Inference goes through a `serve.Predictor`, so a nonzero certificate
(`sca_topk_overflow`, `dcn_window_overflow`) raises here as in serving; the
training model is evaluated through `Predictor.wrap`, without a copy of its
weights.  Sample loading runs on a prefetch thread, the ground truth is
copied to the card from pinned memory without waiting for the forward, and
each frame's counts stay on the device until they are fetched in bulk every
``FLUSH`` frames.

Under a process group (``mesh``) the frames are split over the data ranks
in contiguous blocks (`data.sampler.contiguous_shard_indices` without its
wrap-around padding); each rank keeps its frames' counts, every rank
gathers them (`parallel.allgather_host`) and adds the data ranks' blocks
in frame order, so the scores are the single-process run's, bit for bit.
The model ranks of a data rank score the same frames.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from occnet_tpu_torch.evaluation.ego_pose import (extract_ego_origins,
                                                  pad_origins)
from occnet_tpu_torch.evaluation.ray_metrics import (RayMetricAccumulator,
                                                     generate_lidar_rays,
                                                     occ_score_from_metrics,
                                                     render_pred_gt)

FLUSH = 32          # frames whose counts are fetched from the device at once
COUNT_KEYS = ("gt_cnt", "pred_cnt", "tp_cnt", "ave_sum", "ave_cnt")


def run_evaluation(cfg, predictor, dataset, max_samples: Optional[int] = None,
                   log=print, mark: Optional[Callable[[str], None]] = None,
                   mesh=None) -> Dict[str, float]:
    """Scores of ``predictor`` (a `serve.Predictor`) on ``dataset`` (the
    `SyntheticOccDataset` protocol: infos, get_sample), first
    ``max_samples`` frames; with ``mesh`` (a `parallel.mesh.Mesh`) this
    rank's data rank scores its block of them (module doc).
    ``mark(name)``, when given, is called before each frame ("frame") and
    after its "forward", "render" and "counts" stages (for timing)."""
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    origins_by_token = dict(extract_ego_origins(dataset.infos[:n]))
    rays = generate_lidar_rays()
    acc = RayMetricAccumulator()
    dev = predictor.device
    t0 = time.time()
    pending = []
    frames = range(n)
    if mesh is not None:
        per = -(-n // mesh.dp)
        frames = range(min(mesh.data_rank * per, n),
                       min((mesh.data_rank + 1) * per, n))
    kept = []

    def flush_pending():
        for c in pending:
            if mesh is None:
                acc.update_counts(c)
            else:
                kept.append({k: v.cpu().numpy() for k, v in c.items()})
        pending.clear()

    with ThreadPoolExecutor(max_workers=2) as pool:
        depth = min(4, len(frames))
        futures = [pool.submit(dataset.get_sample, frames[i])
                   for i in range(depth)]
        for i in range(len(frames)):
            s = futures.pop(0).result()
            if i + depth < len(frames):
                futures.append(pool.submit(dataset.get_sample,
                                           frames[i + depth]))
            if mark:
                mark("frame")
            occ_cls, flow = predictor(s["img"][None], s["ego2img"][None])
            if mark:
                mark("forward")
            padded, valid = pad_origins(origins_by_token[s["token"]],
                                        cfg.eval.max_origins)
            host = [torch.from_numpy(np.ascontiguousarray(s[k]))
                    for k in ("voxel_semantics", "voxel_flow")]
            if dev.type == "cuda":
                # pinned here, while the forward runs: the copies then do
                # not wait for it (pinned on the prefetch thread, the
                # forward's launches slowed)
                host = [t.pin_memory() for t in host]
            pred, gt = render_pred_gt(
                occ_cls[0], flow[0], *(t.to(dev, non_blocking=True)
                                       for t in host), rays, padded,
                valid, voxel_size=cfg.eval.voxel_size,
                pc_range=tuple(cfg.eval.pc_range))
            if mark:
                mark("render")
            pending.append(acc.count_async(pred, gt))
            if mark:
                mark("counts")
            if len(pending) >= FLUSH:
                flush_pending()
                log(f"eval {i + 1}/{len(frames)}  "
                    f"{(time.time() - t0) / (i + 1):.2f}s/frame")
        flush_pending()
    if mesh is not None:
        # model rank 0's frames of each data rank
        merge_frame_counts(acc, kept, -(-n // mesh.dp), mesh.dp * mesh.mp,
                           range(0, mesh.dp * mesh.mp, mesh.mp))
    scores = occ_score_from_metrics(acc.finalize())
    log(f"eval done ({n} frames): {scores}")
    return scores



def merge_frame_counts(acc, frames, rows: int, world: int, sources) -> None:
    """Add the ranks' per-frame counts to ``acc`` in frame order: this
    rank's ``frames`` (count dicts, at most ``rows``) are zero-padded to
    ``rows``, gathered from the ``world`` ranks (`parallel.allgather_host`,
    the reference's collect_results_cpu without its tmpdir pickles), and
    the frames of the ranks ``sources`` added in that order, so the
    float64 flow-error sums add in the single-process order."""
    from occnet_tpu_torch import parallel
    rows = max(rows, 1)
    zero = {k: np.zeros_like(getattr(acc, k)) for k in COUNT_KEYS}
    g = parallel.allgather_host({"n": np.int64(len(frames)), **{
        k: np.stack([np.asarray(f[k], zero[k].dtype) for f in frames]
                    + [zero[k]] * (rows - len(frames))) for k in COUNT_KEYS}})
    n_of = np.reshape(g["n"], world)
    g = {k: np.reshape(g[k], (world, rows) + zero[k].shape)
         for k in COUNT_KEYS}
    for r in sources:
        for i in range(int(n_of[r])):
            acc.update_counts({k: g[k][r, i] for k in COUNT_KEYS})
