"""Ray-metric evaluation loop (port of `occnet_tpu/training/eval_loop.py`):
inference over a dataset, each frame's prediction and ground truth rendered
along the simulated LiDAR fan, RayIoU / mAVE / OccScore at the end.  The
train CLI calls it between epochs (the reference's eval hook).

Inference goes through a `serve.Predictor`, so a nonzero certificate
(`sca_topk_overflow`, `dcn_window_overflow`) raises here as in serving; the
training model is evaluated through `Predictor.wrap`, without a copy of its
weights.  Sample loading runs on a prefetch thread, and each frame's counts
stay on the device until they are fetched in bulk every ``FLUSH`` frames.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import torch

from occnet_tpu_torch.evaluation.ego_pose import (extract_ego_origins,
                                                  pad_origins)
from occnet_tpu_torch.evaluation.ray_metrics import (RayMetricAccumulator,
                                                     generate_lidar_rays,
                                                     occ_score_from_metrics,
                                                     render_pred_gt)

FLUSH = 32          # frames whose counts are fetched from the device at once


def run_evaluation(cfg, predictor, dataset, max_samples: Optional[int] = None,
                   log=print, mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, float]:
    """Scores of ``predictor`` (a `serve.Predictor`) on ``dataset`` (the
    `SyntheticOccDataset` protocol: infos, get_sample), first
    ``max_samples`` frames.  ``mark(name)``, when given, is called before
    each frame ("frame") and after its "forward", "render" and "counts"
    stages (for timing)."""
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    origins_by_token = dict(extract_ego_origins(dataset.infos[:n]))
    rays = generate_lidar_rays()
    acc = RayMetricAccumulator()
    dev = predictor.device
    t0 = time.time()
    pending = []

    def flush_pending():
        for c in pending:
            acc.update_counts(c)
        pending.clear()

    with ThreadPoolExecutor(max_workers=2) as pool:
        depth = min(4, n)
        futures = [pool.submit(dataset.get_sample, i) for i in range(depth)]
        for i in range(n):
            s = futures.pop(0).result()
            if i + depth < n:
                futures.append(pool.submit(dataset.get_sample, i + depth))
            if mark:
                mark("frame")
            occ_cls, flow = predictor(s["img"][None], s["ego2img"][None])
            if mark:
                mark("forward")
            padded, valid = pad_origins(origins_by_token[s["token"]],
                                        cfg.eval.max_origins)
            pred, gt = render_pred_gt(
                occ_cls[0], flow[0],
                torch.from_numpy(s["voxel_semantics"]).to(dev),
                torch.from_numpy(s["voxel_flow"]).to(dev), rays, padded,
                valid, voxel_size=cfg.eval.voxel_size,
                pc_range=tuple(cfg.eval.pc_range))
            if mark:
                mark("render")
            pending.append(acc.count_async(pred, gt))
            if mark:
                mark("counts")
            if len(pending) >= FLUSH:
                flush_pending()
                log(f"eval {i + 1}/{n}  "
                    f"{(time.time() - t0) / (i + 1):.2f}s/frame")
        flush_pending()
    scores = occ_score_from_metrics(acc.finalize())
    log(f"eval done ({n} frames): {scores}")
    return scores
