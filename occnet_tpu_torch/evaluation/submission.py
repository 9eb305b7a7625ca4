"""Challenge submission writer and offline scorer (port of
`occnet_tpu/evaluation/submission.py`).

Equivalents of the reference's `format_results` (`datasets/nuscenes_occ.py:
189-257`) and of the offline `tools/ray_iou/metric.py`: `write_submission`
renders each predicted grid along the simulated LiDAR fan from its ego
origins (`ray_metrics.render_sample_vec`: on the card one launch of
`csrc/ray_march.cu`'s fan kernel, on the CPU its plain version, on the
device the grid is on) and packs {token: {pcd_cls u8, pcd_dist f16,
pcd_flow f16 (N, 2)}} plus metadata into a gzip pickle;
`score_submissions` compares two such files into RayIoU@{1,2,4} / mAVE /
OccScore in numpy, exactly as the JAX package does.
"""

from __future__ import annotations

import gzip
import pickle
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from occnet_tpu_torch.evaluation.ego_pose import pad_origins
from occnet_tpu_torch.evaluation.ray_metrics import (
    FLOW_CLASS_IDS as _FLOW_CLASS_IDS,
    FREE_ID,
    THRESHOLDS,
    generate_lidar_rays,
    render_sample_vec,
)

Grid = Union[np.ndarray, torch.Tensor]


def render_to_pcd(sem: Grid, flow: Grid, rays: np.ndarray,
                  origins: np.ndarray, max_origins: int = 8):
    """Render one sample on the device its grids are on (numpy grids on the
    CPU) -> flat host (label, dist, flow) arrays over the valid T * R
    rays."""
    padded, valid = pad_origins(origins, max_origins)
    out = render_sample_vec(torch.as_tensor(sem), torch.as_tensor(flow),
                            rays, padded, valid)
    keep = out["valid"].reshape(-1).cpu().numpy()
    label = out["label"].reshape(-1).cpu().numpy()[keep]
    dist = out["dist"].reshape(-1).cpu().numpy()[keep]
    fl = out["flow"].reshape(-1, 2).cpu().numpy()[keep]
    return label, dist, fl


def submission_entry(sem: Grid, flow: Grid, rays: np.ndarray,
                     origins: np.ndarray) -> dict:
    """One token's entry of a submission: its grids rendered along the fan
    (`render_to_pcd`) as uint8 classes and float16 distances and flows."""
    label, dist, fl = render_to_pcd(sem, flow, rays, origins)
    return {"pcd_cls": label.astype(np.uint8),
            "pcd_dist": dist.astype(np.float16),
            "pcd_flow": fl.astype(np.float16)}


def save_submission(path: str, results: Dict[str, dict],
                    meta: Optional[dict] = None):
    """Pack {token: `submission_entry`} with the challenge's metadata into
    a gzip pickle."""
    payload = {"method": "occnet_tpu", "team": "", "authors": [],
               "e-mail": "", "institution / company": "",
               "country / region": "", "results": results}
    payload.update(meta or {})
    with gzip.open(path, "wb", compresslevel=9) as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def write_submission(path: str,
                     samples: Iterable[Tuple[str, Grid, Grid, np.ndarray]],
                     meta: Optional[dict] = None):
    """samples: iterable of (token, sem (200, 200, 16), flow (..., 2),
    origins (T, 3))."""
    rays = generate_lidar_rays()
    save_submission(path, {token: submission_entry(sem, flow, rays, origins)
                           for token, sem, flow, origins in samples}, meta)


def load_submission(path: str) -> dict:
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


def merge_submissions(part_paths: Iterable[str], out_path: str) -> int:
    """Merge partial submissions (one a process) into one file.  Later parts
    win on duplicate tokens (shard padding repeats boundary samples).
    Returns the merged sample count."""
    merged: Dict[str, dict] = {}
    meta = None
    for p in part_paths:
        payload = load_submission(p)
        if meta is None:
            meta = {k: v for k, v in payload.items() if k != "results"}
        merged.update(payload["results"])
    payload = dict(meta or {})
    payload["results"] = merged
    with gzip.open(out_path, "wb", compresslevel=9) as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return len(merged)


def score_submissions(pred_path: str, gt_path: str) -> dict:
    """Offline scorer replicating `tools/ray_iou/metric.py` (the challenge
    server's scorer), vectorised in numpy.  Two deliberate differences from
    the in-training scorer (`ray_metrics`), kept for leaderboard
    compatibility:

    - rays whose GT class is 'free' are dropped from all counting
      (`metric.py:41-48`);
    - once a (threshold, class) has >= 1 TP, the flow-error sum adds the L2
      error of ALL valid rays of the sample, not only that class's TP rays
      (`metric.py:70-74`).

    A class with zero TPs scores 0/0 = NaN AVE; an all-NaN mAVE propagates
    into a NaN OccScore, as in the reference (`metric.py:118-121`).  Raises
    KeyError when the prediction misses a GT token (the reference's
    RuntimeError, `metric.py:114-115`)."""
    pred = load_submission(pred_path)["results"]
    gt = load_submission(gt_path)["results"]
    n_cls = FREE_ID + 1
    n_thr = len(THRESHOLDS)
    gt_cnt = np.zeros(n_cls)
    pred_cnt = np.zeros(n_cls)
    tp_cnt = np.zeros((n_thr, n_cls))
    ave_sum = np.zeros((n_thr, n_cls))
    ave_cnt = np.zeros((n_thr, n_cls))
    flow_ids = np.asarray(
        [i for i in range(n_cls) if i in _FLOW_CLASS_IDS], np.int64)
    for token, g in gt.items():
        p = pred[token]
        g_cls = g["pcd_cls"].astype(np.int32)
        valid = g_cls != FREE_ID
        gc = g_cls[valid]
        gd = g["pcd_dist"].astype(np.float32)[valid]
        gf = g["pcd_flow"].astype(np.float32)[valid]
        pc = p["pcd_cls"].astype(np.int32)[valid]
        pd = p["pcd_dist"].astype(np.float32)[valid]
        pf = p["pcd_flow"].astype(np.float32)[valid]
        gt_cnt += np.bincount(gc, minlength=n_cls)
        pred_cnt += np.bincount(pc, minlength=n_cls)
        l1 = np.abs(pd - gd)
        cls_tp = pc == gc
        flow_err_total = np.linalg.norm(gf - pf, axis=1).sum()
        n_valid = gc.shape[0]
        for j, thr in enumerate(THRESHOLDS):
            tpj = np.bincount(gc[cls_tp & (l1 < thr)], minlength=n_cls)
            tp_cnt[j] += tpj
            hit = flow_ids[tpj[flow_ids] > 0]
            ave_sum[j, hit] += flow_err_total
            ave_cnt[j, hit] += n_valid
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = (tp_cnt / (gt_cnt + pred_cnt - tp_cnt))[:, :-1]
        ave = np.full(n_cls, np.nan)
        ave[flow_ids] = 0.0
        ave = (ave + ave_sum[1]) / ave_cnt[1]
        ave = ave[:-1]
        miou = float(np.nanmean(iou))
        mave = float(np.nanmean(ave))
    occ_score = miou * 0.9 + max(1.0 - mave, 0.0) * 0.1
    return {
        "RayIoU": miou,
        "RayIoU@1": float(np.nanmean(iou[0])),
        "RayIoU@2": float(np.nanmean(iou[1])),
        "RayIoU@4": float(np.nanmean(iou[2])),
        "mAVE": mave,
        "OccScore": occ_score,
        "final_Occ_Score": occ_score,       # the reference CLI's key name
    }
