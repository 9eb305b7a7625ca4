"""Ray-based RayIoU / mAVE / OccScore evaluation on the device (port of
`occnet_tpu/evaluation/ray_metrics.py`).

- `generate_lidar_rays`: the simulated-LiDAR fan, 39 pitch rings x 360
  azimuths = 14,040 unit rays, pitch-major (reference `ray_metrics.py:
  63-86`).
- `render_pred_gt` / `render_sample_vec`: render semantic + flow grids from
  every ego origin along the fan with the fan DDA
  (`ops/ray_march_vec.py`, one kernel launch for the prediction and the
  ground truth together) and look up each ray's class and flow.
- `count_sample` + `RayMetricAccumulator`: the TP / GT / prediction counts
  and flow-error sums of the reference's `calc_metrics`, per frame on the
  device (flow errors summed in fp32), accumulated on the host in int64 and
  float64.
- OccScore = 0.9 * mean(IoU@{1,2,4}) + 0.1 * max(1 - mAVE@2, 0).

The marcher works in voxel units, so the metric grid must have CUBIC voxels
of edge ``voxel_size``.  Origins are converted to voxel units on the host in
float32 (a CUDA tensor divided by a Python scalar would be multiplied by the
reciprocal, and rays on voxel boundaries would then change voxel).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from occnet_tpu_torch.config import FLOW_CLASS_NAMES, OCC_CLASS_NAMES
from occnet_tpu_torch.ops.ray_march_vec import dda_raymarch_fan_vec

_PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
_VOXEL_SIZE = 0.4
NUM_CLASSES = len(OCC_CLASS_NAMES)          # 17, 'free' last
FREE_ID = NUM_CLASSES - 1
THRESHOLDS = (1.0, 2.0, 4.0)
AVE_THRESHOLD_INDEX = 1                     # AVE uses threshold = 2m
FLOW_CLASS_IDS = tuple(OCC_CLASS_NAMES.index(c) for c in FLOW_CLASS_NAMES)

Rendered = Dict[str, torch.Tensor]


def generate_lidar_rays() -> np.ndarray:
    """(R, 3) unit ray directions — the simulated LiDAR fan
    (`ray_metrics.py:63-86`)."""
    pitch = []
    for k in range(10):
        pitch.append(-(math.pi / 2 - math.atan(k + 1)))
    while pitch[-1] < 0.21:
        delta = pitch[-1] - pitch[-2]
        pitch.append(pitch[-1] + delta)

    rays = []
    for p in pitch:
        for az_deg in np.arange(0, 360, 1):
            az = np.deg2rad(az_deg)
            rays.append((np.cos(p) * np.cos(az),
                         np.cos(p) * np.sin(az),
                         np.sin(p)))
    return np.asarray(rays, dtype=np.float32)


def fan_parameters(rays: np.ndarray, num_az: int = 360
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decompose the pitch-major lidar fan into (az_dirs (A, 2), pitch_dz
    (K,), pitch_scale (K,)) float32 for the fan marcher, on the host.  The
    xy norm is sqrt(fma(y, y, x * x)), as XLA computes the JAX norm."""
    fan = np.asarray(rays, np.float32).reshape(-1, num_az, 3)
    x, y = fan[..., 0], fan[..., 1]
    sq = ((x * x).astype(np.float64) + y.astype(np.float64) ** 2).astype(
        np.float32)
    xy_norm = np.sqrt(sq)                                    # = cos(pitch)
    az_dirs = fan[0, :, :2] / xy_norm[0, :, None]
    pitch_dz = fan[:, 0, 2] / xy_norm[:, 0]                  # tan(pitch)
    pitch_scale = np.float32(1.0) / xy_norm[:, 0]
    return az_dirs, pitch_dz, pitch_scale


def _render_grids(sems: torch.Tensor, flows: torch.Tensor, rays,
                  origins, origin_valid, num_az: int,
                  voxel_size: float, pc_range: Tuple[float, ...]
                  ) -> Rendered:
    """G grids x T origins along the fan in one march: dict of (G, T, R)
    tensors on the grids' device, R pitch-major."""
    dev = sems.device
    occs = sems != FREE_ID
    az, dz, scale = (torch.from_numpy(a).to(dev)
                     for a in fan_parameters(rays, num_az))
    G, R, T = sems.shape[0], np.shape(rays)[0], np.shape(origins)[0]
    o = np.asarray(origins, np.float32)
    o_vox = (o - np.asarray(pc_range[:3], np.float32)) / np.float32(
        voxel_size)
    dist, coord, hit = dda_raymarch_fan_vec(
        occs, torch.from_numpy(o_vox).to(dev), az, dz, scale)
    # (G, T, A, K) -> pitch-major (G, T, K * A)
    dist = dist.transpose(2, 3).reshape(G, T, R) * voxel_size
    coord = coord.transpose(2, 3).reshape(G, T, R, 3).long()
    X, Y, Z = sems.shape[1:]
    flat = (coord[..., 0] * Y + coord[..., 1]) * Z + coord[..., 2]
    gidx = torch.arange(G, device=dev)[:, None, None]
    label = sems.reshape(G, -1)[gidx, flat]
    fl = flows.reshape(G, -1, 2)[gidx, flat]
    valid = torch.from_numpy(np.asarray(origin_valid, bool)).to(dev)
    valid = valid[None, :, None].expand(dist.shape)
    return {"dist": dist, "label": label, "flow": fl, "valid": valid}


def render_pred_gt(sem_pred: torch.Tensor, flow_pred: torch.Tensor,
                   sem_gt: torch.Tensor, flow_gt: torch.Tensor, rays,
                   origins, origin_valid, num_az: int = 360,
                   voxel_size: float = _VOXEL_SIZE,
                   pc_range: Tuple[float, ...] = _PC_RANGE
                   ) -> Tuple[Rendered, Rendered]:
    """Render prediction and ground truth in ONE march.  Grids (X, Y, Z)
    int and (X, Y, Z, 2) float on one device; rays (R, 3) and origins
    (T, 3) metres / origin_valid (T,) host arrays.  Returns two dicts of
    (T, R) tensors."""
    outs = _render_grids(
        torch.stack([sem_pred.long(), sem_gt.long()]),
        torch.stack([flow_pred.float(), flow_gt.float()]), rays, origins,
        origin_valid, num_az, voxel_size, pc_range)
    return ({k: v[0] for k, v in outs.items()},
            {k: v[1] for k, v in outs.items()})


def render_sample_vec(sem: torch.Tensor, flow: torch.Tensor, rays, origins,
                      origin_valid, num_az: int = 360,
                      voxel_size: float = _VOXEL_SIZE,
                      pc_range: Tuple[float, ...] = _PC_RANGE) -> Rendered:
    """One grid along the fan: dict of (T, R) tensors."""
    outs = _render_grids(sem.long()[None], flow.float()[None], rays, origins,
                         origin_valid, num_az, voxel_size, pc_range)
    return {k: v[0] for k, v in outs.items()}


def count_sample(pred: Rendered, gt: Rendered) -> Dict[str, torch.Tensor]:
    """Per-frame TP / GT / prediction counts and flow-error sums over the
    (T * R) rays, on the rays' device (no host sync).  Rays whose GT label
    is 'free' and padded origins are excluded (`ray_metrics.py:218-220`)."""
    valid = gt["valid"].reshape(-1) & (gt["label"].reshape(-1) != FREE_ID)
    p_label = pred["label"].reshape(-1)
    g_label = gt["label"].reshape(-1)
    l1 = (pred["dist"].reshape(-1) - gt["dist"].reshape(-1)).abs()
    fd = pred["flow"].reshape(-1, 2) - gt["flow"].reshape(-1, 2)
    fx, fy = fd[:, 0], fd[:, 1]
    # |fd| as XLA computes the JAX norm: sqrt(fma(y, y, x * x)), rounded once
    sq = ((fx * fx).double() + fy.double() * fy.double()).float()
    flow_err = torch.sqrt(sq.double()).float()
    cls = torch.arange(NUM_CLASSES, device=g_label.device)
    p_onehot = (p_label[:, None] == cls) & valid[:, None]
    g_onehot = (g_label[:, None] == cls) & valid[:, None]
    tp_cls = p_onehot & g_onehot
    tp = [tp_cls & (l1 < thr)[:, None] for thr in THRESHOLDS]
    tp_cnt = torch.stack([m.sum(0) for m in tp])
    return {
        "gt_cnt": g_onehot.sum(0),
        "pred_cnt": p_onehot.sum(0),
        "tp_cnt": tp_cnt,
        "ave_sum": torch.stack([(m * flow_err[:, None]).sum(0) for m in tp]),
        "ave_cnt": tp_cnt,
    }


class RayMetricAccumulator:
    """Streaming accumulator for RayIoU / mAVE over the eval set: int64
    counts and float64 flow-error sums on the host."""

    def __init__(self):
        self.gt_cnt = np.zeros(NUM_CLASSES, np.int64)
        self.pred_cnt = np.zeros(NUM_CLASSES, np.int64)
        self.tp_cnt = np.zeros((len(THRESHOLDS), NUM_CLASSES), np.int64)
        self.ave_sum = np.zeros((len(THRESHOLDS), NUM_CLASSES), np.float64)
        self.ave_cnt = np.zeros((len(THRESHOLDS), NUM_CLASSES), np.int64)
        self.num_samples = 0

    def update(self, pred: Rendered, gt: Rendered):
        self.update_counts(count_sample(pred, gt))

    def count_async(self, pred: Rendered, gt: Rendered
                    ) -> Dict[str, torch.Tensor]:
        """The per-frame counts, left on the device (an eval loop queues
        many frames and fetches them in bulk with `update_counts`)."""
        return count_sample(pred, gt)

    def update_counts(self, c: Dict[str, torch.Tensor]):
        c = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
             for k, v in c.items()}
        self.gt_cnt += c["gt_cnt"].astype(np.int64)
        self.pred_cnt += c["pred_cnt"].astype(np.int64)
        self.tp_cnt += c["tp_cnt"].astype(np.int64)
        self.ave_sum += c["ave_sum"].astype(np.float64)
        self.ave_cnt += c["ave_cnt"].astype(np.int64)
        self.num_samples += 1

    def finalize(self) -> Dict[str, np.ndarray]:
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = self.gt_cnt + self.pred_cnt - self.tp_cnt
            iou = np.where(denom > 0, self.tp_cnt / denom, np.nan)[:, :-1]
            ave = np.full(NUM_CLASSES, np.nan)
            j = AVE_THRESHOLD_INDEX
            for i in FLOW_CLASS_IDS:
                if self.ave_cnt[j, i] > 0:
                    ave[i] = self.ave_sum[j, i] / self.ave_cnt[j, i]
            ave = ave[:-1]
        return {"iou": iou, "ave": ave}


def occ_score_from_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    iou, ave = metrics["iou"], metrics["ave"]
    miou = float(np.nanmean(iou))
    # an all-NaN AVE (no flow-class TPs anywhere) propagates NaN into mAVE
    # and OccScore, exactly as the reference (`ray_metrics.py:250-253`,
    # python max(nan, 0.0) keeps the nan)
    with np.errstate(invalid="ignore"):
        mave = float(np.nanmean(ave))
    occ_score = miou * 0.9 + max(1.0 - mave, 0.0) * 0.1
    per_thr = [float(np.nanmean(iou[j])) for j in range(len(THRESHOLDS))]
    return {
        "RayIoU": miou,
        "RayIoU@1": per_thr[0],
        "RayIoU@2": per_thr[1],
        "RayIoU@4": per_thr[2],
        "mAVE": mave,
        "OccScore": occ_score,
    }


def format_metrics_table(metrics: Dict[str, np.ndarray]) -> str:
    """Per-class IoU@{1,2,4}/AVE table (the PrettyTable of
    `ray_metrics.py:228-248`), plain-text."""
    iou, ave = metrics["iou"], metrics["ave"]
    lines = [f"{'Class':<22}{'IoU@1':>8}{'IoU@2':>8}{'IoU@4':>8}{'AVE':>8}"]
    for i, name in enumerate(OCC_CLASS_NAMES[:-1]):
        vals = [iou[0][i], iou[1][i], iou[2][i], ave[i]]
        cells = "".join(
            f"{v:>8.3f}" if np.isfinite(v) else f"{'nan':>8}" for v in vals)
        lines.append(f"{name:<22}{cells}")
    mean_vals = [np.nanmean(iou[0]), np.nanmean(iou[1]), np.nanmean(iou[2]),
                 np.nanmean(ave)]
    lines.append(f"{'MEAN':<22}" + "".join(f"{v:>8.3f}" for v in mean_vals))
    return "\n".join(lines)
