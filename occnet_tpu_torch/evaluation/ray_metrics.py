"""Ray-based RayIoU / mAVE / OccScore evaluation on the device (port of
`occnet_tpu/evaluation/ray_metrics.py`).

- `generate_lidar_rays`: the simulated-LiDAR fan, 39 pitch rings x 360
  azimuths = 14,040 unit rays, pitch-major (reference `ray_metrics.py:
  63-86`).
- `render_pred_gt` / `render_sample_vec`: render semantic + flow grids from
  every ego origin along the fan with the fan DDA and look up each ray's
  class and flow (`ops/ray_march_vec.fan_render`: on the card one kernel
  launch for the prediction and the ground truth together; the fan
  parameters are built once and kept on the device).
- `count_sample` + `RayMetricAccumulator`: the TP / GT / prediction counts
  and flow-error sums of the reference's `calc_metrics`, per frame on the
  device (one-hot sums, flow errors summed in float64), accumulated on the
  host in int64 and float64.
- OccScore = 0.9 * mean(IoU@{1,2,4}) + 0.1 * max(1 - mAVE@2, 0).

The marcher works in voxel units, so the metric grid must have CUBIC voxels
of edge ``voxel_size``.  Origins are converted to voxel units on the host in
float32 (a CUDA tensor divided by a Python scalar would be multiplied by the
reciprocal, and rays on voxel boundaries would then change voxel).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from occnet_tpu_torch.config import FLOW_CLASS_NAMES, OCC_CLASS_NAMES
from occnet_tpu_torch.ops.ray_march_vec import Rendered, fan_render

_PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
_VOXEL_SIZE = 0.4
NUM_CLASSES = len(OCC_CLASS_NAMES)          # 17, 'free' last
FREE_ID = NUM_CLASSES - 1
THRESHOLDS = (1.0, 2.0, 4.0)
AVE_THRESHOLD_INDEX = 1                     # AVE uses threshold = 2m
FLOW_CLASS_IDS = tuple(OCC_CLASS_NAMES.index(c) for c in FLOW_CLASS_NAMES)


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


class FanTables:
    """`fan_parameters` on a device, built once per (rays, num_az, device)
    and kept there; ``builds`` counts the builds."""

    def __init__(self):
        self._tables: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self.builds = 0

    def __call__(self, rays, num_az: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        rays = np.ascontiguousarray(rays, np.float32)
        key = (hashlib.sha1(rays).digest(), rays.shape, int(num_az),
               str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in fan_parameters(rays, num_az))
            self.builds += 1
        return self._tables[key]

    def clear(self):
        self._tables.clear()
        self.builds = 0


FAN_TABLES = FanTables()


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device``; to the card through pinned memory
    without waiting for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _render_grids(sems: Sequence[torch.Tensor], flows: Sequence[torch.Tensor],
                  rays, origins, origin_valid, num_az: int,
                  voxel_size: float, pc_range: Tuple[float, ...]
                  ) -> Rendered:
    """G grids x T origins along the fan in one march: dict of (G, T, R)
    tensors on the grids' device, R pitch-major (`ops.ray_march_vec.
    fan_render`: one kernel launch for all grids on the card)."""
    dev = sems[0].device
    az, dz, scale = FAN_TABLES(rays, num_az, dev)
    o = np.asarray(origins, np.float32)
    o_vox = (o - np.asarray(pc_range[:3], np.float32)) / np.float32(
        voxel_size)
    outs = fan_render([s.contiguous() for s in sems],
                      [f.contiguous() for f in flows], _to_device(o_vox, dev),
                      az, dz, scale, voxel_size, FREE_ID)
    valid = _to_device(np.asarray(origin_valid, bool), dev)
    outs["valid"] = valid[None, :, None].expand(outs["dist"].shape)
    return outs


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
    outs = _render_grids([sem_pred, sem_gt], [flow_pred, flow_gt], rays,
                         origins, origin_valid, num_az, voxel_size, pc_range)
    return ({k: v[0] for k, v in outs.items()},
            {k: v[1] for k, v in outs.items()})


def render_sample_vec(sem: torch.Tensor, flow: torch.Tensor, rays, origins,
                      origin_valid, num_az: int = 360,
                      voxel_size: float = _VOXEL_SIZE,
                      pc_range: Tuple[float, ...] = _PC_RANGE) -> Rendered:
    """One grid along the fan: dict of (T, R) tensors."""
    outs = _render_grids([sem], [flow], rays, origins, origin_valid, num_az,
                         voxel_size, pc_range)
    return {k: v[0] for k, v in outs.items()}


_CONSTS: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}


def _consts(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The thresholds and the class ids, on ``dev``."""
    key = str(dev)
    if key not in _CONSTS:
        _CONSTS[key] = (
            torch.tensor(THRESHOLDS, dtype=torch.float32, device=dev),
            torch.arange(NUM_CLASSES, device=dev))
    return _CONSTS[key]


def count_sample(pred: Rendered, gt: Rendered) -> Dict[str, torch.Tensor]:
    """Per-frame TP / GT / prediction counts and flow-error sums over the
    (T * R) rays, on the rays' device (no host sync).  Rays whose GT label
    is 'free' and padded origins are excluded (`ray_metrics.py:218-220`).

    Each counted ray's GT and predicted class and, where the two agree, its
    thresholds passed are one-hot booleans summed over the rays; the TPs'
    flow errors |fd| are taken and summed in float64 (within an ulp of
    XLA's fp32 norm).  Only elementwise ops and sums: a histogram
    (`index_add_`, `bincount`) pays up to a few hundred ms for its
    kernels' first use in the first frame of every eval (PERF.md §5)."""
    thresholds, classes = _consts(gt["label"].device)
    g = gt["label"].reshape(-1, 1)
    p = pred["label"].reshape(-1, 1)
    ok = (gt["valid"] & (gt["label"] != FREE_ID)).reshape(-1, 1)
    g_cls = (g == classes) & ok                            # (rays, class)
    p_cls = (p == classes) & ok
    near = (pred["dist"] - gt["dist"]).abs().reshape(-1, 1) < thresholds
    tp = near[:, :, None] & (g_cls & (p == g))[:, None]    # (rays, thr, cls)
    fd = (pred["flow"] - gt["flow"]).double()
    fx, fy = fd[..., 0], fd[..., 1]
    err = (fx * fx + fy * fy).sqrt().reshape(-1, 1, 1)
    tp_cnt = tp.sum(0)
    return {
        "gt_cnt": g_cls.sum(0),
        "pred_cnt": p_cls.sum(0),
        "tp_cnt": tp_cnt,
        "ave_sum": (tp * err).sum(0),
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
