"""Scene clips for the temporal (video) path (port of `occnet_tpu/data/
clips.py`).

The reference's video runner takes (B, T, ...) clips
(`bevformer/runner/epoch_based_runner.py:57-97`): frames 0..T-2 give the
history BEV without gradients, the last frame is supervised.  `ClipDataset`
builds them over a `NuSceneOccDataset`: clip i holds the consecutive frames
of i's scene that end at i, left-padded with the scene's first frame and
``prev_exists`` False (the `prev_bev_exists` reset of
`bevformer_occ.py:171-172`), plus each transition's alignment (``rot_deg``,
normalised ``shifts``) from the infos' ego2global poses
(`clip_alignment`), which `training.temporal.make_temporal_train_step`
consumes.

Batch layout (after `collate`):
  img (B, T, cams, H, W, 3) uint8, ego2img (B, T, cams, 4, 4),
  rot_deg (B, T), shifts (B, T, 2), prev_exists (B, T),
  shift (B, 2): the last transition's shift, for the supervised frame,
  voxel_semantics / voxel_flow: the LAST frame's ground truth,
  tokens: the last frames' sample tokens.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def clip_alignment(prev_pose: np.ndarray, curr_pose: np.ndarray,
                   pc_range: Sequence[float], bev_hw) -> tuple:
    """(rot_deg, shift (2,)) aligning a prev-frame BEV into the current
    frame, in float64 numpy rounded to float32 at the end, as the JAX
    package computes it (`training.temporal.ego_deltas_from_poses` +
    `ops.transforms.shift_bev_ref` on the host)."""
    rel = np.linalg.inv(prev_pose) @ curr_pose
    delta_x, delta_y = rel[0, 3], rel[1, 3]
    yaw_delta = np.degrees(np.arctan2(rel[1, 0], rel[0, 0]))
    yaw_curr = np.degrees(np.arctan2(curr_pose[1, 0], curr_pose[0, 0]))

    bev_h, bev_w = bev_hw
    grid_len_y = (pc_range[4] - pc_range[1]) / bev_h
    grid_len_x = (pc_range[3] - pc_range[0]) / bev_w
    translation = float(np.hypot(delta_x, delta_y))
    translation_angle = np.degrees(np.arctan2(delta_y, delta_x))
    bev_angle = yaw_curr - translation_angle
    shift_y = translation * np.cos(np.radians(bev_angle)) / grid_len_y / bev_h
    shift_x = translation * np.sin(np.radians(bev_angle)) / grid_len_x / bev_w
    return (np.float32(yaw_delta),
            np.asarray([shift_x, shift_y], np.float32))


class ClipDataset:
    """Map-style dataset of ``queue_length``-frame scene clips over a
    `NuSceneOccDataset`: one clip per base frame, ending at that frame."""

    def __init__(self, base, queue_length: int, pc_range: Sequence[float],
                 bev_hw):
        if queue_length < 1:
            raise ValueError(f"queue_length must be >= 1, got {queue_length}")
        self.base = base
        self.queue_length = queue_length
        self.pc_range = tuple(pc_range)
        self.bev_hw = tuple(bev_hw)
        # each frame's scene start (infos are scene-contiguous and in time
        # order, as the reference relies on)
        self._scene_start = np.zeros(len(base), np.int64)
        start, prev_scene = 0, None
        for i, info in enumerate(base.infos):
            scene = info.get("scene_token", "")
            if scene != prev_scene:
                start, prev_scene = i, scene
            self._scene_start[i] = start

    def __len__(self):
        return len(self.base)

    def sample_token(self, idx: int) -> str:
        return self.base.sample_token(idx)

    def clip_indices(self, idx: int) -> np.ndarray:
        """The T frame indices of clip ``idx`` (the scene's first frame
        repeated on the left when the scene is younger than the queue)."""
        lo = int(self._scene_start[idx])
        idxs = list(range(max(lo, idx - self.queue_length + 1), idx + 1))
        return np.asarray([idxs[0]] * (self.queue_length - len(idxs))
                          + idxs, np.int64)

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        idxs = self.clip_indices(idx)
        frames = [self.base.get_sample(int(j), rng) for j in idxs]
        T = self.queue_length
        rot_deg = np.zeros((T,), np.float32)
        shifts = np.zeros((T, 2), np.float32)
        prev_exists = np.zeros((T,), bool)
        for t in range(1, T):
            if idxs[t] == idxs[t - 1]:
                continue                      # left padding: no predecessor
            prev_exists[t] = True
            rot_deg[t], shifts[t] = clip_alignment(
                frames[t - 1]["ego2global"].astype(np.float64),
                frames[t]["ego2global"].astype(np.float64),
                self.pc_range, self.bev_hw)
        last = frames[-1]
        return {
            "img": np.stack([f["img"] for f in frames]),
            "ego2img": np.stack([f["ego2img"] for f in frames]),
            "rot_deg": rot_deg,
            "shifts": shifts,
            "prev_exists": prev_exists,
            "shift": shifts[-1],
            "voxel_semantics": last["voxel_semantics"],
            "voxel_flow": last["voxel_flow"],
            "token": last["token"],
        }

    def collate(self, samples: Sequence[dict]) -> dict:
        batch = {k: np.stack([s[k] for s in samples])
                 for k in ("img", "ego2img", "rot_deg", "shifts",
                           "prev_exists", "shift", "voxel_semantics",
                           "voxel_flow")}
        batch["tokens"] = [s["token"] for s in samples]
        return batch
