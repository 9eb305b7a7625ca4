"""Raw-devkit ego-pose scanner for 4d-occ info generation (a copy of
`occnet_tpu/data/devkit_ego_pose.py`, which the port does not import).

Equivalent of the reference `nuScenesDataset`
(`datasets/nuscenes_ego_pose_loader.py:13-155`), which walks the raw nuScenes
DB — scene/sample/sample_data/ego_pose/calibrated_sensor/log tables — via the
nuscenes-devkit to produce, for every keyframe, the ego origins of its scene's
other frames in the reference LIDAR_TOP frame (then mapped to ego coords),
bounded to +/-39 m and subsampled to <=8.  This variant is used for info
*generation*; the infos-based `evaluation/ego_pose.py` covers eval.

The devkit is not a dependency here: its `nusc.get(table, token)` is a dict
lookup over indexed JSON tables, reimplemented by `NuScenesTables`.  The
devkit's train/val/test scene-name split lists (`nuscenes.utils.splits`) are
data, not code — pass them in via `split_scenes` (None scans every scene).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from occnet_tpu_torch.data.quat import transform_matrix


class NuScenesTables:
    """Indexed raw nuScenes JSON tables — the subset of the devkit's
    `NuScenes` object the ego-pose scanner touches (`nusc.get`, `nusc.scene`,
    `nusc.dataroot`)."""

    TABLES = ("scene", "sample", "sample_data", "ego_pose",
              "calibrated_sensor", "log")

    def __init__(self, dataroot: str, version: str = "v1.0-trainval",
                 tables: Optional[Dict[str, list]] = None):
        self.dataroot = dataroot
        self.version = version
        self._tables: Dict[str, list] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        if tables is not None:  # pre-parsed tables (tests, in-memory use)
            for name, rows in tables.items():
                self._install(name, rows)

    def _install(self, name: str, rows: list):
        self._tables[name] = rows
        self._index[name] = {r["token"]: r for r in rows}

    def _load(self, name: str):
        if name not in self._tables:
            path = os.path.join(self.dataroot, self.version, f"{name}.json")
            with open(path) as f:
                self._install(name, json.load(f))

    def table(self, name: str) -> list:
        self._load(name)
        return self._tables[name]

    def get(self, name: str, token: str) -> dict:
        self._load(name)
        return self._index[name][token]

    @property
    def scene(self) -> list:
        return self.table("scene")


def _global_from_sensor(tables: NuScenesTables, sd_token: str) -> np.ndarray:
    """global <- sensor for one sample_data record: ego_pose @ calibrated
    sensor extrinsics (`nuscenes_ego_pose_loader.py:77-99`)."""
    sd = tables.get("sample_data", sd_token)
    ep = tables.get("ego_pose", sd["ego_pose_token"])
    cs = tables.get("calibrated_sensor", sd["calibrated_sensor_token"])
    global_from_ego = transform_matrix(ep["translation"], ep["rotation"])
    ego_from_sensor = transform_matrix(cs["translation"], cs["rotation"])
    return global_from_ego @ ego_from_sensor


def _lidar2ego(tables: NuScenesTables, sd_token: str) -> np.ndarray:
    sd = tables.get("sample_data", sd_token)
    cs = tables.get("calibrated_sensor", sd["calibrated_sensor_token"])
    return transform_matrix(cs["translation"], cs["rotation"])


class EgoPoseScanner:
    """Scene scanner with the reference loader's exact semantics: walk each
    scene's sample chain (first_sample_token -> next), record the LIDAR_TOP
    sample_data per keyframe, and emit per-sample ego origins.

    `flip_flags` (left-hand-traffic Singapore scenes,
    `nuscenes_ego_pose_loader.py:46-48`) are collected like the reference —
    which computes and never consumes them — and exposed as an attribute.
    """

    def __init__(self, tables: NuScenesTables,
                 split_scenes: Optional[Sequence[str]] = None,
                 bound: float = 39.0, max_origins: int = 8):
        self.tables = tables
        self.bound = bound
        self.max_origins = max_origins
        split = set(split_scenes) if split_scenes is not None else None

        self.scene_tokens: List[str] = []
        self.sample_tokens: List[str] = []
        self.sample_data_tokens: List[str] = []
        self.timestamps: List[int] = []
        self.flip_flags: List[bool] = []
        self._scene_members: Dict[str, List[int]] = {}

        for scene in tables.scene:
            if split is not None and scene["name"] not in split:
                continue
            log = tables.get("log", scene["log_token"])
            flip = log["location"].startswith("singapore")
            token = scene["first_sample_token"]
            while token != "":
                sample = tables.get("sample", token)
                i = len(self.sample_tokens)
                self.scene_tokens.append(scene["token"])
                self.sample_tokens.append(token)
                self.sample_data_tokens.append(sample["data"]["LIDAR_TOP"])
                self.timestamps.append(sample["timestamp"])
                self.flip_flags.append(flip)
                self._scene_members.setdefault(scene["token"], []).append(i)
                token = sample["next"]

    def __len__(self) -> int:
        return len(self.sample_tokens)

    def __getitem__(self, idx: int) -> Tuple[str, np.ndarray]:
        """(sample_token, (T, 3) float32 ego origins), T <= max_origins.

        Matches `nuscenes_ego_pose_loader.py:101-155`: other-frame lidar
        origins in the reference lidar frame, mapped to ego coords via the
        reference frame's lidar2ego, bounded to |x|,|y| < 39 m, subsampled to
        8 evenly spaced indices.
        """
        ref_sd = self.sample_data_tokens[idx]
        ref_from_global = np.linalg.inv(
            _global_from_sensor(self.tables, ref_sd))
        # the reference recomputes lidar2ego inside its frame loop
        # (`:130-142`) — it only depends on the ref frame, so hoist it
        lidar2ego = _lidar2ego(self.tables, ref_sd)

        origins = []
        for j in self._scene_members[self.scene_tokens[idx]]:
            if j == idx:
                o = np.zeros(3, np.float64)
            else:
                g = _global_from_sensor(self.tables,
                                        self.sample_data_tokens[j])
                o = (ref_from_global @ g)[:3, 3]
            o = lidar2ego[:3] @ np.append(o, 1.0)
            if abs(o[0]) < self.bound and abs(o[1]) < self.bound:
                origins.append(o.astype(np.float32))
        if len(origins) > self.max_origins:
            sel = np.round(np.linspace(0, len(origins) - 1,
                                       self.max_origins)).astype(np.int64)
            origins = [origins[k] for k in sel]
        return self.sample_tokens[idx], np.stack(origins)
