"""Ego-origin extraction along the scene trajectory (a copy of
`occnet_tpu/evaluation/ego_pose.py`, which the port does not import).

Equivalent of the reference `EgoPoseDataset`
(`tools/ray_iou/ego_pose_extractor.py:14-121`): for each sample, collect the
origins of every frame in its scene transformed into the reference frame's
ego coordinates (via global), keep those within +/-39 m, and subsample to at
most 8 evenly spaced origins.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from occnet_tpu_torch.data.quat import transform_matrix

# LightwheelOcc pseudo lidar2ego (`ego_pose_extractor.py:22-28`).
PSEUDO_LIDAR2EGO = np.array([
    [0.0, 1.0, 0.0, 0.94],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 1.84],
    [0.0, 0.0, 0.0, 1.0],
])


def _scene_token(info: dict, dataset_type: str) -> str:
    if dataset_type == "openocc_v2":
        if "scene_token" in info:
            return info["scene_token"]
        return info["occ_path"].split("openocc_v2/")[-1].split("/")[0]
    return info["scene_token"]


def _lidar2ego(info: dict, dataset_type: str) -> np.ndarray:
    if dataset_type == "openocc_v2":
        return transform_matrix(info["lidar2ego_translation"],
                                info["lidar2ego_rotation"])
    return PSEUDO_LIDAR2EGO


def _global_from_lidar(info: dict, dataset_type: str) -> np.ndarray:
    g_from_e = transform_matrix(info["ego2global_translation"],
                                info["ego2global_rotation"])
    return g_from_e @ _lidar2ego(info, dataset_type)


def extract_ego_origins(
    data_infos: Sequence[dict],
    dataset_type: str = "openocc_v2",
    max_origins: int = 8,
    bound: float = 39.0,
) -> List[Tuple[str, np.ndarray]]:
    """Returns [(token, (T, 3) origins)] for every sample, T <= max_origins."""
    scenes: Dict[str, List[int]] = {}
    for i, info in enumerate(data_infos):
        scenes.setdefault(_scene_token(info, dataset_type), []).append(i)

    out = []
    for i, info in enumerate(data_infos):
        ref_lidar_from_global = np.linalg.inv(
            _global_from_lidar(info, dataset_type))
        ref_ego_from_lidar = _lidar2ego(info, dataset_type)
        frame_ids = scenes[_scene_token(info, dataset_type)]

        origins = []
        for j in frame_ids:
            if j == i:
                o = np.zeros(3)
            else:
                g = _global_from_lidar(data_infos[j], dataset_type)
                o = (ref_lidar_from_global @ g)[:3, 3]
            o = ref_ego_from_lidar[:3] @ np.append(o, 1.0)
            if abs(o[0]) < bound and abs(o[1]) < bound:
                origins.append(o.astype(np.float32))
        if len(origins) > max_origins:
            sel = np.round(np.linspace(0, len(origins) - 1,
                                       max_origins)).astype(int)
            origins = [origins[k] for k in sel]
        out.append((info["token"], np.stack(origins)))
    return out


def pad_origins(origins: np.ndarray, max_origins: int = 8):
    """(T, 3) -> ((max, 3), (max,) valid mask) for static-shape rendering."""
    t = origins.shape[0]
    padded = np.zeros((max_origins, 3), np.float32)
    padded[:t] = origins[:max_origins]
    valid = np.zeros(max_origins, bool)
    valid[: min(t, max_origins)] = True
    return padded, valid
