"""Minimal quaternion -> rotation-matrix helpers (pure numpy; a copy of
`occnet_tpu/data/quat.py`, which the port does not import).

Replaces the reference's pyquaternion / nuscenes-devkit dependency for the two
operations the data path needs: `transform_matrix` (nuscenes devkit) and
`Quaternion(...).rotation_matrix` — both used when composing ego2lidar /
lidar2img (`datasets/nuscenes_occ.py:80-113`) and ego origins
(`tools/ray_iou/ego_pose_extractor.py:8-12`).
"""

from __future__ import annotations

import numpy as np


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def transform_matrix(translation, rotation_quat, inverse: bool = False
                     ) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion; with
    inverse=True returns the inverse transform (R^T, -R^T t) — the nuscenes
    devkit `transform_matrix` contract."""
    R = quat_to_rot(rotation_quat)
    t = np.asarray(translation, dtype=np.float64)
    tm = np.eye(4)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = -R.T @ t
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


def quaternion_yaw(q) -> float:
    """Yaw of a quaternion: the rotation of the x axis projected on the xy
    plane (the nuscenes-devkit definition)."""
    R = quat_to_rot(q)
    v = R @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))
