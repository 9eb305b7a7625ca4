"""nuScenes / OpenOcc dataset of the port (a copy of
`occnet_tpu/data/nuscenes.py`, which the port does not import): the infos
pkl reader, the per-frame camera geometry and the map-style dataset the
train and test CLIs load.

Equivalent of the reference `NuSceneOcc` dataset (`datasets/nuscenes_occ.py:
21-140`): loads `nuscenes_infos_{train,val}_occ.pkl`, builds each frame's
`lidar2img` (viewpad @ lidar2cam) and `ego2lidar` from the camera
calibration (:80-113, with the LightwheelOcc quaternion branch :91-99),
reads the 6 camera JPEGs (`data/jpeg.py`: the pixels of the JAX package's
`tf.io.decode_jpeg`) and the occupancy ground truth.

Images are always returned raw: unpadded uint8 (6, H, W, 3), the JAX
dataset's ``device_normalize=True`` form.  The card normalises and pads them
(`serve.Predictor`; in training `pipeline.make_device_train_augmenter`, with
the photometric distortion), so a frame uploads 4x fewer bytes.  `ego2img`
is the same float32 numpy product on the host as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from occnet_tpu_torch.config import DataConfig
from occnet_tpu_torch.data.jpeg import read_jpeg
from occnet_tpu_torch.data.pipeline import load_occ_gt
from occnet_tpu_torch.data.quat import quat_to_rot, transform_matrix

# nuScenes surround-camera order used by the infos dicts.
CAM_ORDER = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def load_infos(ann_file: str, load_interval: int = 1):
    with open(ann_file, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"][::load_interval]
    metadata = data.get("metadata", {})
    return infos, metadata


def build_camera_matrices(info: dict, version: str = ""
                          ) -> Dict[str, np.ndarray]:
    """Per-frame lidar2img / ego2lidar from an infos entry
    (`nuscenes_occ.py:80-113`), in float64 on the host, stored float32."""
    ego2lidar = transform_matrix(
        info["lidar2ego_translation"], info["lidar2ego_rotation"],
        inverse=True)
    lidar2img = []
    intrinsics = []
    lidar2cam = []
    cams = info["cams"]
    keys = [k for k in CAM_ORDER if k in cams] or list(cams.keys())
    for cam_type in keys:
        cam = cams[cam_type]
        if "LightwheelOcc" in version:
            s2l_r = quat_to_rot(cam["sensor2lidar_rotation"])
        else:
            s2l_r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
        lidar2cam_r = np.linalg.inv(s2l_r)
        t = np.asarray(cam["sensor2lidar_translation"], np.float64)
        l2c = np.eye(4)
        l2c[:3, :3] = lidar2cam_r
        l2c[:3, 3] = -lidar2cam_r @ t
        K = np.asarray(cam["cam_intrinsic"], np.float64)
        viewpad = np.eye(4)
        viewpad[: K.shape[0], : K.shape[1]] = K
        lidar2img.append(viewpad @ l2c)
        intrinsics.append(viewpad)
        lidar2cam.append(l2c)
    return {
        "lidar2img": np.stack(lidar2img).astype(np.float32),
        "lidar2cam": np.stack(lidar2cam).astype(np.float32),
        "cam_intrinsic": np.stack(intrinsics).astype(np.float32),
        "ego2lidar": ego2lidar.astype(np.float32),
        "img_paths": [cams[k].get("data_path", cams[k].get("cam_path", ""))
                      for k in keys],
    }


class NuSceneOccDataset:
    """Map-style dataset over the infos list (the protocol the loaders and
    `training.eval_loop.run_evaluation` read: ``infos``, ``get_sample``,
    ``collate``, ``sample_token``)."""

    def __init__(self, cfg: DataConfig, ann_file: str,
                 training: bool = True, load_interval: int = 1):
        self.cfg = cfg
        self.training = training
        self.infos, self.metadata = load_infos(ann_file, load_interval)
        self.version = str(self.metadata.get("version", ""))

    def __len__(self):
        return len(self.infos)

    def sample_token(self, idx: int) -> str:
        return self.infos[idx]["token"]

    def _path(self, p: str) -> str:
        if os.path.isabs(p):
            return p
        path = os.path.join(self.cfg.data_root, p)
        # infos sometimes store data_root-relative paths
        return path if os.path.exists(path) else p

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        """One frame; ``rng`` is unused (the distortion runs on the card)
        and kept for the loaders' protocol."""
        info = self.infos[idx]
        geo = build_camera_matrices(info, self.version)
        imgs = np.stack([read_jpeg(self._path(p))
                         for p in geo["img_paths"]])

        # occ_path in infos is data_root-relative (the reference joins
        # `data_root` at `nuscenes_occ.py:165`); a missing file (test split)
        # gives zero labels at the configured grid size
        occ_path = info.get("occ_path")
        if occ_path and not os.path.isabs(occ_path):
            joined = os.path.join(self.cfg.data_root, occ_path)
            occ_path = joined if os.path.exists(joined) else occ_path
        sem, flow = load_occ_gt(occ_path, occ_size=tuple(self.cfg.occ_size))
        ego2img = np.einsum(
            "cij,jk->cik", geo["lidar2img"], geo["ego2lidar"])

        ego2global = transform_matrix(
            info.get("ego2global_translation", (0.0, 0.0, 0.0)),
            info.get("ego2global_rotation", (1.0, 0.0, 0.0, 0.0)))
        return {
            "img": imgs,                       # (6, H, W, 3) uint8
            "ego2img": ego2img.astype(np.float32),
            "lidar2img": geo["lidar2img"],
            "ego2lidar": geo["ego2lidar"],
            "voxel_semantics": sem.astype(np.int32),
            "voxel_flow": flow,
            "token": info["token"],
            # temporal-path metadata (streaming state + clip alignment)
            "scene_token": info.get("scene_token", ""),
            "ego2global": ego2global.astype(np.float32),
        }

    def collate(self, samples: Sequence[dict]) -> dict:
        batch = {}
        for k in ("img", "ego2img", "voxel_semantics", "voxel_flow"):
            batch[k] = np.stack([s[k] for s in samples])
        batch["tokens"] = [s["token"] for s in samples]
        return batch


def build_train_dataset(cfg: DataConfig, training: bool = True, **kwargs):
    """The train split of a DataConfig: a plain NuSceneOccDataset, or, when
    ``cfg.extra_trainsets`` names more (data_root, ann_file) pairs, the
    ConcatOccDataset of all of them (the reference's `ConcatDataset`
    trainset, `bevformer_base_occ_w_lightwheel.py:219-226`).  The
    LightwheelOcc quaternion branch follows each ann file's own metadata
    version, as in the reference (`nuscenes_occ.py:91`)."""
    main = NuSceneOccDataset(
        cfg, os.path.join(cfg.data_root, cfg.train_ann),
        training=training, **kwargs)
    if not cfg.extra_trainsets:
        return main
    extras = []
    for root, ann in cfg.extra_trainsets:
        ecfg = dataclasses.replace(cfg, data_root=root, extra_trainsets=())
        extras.append(NuSceneOccDataset(
            ecfg, os.path.join(root, ann), training=training, **kwargs))
    return ConcatOccDataset([main] + extras)


class ConcatOccDataset:
    """Concatenation of occupancy datasets (the reference's `ConcatDataset`
    of the nuScenes and LightwheelOcc trainsets,
    `bevformer_base_occ_w_lightwheel.py:181-226`)."""

    def __init__(self, datasets: Sequence[NuSceneOccDataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx: int):
        ds = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[ds], idx - int(self._offsets[ds])

    def sample_token(self, idx: int) -> str:
        ds, local = self._locate(idx)
        return ds.sample_token(local)

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        ds, local = self._locate(idx)
        return ds.get_sample(local, rng)

    def collate(self, samples):
        return self.datasets[0].collate(samples)
