"""Synthetic geometric occupancy benchmark (port of
`occnet_tpu/data/synthetic.py`): voxel scenes rendered to camera views with
a known projection, so 3-D occupancy is inferable from the images.

Scenes are boxes on a ground plane drawn per seed (`make_scene`, numpy,
bitwise the JAX package's); views are rendered with the port's per-ray DDA
(`ops/ray_march.py`, on the card one kernel launch for all cameras of a
scene, from tables built once per rig): every pixel's colour is the
palette entry of the first occupied voxel its ray hits, shaded by distance
and by a per-voxel brightness hash; rays that hit nothing get a sky
gradient.  The benchmark uses CUBIC voxels so the ray-metric renderers stay
exact with a scalar voxel size.

Card and CPU renders agree to the rare pixel: every fp32 step is an IEEE
operation in a fixed order on both (ray directions as three multiply-adds
in order, origins and per-row constants on the host), except `exp` in the
distance shading.  Against the JAX renderer they differ where XLA sums the
camera rotation in another order and a ray grazes a voxel edge.
"""

from __future__ import annotations

import colorsys
import hashlib
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from occnet_tpu_torch.config import (DataConfig, FLOW_CLASS_NAMES,
                                     ModelConfig, OCC_CLASS_NAMES)
from occnet_tpu_torch.data.pipeline import normalize_img, pad_to_divisor
from occnet_tpu_torch.ops import ray_march
from occnet_tpu_torch.ops.ray_march import SceneTables, camera_dirs, fma

FREE_ID = len(OCC_CLASS_NAMES) - 1

# Box semantic classes used by the generator (flow classes first so mAVE
# has support): car, truck, bus, pedestrian, barrier, manmade.
BOX_CLASSES = (0, 1, 3, 7, 9, 14)
GROUND_ID = OCC_CLASS_NAMES.index("driveable_surface")      # 10

# Class-determined planar velocity (m/s) for the flow classes, spread over
# 0.5-3.0 m/s so a predict-zero flow head does not score well.
_N_FLOW = len(FLOW_CLASS_NAMES)
CLASS_VELOCITY = np.zeros((len(OCC_CLASS_NAMES), 2), np.float32)
for _c in range(_N_FLOW):
    _a = 2.0 * np.pi * _c / _N_FLOW
    _s = 0.5 + 2.5 * _c / max(_N_FLOW - 1, 1)
    CLASS_VELOCITY[_c] = (_s * np.cos(_a), _s * np.sin(_a))


def _flow_of(sem: np.ndarray) -> np.ndarray:
    """(X,Y,Z) sem -> (X,Y,Z,2) class-determined flow."""
    flow = CLASS_VELOCITY[sem]
    flow[sem == FREE_ID] = 0.0
    return np.ascontiguousarray(flow, np.float32)


def class_palette() -> np.ndarray:
    """(num_classes, 3) float RGB in [0,1]: a hue wheel over the non-free
    classes, free = black (never rendered: free voxels are holes)."""
    n = len(OCC_CLASS_NAMES) - 1
    pal = np.zeros((n + 1, 3), np.float32)
    for i in range(n):
        # stride the hue wheel so adjacent class ids get distant hues
        h = (i * 5 % n) / n
        v = 0.95 if i % 2 == 0 else 0.7
        pal[i] = colorsys.hsv_to_rgb(h, 0.85, v)
    return pal


def make_scene(
    seed: int,
    occ_size: Tuple[int, int, int] = (50, 50, 8),
    num_boxes: Tuple[int, int] = (5, 11),
) -> Tuple[np.ndarray, np.ndarray]:
    """Random boxes-on-ground scene -> (sem (X,Y,Z) int32, flow (X,Y,Z,2)).

    Ground = bottom voxel layer (driveable_surface); boxes rest on it with
    random class / footprint / height; an ego-clearance disc around the grid
    centre stays free so cameras never start inside geometry.
    """
    X, Y, Z = occ_size
    rng = np.random.RandomState(seed)
    sem = np.full((X, Y, Z), FREE_ID, np.int32)
    sem[:, :, 0] = GROUND_ID

    n = rng.randint(num_boxes[0], num_boxes[1])
    cx0, cy0 = X // 2, Y // 2
    clearance = max(2, X // 12)
    for _ in range(n):
        c = BOX_CLASSES[rng.randint(len(BOX_CLASSES))]
        ex = rng.randint(2, max(3, X // 8))
        ey = rng.randint(2, max(3, Y // 8))
        ez = rng.randint(1, Z - 2)
        x = rng.randint(0, X - ex)
        y = rng.randint(0, Y - ey)
        # keep the ego disc clear
        if (abs(x + ex / 2 - cx0) < clearance + ex / 2
                and abs(y + ey / 2 - cy0) < clearance + ey / 2):
            continue
        sem[x:x + ex, y:y + ey, 1:1 + ez] = c

    return sem, _flow_of(sem)


def ring_camera_rig(
    num_cams: int,
    img_hw: Tuple[int, int],
    height: float = 1.5,
    pitch_deg: float = 10.0,
    focal: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Outward-facing surround rig at the ego origin (nuScenes-like): yaw
    ring of `num_cams` cameras pitched down, 90-degree hfov by default.

    Returns R (C,3,3) ego->cam rotation (rows = right/down/forward), t (C,3)
    camera centres in ego, K (3,3) intrinsics, and ego2img (C,4,4) — the
    matrix stack the model consumes.
    """
    h, w = img_hw
    f = focal if focal is not None else w / 2.0
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float64)
    p = np.deg2rad(pitch_deg)
    Rs, ts, ego2img = [], [], []
    for ci in range(num_cams):
        a = 2.0 * np.pi * ci / num_cams
        fwd = np.array([np.cos(a) * np.cos(p), np.sin(a) * np.cos(p),
                        -np.sin(p)])
        # facing +x with world-up +z, right = -y
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        # right-handed (x=right, y=down, z=forward): down = forward x right
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])            # ego -> cam
        t = np.array([0.0, 0.0, height])
        e2c = np.eye(4)
        e2c[:3, :3] = R
        e2c[:3, 3] = -R @ t
        viewpad = np.eye(4)
        viewpad[:3, :3] = K
        Rs.append(R)
        ts.append(t)
        ego2img.append(viewpad @ e2c)
    return {
        "R": np.stack(Rs).astype(np.float32),
        "t": np.stack(ts).astype(np.float32),
        "K": K.astype(np.float32),
        "ego2img": np.stack(ego2img).astype(np.float32),
    }


def _f32(x) -> np.float32:
    return np.float32(x)


# scene tables on a device, built once per (rig, palette, image size,
# range, device)
_TABLES: Dict[tuple, SceneTables] = {}


def scene_tables(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                 palette: np.ndarray, img_hw: Tuple[int, int],
                 pc_range: Sequence[float], voxel_size: float, device
                 ) -> SceneTables:
    """The host-built inputs of `render_views` in float32 on ``device``,
    built once and kept: pixel centres u = (px + 0.5 - cx) / fx and
    v = (py + 0.5 - cy) / fy, camera centres in voxel units, the voxel-hash
    texture 0.85 + 0.15 * (q / 7) and the sky row factor 1 - 0.3 * (row
    centre) / h, each multiply-add fused as XLA compiles the JAX
    renderer."""
    h, w = img_hw
    key = (np.asarray(R, np.float32).tobytes(),
           np.asarray(t, np.float32).tobytes(),
           np.asarray(K, np.float32).tobytes(),
           np.asarray(palette, np.float32).tobytes(), tuple(img_hw),
           tuple(float(x) for x in pc_range), float(voxel_size),
           str(torch.device(device)))
    tables = _TABLES.get(key)
    if tables is not None:
        return tables
    u = (np.arange(w, dtype=np.float32) + _f32(0.5) - K[0, 2]) / K[0, 0]
    v = (np.arange(h, dtype=np.float32) + _f32(0.5) - K[1, 2]) / K[1, 1]
    o_vox = (t - np.asarray(pc_range[:3], np.float32)) / _f32(voxel_size)
    q = np.arange(8, dtype=np.float32) / _f32(7.0)
    tex = fma(torch.from_numpy(q), float(_f32(0.15)), float(_f32(0.85)))
    row = fma(torch.from_numpy(v), float(K[1, 1]), float(K[1, 2])).numpy()
    sky_row = _f32(1.0) - (_f32(0.3) * row) / _f32(h)
    sky = np.array([0.53, 0.81, 0.92], np.float32)[None] * sky_row[:, None]
    tables = SceneTables(
        rot=torch.from_numpy(np.ascontiguousarray(R, np.float32)),
        origin=torch.from_numpy(np.ascontiguousarray(o_vox, np.float32)),
        u=torch.from_numpy(u), v=torch.from_numpy(v), tex=tex,
        sky=torch.from_numpy(np.ascontiguousarray(sky)),
        palette=torch.from_numpy(np.ascontiguousarray(palette, np.float32)),
        voxel_size=float(voxel_size)).to(device)
    _TABLES[key] = tables
    return tables


def camera_rays(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                img_hw: Tuple[int, int], pc_range: Sequence[float],
                voxel_size: float, device) -> Tuple[torch.Tensor, np.ndarray]:
    """Per-pixel ray directions in ego frame (C, H*W, 3) float32 on
    ``device`` (`ops.ray_march.camera_dirs` of the scene tables) and camera
    origins in voxel units (C, 3) float32 numpy: the rays `render_views`
    marches."""
    tables = scene_tables(R, t, K, class_palette(), img_hw, pc_range,
                          voxel_size, device)
    dirs = torch.stack([camera_dirs(tables, c) for c in range(len(R))])
    return dirs, tables.origin.cpu().numpy()


def class_ids_u8(sem: np.ndarray, n_cls: int) -> torch.Tensor:
    """The class ids of ``sem`` as a uint8 tensor (the render kernel's label
    type) after checking them on the host: each in [0, n_cls), so that the
    kernel's palette lookup stays inside the palette."""
    lo, hi = int(sem.min()), int(sem.max())
    if lo < 0 or hi >= n_cls:
        raise ValueError(f"class ids must lie in [0, {n_cls}), got "
                         f"[{lo}, {hi}]")
    return torch.from_numpy(sem.astype(np.uint8))


def render_views(sem: torch.Tensor, R: np.ndarray, t: np.ndarray,
                 K: np.ndarray, palette: np.ndarray, img_hw: Tuple[int, int],
                 pc_range: Sequence[float], max_steps: int = 160
                 ) -> torch.Tensor:
    """Render (C, H, W, 3) uint8 camera views of a semantic voxel grid
    ``sem`` (X, Y, Z) by DDA ray casting on the grid's device: one kernel
    launch for all cameras on the card (`ops.ray_march.render_views`),
    CUBIC voxels assumed (the pc_range x-extent / X must equal the z voxel
    size).  Pixels whose ray never hits geometry get a sky gradient.  On
    the card ``sem`` holds uint8 class ids (`class_ids_u8`)."""
    vs = (pc_range[3] - pc_range[0]) / sem.shape[0]
    tables = scene_tables(R, t, K, palette, img_hw, pc_range, vs, sem.device)
    return ray_march.render_views(sem, tables, FREE_ID, max_steps)


def _to_host(views: torch.Tensor) -> np.ndarray:
    """The views as a numpy array of their own; from the card through a
    pinned buffer (one DMA, then a host copy), which is quicker than a copy
    to pageable memory."""
    if not views.is_cuda:
        return views.numpy()
    host = torch.empty(views.shape, dtype=views.dtype, pin_memory=True)
    host.copy_(views)
    return host.numpy().copy()


class SyntheticOccDataset:
    """Map-style dataset over generated scenes, with the protocol of the
    JAX package's (get_sample / collate / sample_token / infos), so the train
    CLI, the loader and `run_evaluation` work unchanged.

    Views are rendered on ``device`` (the card unless the caller asks for
    the CPU) at construction and kept on the host as uint8 numpy, so loader
    threads never touch the device.  Train / val splits must use disjoint
    ``seed`` ranges.  ``render_ms`` holds each rendered scene's time
    (synchronised host clock).
    """

    def __init__(self, data_cfg: DataConfig, model_cfg: ModelConfig,
                 n_samples: int, seed: int = 0, training: bool = True,
                 num_boxes: Tuple[int, int] = (5, 11),
                 size_divisor: int = 32, render_scale: int = 1, log=None,
                 cache_dir: Optional[str] = None,
                 device_normalize: bool = False, device="cuda"):
        self.cfg = data_cfg
        self.training = training
        self.size_divisor = size_divisor
        # device_normalize: ship the raw uint8 views; the device pipeline
        # normalises and pads them (4x less host-to-device traffic)
        self.device_normalize = device_normalize
        occ_size = tuple(data_cfg.occ_size)
        pc_range = tuple(model_cfg.pc_range)
        vs_xy = (pc_range[3] - pc_range[0]) / occ_size[0]
        vs_z = (pc_range[5] - pc_range[2]) / occ_size[2]
        if abs(vs_xy - vs_z) > 1e-6:
            raise ValueError(
                f"synthetic benchmark needs cubic voxels, got xy={vs_xy} "
                f"z={vs_z}; pick pc_range/occ_size accordingly")
        img_hw = (model_cfg.img_h, model_cfg.img_w)
        # render_scale > 1: ray-cast at reduced resolution and pixel-repeat
        # up to the model size (render cost / scale^2)
        if img_hw[0] % render_scale or img_hw[1] % render_scale:
            raise ValueError(f"render_scale {render_scale} must divide "
                             f"img {img_hw}")
        low_hw = (img_hw[0] // render_scale, img_hw[1] // render_scale)
        rig = ring_camera_rig(model_cfg.num_cams, img_hw)
        rig_low = ring_camera_rig(model_cfg.num_cams, low_hw)
        self.ego2img = rig["ego2img"]
        self.render_ms = []

        cache = None
        if cache_dir is not None:
            key = repr((n_samples, seed, occ_size, img_hw, num_boxes,
                        tuple(pc_range), model_cfg.num_cams, render_scale))
            cache = os.path.join(
                cache_dir, f"scenes-torch-"
                f"{hashlib.sha1(key.encode()).hexdigest()[:16]}.npz")
        if cache is not None and os.path.exists(cache):
            z = np.load(cache)
            # materialise each array once: an NpzFile member decompresses
            # the whole array on every [] access
            imgs, sem = z["imgs"], z["sem"]
            self.samples = [(imgs[i], sem[i], _flow_of(sem[i]))
                            for i in range(n_samples)]
            if log is not None:
                log(f"synthetic scenes: {n_samples} loaded from {cache}")
        else:
            dev = torch.device(device)
            palette = class_palette()
            max_steps = sum(occ_size) + 4
            self.samples = []
            for i in range(n_samples):
                sem, flow = make_scene(seed + i, occ_size, num_boxes)
                t0 = time.perf_counter()
                # class ids as uint8: a quarter of the int32 copy, and the
                # kernel's own label type
                imgs = _to_host(render_views(
                    class_ids_u8(sem, len(palette)).to(dev),
                    rig_low["R"], rig_low["t"], rig_low["K"], palette,
                    low_hw, pc_range, max_steps))
                self.render_ms.append((time.perf_counter() - t0) * 1e3)
                if render_scale > 1:
                    imgs = imgs.repeat(render_scale, axis=1).repeat(
                        render_scale, axis=2)
                self.samples.append((imgs, sem, flow))
                if log is not None and (i + 1) % 32 == 0:
                    log(f"synthetic scenes: {i + 1}/{n_samples}")
            if cache is not None:
                os.makedirs(cache_dir, exist_ok=True)
                np.savez_compressed(
                    cache,
                    imgs=np.stack([s[0] for s in self.samples]),
                    sem=np.stack([s[1] for s in self.samples]))
                if log is not None:
                    log(f"synthetic scenes: cached to {cache}")

        self.infos = []
        for i in range(n_samples):
            tok = f"synth-{seed + i}"
            self.infos.append({
                "token": tok,
                "scene_token": tok,
                "ego2global_translation": (0.0, 0.0, 0.0),
                "ego2global_rotation": (1.0, 0.0, 0.0, 0.0),
                "lidar2ego_translation": (0.0, 0.0, 0.0),
                "lidar2ego_rotation": (1.0, 0.0, 0.0, 0.0),
            })

    def __len__(self):
        return len(self.samples)

    def sample_token(self, idx: int) -> str:
        return self.infos[idx]["token"]

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> dict:
        imgs, sem, flow = self.samples[idx]
        if not self.device_normalize:
            # no photometric distortion: the synthetic task encodes class
            # identity in colour, which its hue shift and channel swap destroy
            mean = np.asarray(self.cfg.img_mean, np.float32)
            std = np.asarray(self.cfg.img_std, np.float32)
            if not self.cfg.to_rgb:
                mean, std = mean[::-1].copy(), std[::-1].copy()
            imgs = pad_to_divisor(normalize_img(imgs, mean, std),
                                  self.size_divisor)
        return {
            "img": imgs,
            "ego2img": self.ego2img,
            "voxel_semantics": sem,
            "voxel_flow": flow,
            "token": self.infos[idx]["token"],
            "scene_token": self.infos[idx]["scene_token"],
            "ego2global": np.eye(4, dtype=np.float32),
        }

    def collate(self, samples: Sequence[dict]) -> dict:
        batch = {}
        for k in ("img", "ego2img", "voxel_semantics", "voxel_flow"):
            batch[k] = np.stack([s[k] for s in samples])
        batch["tokens"] = [s["token"] for s in samples]
        return batch
