"""Image processing (port of `occnet_tpu.data.pipeline`): the occupancy
ground-truth reader (`load_occ_gt`), the on-device normaliser of the serving
path, the train-time augmenter (photometric distortion -> normalise -> pad)
of uint8 uploads, and the host-side numpy transforms of float datasets:
normalise, pad, the photometric distortion drawn from a `RandomState`
(`photometric_distortion`) and the multi-view random rescale
(`random_scale_image`).

The photometric distortion is split into a draw from a `torch.Generator`
(`photometric_draws`) and an apply from explicit draws
(`photometric_distortion_device`), so the apply can be held against the JAX
package's on the same draws.  Every draw stays on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from occnet_tpu_torch.config import DataConfig

Draws = Dict[str, torch.Tensor]


def load_occ_gt(occ_path: Optional[str],
                occ_size: Tuple[int, int, int] = (200, 200, 16)):
    """labels.npz -> (semantics uint8 (X, Y, Z), flow float32 (X, Y, Z, 2));
    zeros at ``occ_size`` when the file is absent (the test split)."""
    if occ_path is not None and os.path.exists(occ_path):
        labels = np.load(occ_path)
        return (labels["semantics"].astype(np.uint8),
                labels["flow"].astype(np.float32))
    sem = np.zeros(occ_size, dtype=np.uint8)
    flow = np.zeros(occ_size + (2,), dtype=np.float32)
    return sem, flow


def _rgb_to_hsv_np(img: np.ndarray) -> np.ndarray:
    """[0, 255] RGB -> HSV (h in degrees, s and v in [0, 1]), numpy."""
    rgb = img / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) / dz % 6.0,
                 np.where(maxc == g, (b - r) / dz + 2.0, (r - g) / dz + 4.0))
    h = np.where(delta > 0, h * 60.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb_np(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    cond = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r = np.select(cond, [v, q, p, p, t], v)
    g = np.select(cond, [t, v, v, q, p], p)
    b = np.select(cond, [p, p, t, v, v], q)
    return np.stack([r, g, b], axis=-1) * 255.0


def photometric_distortion(
    imgs: np.ndarray,
    rng: np.random.RandomState,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> np.ndarray:
    """Host photometric distortion of (N, H, W, 3) float32 RGB in [0, 255]
    with the JAX package's draws from ``rng`` image by image: brightness,
    contrast before or after the HSV round trip, saturation, hue, channel
    swap, each on with probability 0.5."""
    out = []
    for img in imgs:
        img = img.astype(np.float32)
        if rng.randint(2):
            img = img + rng.uniform(-brightness_delta, brightness_delta)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            img = img * rng.uniform(*contrast_range)
        hsv = _rgb_to_hsv_np(img)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(*saturation_range)
        if rng.randint(2):
            h = hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)
            h = np.where(h > 360, h - 360, h)
            h = np.where(h < 0, h + 360, h)
            hsv[..., 0] = h
        img = _hsv_to_rgb_np(hsv)
        if mode == 0 and rng.randint(2):
            img = img * rng.uniform(*contrast_range)
        if rng.randint(2):
            img = img[..., rng.permutation(3)]
        out.append(img.astype(np.float32))
    return np.stack(out)


def random_scale_image(imgs: np.ndarray, lidar2img: np.ndarray,
                       rng: np.random.RandomState,
                       scales: Sequence[float] = (0.9, 1.0, 1.1)):
    """One scale drawn from ``scales`` for the sample, every view (N, H, W,
    3) resized by it (bilinear, pixel centres, edge-clamped) and the first
    two rows of each projection (N, 4, 4) scaled to match.  Returns
    (images, lidar2img)."""
    s = scales[rng.randint(len(scales))]
    if s == 1.0:
        return imgs, lidar2img
    n, h, w, c = imgs.shape
    nh, nw = int(round(h * s)), int(round(w * s))
    ys = (np.arange(nh) + 0.5) / s - 0.5
    xs = (np.arange(nw) + 0.5) / s - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    ty = (ys - y0).clip(0, 1)[None, :, None, None]
    tx = (xs - x0).clip(0, 1)[None, None, :, None]
    out = (imgs[:, y0][:, :, x0] * (1 - ty) * (1 - tx)
           + imgs[:, y0][:, :, x1] * (1 - ty) * tx
           + imgs[:, y1][:, :, x0] * ty * (1 - tx)
           + imgs[:, y1][:, :, x1] * ty * tx)
    scale_mat = np.eye(4, dtype=lidar2img.dtype)
    scale_mat[0, 0] = scale_mat[1, 1] = s
    return out.astype(imgs.dtype), np.einsum("ij,njk->nik", scale_mat,
                                             lidar2img)


def _mean_std(cfg: DataConfig):
    mean = np.asarray(cfg.img_mean, np.float32)
    std = np.asarray(cfg.img_std, np.float32)
    if not cfg.to_rgb:
        mean, std = mean[::-1].copy(), std[::-1].copy()
    return mean, std


def _normalize_pad(out: torch.Tensor, mean, std, size_divisor: int
                   ) -> torch.Tensor:
    m = torch.from_numpy(mean).to(out.device)
    s = torch.from_numpy(std).to(out.device)
    out = (out - m) / s
    h, w = out.shape[-3], out.shape[-2]
    ph, pw = (-h) % size_divisor, (-w) % size_divisor
    if ph or pw:
        out = F.pad(out, (0, 0, 0, pw, 0, ph))
    return out


def normalize_img(imgs: np.ndarray, mean, std) -> np.ndarray:
    """Host-side (x - mean) / std in float32 (`pipeline.normalize_img`)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (imgs.astype(np.float32) - mean) / std


def pad_to_divisor(imgs: np.ndarray, divisor: int = 32) -> np.ndarray:
    """(N, H, W, C) -> bottom/right zero-padded to multiples of divisor."""
    n, h, w, c = imgs.shape
    ph = (-h) % divisor
    pw = (-w) % divisor
    if ph == 0 and pw == 0:
        return imgs
    return np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)))


def make_device_normalizer(cfg: DataConfig, size_divisor: int = 32):
    """uint8 (..., H, W, 3) on the device -> float32 (x - mean) / std, then
    bottom/right zero padding to a multiple of ``size_divisor`` (nuScenes
    900x1600 -> 928x1600).  With ``to_rgb=False`` the BGR mean/std are
    reversed for RGB input.  Non-uint8 input is returned unchanged (already
    normalised)."""
    mean, std = _mean_std(cfg)

    def normalize(imgs: torch.Tensor) -> torch.Tensor:
        if imgs.dtype != torch.uint8:
            return imgs
        return _normalize_pad(imgs.to(torch.float32), mean, std,
                              size_divisor)

    return normalize


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """`pipeline._rgb_to_hsv_jax` (identical math): [0, 255] RGB -> HSV with
    h in degrees, s and v in [0, 1]."""
    rgb = img / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), zero)
    dz = delta.clamp(min=1e-12)
    h = torch.where(maxc == r, torch.remainder((g - b) / dz, 6.0),
                    torch.where(maxc == g, (b - r) / dz + 2.0,
                                (r - g) / dz + 4.0))
    h = torch.where(delta > 0, h * 60.0, zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """`pipeline._hsv_to_rgb_jax` (identical math)."""
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    i = torch.remainder(torch.floor(h), 6)
    f = h - torch.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))

    def select(choices, default):          # jnp.select: first match wins
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return torch.stack([r, g, b], dim=-1) * 255.0


def photometric_draws(generator: Optional[torch.Generator], n: int,
                      brightness_delta: float = 32.0,
                      contrast_range: Tuple[float, float] = (0.5, 1.5),
                      saturation_range: Tuple[float, float] = (0.5, 1.5),
                      hue_delta: float = 18.0, device=None) -> Draws:
    """One independent draw set for each of ``n`` images, with the gates
    and ranges of the JAX package's `photometric_distortion_device`: each
    of brightness, contrast (before or after HSV by ``mode1``), saturation,
    hue and the channel swap is on with probability 0.5."""
    dev = generator.device if generator is not None else device

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)

    def gate():
        return torch.rand(n, generator=generator, device=dev) < 0.5

    return {
        "bright_on": gate(),
        "bright": uni(-brightness_delta, brightness_delta),
        "mode1": gate(),
        "contrast_pre_on": gate(),
        "contrast_pre": uni(*contrast_range),
        "sat_on": gate(),
        "sat": uni(*saturation_range),
        "hue_on": gate(),
        "hue": uni(-hue_delta, hue_delta),
        "contrast_post_on": gate(),
        "contrast_post": uni(*contrast_range),
        "perm": torch.rand(n, 3, generator=generator, device=dev).argsort(-1),
        "swap_on": gate(),
    }


def photometric_distortion_device(imgs: torch.Tensor, draws: Draws
                                  ) -> torch.Tensor:
    """imgs (..., H, W, 3) float32 RGB in [0, 255], one draw set per image
    (``draws`` from `photometric_draws` over the flattened leading dims):
    brightness, contrast (pre), the HSV round trip with saturation and hue,
    contrast (post), channel swap — the JAX package's order.  The HSV round
    trip is unconditional, as there."""
    lead = imgs.shape[:-3]
    img = imgs.reshape((-1,) + imgs.shape[-3:])

    def per(x):                            # (N,) -> (N, 1, 1, 1)
        return x.reshape(-1, 1, 1, 1)

    def per3(x):                           # (N,) -> (N, 1, 1), HSV planes
        return x.reshape(-1, 1, 1)

    d = draws
    img = torch.where(per(d["bright_on"]), img + per(d["bright"]), img)
    img = torch.where(per(d["mode1"] & d["contrast_pre_on"]),
                      img * per(d["contrast_pre"]), img)
    hsv = _rgb_to_hsv(img)
    s = torch.where(per3(d["sat_on"]), hsv[..., 1] * per3(d["sat"]),
                    hsv[..., 1])
    h = hsv[..., 0] + torch.where(per3(d["hue_on"]), per3(d["hue"]),
                                  torch.zeros((), device=img.device))
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    img = _hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    img = torch.where(per(~d["mode1"] & d["contrast_post_on"]),
                      img * per(d["contrast_post"]), img)
    swapped = torch.gather(img, -1, d["perm"].reshape(-1, 1, 1, 3).expand(
        img.shape))
    img = torch.where(per(d["swap_on"]), swapped, img)
    return img.reshape(lead + imgs.shape[-3:])


def make_device_train_augmenter(cfg: DataConfig, size_divisor: int = 32,
                                distort: bool = True):
    """On-device train-time processing of uint8 uploads: photometric
    distortion -> normalise -> bottom/right zero-pad, the host path's order.
    Returns ``augment(generator, imgs, shard=(0, 1))``; float inputs pass
    through unchanged (already processed), as in the JAX package.  With
    ``shard = (rank, world)`` the images are a data-parallel rank's part of
    a global batch world times as large: the draws are taken for the whole
    global batch and the rank applies its own slice of them, so the
    generator's draws, and each image's, are those of one process holding
    the global batch."""
    mean, std = _mean_std(cfg)

    def augment(generator: Optional[torch.Generator], imgs: torch.Tensor,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        if imgs.dtype != torch.uint8:
            return imgs
        out = imgs.to(torch.float32)
        if distort:
            n = int(np.prod(out.shape[:-3]))
            rank, world = shard
            draws = photometric_draws(generator, n * world,
                                      device=out.device)
            if world > 1:
                draws = {k: v[rank * n:(rank + 1) * n]
                         for k, v in draws.items()}
            out = photometric_distortion_device(out, draws)
        return _normalize_pad(out, mean, std, size_divisor)

    return augment
