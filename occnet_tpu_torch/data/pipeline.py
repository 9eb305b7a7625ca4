"""On-device image normalisation (port of
`occnet_tpu.data.pipeline.make_device_normalizer`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from occnet_tpu.config import DataConfig


def make_device_normalizer(cfg: DataConfig, size_divisor: int = 32):
    """uint8 (..., H, W, 3) on the device -> float32 (x - mean) / std, then
    bottom/right zero padding to a multiple of ``size_divisor`` (nuScenes
    900x1600 -> 928x1600).  With ``to_rgb=False`` the BGR mean/std are
    reversed for RGB input.  Non-uint8 input is returned unchanged (already
    normalised)."""
    mean = np.asarray(cfg.img_mean, np.float32)
    std = np.asarray(cfg.img_std, np.float32)
    if not cfg.to_rgb:
        mean, std = mean[::-1].copy(), std[::-1].copy()

    def normalize(imgs: torch.Tensor) -> torch.Tensor:
        if imgs.dtype != torch.uint8:
            return imgs
        m = torch.from_numpy(mean).to(imgs.device)
        s = torch.from_numpy(std).to(imgs.device)
        out = (imgs.to(torch.float32) - m) / s
        h, w = out.shape[-3], out.shape[-2]
        ph, pw = (-h) % size_divisor, (-w) % size_divisor
        if ph or pw:
            out = F.pad(out, (0, 0, 0, pw, 0, ph))
        return out

    return normalize
