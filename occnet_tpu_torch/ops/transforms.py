"""BEV transforms of the temporal path (port of `occnet_tpu/ops/
transforms.py`): `rotate_bev` turns the prev-frame BEV map about its centre
(the reference's torchvision `rotate`, NEAREST by default, as an inverse
affine resample) and `shift_bev_ref` gives the ego-motion shift of the BEV
reference grid (`transformer.py:122-141` of the reference).

The nearest rotation rounds fp32 source coordinates, so a cell whose
coordinate lies near a .5 tie changes source on one ulp.  The port computes
them as the JAX package's jitted rotation does (XLA's compiled fp32, not
the source's arithmetic):

- theta = -angle * fl32(fl32(pi) * fl32(1/180)): XLA folds ``* pi / 180``
  into one multiplication by that constant;
- cos / sin of theta correctly rounded to fp32 (taken in float64; XLA's
  fp32 cos / sin are, on the angles the tests draw), on the angle's device;
- nearest: src_x = fma(cos, x0, -fl(sin*y0)) + cx and src_y = fma(sin, x0,
  fl(cos*y0)) + cy: XLA contracts one product of each sum into an FMA in
  that fusion.  The FMA is emulated exactly in float64 (`fma32`), so the
  card and the CPU give the same coordinates for the same cos / sin;
- bilinear: the same sums without contraction (XLA fuses them otherwise).

Then, as in JAX: round half to even, the validity mask, the clamp, the
gather, the multiplication by the mask.  The gather is one advanced-index
gather on the tensor's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# XLA's folding of `* jnp.pi / 180.0`: fl32(fl32(pi) * fl32(1 / 180))
DEG2RAD_XLA = float(np.float32(np.float32(np.pi) * np.float32(1.0 / 180.0)))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """fp32 fused multiply-add a * b + c rounded once, on any device: the
    product is exact in float64, the sum's rounding error is recovered
    exactly (TwoSum), and a float64 sum that lands on an fp32 midpoint is
    resolved by the error's sign (the one case where rounding the float64
    sum to fp32 is not the correctly rounded result)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, math.inf)
    nxt = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    mid = (s != rd) & (s == (rd + nxt.double()) * 0.5)
    up = mid & (err != 0) & ((err > 0) == (nxt.double() > rd))
    return torch.where(up, nxt, r)


def rotation_cos_sin(angle_deg) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of the inverse rotation for counter-clockwise
    ``angle_deg`` (tensor, array or float), on the angle's device."""
    a = torch.as_tensor(angle_deg, dtype=torch.float32)
    t = ((-a) * DEG2RAD_XLA).double()       # an fp32 product: exact scalar
    return torch.cos(t).float(), torch.sin(t).float()


def rotation_source(cos: torch.Tensor, sin: torch.Tensor, bev_hw,
                    center: Tuple[float, float], contract: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 source coordinates (src_x, src_y), each (..., H, W) for cos /
    sin of shape (...), in XLA's rounding of the nearest rotation, or of
    the bilinear one without ``contract`` (module docstring)."""
    h, w = bev_hw
    dev = cos.device
    cx, cy = center                   # fp32 scalars, as JAX's weak types
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    x0, y0 = xs - cx, ys - cy
    c, s = cos[..., None, None], sin[..., None, None]
    if not contract:
        return c * x0 - s * y0 + cx, s * x0 + c * y0 + cy
    return fma32(c, x0, -(s * y0)) + cx, fma32(s, x0, c * y0) + cy


def nearest_source_index(cos: torch.Tensor, sin: torch.Tensor, bev_hw,
                         center: Tuple[float, float]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat source index (..., H*W) int64, valid (..., H*W) bool) of the
    nearest rotation: rounded half to even, masked, then clamped."""
    h, w = bev_hw
    src_x, src_y = rotation_source(cos, sin, bev_hw, center)
    ix = torch.round(src_x).to(torch.int64)
    iy = torch.round(src_y).to(torch.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    return idx.flatten(-2), valid.flatten(-2)


def rotate_bev(bev: torch.Tensor, angle_deg,
               center: Tuple[float, float] = (100.0, 100.0),
               method: str = "nearest") -> torch.Tensor:
    """Rotate BEV maps counter-clockwise by ``angle_deg`` about ``center``
    (x, y in pixels): output cell (y, x) samples the input at the inverse
    rotation.  ``bev`` is (H, W, C) with a scalar angle, or (B, H, W, C)
    with B angles; the angles' cos / sin are taken on their own device."""
    squeeze = bev.dim() == 3
    if squeeze:
        bev = bev[None]
    b, h, w, c = bev.shape
    cos, sin = (t.to(bev.device, torch.float32, non_blocking=True)
                .reshape(-1).expand(b) for t in rotation_cos_sin(angle_deg))
    flat = bev.reshape(b, h * w, c)
    if method == "nearest":
        idx, valid = nearest_source_index(cos, sin, (h, w), center)
        out = torch.gather(flat, 1, idx[..., None].expand(b, h * w, c))
        out = out * valid[..., None].to(bev.dtype)
    elif method == "bilinear":
        src_x, src_y = rotation_source(cos, sin, (h, w), center,
                                       contract=False)
        x0f, y0f = torch.floor(src_x), torch.floor(src_y)
        tx = (src_x - x0f).flatten(-2)[..., None].to(bev.dtype)
        ty = (src_y - y0f).flatten(-2)[..., None].to(bev.dtype)
        out = torch.zeros_like(flat)
        for dy in (0, 1):
            for dx in (0, 1):
                ix = (x0f.to(torch.int64) + dx).flatten(-2)
                iy = (y0f.to(torch.int64) + dy).flatten(-2)
                valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
                wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
                idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
                g = torch.gather(flat, 1, idx[..., None].expand(b, h * w, c))
                out = out + g * wgt * valid[..., None].to(bev.dtype)
    else:
        raise ValueError(f"unknown rotation method {method!r}")
    out = out.reshape(b, h, w, c)
    return out[0] if squeeze else out


def shift_bev_ref(delta_xy, ego_angle_deg, grid_length: Tuple[float, float],
                  bev_hw: Tuple[int, int]) -> torch.Tensor:
    """Normalised (shift_x, shift_y) of the BEV grid between two frames from
    the ego translation ``delta_xy`` (..., 2) in metres (prev-ego frame) and
    the current ego yaw ``ego_angle_deg`` (...) in degrees: the can-bus
    shift of `transformer.py:122-141`.  Taken in float64 on the inputs'
    device and rounded once to fp32 (no division by a Python scalar, no
    host-to-device copy), so the card and the CPU agree; the JAX package's
    fp32 chain lies within a few ulps of it."""
    d = torch.as_tensor(delta_xy).double()
    yaw = torch.as_tensor(ego_angle_deg).to(d.device, torch.float64)
    dx, dy = d[..., 0], d[..., 1]
    translation = torch.sqrt(dx * dx + dy * dy)
    rad = math.pi / 180.0
    bev_angle = yaw - torch.atan2(dy, dx) * (180.0 / math.pi)
    gl_y, gl_x = grid_length
    bev_h, bev_w = bev_hw
    den_y, den_x = (torch.full((), v, dtype=torch.float64, device=d.device)
                    for v in (gl_y * bev_h, gl_x * bev_w))
    shift_y = translation * torch.cos(bev_angle * rad) / den_y
    shift_x = translation * torch.sin(bev_angle * rad) / den_x
    return torch.stack([shift_x, shift_y], dim=-1).float()
