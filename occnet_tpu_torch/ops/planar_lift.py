"""Planar-homography lift of camera features onto the BEV grid (geometry and
the per-level loop), the port of `occnet_tpu/ops/planar_lift.py`.

For a fixed height z the map from BEV cell indices to image pixels is a
plane-to-plane homography, so warping a feature level onto the BEV grid
factors into two 1D linear resamples: along the image line of each BEV row
(pass 2) and across it at each tap's own line height (pass 1).  Rows whose
image line is steeper than 45 degrees resample in the other order (y first).

The geometry here is plain fp32 PyTorch, op for op the JAX package's
(`lift_pallas._plane_positions`, `planar_lift.warp_level_multi_z`); the
sampling itself is `lift_cuda.lift_level` (CUDA kernel or plain version), and
its gradient `lift_cuda.lift_level_bwd`, tied together by `_LiftAverage`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from occnet_tpu_torch.ops.lift_cuda import lift_level, lift_level_bwd


def z_anchors(pc_range: Sequence[float], num_z: int) -> np.ndarray:
    """Pillar heights in metres (`encoder.py:66-67` of the reference):
    linspace(0.5, Z-0.5, num_z)/Z over the pc z-range, rounded like the JAX
    package's float32 `jnp.linspace`."""
    z_extent = float(pc_range[5]) - float(pc_range[2])
    z_norm = (np.linspace(0.5, z_extent - 0.5, num_z).astype(np.float32)
              / np.float32(z_extent))
    return z_norm * np.float32(z_extent) + np.float32(pc_range[2])


def plane_homographies(ego2img: torch.Tensor, pc_range: Sequence[float],
                       z: torch.Tensor, bev_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """3x3 homographies M with (u, v, w)^T = M @ (ix, iy, 1)^T mapping BEV
    cell indices (cell centres at integer ix, iy) to image pixel coords.
    ego2img (..., 4, 4) fp32, z (Z,) -> (..., Z, 3, 3)."""
    bev_h, bev_w = bev_hw
    # grid constants in float32 on the host with true division: CUDA's
    # division by a scalar multiplies by its reciprocal, which rounds
    # differently, and cells on a camera's field-of-view edge then flip
    # validity between devices
    pc = np.asarray(pc_range, np.float32)
    dx = (pc[3] - pc[0]) / np.float32(bev_w)
    dy = (pc[4] - pc[1]) / np.float32(bev_h)
    x0 = float(pc[0] + np.float32(0.5) * dx)
    y0 = float(pc[1] + np.float32(0.5) * dy)
    dx, dy = float(dx), float(dy)
    E = ego2img[..., :3, :]                                   # (..., 3, 4)
    col_x = E[..., 0] * dx
    col_y = E[..., 1] * dy
    const = (E[..., None, :, 0] * x0 + E[..., None, :, 1] * y0
             + E[..., None, :, 2] * z[:, None] + E[..., None, :, 3])
    col_x = col_x[..., None, :].expand(const.shape)
    col_y = col_y[..., None, :].expand(const.shape)
    return torch.stack([col_x, col_y, const], dim=-1)         # (..., Z, 3, 3)


def _band_limit(pos: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-padding semantics: positions outside (-1, n) get no support."""
    return torch.where((pos > -1.0) & (pos < n), pos,
                       torch.full_like(pos, -2.0))


def feature_homographies(H: torch.Tensor, h: int, w: int,
                         img_hw: Tuple[int, int]) -> torch.Tensor:
    """Fold the per-level feature-pixel scaling S (grid_sample
    align_corners=False: xf = u * (w / img_w) - 0.5) into H (..., 3, 3)."""
    img_h, img_w = img_hw
    sx = torch.tensor(w / img_w, dtype=torch.float32)
    sy = torch.tensor(h / img_h, dtype=torch.float32)
    return torch.stack([sx * H[..., 0, :] - 0.5 * H[..., 2, :],
                        sy * H[..., 1, :] - 0.5 * H[..., 2, :],
                        H[..., 2, :]], dim=-2)


def level_geometry(Ml: torch.Tensor, bev_hw: Tuple[int, int], h: int, w: int,
                   eps: float = 1e-4):
    """Sampling positions of one feature level.  Ml (B, A, Z, 3, 3)
    BEV-cell -> feature-pixel homographies.

    Returns
      pos1  (B, A, Z*bev_h, w + h) f32: pass-1 position of every image-line
            tap, band-limited; [..., :w] order A (image y at column x),
            [..., w:] order B (image x at row y);
      pos2  (B, A, Z*bev_h, bev_w) f32: pass-2 position along the line
            (xf in order A, yf in order B), -2 where the cell is invisible;
      steep (B, A, Z*bev_h) bool: the row uses order B;
      valid (B, A, Z, bev_h, bev_w) bool: the cell projects into the level.
    """
    bev_h, bev_w = bev_hw
    B, A, Z = Ml.shape[:3]
    dev = Ml.device
    f32 = torch.float32
    ix = torch.arange(bev_w, dtype=f32, device=dev)
    iy = torch.arange(bev_h, dtype=f32, device=dev)
    xs = torch.arange(w, dtype=f32, device=dev)
    ygrid = torch.arange(h, dtype=f32, device=dev)
    m = Ml[..., None, None]                     # (B, A, Z, 3, 3, 1, 1)

    def proj(i):
        return (m[..., i, 0, :, :] * ix[None, :] + m[..., i, 1, :, :]
                * iy[:, None] + m[..., i, 2, :, :])   # (B, A, Z, bev_h, bev_w)

    px, py, pw = proj(0), proj(1), proj(2)
    in_front = pw > eps
    den = torch.where(in_front, pw, torch.full_like(pw, eps))
    xf = px / den
    yf = py / den
    valid = (in_front & (xf > -0.5) & (xf < w - 0.5)
             & (yf > -0.5) & (yf < h - 0.5))

    # image line of BEV row r in plane z: through p_inf = M[:, 0] (the row's
    # point at infinity) and p_r = M[:, 1] * r + M[:, 2]; l = p_inf x p_r
    p_inf = Ml[..., :, 0][..., None, :]                   # (B, A, Z, 1, 3)
    p_r = (Ml[..., None, :, 1] * iy[:, None]
           + Ml[..., None, :, 2])                         # (B, A, Z, bev_h, 3)
    p_inf = p_inf.expand(p_r.shape)
    l0 = p_inf[..., 1] * p_r[..., 2] - p_inf[..., 2] * p_r[..., 1]
    l1 = p_inf[..., 2] * p_r[..., 0] - p_inf[..., 0] * p_r[..., 2]
    l2 = p_inf[..., 0] * p_r[..., 1] - p_inf[..., 1] * p_r[..., 0]
    steep = l1.abs() < l0.abs()                           # (B, A, Z, bev_h)

    def safe(d):
        tiny = torch.where(d < 0, torch.full_like(d, -1e-8),
                           torch.full_like(d, 1e-8))
        return torch.where(d.abs() < 1e-8, tiny, d)

    a = -l0 / safe(l1)          # y = a*x + b
    b = -l2 / safe(l1)
    a2 = -l1 / safe(l0)         # x = a2*y + b2
    b2 = -l2 / safe(l0)

    posA = _band_limit(a[..., None] * xs + b[..., None], h)
    posB = _band_limit(a2[..., None] * ygrid + b2[..., None], w)
    pos1 = torch.cat([posA, posB], dim=-1).reshape(B, A, Z * bev_h, w + h)

    st = steep[..., None]
    dead = torch.full_like(xf, -2.0)
    pos2 = torch.where(valid & ~st, _band_limit(xf, w),
                       torch.where(valid & st, _band_limit(yf, h), dead))
    return (pos1.contiguous(), pos2.reshape(B, A, Z * bev_h, bev_w),
            steep.reshape(B, A, Z * bev_h).contiguous(), valid)


class _LiftAverage(torch.autograd.Function):
    """The per-level lift loop with its transpose as the backward (the
    counterpart of `lift_pallas.lift_level`'s custom VJP).  It allocates and
    owns the (B, L, Z, Q, C) output; it saves only the per-level geometry
    (pos1, pos2, steep) and inv_count, ~20 MB at level 0 of the full width.
    Geometry and count get no gradient, as in the JAX package."""

    @staticmethod
    def forward(ctx, geoms, inv_count, shape, out_dtype, impl, *feats):
        B, L, Z, Q, C = shape
        ZR, M = geoms[0][1].shape[2], geoms[0][1].shape[3]
        U_bar = torch.empty(shape, dtype=out_dtype, device=inv_count.device)
        for lvl, (feat, (pos1, pos2, steep)) in enumerate(zip(feats, geoms)):
            lift_level(feat, pos1, pos2, steep, inv_count,
                       U_bar[:, lvl].view(B, ZR, M, C), impl=impl)
        ctx.save_for_backward(inv_count, *[t for g in geoms for t in g])
        ctx.hws = [tuple(f.shape[2:4]) for f in feats]
        ctx.impl = impl
        return U_bar

    @staticmethod
    def backward(ctx, g):
        inv_count, *flat = ctx.saved_tensors
        g = g.contiguous()
        B, L, Z, Q, C = g.shape
        dfeats = []
        for lvl, hw in enumerate(ctx.hws):
            pos1, pos2, steep = flat[3 * lvl: 3 * lvl + 3]
            gl = g[:, lvl].view(B, pos2.shape[2], pos2.shape[3], C)
            dfeats.append(lift_level_bwd(gl, pos1, pos2, steep, inv_count,
                                         hw, impl=ctx.impl))
        return (None, None, None, None, None, *dfeats)


def lift_and_average(
    mlvl_feats: Sequence[torch.Tensor],   # per level (B, cams, h, w, C)
    ego2img: torch.Tensor,                # (B, cams, 4, 4)
    pc_range: Sequence[float],
    num_z: int,
    bev_hw: Tuple[int, int],
    img_hw: Tuple[int, int],
    out_dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
):
    """Lift + camera-average: U_bar[b,l,z,q] = sum_cam U / count[b,q], with
    count = #cameras where any z-anchor of query q is visible at level 0
    (clamped to >= 1) — the reference SCA's scatter-add + count
    normalisation.  Returns (U_bar (B, L, Z, Q, C) out_dtype, count (B, Q)
    f32).  ``impl`` is passed to `lift_level` ("auto": kernel on CUDA).
    Differentiable in the features (bf16 gradient, as in the JAX package)."""
    dev = ego2img.device
    bev_h, bev_w = bev_hw
    Q = bev_h * bev_w
    B = ego2img.shape[0]
    C = mlvl_feats[0].shape[-1]
    z = torch.from_numpy(z_anchors(pc_range, num_z)).to(dev)
    H = plane_homographies(ego2img.float(), pc_range, z, bev_hw)
    geoms = []
    count = inv_count = None
    for lvl, feat in enumerate(mlvl_feats):
        h, w = feat.shape[2], feat.shape[3]
        Ml = feature_homographies(H, h, w, img_hw)
        pos1, pos2, steep, valid = level_geometry(Ml, bev_hw, h, w)
        if lvl == 0:
            count = valid.any(dim=2).sum(dim=1).to(torch.float32)
            count = count.clamp(min=1.0).reshape(B, Q)
            inv_count = 1.0 / count
        geoms.append((pos1, pos2, steep))
    U_bar = _LiftAverage.apply(
        geoms, inv_count, (B, len(mlvl_feats), num_z, Q, C), out_dtype, impl,
        *[f.to(torch.bfloat16).contiguous() for f in mlvl_feats])
    return U_bar, count
