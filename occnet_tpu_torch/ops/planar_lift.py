"""Planar-homography lift of camera features onto the BEV grid (geometry and
the per-level loop), the port of `occnet_tpu/ops/planar_lift.py`.

For a fixed height z the map from BEV cell indices to image pixels is a
plane-to-plane homography, so warping a feature level onto the BEV grid
factors into two 1D linear resamples: along the image line of each BEV row
(pass 2) and across it at each tap's own line height (pass 1).  Rows whose
image line is steeper than 45 degrees resample in the other order (y first).

The geometry here is plain fp32 PyTorch, op for op the JAX package's
(`lift_pallas._plane_positions`, `planar_lift.warp_level_multi_z`), and, on
CUDA tensors, one launch of `csrc/lift_geometry.cu` that is bitwise equal to
it (`lift_geometry_cuda`, fed by its launch arguments alone); the sampling
itself is `lift_cuda.lift_level` (CUDA kernel or plain version), and its
gradient `lift_cuda.lift_level_bwd`, tied together by `_LiftAverage`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from occnet_tpu_torch.ops._build import F32, I32, P, Kernel
from occnet_tpu_torch.ops.lift_cuda import (_resolve, lift_bwd_index,
                                            lift_level, lift_level_bwd)
from occnet_tpu_torch.utils import profiling
from occnet_tpu_torch.utils.profiling import span

EPS = 1e-4            # a homogeneous w at or below it is behind the camera


def z_anchors(pc_range: Sequence[float], num_z: int) -> np.ndarray:
    """Pillar heights in metres (`encoder.py:66-67` of the reference):
    linspace(0.5, Z-0.5, num_z)/Z over the pc z-range, rounded like the JAX
    package's float32 `jnp.linspace`."""
    z_extent = float(pc_range[5]) - float(pc_range[2])
    z_norm = (np.linspace(0.5, z_extent - 0.5, num_z).astype(np.float32)
              / np.float32(z_extent))
    return z_norm * np.float32(z_extent) + np.float32(pc_range[2])


def grid_constants(pc_range: Sequence[float], bev_hw: Tuple[int, int]
                   ) -> Tuple[float, float, float, float]:
    """(dx, dy, x0, y0): the BEV cell size and the centre of cell (0, 0) in
    metres, float32 values as Python floats."""
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
    return float(dx), float(dy), x0, y0


def plane_homographies(ego2img: torch.Tensor, pc_range: Sequence[float],
                       z: torch.Tensor, bev_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """3x3 homographies M with (u, v, w)^T = M @ (ix, iy, 1)^T mapping BEV
    cell indices (cell centres at integer ix, iy) to image pixel coords.
    ego2img (..., 4, 4) fp32, z (Z,) -> (..., Z, 3, 3)."""
    dx, dy, x0, y0 = grid_constants(pc_range, bev_hw)
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
                   eps: float = EPS,
                   rows: Optional[Tuple[int, int]] = None):
    """Sampling positions of one feature level.  Ml (B, A, Z, 3, 3)
    BEV-cell -> feature-pixel homographies; ``rows`` = (r0, r1) restricts
    them to the BEV rows [r0, r1) (R = r1 - r0 rows; default all bev_h),
    each row's values those of the whole grid's.

    Returns
      pos1  (B, A, Z*R, w + h) f32: pass-1 position of every image-line
            tap, band-limited; [..., :w] order A (image y at column x),
            [..., w:] order B (image x at row y);
      pos2  (B, A, Z*R, bev_w) f32: pass-2 position along the line
            (xf in order A, yf in order B), -2 where the cell is invisible;
      steep (B, A, Z*R) bool: the row uses order B;
      valid (B, A, Z, R, bev_w) bool: the cell projects into the level.
    """
    bev_h, bev_w = bev_hw
    r0, r1 = (0, bev_h) if rows is None else rows
    bev_h = r1 - r0
    B, A, Z = Ml.shape[:3]
    dev = Ml.device
    f32 = torch.float32
    ix = torch.arange(bev_w, dtype=f32, device=dev)
    iy = torch.arange(r0, r1, dtype=f32, device=dev)
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


Geometry = Tuple[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 torch.Tensor, torch.Tensor]


def lift_geometry_plain(ego2img: torch.Tensor, pc_range: Sequence[float],
                        num_z: int, bev_hw: Tuple[int, int],
                        img_hw: Tuple[int, int],
                        level_hw: Sequence[Tuple[int, int]],
                        rows: Optional[Tuple[int, int]] = None) -> Geometry:
    """The lift's geometry in plain PyTorch: ([(pos1, pos2, steep)] a level
    of `level_geometry`, for the feature sizes ``level_hw``; count (B, Q),
    the cameras that see a query's cell at any z-anchor at level 0, clamped
    to >= 1; inv_count = 1 / count), over the BEV rows ``rows``."""
    dev = ego2img.device
    B = ego2img.shape[0]
    z = torch.from_numpy(z_anchors(pc_range, num_z)).to(dev)
    H = plane_homographies(ego2img.float(), pc_range, z, bev_hw)
    geoms = []
    count = inv_count = None
    for lvl, (h, w) in enumerate(level_hw):
        Ml = feature_homographies(H, h, w, img_hw)
        pos1, pos2, steep, valid = level_geometry(Ml, bev_hw, h, w,
                                                  rows=rows)
        if lvl == 0:
            count = valid.any(dim=2).sum(dim=1).to(torch.float32)
            count = count.clamp(min=1.0).reshape(B, -1)
            inv_count = 1.0 / count
        geoms.append((pos1, pos2, steep))
    return geoms, count, inv_count


GEOMETRY = Kernel("occ_lift_geometry", [P, I32, P])
_MAX_LEVELS = 8       # csrc/lift_geometry.cu kMaxLevels
_MAX_Z = 256          # csrc/lift_geometry.cu kMaxZ


class _GeomArgs(ctypes.Structure):
    """The launch arguments of `csrc/lift_geometry.cu` (its `GeomArgs`,
    field for field)."""
    _fields_ = [("ego2img", P), ("pos1", P * _MAX_LEVELS),
                ("pos2", P * _MAX_LEVELS), ("steep", P * _MAX_LEVELS),
                ("count", P), ("inv_count", P),
                ("B", I32), ("A", I32), ("Z", I32), ("R", I32), ("r0", I32),
                ("M", I32), ("levels", I32),
                ("h", I32 * _MAX_LEVELS), ("w", I32 * _MAX_LEVELS),
                ("sx", F32 * _MAX_LEVELS), ("sy", F32 * _MAX_LEVELS),
                ("dx", F32), ("dy", F32), ("x0", F32), ("y0", F32),
                ("eps", F32), ("z", F32 * _MAX_Z)]


def geometry_args(pc_range: Sequence[float], num_z: int,
                  bev_hw: Tuple[int, int], img_hw: Tuple[int, int],
                  level_hw: Sequence[Tuple[int, int]],
                  rows: Optional[Tuple[int, int]] = None) -> _GeomArgs:
    """The host-side constants of the geometry kernel, each the float32
    value the plain version computes with: the z-anchors, `grid_constants`,
    each level's sx = fp32(w / img_w) and sy = fp32(h / img_h) (torch's
    rounding of the Python quotient), `EPS`, the rows and the BEV width.
    Pointers and the batch are left to `lift_geometry_cuda`."""
    bev_h, bev_w = bev_hw
    img_h, img_w = img_hw
    r0, r1 = (0, bev_h) if rows is None else rows
    if not 0 <= r0 < r1 <= bev_h:
        raise ValueError(f"lift geometry: rows {rows} outside [0, {bev_h})")
    if not 1 <= len(level_hw) <= _MAX_LEVELS or not 1 <= num_z <= _MAX_Z:
        raise ValueError(f"lift geometry kernel: 1-{_MAX_LEVELS} levels and "
                         f"1-{_MAX_Z} z-anchors, got {len(level_hw)} and "
                         f"{num_z}")
    g = _GeomArgs()
    g.Z, g.R, g.r0, g.M, g.levels = num_z, r1 - r0, r0, bev_w, len(level_hw)
    for lvl, (h, w) in enumerate(level_hw):
        g.h[lvl], g.w[lvl] = h, w
        g.sx[lvl], g.sy[lvl] = w / img_w, h / img_h
    g.dx, g.dy, g.x0, g.y0 = grid_constants(pc_range, bev_hw)
    g.eps = EPS
    g.z[:num_z] = z_anchors(pc_range, num_z).tolist()
    return g


def lift_geometry_cuda(ego2img: torch.Tensor, pc_range: Sequence[float],
                       num_z: int, bev_hw: Tuple[int, int],
                       img_hw: Tuple[int, int],
                       level_hw: Sequence[Tuple[int, int]],
                       rows: Optional[Tuple[int, int]] = None) -> Geometry:
    """`lift_geometry_plain` as one launch of `csrc/lift_geometry.cu`,
    bitwise equal to it.  ego2img (B, A, 4, 4) contiguous float32 on a CUDA
    device; the outputs are allocated here and nothing else crosses from
    the host: no upload, no read-back, no synchronise.  Counts the launch
    in the counter ``lift.geometry_kernel``."""
    g = geometry_args(pc_range, num_z, bev_hw, img_hw, level_hw, rows)
    if ego2img.dtype != torch.float32 or ego2img.dim() != 4 \
            or tuple(ego2img.shape[2:]) != (4, 4) \
            or not ego2img.is_contiguous():
        raise ValueError(f"lift geometry kernel: ego2img must be contiguous "
                         f"float32 (B, A, 4, 4), got {ego2img.dtype} "
                         f"{tuple(ego2img.shape)}")
    dev = ego2img.device
    if dev.type != "cuda":
        raise ValueError(f"lift geometry kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    B, A = ego2img.shape[:2]
    g.B, g.A = B, A
    g.ego2img = ego2img.data_ptr()
    ZR, M = num_z * g.R, g.M
    geoms = []
    for lvl, (h, w) in enumerate(level_hw):
        # in the plain version's order: the caching allocator's layout, and
        # so the peak memory of a step, follows the order of allocations
        pos1 = torch.empty(B, A, ZR, w + h, dtype=torch.float32, device=dev)
        pos2 = torch.empty(B, A, ZR, M, dtype=torch.float32, device=dev)
        steep = torch.empty(B, A, ZR, dtype=torch.bool, device=dev)
        g.pos1[lvl], g.pos2[lvl] = pos1.data_ptr(), pos2.data_ptr()
        g.steep[lvl] = steep.data_ptr()
        geoms.append((pos1, pos2, steep))
        if lvl == 0:
            count = torch.empty(B, g.R * M, dtype=torch.float32, device=dev)
            inv_count = torch.empty_like(count)
            g.count, g.inv_count = count.data_ptr(), inv_count.data_ptr()
    GEOMETRY(ctypes.byref(g), ctypes.sizeof(g),
             torch.cuda.current_stream(dev).cuda_stream)
    profiling.count("lift.geometry_kernel", 1)
    return geoms, count, inv_count


class _LiftAverage(torch.autograd.Function):
    """The per-level lift loop with its transpose as the backward (the
    counterpart of `lift_pallas.lift_level`'s custom VJP).  It allocates and
    owns the (B, L, Z, Q, C) output; it saves only the per-level geometry
    (pos1, pos2, steep) and inv_count, ~20 MB at level 0 of the full width,
    and, when the backward will run the kernel, each level's transposed
    index (`lift_bwd_index`, 24 MB at level 0), built here from the same
    geometry.  Geometry and count get no gradient, as in the JAX package."""

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
        ctx.indices = [None] * len(feats)
        if any(ctx.needs_input_grad[5:]) \
                and _resolve(impl, inv_count) == "cuda":
            ctx.indices = [lift_bwd_index(*geo, hw)
                           for geo, hw in zip(geoms, ctx.hws)]
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
                                         hw, impl=ctx.impl,
                                         index=ctx.indices[lvl]))
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
    rows: Optional[Tuple[int, int]] = None,
):
    """Lift + camera-average: U_bar[b,l,z,q] = sum_cam U / count[b,q], with
    count = #cameras where any z-anchor of query q is visible at level 0
    (clamped to >= 1) — the reference SCA's scatter-add + count
    normalisation.  Returns (U_bar (B, L, Z, Q, C) out_dtype, count (B, Q)
    f32).  ``impl`` is passed to `lift_level` ("auto": kernel on CUDA).
    ``rows`` = (r0, r1) lifts the BEV rows [r0, r1) alone (Q = (r1 - r0) *
    bev_w queries, the whole lift's queries r0 * bev_w .. r1 * bev_w - 1,
    bit for bit: a BEV-query shard's, as the JAX package shards the lift's
    Q axis).  Differentiable in the features (bf16 gradient, as in the JAX
    package).  The homographies, the level geometry and the count are the
    span ``encoder.geometry``: `lift_geometry_cuda` (one launch) for CUDA
    tensors under "auto" or "cuda", `lift_geometry_plain` for CPU tensors
    or under "plain"; never one for the other."""
    bev_h, bev_w = bev_hw
    r0, r1 = (0, bev_h) if rows is None else rows
    Q = (r1 - r0) * bev_w
    B = ego2img.shape[0]
    C = mlvl_feats[0].shape[-1]
    level_hw = [tuple(f.shape[2:4]) for f in mlvl_feats]
    with span("encoder.geometry"):
        how = _resolve(impl, ego2img)
        if how == "cuda":
            geometry = lift_geometry_cuda
        elif how == "plain":
            geometry = lift_geometry_plain
        else:
            raise ValueError(f"unknown lift impl {impl!r}")
        geoms, count, inv_count = geometry(ego2img.float().contiguous(),
                                           pc_range, num_z, bev_hw, img_hw,
                                           level_hw, (r0, r1))
    U_bar = _LiftAverage.apply(
        geoms, inv_count, (B, len(mlvl_feats), num_z, Q, C), out_dtype, impl,
        *[f.to(torch.bfloat16).contiguous() for f in mlvl_feats])
    return U_bar, count
