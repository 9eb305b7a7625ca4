"""Camera geometry of the plain reference: the pillar and BEV-plane
reference points and their projection into the cameras (gather encoder),
and the plane homographies and per-level sampling positions of the planar
lift (dense encoder).

All of it is fp32 with the arithmetic written out op by op in a fixed order
(grid constants on the host with true division, the 4 x 4 projection as
four multiply-adds), so that a BEV cell on a camera's field-of-view edge
falls on the same side as in any implementation that keeps to this order:
one ulp there flips a cell's visibility, and with it a query's camera
count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def pillar_points(bev_h: int, bev_w: int, z_range: float, num_z: int
                  ) -> np.ndarray:
    """(Z, bev_h * bev_w, 3) float32 normalised xyz of the pillar anchors:
    z at linspace(0.5, z_range - 0.5, Z) / z_range, xy at cell centres."""
    f32 = np.float32
    zs = np.linspace(0.5, z_range - 0.5, num_z).astype(f32) / f32(z_range)
    xs = (np.arange(bev_w, dtype=f32) + f32(0.5)) / f32(bev_w)
    ys = (np.arange(bev_h, dtype=f32) + f32(0.5)) / f32(bev_h)
    ref = np.stack([np.broadcast_to(xs[None, None, :], (num_z, bev_h, bev_w)),
                    np.broadcast_to(ys[None, :, None], (num_z, bev_h, bev_w)),
                    np.broadcast_to(zs[:, None, None], (num_z, bev_h, bev_w))],
                   axis=-1)
    return np.ascontiguousarray(ref.reshape(num_z, bev_h * bev_w, 3))


def plane_points(bev_h: int, bev_w: int) -> np.ndarray:
    """(bev_h * bev_w, 1, 2) float32 normalised xy of the BEV cell centres,
    row-major over (y, x): the temporal self-attention's reference."""
    f32 = np.float32
    ys, xs = np.meshgrid((np.arange(bev_h, dtype=f32) + f32(0.5)) / f32(bev_h),
                         (np.arange(bev_w, dtype=f32) + f32(0.5)) / f32(bev_w),
                         indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)[:, None, :]


def project(ref_3d: np.ndarray, pc_range: Sequence[float],
            ego2img: torch.Tensor, img_hw: Tuple[int, int], eps: float = 1e-5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pillar anchors into every camera: (ref_cam (cams, B, Q, Z, 2)
    normalised image xy, mask (cams, B, Q, Z) bool: in front, strictly
    inside the image and finite)."""
    dev = ego2img.device
    ref = torch.as_tensor(ref_3d, dtype=torch.float32, device=dev)
    pc = torch.tensor(pc_range, dtype=torch.float32, device=dev)
    xyz = ref * (pc[3:6] - pc[0:3]) + pc[0:3]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    E = ego2img.float()[:, :, :3, :, None, None]
    pts = E[:, :, :, 0] * x + E[:, :, :, 1] * y + E[:, :, :, 2] * z \
        + E[:, :, :, 3]
    depth = pts[:, :, 2]
    in_front = depth > eps
    den = torch.clamp(depth, min=eps)
    h, w = img_hw
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    xy = torch.stack([pts[:, :, 0] / den, pts[:, :, 1] / den], dim=-1) / size
    mask = (in_front & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
            & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0)
            & torch.isfinite(xy).all(dim=-1))
    xy = torch.nan_to_num(xy)
    return (xy.permute(1, 0, 3, 2, 4).contiguous(),
            mask.permute(1, 0, 3, 2).contiguous())


def z_anchors(pc_range: Sequence[float], num_z: int) -> np.ndarray:
    """Pillar heights in metres, float32."""
    z_extent = float(pc_range[5]) - float(pc_range[2])
    z_norm = (np.linspace(0.5, z_extent - 0.5, num_z).astype(np.float32)
              / np.float32(z_extent))
    return z_norm * np.float32(z_extent) + np.float32(pc_range[2])


def plane_homographies(ego2img: torch.Tensor, pc_range: Sequence[float],
                       z: torch.Tensor, bev_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """(..., Z, 3, 3) homographies from BEV cell indices (centres at
    integer ix, iy) at height z to image pixels."""
    bev_h, bev_w = bev_hw
    pc = np.asarray(pc_range, np.float32)
    dx = (pc[3] - pc[0]) / np.float32(bev_w)
    dy = (pc[4] - pc[1]) / np.float32(bev_h)
    x0 = float(pc[0] + np.float32(0.5) * dx)
    y0 = float(pc[1] + np.float32(0.5) * dy)
    dx, dy = float(dx), float(dy)
    E = ego2img[..., :3, :]
    col_x = E[..., 0] * dx
    col_y = E[..., 1] * dy
    const = (E[..., None, :, 0] * x0 + E[..., None, :, 1] * y0
             + E[..., None, :, 2] * z[:, None] + E[..., None, :, 3])
    col_x = col_x[..., None, :].expand(const.shape)
    col_y = col_y[..., None, :].expand(const.shape)
    return torch.stack([col_x, col_y, const], dim=-1)


def level_homographies(H: torch.Tensor, h: int, w: int,
                       img_hw: Tuple[int, int]) -> torch.Tensor:
    """Fold a feature level's pixel scaling (x_f = u * w / img_w - 0.5, as
    grid_sample with align_corners=False) into the homographies."""
    img_h, img_w = img_hw
    sx = torch.tensor(w / img_w, dtype=torch.float32)
    sy = torch.tensor(h / img_h, dtype=torch.float32)
    return torch.stack([sx * H[..., 0, :] - 0.5 * H[..., 2, :],
                        sy * H[..., 1, :] - 0.5 * H[..., 2, :],
                        H[..., 2, :]], dim=-2)


def _band(pos: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((pos > -1.0) & (pos < n), pos,
                       torch.full_like(pos, -2.0))


def level_positions(Ml: torch.Tensor, bev_hw: Tuple[int, int], h: int,
                    w: int, eps: float = 1e-4):
    """The two-pass sampling positions of one level (the lift's
    definition): for each plane row r of each z, the image line of the BEV
    row; ``steep`` rows resample in y first.  Returns pos1 (B, A, Z*R,
    w + h): the across-line position at each integer step along the line
    ([:w] image y at column x, [w:] image x at row y), -2 outside; pos2
    (B, A, Z*R, M): the along-line position of each cell, -2 where it does
    not project into the level; steep (B, A, Z*R); valid (B, A, Z, R, M)."""
    bev_h, bev_w = bev_hw
    B, A, Z = Ml.shape[:3]
    dev = Ml.device
    f32 = torch.float32
    ix = torch.arange(bev_w, dtype=f32, device=dev)
    iy = torch.arange(bev_h, dtype=f32, device=dev)
    xs = torch.arange(w, dtype=f32, device=dev)
    ygrid = torch.arange(h, dtype=f32, device=dev)
    m = Ml[..., None, None]

    def proj(i):
        return (m[..., i, 0, :, :] * ix[None, :] + m[..., i, 1, :, :]
                * iy[:, None] + m[..., i, 2, :, :])

    px, py, pw = proj(0), proj(1), proj(2)
    in_front = pw > eps
    den = torch.where(in_front, pw, torch.full_like(pw, eps))
    xf = px / den
    yf = py / den
    valid = (in_front & (xf > -0.5) & (xf < w - 0.5)
             & (yf > -0.5) & (yf < h - 0.5))
    p_inf = Ml[..., :, 0][..., None, :]
    p_r = Ml[..., None, :, 1] * iy[:, None] + Ml[..., None, :, 2]
    p_inf = p_inf.expand(p_r.shape)
    l0 = p_inf[..., 1] * p_r[..., 2] - p_inf[..., 2] * p_r[..., 1]
    l1 = p_inf[..., 2] * p_r[..., 0] - p_inf[..., 0] * p_r[..., 2]
    l2 = p_inf[..., 0] * p_r[..., 1] - p_inf[..., 1] * p_r[..., 0]
    steep = l1.abs() < l0.abs()

    def safe(d):
        tiny = torch.where(d < 0, torch.full_like(d, -1e-8),
                           torch.full_like(d, 1e-8))
        return torch.where(d.abs() < 1e-8, tiny, d)

    a = -l0 / safe(l1)
    b = -l2 / safe(l1)
    a2 = -l1 / safe(l0)
    b2 = -l2 / safe(l0)
    posA = _band(a[..., None] * xs + b[..., None], h)
    posB = _band(a2[..., None] * ygrid + b2[..., None], w)
    pos1 = torch.cat([posA, posB], dim=-1).reshape(B, A, Z * bev_h, w + h)
    st = steep[..., None]
    dead = torch.full_like(xf, -2.0)
    pos2 = torch.where(valid & ~st, _band(xf, w),
                       torch.where(valid & st, _band(yf, h), dead))
    return (pos1, pos2.reshape(B, A, Z * bev_h, bev_w),
            steep.reshape(B, A, Z * bev_h), valid)


def lift_geometry(ego2img: torch.Tensor, pc_range, num_z: int,
                  bev_hw: Tuple[int, int], img_hw: Tuple[int, int],
                  levels: Sequence[Tuple[int, int]]):
    """[(pos1, pos2, steep)] a level and the (B, Q) number of cameras that
    see each BEV cell at level 0 (at least 1)."""
    dev = ego2img.device
    z = torch.from_numpy(z_anchors(pc_range, num_z)).to(dev)
    H = plane_homographies(ego2img.float(), pc_range, z, bev_hw)
    out, count = [], None
    for h, w in levels:
        pos1, pos2, steep, valid = level_positions(
            level_homographies(H, h, w, img_hw), bev_hw, h, w)
        if count is None:
            count = valid.any(dim=2).sum(dim=1).to(torch.float32).clamp(
                min=1.0).reshape(ego2img.shape[0], -1)
        out.append((pos1, pos2, steep))
    return out, count


def lift_taps(pos1: torch.Tensor, pos2: torch.Tensor, steep: torch.Tensor,
              a: int, h: int, w: int,
              b: Optional[int] = None) -> list:
    """The (weight, pixel) pairs of camera ``a``: for every output cell the
    2 x 2 taps of the two passes (along the line at pos2, then across it at
    each tap's own pos1), a tap outside its axis or a dead position giving
    weight 0.  Returns [(wt (B, N) f32, pix (B, N) int64)] with N = Z*R*M
    (sample ``b`` alone when given)."""
    sl = slice(None) if b is None else slice(b, b + 1)
    p2 = pos2[sl, a]
    Bn, ZR, M = p2.shape
    p2 = p2.reshape(Bn, ZR * M)
    st = steep[sl, a][:, :, None].expand(Bn, ZR, M).reshape(Bn, ZR * M)
    n_line = torch.where(st, h, w)
    n_across = torch.where(st, w, h)
    rows = pos1[sl, a].reshape(Bn, ZR, w + h)
    k0f = torch.floor(p2)
    f2 = p2 - k0f
    k0 = k0f.to(torch.int64)
    zr = torch.arange(ZR, device=p2.device)[None, :, None].expand(
        Bn, ZR, M).reshape(Bn, ZR * M)
    taps = []
    for dk in (0, 1):
        k = k0 + dk
        ok_k = (k >= 0) & (k < n_line)
        w2 = f2 if dk else 1.0 - f2
        col = torch.minimum(k.clamp(min=0), n_line - 1) + torch.where(
            st, w, 0)
        p1 = torch.gather(rows.reshape(Bn, ZR * (w + h)), 1,
                          zr * (w + h) + col)
        j0f = torch.floor(p1)
        f1 = p1 - j0f
        j0 = j0f.to(torch.int64)
        for dj in (0, 1):
            j = j0 + dj
            ok = ok_k & (j >= 0) & (j < n_across)
            wt = torch.where(ok, w2 * (f1 if dj else 1.0 - f1),
                             torch.zeros_like(f1))
            y = torch.where(st, k, j)
            x = torch.where(st, j, k)
            taps.append((wt, torch.where(ok, y * w + x,
                                         torch.zeros_like(k))))
    return taps
