"""Fan DDA of the evaluation path (port of `occnet_tpu/ops/ray_march_vec.py`
and of `pack_columns` from `ray_march_fast.py`): the CUDA kernel
(`csrc/ray_march.cu`, `fan_kernel`) and its plain PyTorch version.

The simulated LiDAR fan is A azimuths x K pitch rings from each of T
origins.  All rings of one azimuth share the xy-column walk, whose crossing
times are two arithmetic progressions (``tmax0 + i * tdelta``, closed form)
merged in order, y first on an exact tie.  The grid's Z <= 32 z-voxels pack
into one int32 bitmask per (x, y) column.  In each crossed column a pitch
ray covers a contiguous z-range of at most ``max_z_sub`` voxels; the first
crossing whose range holds an occupied bit is the hit, and the per-crossing
z-sub-walk (`_z_subwalk`) is replayed there to find the first occupied
voxel's exit distance.  A miss takes the last voxel of the last visited
crossing; a ray that never enters returns zeros.  The caps
``max_xy_steps`` = 420 and ``max_z_sub`` = 4 are part of the semantics (the
eval marcher differs from an exact DDA on steep rays) and are copied, not
fixed.

The plain version transliterates the JAX program (a stable sort of the
crossing keys, cumulative sums, first-True argmax over the crossings); the
kernel is one thread per (grid, origin, azimuth, pitch ring) walking the
merge with two counters and stopping at its hit, with the same results.
`dda_raymarch_fan_vec` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from occnet_tpu_torch.ops._build import I32, P, Kernel
from occnet_tpu_torch.ops.ray_march import fma

_BIG = 1e30

FAN = Kernel("occ_fan_raymarch", [P, P, P, P, P, P, P, P, I32, I32, I32,
                                  I32, I32, I32, I32, I32, I32, P])


def pack_columns(occ: torch.Tensor) -> torch.Tensor:
    """(..., X, Y, Z <= 32) occupancy (> 0.5 occupied) -> (..., X, Y) int32
    bitmask, bit z set for an occupied voxel z."""
    Z = occ.shape[-1]
    bits = (occ > 0.5).to(torch.int32)
    weights = torch.ones(Z, dtype=torch.int32, device=occ.device) \
        << torch.arange(Z, dtype=torch.int32, device=occ.device)
    return (bits * weights).sum(dim=-1, dtype=torch.int32)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none), as
    `jnp.argmax` of a bool array."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _column_walk(origin, az_dirs, X, Y, N):
    """Closed-form xy walk of one origin: per (azimuth, crossing) the
    column (vx, vy), t_in, t_exit and inside."""
    f32 = torch.float32
    dev = az_dirs.device
    o = origin.to(f32)
    d = az_dirs.to(f32)                                     # (A, 2)
    A = d.shape[0]
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    v0 = torch.floor(o[:2]).to(torch.int32)
    nb = v0.to(f32) + (step > 0).to(f32)
    tmax0 = torch.where(d != 0, (nb - o[:2]) / d, _BIG)
    tdelta = torch.where(d != 0, step.to(f32) / d, _BIG)
    i = torch.arange(N, dtype=f32, device=dev)
    tX = fma(i[None, :], tdelta[:, 0:1], tmax0[:, 0:1])     # (A, N)
    tY = fma(i[None, :], tdelta[:, 1:2], tmax0[:, 1:2])
    # y first: a stable sort of [tY, tX] crosses y on exact ties
    keys = torch.cat([tY, tX], dim=1)
    flags = torch.cat([torch.zeros(A, N, dtype=torch.int32, device=dev),
                       torch.ones(A, N, dtype=torch.int32, device=dev)], 1)
    t_sorted, order = torch.sort(keys, dim=1, stable=True)
    t_exit = t_sorted[:, :N]
    fx = torch.gather(flags, 1, order)[:, :N]               # 1 = x-crossing
    cx = torch.cumsum(fx, 1, dtype=torch.int32) - fx
    cy = torch.cumsum(1 - fx, 1, dtype=torch.int32) - (1 - fx)
    vx = v0[0] + step[:, 0:1] * cx
    vy = v0[1] + step[:, 1:2] * cy
    t_in = torch.cat([torch.zeros(A, 1, dtype=f32, device=dev),
                      t_exit[:, :-1]], dim=1)
    inside = (vx >= 0) & (vx < X) & (vy >= 0) & (vy < Y)
    return vx, vy, t_in, t_exit, inside


def _safe_div_or_big(num, dz):
    """where(dz != 0, num / where(dz == 0, 1, dz), BIG)."""
    return torch.where(dz != 0, num / torch.where(dz == 0, 1.0, dz), _BIG)


def _z_subwalk(colbits, vx, vy, t_in, t_exit, z0, dz, zstep, Z, max_z_sub):
    """The per-crossing z-sub-walk at ONE crossing per ray: first-occupied
    (hit) and last-visited voxel of the crossing."""
    f32 = torch.float32
    zi = torch.floor(fma(t_in, dz, z0)).to(torch.int32)
    hit = torch.zeros(zi.shape, dtype=torch.bool, device=zi.device)
    hit_s = torch.zeros(zi.shape, dtype=f32, device=zi.device)
    hit_z = torch.zeros_like(zi)
    last_ok = torch.zeros_like(hit)
    last_s = torch.zeros_like(hit_s)
    last_z = torch.zeros_like(zi)
    for j in range(max_z_sub):
        zj = zi + j * zstep
        z_ok = (zj >= 0) & (zj < Z)
        zb = zj + (zstep > 0).to(torch.int32)
        s_zb = _safe_div_or_big(zb.to(f32) - z0, dz)
        if j == 0:
            enters = torch.ones_like(hit)
        else:
            s_enter = _safe_div_or_big(
                (zj + (zstep < 0).to(torch.int32)).to(f32) - z0, dz)
            enters = (s_enter < t_exit) & (dz != 0)
        visit = z_ok & enters
        occ_bit = ((colbits >> zj.clamp(0, Z - 1)) & 1) > 0
        s_exit_vox = torch.minimum(s_zb, t_exit)
        newly = visit & occ_bit & ~hit
        hit_s = torch.where(newly, s_exit_vox, hit_s)
        hit_z = torch.where(newly, zj, hit_z)
        hit = hit | newly
        last_s = torch.where(visit, s_exit_vox, last_s)
        last_z = torch.where(visit, zj, last_z)
        last_ok = last_ok | visit
    coord_hit = torch.stack([vx, vy, hit_z], dim=-1)
    coord_last = torch.stack([vx, vy, last_z], dim=-1)
    return hit, hit_s, coord_hit, last_ok, last_s, coord_last


def dda_raymarch_fan_vec_plain(occs, origins, az_dirs, pitch_dz, pitch_scale,
                               max_xy_steps: int = 420, max_z_sub: int = 4):
    """The JAX program, op for op: occs (G, X, Y, Z), origins (T, 3) voxel
    units, az_dirs (A, 2), pitch_dz / pitch_scale (K,) -> dist (G, T, A, K)
    f32 (3-D distance, voxel units), coord (G, T, A, K, 3) int32,
    hit (G, T, A, K) bool."""
    G, X, Y, Z = occs.shape
    N = max_xy_steps
    f32 = torch.float32
    cols = pack_columns(occs).reshape(G, X * Y)
    walks = [_column_walk(o, az_dirs, X, Y, N) for o in origins]
    vx, vy, t_in, t_exit, inside = (torch.stack(w) for w in zip(*walks))
    idx = (vx.clamp(0, X - 1).long() * Y
           + vy.clamp(0, Y - 1).long()).reshape(-1)
    colbits = cols[:, idx].reshape((G,) + tuple(vx.shape))  # (G, T, A, N)
    colbits = torch.where(inside[None], colbits, 0)

    dz = pitch_dz.to(f32)
    zstep = torch.where(dz >= 0, 1, -1).to(torch.int32)
    z0 = origins[:, 2].to(f32)
    z0_b = z0[:, None, None, None]
    dz_b = dz[None, None, None, :]
    zstep_b = zstep[None, None, None, :]
    t_in_b = t_in[..., None]
    t_exit_b = t_exit[..., None]
    zi = torch.floor(fma(t_in_b, dz_b, z0_b)).to(torch.int32)  # (T,A,N,K)
    extra = torch.zeros(zi.shape, dtype=torch.int32, device=zi.device)
    for j in range(1, max_z_sub):
        s_enter = _safe_div_or_big(
            (zi + j * zstep_b + (zstep_b < 0).to(torch.int32)).to(f32)
            - z0_b, dz_b)
        extra = extra + ((s_enter < t_exit_b) & (dz_b != 0)).to(torch.int32)
    z_far = zi + extra * zstep_b
    zmin, zmax = torch.minimum(zi, z_far), torch.maximum(zi, z_far)
    lo = zmin.clamp(0, Z - 1)
    hi = zmax.clamp(0, Z - 1)
    nonempty = zmin.clamp(min=0) <= zmax.clamp(max=Z - 1)
    span = hi - lo + 1
    ones = torch.ones_like(span)
    range_mask = torch.where(nonempty, ((ones << span) - 1) << lo, 0)
    visited = inside[..., None] & nonempty                  # (T, A, N, K)
    anyhit = visited & ((colbits[..., None] & range_mask[None]) != 0)

    n_hit = _first_true(anyhit, 3)                          # (G, T, A, K)
    has_hit = anyhit.any(dim=3)
    n_last = (N - 1) - _first_true(torch.flip(visited, dims=[2]), 2)
    has_vis = visited.any(dim=2)                            # (T, A, K)

    def at_n(arr_tan, n_gtak):
        # arr (T, A, N) at n (G, T, A, K) -> (G, T, A, K)
        src = arr_tan[None].expand(n_gtak.shape[0], *arr_tan.shape)
        return torch.gather(src, 3, n_gtak)

    def resolve(n_sel):
        cb = torch.gather(colbits, 3, n_sel)
        return _z_subwalk(cb, at_n(vx, n_sel), at_n(vy, n_sel),
                          at_n(t_in, n_sel), at_n(t_exit, n_sel),
                          z0[None, :, None, None], dz[None, None, None, :],
                          zstep[None, None, None, :], Z, max_z_sub)

    hit_j, hit_s, coord_hit, _, _, _ = resolve(n_hit)
    hit = has_hit & hit_j
    n_last_g = n_last[None].expand(G, *n_last.shape).contiguous()
    _, _, _, last_ok, last_s, coord_last = resolve(n_last_g)
    last_ok = last_ok & has_vis[None]
    last_s = torch.where(last_ok, last_s, 0.0)
    coord_last = torch.where(last_ok[..., None], coord_last, 0)
    dist_s = torch.where(hit, hit_s, last_s)
    coord = torch.where(hit[..., None], coord_hit, coord_last)
    dist = dist_s * pitch_scale.to(f32)[None, None, None, :]
    return dist, coord, hit


def dda_raymarch_fan_vec_cuda(occs, origins, az_dirs, pitch_dz, pitch_scale,
                              max_xy_steps: int = 420, max_z_sub: int = 4):
    """`dda_raymarch_fan_vec_plain` as one launch of the CUDA kernel."""
    dev = occs.device
    if dev.type != "cuda":
        raise ValueError(f"fan kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
    G, X, Y, Z = occs.shape
    T, A, K = origins.shape[0], az_dirs.shape[0], pitch_dz.shape[0]
    checks = [(origins, (T, 3)), (az_dirs, (A, 2)), (pitch_dz, (K,)),
              (pitch_scale, (K,))]
    for t, shape in checks:
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fan kernel: expected contiguous float32 "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if Z > 32 or max_z_sub < 1:
        raise ValueError(f"fan kernel: Z={Z} must be <= 32, max_z_sub >= 1")
    cols = pack_columns(occs).contiguous()
    dist = torch.empty(G, T, A, K, dtype=torch.float32, device=dev)
    coord = torch.empty(G, T, A, K, 3, dtype=torch.int32, device=dev)
    hit = torch.empty(G, T, A, K, dtype=torch.bool, device=dev)
    FAN(cols.data_ptr(), origins.data_ptr(), az_dirs.data_ptr(),
        pitch_dz.data_ptr(), pitch_scale.data_ptr(), dist.data_ptr(),
        coord.data_ptr(), hit.data_ptr(), G, T, A, K, X, Y, Z, max_xy_steps,
        max_z_sub, torch.cuda.current_stream(dev).cuda_stream)
    return dist, coord, hit


def dda_raymarch_fan_vec(occs, origins, az_dirs, pitch_dz, pitch_scale,
                         max_xy_steps: int = 420, max_z_sub: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """March G grids x T origins x A azimuths x K pitch rings: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if occs.is_cuda:
        return dda_raymarch_fan_vec_cuda(occs, origins, az_dirs, pitch_dz,
                                         pitch_scale, max_xy_steps,
                                         max_z_sub)
    if occs.device.type == "cpu":
        return dda_raymarch_fan_vec_plain(occs, origins, az_dirs, pitch_dz,
                                          pitch_scale, max_xy_steps,
                                          max_z_sub)
    raise ValueError(f"fan march: no implementation for {occs.device}")
