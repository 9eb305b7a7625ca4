"""Column-factored fan DDA (port of `occnet_tpu/ops/ray_march_fast.py`): the
JAX package's loop over one origin's fan, as plain torch on any device.

All pitch rings of one azimuth share the origin and the xy direction, hence
the xy-column walk.  The grid's Z <= 32 z-voxels pack into one bitmask per
(x, y) column (`pack_columns`), the walk reads one mask a crossing, and
each pitch ray resolves its z-interval inside the crossing by bit tests, at
most ``max_z_sub`` voxels: the first occupied voxel's exit distance and
index, or, on a miss, the last visited voxel's.

`dda_raymarch_fan` transliterates the JAX loop: ``max_xy_steps`` masked
iterations, crossing times accumulated step by step (``tmax += tdelta``),
z entry ``fma(t_in, dz, z0)`` as XLA contracts it.  It is the reference for
the JAX package's loop and has no kernel.  The fan marcher the port runs,
on the card as the fan kernel, is `ray_march_vec`'s loop-free one: its
crossing times are the closed form ``fma(i, tdelta, tmax0)``, which the
JAX tests hold equal to the loop in hits and voxels and within 2e-3 in
distance (`tests/test_ray_march_vec.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from occnet_tpu_torch.ops.ray_march import fma
from occnet_tpu_torch.ops.ray_march_vec import pack_columns

__all__ = ["pack_columns", "dda_raymarch_fan"]

_BIG = 1e30


def dda_raymarch_fan(occ: torch.Tensor, origin: torch.Tensor,
                     az_dirs: torch.Tensor, pitch_dz: torch.Tensor,
                     pitch_scale: torch.Tensor, max_xy_steps: int = 420,
                     max_z_sub: int = 4
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """March A azimuths x K pitch rings from one origin by the JAX loop, op
    for op, on ``occ``'s device: occ (X, Y, Z), origin (3,) voxel units,
    az_dirs (A, 2) unit xy directions, pitch_dz / pitch_scale (K,) ->
    dist (A, K) f32 (3-D distance, voxel units), coord (A, K, 3) int32,
    hit (A, K) bool."""
    X, Y, Z = occ.shape
    dev = occ.device
    f32, i32 = torch.float32, torch.int32
    cols_flat = pack_columns(occ).reshape(-1)
    A, K = az_dirs.shape[0], pitch_dz.shape[0]
    o = origin.to(f32)
    d = az_dirs.to(f32)
    step = torch.where(d >= 0, 1, -1).to(i32)
    v = torch.floor(o[:2]).to(i32).expand(A, 2).clone()
    nb = v.to(f32) + (step > 0).to(f32)
    tmax = torch.where(d != 0, (nb - o[:2]) / d, _BIG)
    tdelta = torch.where(d != 0, step.to(f32) / d, _BIG)
    dz = pitch_dz.to(f32)[None, :]                          # (1, K)
    z0 = o[2]
    zstep = torch.where(dz >= 0, 1, -1).to(i32)
    dz_safe = torch.where(dz == 0, 1.0, dz)
    t_last = torch.zeros(A, dtype=f32, device=dev)
    hit = torch.zeros(A, K, dtype=torch.bool, device=dev)
    hit_s = torch.zeros(A, K, dtype=f32, device=dev)
    hit_v = torch.zeros(A, K, 3, dtype=i32, device=dev)
    last_s = torch.zeros_like(hit_s)
    last_v = torch.zeros_like(hit_v)
    was_inside = torch.zeros(A, dtype=torch.bool, device=dev)
    done = torch.zeros_like(was_inside)
    hi = torch.tensor([X - 1, Y - 1], dtype=i32, device=dev)
    for _ in range(max_xy_steps):
        inside = (v[:, 0] >= 0) & (v[:, 0] < X) & (v[:, 1] >= 0) \
            & (v[:, 1] < Y)
        done = done | (was_inside & ~inside)
        active = ~done
        use_x = tmax[:, 0] < tmax[:, 1]
        t_exit = torch.where(use_x, tmax[:, 0], tmax[:, 1])[:, None]
        vc = torch.minimum(torch.clamp(v, min=0), hi).long()
        colbits = torch.where(inside, cols_flat[vc[:, 0] * Y + vc[:, 1]],
                              0)[:, None]
        zi = torch.floor(fma(t_last[:, None], dz, z0)).to(i32)
        walk = (active & inside)[:, None]
        hx = v[:, None, 0].expand(A, K)
        hy = v[:, None, 1].expand(A, K)
        for j in range(max_z_sub):
            zj = zi + j * zstep
            z_ok = (zj >= 0) & (zj < Z)
            zb = zj + (zstep > 0).to(i32)
            s_zb = torch.where(dz != 0, (zb.to(f32) - z0) / dz, _BIG)
            if j == 0:
                enters = torch.ones_like(z_ok)
            else:
                s_enter = torch.where(
                    dz != 0, (torch.where(zstep > 0, zj, zj + 1).to(f32)
                              - z0) / dz_safe, _BIG)
                enters = (s_enter < t_exit) & (dz != 0)
            visit = z_ok & enters & walk
            occ_bit = ((colbits >> zj.clamp(0, Z - 1)) & 1) > 0
            s_exit_vox = torch.minimum(s_zb, t_exit)
            newly = visit & occ_bit & ~hit
            cand = torch.stack([hx, hy, zj], dim=-1)
            hit_s = torch.where(newly, s_exit_vox, hit_s)
            hit_v = torch.where(newly[..., None], cand, hit_v)
            hit = hit | newly
            last_s = torch.where(visit, s_exit_vox, last_s)
            last_v = torch.where(visit[..., None], cand, last_v)
        adv_x = (active & use_x)[:, None]
        adv_y = (active & ~use_x)[:, None]
        adv = torch.cat([adv_x, adv_y], dim=1)
        v = torch.where(adv, v + step, v)
        tmax = torch.where(adv, tmax + tdelta, tmax)
        t_last = torch.where(active, t_exit[:, 0], t_last)
        was_inside = was_inside | inside
    dist_s = torch.where(hit, hit_s, last_s)
    coord = torch.where(hit[..., None], hit_v, last_v)
    return dist_s * pitch_scale.to(f32)[None, :], coord, hit

