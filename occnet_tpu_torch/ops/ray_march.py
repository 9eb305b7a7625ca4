"""Per-ray Amanatides-Woo voxel traversal (port of
`occnet_tpu/ops/ray_march.py`): the CUDA kernel (`csrc/ray_march.cu`,
`dda_kernel`) and its plain PyTorch version.

For each ray, march voxel by voxel through an occupancy grid; the first
voxel with occ > 0.5 is the hit, recorded as that voxel's EXIT distance
(the smallest crossing time, in voxel units along the normalised direction)
and its (x, y, z) index.  A ray that crosses the grid without a hit returns
the exit distance and index of the last voxel it visited; a ray that never
enters returns zeros.  The advancing axis follows the reference kernel's
nested strict comparisons, and crossing times accumulate step by step
(``tmax + tdelta``), as in the JAX loop.

The plain version is the JAX package's masked fixed-length loop
(``max_steps`` iterations over every ray); the kernel is one thread per ray
that stops at its hit or where it leaves the grid, with the same results.
`dda_raymarch` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from occnet_tpu_torch.ops._build import I32, I64, P, Kernel

_BIG = 1e30

DDA = Kernel("occ_dda_raymarch", [P, P, P, P, P, P, I64, I32, I32, I32, I32,
                                  I32, P])


def fma(a, b, c) -> torch.Tensor:
    """fp32 a * b + c with one rounding, as XLA's fused multiply-add: the
    product of two fp32 values is exact in float64, and so is the sum at
    the magnitudes of these marchers, so one rounding to fp32 remains."""
    def f64(x):
        return x.to(torch.float64) if torch.is_tensor(x) else x
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _norm(dirs: torch.Tensor) -> torch.Tensor:
    """(R, 1) max(|dirs|, 1e-12), |dirs|^2 summed as XLA compiles the JAX
    norm: fma(z, z, fma(y, y, x * x)).  The square root is taken in float64
    and rounded once: PyTorch's fp32 `sqrt` on the CPU is not correctly
    rounded."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    norm = torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()
    return torch.clamp(norm, min=1e-12)[:, None]


def dda_raymarch_plain(occ: torch.Tensor, origins: torch.Tensor,
                       dirs: torch.Tensor, max_steps: int = 448
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX loop, op for op: occ (X, Y, Z), origins (R, 3) voxel units,
    dirs (R, 3) -> (dist (R,) f32, coord (R, 3) int32, hit (R,) bool)."""
    X, Y, Z = occ.shape
    dev = occ.device
    sizes = torch.tensor([X, Y, Z], dtype=torch.int32, device=dev)
    occ_flat = (occ.reshape(-1) > 0.5)
    o = origins.to(torch.float32)
    dirs = dirs.to(torch.float32)
    nrm = _norm(dirs)
    d = dirs / nrm
    R = o.shape[0]
    v = torch.floor(o).to(torch.int32)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    nb = v.to(torch.float32) + (step > 0).to(torch.float32)
    # x / (dirs / nrm) as XLA rewrites it: (x * nrm) / dirs
    tmax = torch.where(d != 0, ((nb - o) * nrm) / dirs, _BIG)
    tdelta = torch.where(d != 0, (step.to(torch.float32) * nrm) / dirs, _BIG)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    hit_d = torch.zeros(R, dtype=torch.float32, device=dev)
    hit_v = torch.zeros(R, 3, dtype=torch.int32, device=dev)
    last_d = torch.zeros_like(hit_d)
    last_v = torch.zeros_like(hit_v)
    was_inside = torch.zeros_like(hit)
    done = torch.zeros_like(hit)
    for _ in range(max_steps):
        inside = ((v >= 0) & (v < sizes)).all(dim=-1)
        done = done | (was_inside & ~inside)
        active = ~done
        tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
        axis = torch.where(tx < ty, torch.where(tx < tz, 0, 2),
                           torch.where(ty < tz, 1, 2))
        exit_d = tmax.amin(dim=-1)
        vc = torch.minimum(torch.clamp(v, min=0), sizes - 1).long()
        occ_here = occ_flat[vc[:, 0] * (Y * Z) + vc[:, 1] * Z + vc[:, 2]] \
            & inside
        newly = active & inside & occ_here & ~hit
        upd = active & inside
        hit = hit | newly
        hit_d = torch.where(newly, exit_d, hit_d)
        hit_v = torch.where(newly[:, None], v, hit_v)
        last_d = torch.where(upd, exit_d, last_d)
        last_v = torch.where(upd[:, None], v, last_v)
        adv = active[:, None] & (axis[:, None] == torch.arange(3, device=dev))
        v = torch.where(adv, v + step, v)
        tmax = torch.where(adv, tmax + tdelta, tmax)
        was_inside = was_inside | inside
    dist = torch.where(hit, hit_d, last_d)
    coord = torch.where(hit[:, None], hit_v, last_v)
    dist = torch.where(was_inside, dist, 0.0)
    coord = torch.where(was_inside[:, None], coord, 0)
    return dist, coord, hit


def dda_raymarch_cuda(occ: torch.Tensor, origins: torch.Tensor,
                      dirs: torch.Tensor, max_steps: int = 448
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`dda_raymarch_plain` as one launch of the CUDA kernel.  ``origins``
    may be one origin broadcast over the rays (an expanded (R, 3) view with
    row stride 0)."""
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"dda kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
    X, Y, Z = occ.shape
    R = dirs.shape[0]
    if dirs.device != dev or dirs.dtype != torch.float32 \
            or tuple(dirs.shape) != (R, 3) or not dirs.is_contiguous():
        raise ValueError(f"dda kernel: expected contiguous float32 dirs "
                         f"(R, 3) on {dev}, got {dirs.dtype} "
                         f"{tuple(dirs.shape)} on {dirs.device}")
    if origins.device != dev or origins.dtype != torch.float32 \
            or tuple(origins.shape) != (R, 3) or origins.stride(1) != 1 \
            or origins.stride(0) not in (0, 3):
        raise ValueError(f"dda kernel: expected float32 origins (R, 3) on "
                         f"{dev} with row stride 0 or 3, got "
                         f"{origins.dtype} {tuple(origins.shape)} "
                         f"{origins.stride()} on {origins.device}")
    occ_u8 = (occ > 0.5).to(torch.uint8).contiguous()
    dist = torch.empty(R, dtype=torch.float32, device=dev)
    coord = torch.empty(R, 3, dtype=torch.int32, device=dev)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    DDA(occ_u8.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
        dist.data_ptr(), coord.data_ptr(), hit.data_ptr(), R,
        origins.stride(0), X, Y, Z, max_steps,
        torch.cuda.current_stream(dev).cuda_stream)
    return dist, coord, hit


def dda_raymarch(occ: torch.Tensor, origins: torch.Tensor,
                 dirs: torch.Tensor, max_steps: int = 448
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dist (R,), coord (R, 3) int32, hit (R,) bool): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if occ.is_cuda:
        return dda_raymarch_cuda(occ, origins, dirs, max_steps)
    if occ.device.type == "cpu":
        return dda_raymarch_plain(occ, origins, dirs, max_steps)
    raise ValueError(f"dda_raymarch: no implementation for {occ.device}")
