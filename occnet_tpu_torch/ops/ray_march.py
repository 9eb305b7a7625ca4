"""Per-ray Amanatides-Woo voxel traversal (port of
`occnet_tpu/ops/ray_march.py`) and the synthetic scene render built on it
(port of the jitted `occnet_tpu/data/synthetic.render_views`): the CUDA
kernel (`csrc/ray_march.cu`, `dda_kernel`, one template with a raw and a
render epilogue) and the plain PyTorch versions.

For each ray, march voxel by voxel through an occupancy grid; the first
voxel with occ > 0.5 is the hit, recorded as that voxel's EXIT distance
(the smallest crossing time, in voxel units along the normalised direction)
and its (x, y, z) index.  A ray that crosses the grid without a hit returns
the exit distance and index of the last voxel it visited; a ray that never
enters returns zeros.  The advancing axis follows the reference kernel's
nested strict comparisons, and crossing times accumulate step by step
(``tmax + tdelta``), as in the JAX loop.

`dda_raymarch` returns that raw form for given rays.  `render_views`
renders all C cameras of a scene to (C, H, W, 3) uint8 views from
host-built `SceneTables`: each pixel's direction, the march, the hit
voxel's label, distance shading, a per-voxel texture and a sky gradient
where nothing is hit.  The plain versions are the JAX package's masked
fixed-length loop (``max_steps`` iterations over every ray) and the
port's torch composition around it; the kernel packs the grid into column
bitmasks in shared memory and walks 8 x 4 pixel tiles a warp, one launch a
scene, with the same results.  Each entry point launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from occnet_tpu_torch.ops._build import F32, I32, I64, P, Kernel

_BIG = 1e30

DDA = Kernel("occ_dda_raymarch", [P, P, P, P, P, P, I64, I32, I32, I32, I32,
                                  I32, P])
RENDER = Kernel("occ_render_views", [P, I32, I32, I32, I32, I32, P, P, P, P,
                                     P, P, P, P, I32, I32, I32, F32, P])

# shared memory a block may use on the H100 (227 KB), and what the kernel's
# render epilogue adds to the packed columns: 24 warps x 8 x 4 RGB pixels
SMEM_PER_BLOCK = 232448
_RENDER_STAGE_BYTES = 24 * 8 * 4 * 3


def check_packed_grid(X: int, Y: int, Z: int, render: bool, who: str
                      ) -> int:
    """Shared memory the kernel's packed columns of an (X, Y, Z) grid take
    (Z-bit column masks: uint16 up to Z = 16, else uint32, 16-byte
    aligned); raises where a block could not hold them."""
    if not 1 <= Z <= 32:
        raise ValueError(f"{who}: Z={Z} must be in [1, 32] (one bitmask a "
                         f"column)")
    word = 2 if Z <= 16 else 4
    need = -(-X * Y * word // 16) * 16 + (_RENDER_STAGE_BYTES if render
                                           else 0)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"{who}: the {X} x {Y} grid's packed columns take "
                         f"{need} bytes of shared memory, more than the "
                         f"{SMEM_PER_BLOCK} a block may use")
    return need


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
    X, Y, Z = occ.shape
    check_packed_grid(X, Y, Z, False, "dda kernel")
    dev = occ.device
    if dev.type != "cuda":
        raise ValueError(f"dda kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
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


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Host-built inputs of a scene render, on one device, float32: ``rot``
    (C, 3, 3) ego -> camera rotations, ``origin`` (C, 3) camera centres in
    voxel units, ``u`` (W,) / ``v`` (H,) pixel centres through the
    intrinsics, ``tex`` (8,) the voxel-hash texture, ``sky`` (H, 3) each
    row's sky colour, ``palette`` (classes, 3); ``voxel_size`` the cubic
    voxel's edge in metres."""
    rot: torch.Tensor
    origin: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tex: torch.Tensor
    sky: torch.Tensor
    palette: torch.Tensor
    voxel_size: float

    def to(self, device) -> "SceneTables":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "voxel_size"})


def camera_dirs(tables: SceneTables, c: int) -> torch.Tensor:
    """(H * W, 3) ego-frame directions of camera ``c``'s pixels, row-major:
    u * R[0, j] + v * R[1, j] + R[2, j], one rounding an operation."""
    H, W = tables.v.shape[0], tables.u.shape[0]
    uu = tables.u[None].expand(H, W).reshape(-1)
    vv = tables.v[:, None].expand(H, W).reshape(-1)
    Rc = tables.rot[c]
    return torch.stack([uu * Rc[0, j] + vv * Rc[1, j] + Rc[2, j]
                        for j in range(3)], dim=-1)


def render_views_plain(labels: torch.Tensor, tables: SceneTables,
                       free_id: int, max_steps: int) -> torch.Tensor:
    """(C, H, W, 3) uint8 views of the label grid ``labels`` (X, Y, Z):
    per camera, `dda_raymarch_plain` of its pixel rays, then the hit
    voxel's palette colour x distance shade x voxel texture, the sky row
    where nothing is hit, x 255, clamped and truncated."""
    C, H, W = tables.rot.shape[0], tables.v.shape[0], tables.u.shape[0]
    X, Y, Z = labels.shape
    occ = labels != free_id
    flat = labels.reshape(-1)
    sky = tables.sky[:, None].expand(H, W, 3).reshape(-1, 3)
    views = []
    for c in range(C):
        origin = tables.origin[c][None].expand(H * W, 3)
        dist, coord, hit = dda_raymarch_plain(occ, origin,
                                              camera_dirs(tables, c),
                                              max_steps)
        coord = coord.long()
        label = flat[(coord[:, 0] * Y + coord[:, 1]) * Z + coord[:, 2]].long()
        dist_m = dist * tables.voxel_size
        # a tensor divisor: CUDA multiplies by the reciprocal of a scalar
        e = torch.exp(-dist_m / torch.full_like(dist_m, 25.0))
        shade = fma(e, float(np.float32(0.65)), float(np.float32(0.35)))
        tex = tables.tex[(coord[:, 0] * 7 + coord[:, 1] * 13
                          + coord[:, 2] * 3) % 8]
        color = tables.palette[label] * (shade * tex)[:, None]
        img = torch.where(hit[:, None], color, sky)
        views.append(torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
                     .reshape(H, W, 3))
    return torch.stack(views)


def render_views_cuda(labels: torch.Tensor, tables: SceneTables,
                      free_id: int, max_steps: int) -> torch.Tensor:
    """`render_views_plain` as one launch of the CUDA kernel, all cameras.
    ``labels`` are uint8 class ids below ``len(palette)``: the kernel reads
    the palette at each hit's id unchecked, so the caller checks the ids
    (`data.synthetic.class_ids_u8`)."""
    X, Y, Z = labels.shape
    check_packed_grid(X, Y, Z, True, "render kernel")
    if labels.dtype != torch.uint8:
        raise ValueError(f"render kernel: labels must be uint8 class ids, "
                         f"got {labels.dtype}")
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"render kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
    C, H, W = tables.rot.shape[0], tables.v.shape[0], tables.u.shape[0]
    n_cls = tables.palette.shape[0]
    shapes = {"rot": (C, 3, 3), "origin": (C, 3), "u": (W,), "v": (H,),
              "tex": (8,), "sky": (H, 3), "palette": (n_cls, 3)}
    for name, shape in shapes.items():
        t = getattr(tables, name)
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"render kernel: expected contiguous float32 "
                             f"{name} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= free_id < 256 or n_cls > 256:
        raise ValueError(f"render kernel: class ids must fit uint8, got "
                         f"free_id {free_id}, {n_cls} classes")
    lab = labels.contiguous()
    img = torch.empty(C, H, W, 3, dtype=torch.uint8, device=dev)
    RENDER(lab.data_ptr(), free_id, X, Y, Z, max_steps,
           tables.rot.data_ptr(), tables.origin.data_ptr(),
           tables.u.data_ptr(), tables.v.data_ptr(), tables.tex.data_ptr(),
           tables.sky.data_ptr(), tables.palette.data_ptr(), img.data_ptr(),
           C, H, W, tables.voxel_size,
           torch.cuda.current_stream(dev).cuda_stream)
    return img


def render_views(labels: torch.Tensor, tables: SceneTables, free_id: int,
                 max_steps: int) -> torch.Tensor:
    """(C, H, W, 3) uint8 views: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if labels.is_cuda:
        return render_views_cuda(labels, tables, free_id, max_steps)
    if labels.device.type == "cpu":
        return render_views_plain(labels, tables, free_id, max_steps)
    raise ValueError(f"render_views: no implementation for {labels.device}")
