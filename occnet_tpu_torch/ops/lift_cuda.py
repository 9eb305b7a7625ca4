"""One level of the planar lift: the CUDA kernel (`csrc/lift.cu`) and its
plain PyTorch version.

Both take the fp32 positions built by `planar_lift.level_geometry` and
compute, per batch element b, z-row zr (= z * bev_h + row) and BEV column m:

    out[b, zr, m, :] = inv_count[b, row, m] * sum_cam
        sum_{k in taps(pos2)} hat(pos2 - k)
        * sum_{j in taps(pos1[k])} hat(pos1[k] - j) * feat[pixel(k, j), :]

where `taps(p)` are floor(p) and floor(p) + 1 restricted to the axis extent
(grid_sample zero padding), k runs along the row's image line (image x in
pass order A, image y in order B, per (cam, z, row) by `steep`) and j across
it.  A position of -2 is dead.  Features are rounded to bf16 and everything
else is fp32 (the JAX einsum lift also rounds its hat weights and pass-1
intermediate to bf16, so the two differ by a few bf16 steps).

The backward (`lift_level_bwd`) is the exact transpose: each output cell
sends ``g * inv_count * weight`` back to the <= 4 feature pixels of every
camera that sees it, accumulated in fp32 and returned in bf16 like the JAX
package's `lift_pallas._lift_level_bwd`.  The plain version scatters; the
kernel gathers, each feature pixel from the cells that reach it, through the
transposed index `lift_bwd_index`.

`lift_level` / `lift_level_bwd` launch the kernel for CUDA tensors and run the
plain version for CPU tensors; they never fall back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from occnet_tpu_torch.ops._build import I32, I64, P, Kernel

LIFT = Kernel("occ_lift_level",
              [P, P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32,
               I64, P])
LIFT_BWD = Kernel("occ_lift_level_bwd", [P] * 6 + [I32] * 11 + [I64, P])
LIFT_BWD_INDEX = Kernel("occ_lift_bwd_index", [P] * 5 + [I32] * 6 + [P])


def _taps(pos1, pos2, steep, a, h, w):
    """The <= 4 (weight, pixel) taps of camera ``a`` for every output cell,
    with the sampler's skip rules (dead position, tap outside the axis):
    yields (wt (B, ZR*M) f32, zero where skipped; pix (B, ZR*M) int64,
    0 where skipped)."""
    B, _, ZR, M = pos2.shape
    dev = pos2.device
    p2 = pos2[:, a].reshape(B, ZR * M)
    st = steep[:, a][:, :, None].expand(B, ZR, M).reshape(B, ZR * M)
    n2 = torch.where(st, h, w)
    n1 = torch.where(st, w, h)
    k0 = torch.floor(p2)
    f2 = p2 - k0
    k0 = k0.to(torch.int64)
    # pass-1 positions of each pass-2 tap, at the tap's own line height
    p1rows = pos1[:, a].reshape(B * ZR, w + h)
    row_base = (torch.arange(B * ZR, device=dev) * (w + h)
                ).reshape(B, ZR, 1).expand(B, ZR, M).reshape(B, ZR * M)
    row_base = row_base + torch.where(st, w, 0)
    for dk in (0, 1):
        k = k0 + dk
        ok2 = (k >= 0) & (k < n2)
        w2 = f2 if dk else 1.0 - f2
        p1 = p1rows.reshape(-1)[
            row_base + torch.minimum(k.clamp(min=0), n2 - 1)]
        j0 = torch.floor(p1)
        f1 = p1 - j0
        j0 = j0.to(torch.int64)
        for dj in (0, 1):
            j = j0 + dj
            ok = ok2 & (j >= 0) & (j < n1)
            wt = torch.where(ok, w2 * (f1 if dj else 1.0 - f1), 0.0)
            y = torch.where(st, k, j)
            x = torch.where(st, j, k)
            yield wt, torch.where(ok, y * w + x, 0)


def _cell_inv_count(inv_count, B, ZR, M):
    """(B, R * M) per-query 1/count -> (B, ZR * M, 1) per output cell."""
    R = inv_count.shape[1] // M
    return inv_count.reshape(B, 1, R, M).expand(B, ZR // R, R, M).reshape(
        B, ZR * M, 1)


def lift_level_plain(feat: torch.Tensor, pos1: torch.Tensor,
                     pos2: torch.Tensor, steep: torch.Tensor,
                     inv_count: torch.Tensor, out: torch.Tensor) -> None:
    """Gather form of the level lift, written into ``out`` (B, ZR, M, C).

    feat (B, A, h, w, C); pos1 (B, A, ZR, w + h); pos2 (B, A, ZR, M);
    steep (B, A, ZR) bool; inv_count (B, R * M).  Loops over cameras so the
    working set stays at a few (B, ZR*M, C) fp32 buffers at full width.

    The sum runs in a fixed order, camera ascending, then dk, then dj, each
    step ``acc + (w2 * w1) * f`` in separate fp32 roundings, then ``acc *
    inv_count`` and one rounding on the copy into ``out``; the kernel
    repeats it, so the two are bitwise equal."""
    B, A, h, w, C = feat.shape
    ZR, M = pos2.shape[2], pos2.shape[3]
    bidx = torch.arange(B, device=feat.device)[:, None]
    acc = torch.zeros(B, ZR * M, C, dtype=torch.float32, device=feat.device)
    for a in range(A):
        f = feat[:, a].to(torch.bfloat16).reshape(B, h * w, C)
        for wt, pix in _taps(pos1, pos2, steep, a, h, w):
            acc += wt[..., None] * f[bidx, pix].float()
    acc *= _cell_inv_count(inv_count, B, ZR, M)
    out.copy_(acc.reshape(out.shape))


def lift_level_cuda(feat: torch.Tensor, pos1: torch.Tensor,
                    pos2: torch.Tensor, steep: torch.Tensor,
                    inv_count: torch.Tensor, out: torch.Tensor) -> None:
    """`lift_level_plain` as one launch of the CUDA kernel, bitwise equal to
    it (same fp32 operations in the same order).  ``out`` may be a strided
    view (B, ZR, M, C) with contiguous (ZR, M, C) per batch element, e.g.
    one level of the stacked (B, L, Z, Q, C) lift output."""
    B, A, h, w, C = feat.shape
    ZR, M = pos2.shape[2], pos2.shape[3]
    R = inv_count.shape[1] // M
    dev = feat.device
    if dev.type != "cuda":
        raise ValueError(f"lift kernel: tensors must be on a CUDA device, "
                         f"got {dev}")
    checks = [
        (feat, torch.bfloat16, (B, A, h, w, C)),
        (pos1, torch.float32, (B, A, ZR, w + h)),
        (pos2, torch.float32, (B, A, ZR, M)),
        (steep, torch.bool, (B, A, ZR)),
        (inv_count, torch.float32, (B, R * M)),
    ]
    for t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"lift kernel: expected contiguous {dt} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if out.device != dev or out.dtype not in (torch.bfloat16, torch.float32) \
            or tuple(out.shape) != (B, ZR, M, C) \
            or out[0].stride() != (M * C, C, 1):
        raise ValueError(f"lift kernel: bad output {out.dtype} "
                         f"{tuple(out.shape)} {out.stride()}")
    if C % 8 or ZR % R or ZR // R > 256 or feat.data_ptr() % 16 \
            or out.data_ptr() % 16 or out.stride(0) % 8:
        raise ValueError(f"lift kernel: C={C} must be a multiple of 8, "
                         f"at most 256 z-anchors (ZR={ZR}, R={R}), with "
                         f"16-byte aligned feat/out rows")
    LIFT(feat.data_ptr(), pos1.data_ptr(), pos2.data_ptr(),
         steep.data_ptr(), inv_count.data_ptr(), out.data_ptr(),
         int(out.dtype == torch.bfloat16), B, A, h, w, C, ZR, R, M,
         out.stride(0), torch.cuda.current_stream(dev).cuda_stream)


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl != "auto":
        return impl
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"lift: no implementation for {t.device}")


def lift_level(feat, pos1, pos2, steep, inv_count, out,
               impl: str = "auto") -> None:
    """Dispatch: "auto" = the kernel for CUDA tensors, the plain version
    for CPU tensors; "cuda" / "plain" force one."""
    impl = _resolve(impl, feat)
    if impl == "cuda":
        lift_level_cuda(feat, pos1, pos2, steep, inv_count, out)
    elif impl == "plain":
        lift_level_plain(feat, pos1, pos2, steep, inv_count, out)
    else:
        raise ValueError(f"unknown lift impl {impl!r}")


def lift_level_bwd_plain(g: torch.Tensor, pos1: torch.Tensor,
                         pos2: torch.Tensor, steep: torch.Tensor,
                         inv_count: torch.Tensor, hw,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Transpose of `lift_level_plain`: g (B, ZR, M, C) -> dfeat
    (B, A, h, w, C) in ``out_dtype`` (bf16 as the JAX package returns it;
    fp32 for exact adjoint checks), scattered in fp32 with ``index_add_``.
    Each cell's g * inv_count (one fp32 rounding) times each tap weight is
    added to the tap's feature pixel; skipped taps add exact zeros to pixel
    0."""
    B, ZR, M, C = g.shape
    A = pos2.shape[1]
    h, w = hw
    dev = g.device
    gi = g.float().reshape(B, ZR * M, C) * _cell_inv_count(inv_count, B, ZR,
                                                           M)
    dfeat = torch.zeros(B * A * h * w, C, dtype=torch.float32, device=dev)
    bbase = torch.arange(B, device=dev)[:, None] * (A * h * w)
    for a in range(A):
        for wt, pix in _taps(pos1, pos2, steep, a, h, w):
            dfeat.index_add_(0, (bbase + a * h * w + pix).reshape(-1),
                             (wt[..., None] * gi).reshape(-1, C))
    return dfeat.reshape(B, A, h, w, C).to(out_dtype)


class LiftBwdIndex(NamedTuple):
    """The transposed index of one level's lift, for `csrc/lift_bwd.cu`.

    A line is one (b, camera, kk) with kk < w the image column x = kk (pass
    order A: its pixels run down the column, j = image row) and kk >= w the
    image row y = kk - w (order B: j = image column).  ``runs[b, a, kk, zr]``
    holds, for the plane zr (camera, z-anchor, BEV row), the run [m_lo,
    m_hi) of BEV columns whose pass-2 hat reaches the line's tap (floor(pos2)
    = tap or tap - 1; packed as m_lo | m_hi << 16, 0 when no cell does) and
    the plane's pass-1 position pos1[b, a, zr, kk] (as int32 bits), which
    places the plane's line across the tap.  A plane of the other order has
    no run on the line.

    ``excess`` holds the (cell, tap) pairs the runs cover beyond the live
    taps, on the host (behind the event ``ready`` for a CUDA index);
    `check` reads it."""
    runs: torch.Tensor       # (B, A, w + h, ZR, 2) int32
    shape: tuple             # (B, A, ZR, M, h, w) of the level
    excess: torch.Tensor     # (1,) int64 on the host
    ready: Optional[object]  # torch.cuda.Event, None for CPU tensors

    def check(self) -> None:
        """Raise ValueError if the index's premise failed."""
        if self.ready is not None:
            self.ready.synchronize()
        excess = int(self.excess[0])
        if excess != 0:
            raise ValueError(
                f"lift_bwd index: the runs of BEV columns reaching each tap "
                f"cover {excess} (cell, tap) pairs more than are live: a "
                f"plane's live cells are not one monotone run of pos2")


def lift_bwd_index_plain(pos1: torch.Tensor, pos2: torch.Tensor,
                         steep: torch.Tensor, hw):
    """(runs, excess) of `LiftBwdIndex` in plain PyTorch: each run as the
    smallest and largest m whose pass-2 hat reaches the tap (a dead position
    p <= -1 and a tap outside the line skipped, as the sampler skips
    them)."""
    B, A, ZR, M = pos2.shape
    h, w = hw
    K1 = w + h
    P = B * A * ZR
    dev = pos2.device
    p2 = pos2.reshape(P, M)
    st = steep.reshape(P, 1)
    k0 = torch.floor(p2).to(torch.int64)
    k = torch.stack([k0, k0 + 1])                     # (2, P, M)
    ok = (p2 > -1.0) & (k >= 0) & (k < torch.where(st, h, w))
    m = torch.arange(M, device=dev, dtype=torch.int32)
    slot = (torch.arange(P, device=dev)[:, None] * K1
            + torch.where(ok, k + torch.where(st, w, 0), 0)).reshape(-1)
    lo = torch.full((P * K1,), M, dtype=torch.int32, device=dev)
    hi = torch.full((P * K1,), -1, dtype=torch.int32, device=dev)
    lo.scatter_reduce_(0, slot, torch.where(ok, m, M).reshape(-1), "amin")
    hi.scatter_reduce_(0, slot, torch.where(ok, m, -1).reshape(-1), "amax")
    run = hi >= lo
    excess = torch.where(run, hi - lo + 1, 0).sum() - ok.sum()
    packed = torch.where(run, lo | ((hi + 1) << 16), 0)
    runs = torch.stack([packed.reshape(P, K1),
                        pos1.reshape(P, K1).view(torch.int32)], dim=-1)
    return (runs.reshape(B, A, ZR, K1, 2).transpose(2, 3).contiguous(),
            excess.reshape(1))


def lift_bwd_index_cuda(pos1: torch.Tensor, pos2: torch.Tensor,
                        steep: torch.Tensor, hw):
    """`lift_bwd_index_plain` as one launch of `occ_lift_bwd_index` (a warp
    a plane); the excess stays on the device."""
    B, A, ZR, M = pos2.shape
    h, w = hw
    dev = pos2.device
    if dev.type != "cuda":
        raise ValueError(f"lift_bwd index kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    for t, dt, shape in ((pos1, torch.float32, (B, A, ZR, w + h)),
                         (pos2, torch.float32, (B, A, ZR, M)),
                         (steep, torch.bool, (B, A, ZR))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"lift_bwd index kernel: expected contiguous "
                             f"{dt} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if M >= 1 << 15:
        raise ValueError(f"lift_bwd index kernel: M = {M} BEV columns must "
                         f"be < 32768")
    runs = torch.empty(B, A, w + h, ZR, 2, dtype=torch.int32, device=dev)
    excess = torch.zeros(1, dtype=torch.int64, device=dev)
    LIFT_BWD_INDEX(pos1.data_ptr(), pos2.data_ptr(), steep.data_ptr(),
                   runs.data_ptr(), excess.data_ptr(), B, A, ZR, M, h, w,
                   torch.cuda.current_stream(dev).cuda_stream)
    return runs, excess


def lift_bwd_index(pos1: torch.Tensor, pos2: torch.Tensor,
                   steep: torch.Tensor, hw, impl: str = "auto"
                   ) -> LiftBwdIndex:
    """Build the `LiftBwdIndex` of one level from the forward's geometry:
    the kernel for CUDA tensors (its excess copied to pinned memory behind
    an event, so nothing waits for the card here), the plain version for
    CPU tensors.

    It rests on the lift's geometry: within a plane, pos2 along the BEV
    column m is one Moebius function of m over one interval of live cells,
    so the cells whose pass-2 hat reaches a tap are one contiguous run of m.
    `LiftBwdIndex.check` raises ValueError if the runs cover more (cell,
    tap) pairs than are live, and for CPU tensors `lift_bwd_index` calls it
    at once."""
    B, A, ZR, M = pos2.shape
    h, w = hw
    impl = _resolve(impl, pos2)
    if impl == "cuda":
        runs, excess = lift_bwd_index_cuda(pos1, pos2, steep, hw)
        host = torch.empty(1, dtype=torch.int64, pin_memory=True)
        host.copy_(excess, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return LiftBwdIndex(runs, (B, A, ZR, M, h, w), host, ready)
    if impl != "plain":
        raise ValueError(f"unknown lift impl {impl!r}")
    runs, excess = lift_bwd_index_plain(pos1, pos2, steep, hw)
    index = LiftBwdIndex(runs, (B, A, ZR, M, h, w), excess, None)
    index.check()
    return index


# a lift_bwd block of 256 threads takes one line and 8 * cg of its channels
# in groups of cg lanes: the widest groups that still give a level this many
# blocks, so that every SM has work while each block's fixed cost (loading
# and sorting its line's planes) is paid as few times as possible: 32 / 16 /
# 8 / 4 lanes at the four turbo_occ levels at B = 1.
_MIN_BLOCKS = 1600


def lift_level_bwd_cuda(g: torch.Tensor, pos1: torch.Tensor,
                        pos2: torch.Tensor, steep: torch.Tensor,
                        inv_count: torch.Tensor, hw,
                        out_dtype: torch.dtype = torch.bfloat16,
                        index: Optional[LiftBwdIndex] = None
                        ) -> torch.Tensor:
    """`lift_level_bwd_plain` as one call of the CUDA kernel (two launches
    in stream order, pass order A then B, every output element written by
    one thread, no atomics).  ``g`` (B, ZR, M, C) bf16 or fp32 may be a
    strided view with contiguous (ZR, M, C) per batch element, e.g. one
    level of the stacked (B, L, Z, Q, C) gradient.  ``index`` is the
    level's `lift_bwd_index` (built here when not given); it raises if the
    index's premise failed."""
    B, ZR, M, C = g.shape
    A = pos2.shape[1]
    h, w = hw
    R = inv_count.shape[1] // M
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"lift_bwd kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    checks = [
        (pos1, torch.float32, (B, A, ZR, w + h)),
        (pos2, torch.float32, (B, A, ZR, M)),
        (steep, torch.bool, (B, A, ZR)),
        (inv_count, torch.float32, (B, R * M)),
    ]
    for t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"lift_bwd kernel: expected contiguous {dt} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if g.dtype not in (torch.bfloat16, torch.float32) \
            or g[0].stride() != (M * C, C, 1):
        raise ValueError(f"lift_bwd kernel: bad gradient {g.dtype} "
                         f"{tuple(g.shape)} {g.stride()}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lift_bwd kernel: output bf16 or fp32, got "
                         f"{out_dtype}")
    if C % 8 or ZR % R or g.data_ptr() % 16 or g.stride(0) % 8:
        raise ValueError(f"lift_bwd kernel: C={C} must be a multiple of 8 "
                         f"with a 16-byte aligned gradient")
    if index is None:
        index = lift_bwd_index(pos1, pos2, steep, hw, impl="cuda")
    if index.runs.device != dev or index.shape != (B, A, ZR, M, h, w):
        raise ValueError(f"lift_bwd kernel: the index of level "
                         f"{index.shape} is not this level's "
                         f"{(B, A, ZR, M, h, w)}")
    index.check()
    widths = [n for n in (32, 16, 8, 4, 2, 1) if (C // 8) % n == 0]
    cg = next((n for n in widths
               if B * A * (w + h) * (C // (8 * n)) >= _MIN_BLOCKS),
              widths[-1])
    # no zeros needed: order A writes every pixel of the fp32 scratch, order
    # B reads it and writes every pixel of the output (in place for fp32)
    out = torch.empty(B, A, h, w, C, dtype=out_dtype, device=dev)
    tmp = out if out_dtype == torch.float32 else torch.empty(
        B, A, h, w, C, dtype=torch.float32, device=dev)
    LIFT_BWD(g.data_ptr(), pos2.data_ptr(), inv_count.data_ptr(),
             index.runs.data_ptr(), tmp.data_ptr(), out.data_ptr(),
             int(g.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
             B, A, h, w, C, ZR, R, M, cg, g.stride(0),
             torch.cuda.current_stream(dev).cuda_stream)
    return out


def lift_level_bwd(g, pos1, pos2, steep, inv_count, hw,
                   impl: str = "auto", out_dtype=torch.bfloat16,
                   index: Optional[LiftBwdIndex] = None) -> torch.Tensor:
    """Dispatch as `lift_level`: the kernel for CUDA tensors (through
    ``index``, built when not given), the plain version for CPU tensors."""
    impl = _resolve(impl, g)
    if impl == "cuda":
        return lift_level_bwd_cuda(g, pos1, pos2, steep, inv_count, hw,
                                   out_dtype, index)
    if impl == "plain":
        return lift_level_bwd_plain(g, pos1, pos2, steep, inv_count, hw,
                                    out_dtype)
    raise ValueError(f"unknown lift impl {impl!r}")
