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
is accumulated in fp32, the rounding points of the JAX einsum lift.

`lift_level` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from occnet_tpu_torch.ops._build import I32, I64, P, Kernel

LIFT = Kernel("occ_lift_level",
              [P, P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32,
               I64, P])


def lift_level_plain(feat: torch.Tensor, pos1: torch.Tensor,
                     pos2: torch.Tensor, steep: torch.Tensor,
                     inv_count: torch.Tensor, out: torch.Tensor) -> None:
    """Gather form of the level lift, written into ``out`` (B, ZR, M, C).

    feat (B, A, h, w, C); pos1 (B, A, ZR, w + h); pos2 (B, A, ZR, M);
    steep (B, A, ZR) bool; inv_count (B, R * M).  Loops over cameras so the
    working set stays at a few (B, ZR*M, C) fp32 buffers at full width."""
    B, A, h, w, C = feat.shape
    ZR, M = pos2.shape[2], pos2.shape[3]
    R = inv_count.shape[1] // M
    bidx = torch.arange(B, device=feat.device)[:, None]
    acc = torch.zeros(B, ZR * M, C, dtype=torch.float32, device=feat.device)
    for a in range(A):
        f = feat[:, a].to(torch.bfloat16).reshape(B, h * w, C)
        p2 = pos2[:, a].reshape(B, ZR * M)
        st = steep[:, a][:, :, None].expand(B, ZR, M).reshape(B, ZR * M)
        n2 = torch.where(st, h, w)
        n1 = torch.where(st, w, h)
        k0 = torch.floor(p2)
        f2 = p2 - k0
        k0 = k0.to(torch.int64)
        # pass-1 positions of each pass-2 tap, at the tap's own line height
        p1rows = pos1[:, a].reshape(B * ZR, w + h)
        row_base = (torch.arange(B * ZR, device=feat.device) * (w + h)
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
                pix = torch.where(ok, y * w + x, 0)
                acc += wt[..., None] * f[bidx, pix].float()
    acc *= inv_count.reshape(B, 1, R, M).expand(B, ZR // R, R, M).reshape(
        B, ZR * M, 1)
    out.copy_(acc.reshape(out.shape))


def lift_level_cuda(feat: torch.Tensor, pos1: torch.Tensor,
                    pos2: torch.Tensor, steep: torch.Tensor,
                    inv_count: torch.Tensor, out: torch.Tensor) -> None:
    """`lift_level_plain` as one launch of the CUDA kernel.  ``out`` may be a
    strided view (B, ZR, M, C) with contiguous (ZR, M, C) per batch element,
    e.g. one level of the stacked (B, L, Z, Q, C) lift output."""
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
    if C % 8 or C > 2048 or ZR % R or feat.data_ptr() % 16 \
            or out.data_ptr() % 16:
        raise ValueError(f"lift kernel: C={C} must be a multiple of 8 "
                         f"<= 2048 with 16-byte aligned feat/out")
    LIFT(feat.data_ptr(), pos1.data_ptr(), pos2.data_ptr(),
         steep.data_ptr(), inv_count.data_ptr(), out.data_ptr(),
         int(out.dtype == torch.bfloat16), B, A, h, w, C, ZR, R, M,
         out.stride(0), torch.cuda.current_stream(dev).cuda_stream)


def lift_level(feat, pos1, pos2, steep, inv_count, out,
               impl: str = "auto") -> None:
    """Dispatch: "auto" = the kernel for CUDA tensors, the plain version
    for CPU tensors; "cuda" / "plain" force one."""
    if impl == "auto":
        if feat.is_cuda:
            impl = "cuda"
        elif feat.device.type == "cpu":
            impl = "plain"
        else:
            raise ValueError(f"lift: no implementation for {feat.device}")
    if impl == "cuda":
        lift_level_cuda(feat, pos1, pos2, steep, inv_count, out)
    elif impl == "plain":
        lift_level_plain(feat, pos1, pos2, steep, inv_count, out)
    else:
        raise ValueError(f"unknown lift impl {impl!r}")
