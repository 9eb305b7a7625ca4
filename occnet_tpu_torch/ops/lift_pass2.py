"""Pass-2 of the planar lift from a tmp slab: the CUDA kernel
(`csrc/lift_pass2.cu`) and its plain PyTorch version.

The counterpart of the JAX package's uncompacted `lift_pallas._pass2`
(Pallas kernel #7), whose only caller is the per-pass bench tool
(`occnet_tpu_torch/tools/bench_lift_passes.py` here).  Given the pass-1
output slabs tmpA (ZR_pad, A, w_pad, C) and tmpB (ZR_pad, A, h_pad, C) bf16,
the pass-2 positions pos2A / pos2B (ZR_pad, A, M) f32 (-2 = dead) and
inv_count (bev_h, 1, M) f32, it computes for the real rows zr < ZR

    out[zr, m, :] = inv_count[zr % bev_h, 0, m] * sum_a (
        sum_k hatA(pos2A[zr, a, m] - k) * tmpA[zr, a, k, :]
      + sum_k hatB(pos2B[zr, a, m] - k) * tmpB[zr, a, k, :])

with hat(d) = max(0, 1 - |d|) rounded to bf16 (`_hat_t`), fp32
accumulation and one rounding to ``out_dtype``.  Only the <= 2 taps of
nonzero weight are read: a NaN in a tmp row that no weight reaches stays
out of the output, where the TPU kernel's dense contraction would give
0 * NaN = NaN.  With finite tmp the two agree to the order of the fp32 sum.

`lift_pass2` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from occnet_tpu_torch.ops._build import I32, P, Kernel

LIFT_PASS2 = Kernel("occ_lift_pass2",
                    [P, P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32,
                     I32, P])


def _hat_bf16(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """bf16(max(0, 1 - |p - k|)) as fp32."""
    w = torch.clamp(1.0 - (p - k.to(torch.float32)).abs(), min=0.0)
    return w.to(torch.bfloat16).to(torch.float32)


def lift_pass2_plain(pos2A: torch.Tensor, pos2B: torch.Tensor,
                     inv_count: torch.Tensor, tmpA: torch.Tensor,
                     tmpB: torch.Tensor, ZR: int, bev_h: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Gather form of `lift_pallas._pass2`, summed in the kernel's order
    (cameras of order A, then of order B; tap floor(p), then floor(p) + 1):
    -> (ZR, M, C) in ``out_dtype``."""
    A, M = pos2A.shape[1], pos2A.shape[2]
    C = tmpA.shape[3]
    dev = tmpA.device
    acc = torch.zeros(ZR, M, C, dtype=torch.float32, device=dev)
    zr = torch.arange(ZR, device=dev)[:, None]
    for pos, tmp in ((pos2A, tmpA), (pos2B, tmpB)):
        K = tmp.shape[2]
        for a in range(A):
            p = pos[:ZR, a]                                 # (ZR, M)
            k0 = torch.floor(p).to(torch.int64)
            for dk in (0, 1):
                k = k0 + dk
                w = torch.where((k >= 0) & (k < K), _hat_bf16(p, k), 0.0)
                rows = tmp[zr, a, k.clamp(0, K - 1)].float()  # (ZR, M, C)
                acc += torch.where(w[..., None] != 0, w[..., None] * rows,
                                   0.0)
    inv = inv_count[:, 0][torch.arange(ZR, device=dev) % bev_h]  # (ZR, M)
    return (acc * inv[..., None]).to(out_dtype)


def lift_pass2_cuda(pos2A: torch.Tensor, pos2B: torch.Tensor,
                    inv_count: torch.Tensor, tmpA: torch.Tensor,
                    tmpB: torch.Tensor, ZR: int, bev_h: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """`lift_pass2_plain` as one launch of the CUDA kernel."""
    ZRp, A, w_pad, C = tmpA.shape
    h_pad = tmpB.shape[2]
    M = pos2A.shape[2]
    dev = tmpA.device
    if dev.type != "cuda":
        raise ValueError(f"lift_pass2 kernel: tensors must be on a CUDA "
                         f"device, got {dev}")
    checks = [
        (pos2A, torch.float32, (ZRp, A, M)),
        (pos2B, torch.float32, (ZRp, A, M)),
        (inv_count, torch.float32, (bev_h, 1, M)),
        (tmpA, torch.bfloat16, (ZRp, A, w_pad, C)),
        (tmpB, torch.bfloat16, (ZRp, A, h_pad, C)),
    ]
    for t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"lift_pass2 kernel: expected contiguous {dt} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32) or not 0 < ZR <= ZRp:
        raise ValueError(f"lift_pass2 kernel: bad out_dtype {out_dtype} or "
                         f"ZR {ZR} (ZR_pad {ZRp})")
    if C % 8 or C > 2048 or tmpA.data_ptr() % 16 or tmpB.data_ptr() % 16:
        raise ValueError(f"lift_pass2 kernel: C={C} must be a multiple of 8 "
                         f"<= 2048 with 16-byte aligned tmp slabs")
    out = torch.empty(ZR, M, C, dtype=out_dtype, device=dev)
    LIFT_PASS2(pos2A.data_ptr(), pos2B.data_ptr(), inv_count.data_ptr(),
               tmpA.data_ptr(), tmpB.data_ptr(), out.data_ptr(),
               int(out_dtype == torch.bfloat16), ZR, A, M, w_pad, h_pad, C,
               bev_h, torch.cuda.current_stream(dev).cuda_stream)
    return out


def lift_pass2(pos2A, pos2B, inv_count, tmpA, tmpB, ZR: int, bev_h: int,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if tmpA.is_cuda:
        return lift_pass2_cuda(pos2A, pos2B, inv_count, tmpA, tmpB, ZR,
                               bev_h, out_dtype)
    if tmpA.device.type == "cpu":
        return lift_pass2_plain(pos2A, pos2B, inv_count, tmpA, tmpB, ZR,
                                bev_h, out_dtype)
    raise ValueError(f"lift_pass2: no implementation for {tmpA.device}")
