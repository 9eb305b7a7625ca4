"""Dense TSA 3x3 tap attention: the CUDA kernel (`csrc/tap.cu`) and its
plain PyTorch version, the port of `occnet_tpu/ops/tsa_pallas.py`.

Per BEV position (y, x), head h and queue slot n:

    out[b, y, x, h*D+d] = (1/nq) * sum_{n,t} attn[b, y, x, n, t, h]
                                            * v[b, n, y - dy_t, x - dx_t, h*D+d]

— a spatially varying 3x3 filter over the (prev, current) BEV value grids,
zero-padded at the border.  `tap_attention` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from occnet_tpu_torch.ops._build import I32, P, Kernel

TSA_TAPS: Tuple[Tuple[int, int], ...] = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

TAP = Kernel("occ_tap_attention", [P, P, P, I32, I32, I32, I32, I32, I32,
                                   I32, P])


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded shift on (..., H, W, C): out[y, x] = in[y - dy, x - dx]."""
    h, w = x.shape[-3], x.shape[-2]
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    ys, xs = 1 - dy, 1 - dx
    return padded[..., ys: ys + h, xs: xs + w, :]


def tap_attention_plain(vgrid: torch.Tensor, attn: torch.Tensor
                        ) -> torch.Tensor:
    """vgrid (B, nq, H, W, C), attn (B, H, W, nq, T, heads) -> (B, H, W, C)
    fp32; the shift loop of `tap_attention_xla`, fp32 accumulation."""
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    D = C // heads
    acc = torch.zeros(B, H, W, heads, D, dtype=torch.float32,
                      device=vgrid.device)
    for t, (dy, dx) in enumerate(TSA_TAPS):
        shifted = _shift2d(vgrid, dy, dx).float().reshape(B, nq, H, W, heads,
                                                          D)
        w_t = attn[:, :, :, :, t, :].float()            # (B, H, W, nq, heads)
        acc = acc + torch.einsum("bnywhd,bywnh->bywhd", shifted, w_t)
    return (acc / nq).reshape(B, H, W, C)


def tap_attention_cuda(vgrid: torch.Tensor, attn: torch.Tensor
                       ) -> torch.Tensor:
    """`tap_attention_plain` as one launch of the CUDA kernel."""
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    if not vgrid.is_cuda:
        raise ValueError(f"tap kernel: tensors must be on a CUDA device, "
                         f"got {vgrid.device}")
    if attn.shape != (B, H, W, nq, len(TSA_TAPS), heads):
        raise ValueError(f"tap kernel: attn {tuple(attn.shape)} does not "
                         f"match vgrid {tuple(vgrid.shape)}")
    if vgrid.dtype not in (torch.bfloat16, torch.float32) \
            or attn.dtype != vgrid.dtype or attn.device != vgrid.device:
        raise ValueError(f"tap kernel: vgrid/attn must share one device and "
                         f"dtype bf16|f32, got {vgrid.dtype}/{attn.dtype}")
    if not (vgrid.is_contiguous() and attn.is_contiguous()):
        raise ValueError("tap kernel: inputs must be contiguous")
    if C % heads or (C // heads) % 4 or vgrid.data_ptr() % 16:
        raise ValueError(f"tap kernel: head width {C}/{heads} must be a "
                         f"multiple of 4 with 16-byte aligned vgrid")
    out = torch.empty(B, H, W, C, dtype=torch.float32, device=vgrid.device)
    TAP(vgrid.data_ptr(), attn.data_ptr(), out.data_ptr(),
        int(vgrid.dtype == torch.bfloat16), B, nq, H, W, C, heads,
        torch.cuda.current_stream(vgrid.device).cuda_stream)
    return out


def tap_attention(vgrid: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if vgrid.is_cuda:
        return tap_attention_cuda(vgrid, attn)
    if vgrid.device.type == "cpu":
        return tap_attention_plain(vgrid, attn)
    raise ValueError(f"tap attention: no implementation for {vgrid.device}")
