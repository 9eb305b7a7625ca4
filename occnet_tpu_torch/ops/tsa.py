"""Dense TSA 3x3 tap attention: the CUDA kernel (`csrc/tap.cu`) and its
plain PyTorch version, the port of `occnet_tpu/ops/tsa_pallas.py`.

Per BEV position (y, x), head h and queue slot n:

    out[b, y, x, h*D+d] = (1/nq) * sum_{n,t} attn[b, y, x, n, t, h]
                                            * v[b, n, y - dy_t, x - dx_t, h*D+d]

— a spatially varying 3x3 filter over the (prev, current) BEV value grids,
zero-padded at the border.  Its gradient is the closed form of the JAX
package's `tsa_pallas._tap_attention_bwd`:

    dv[b, n, y, x, c]       = (1/nq) * sum_t attn[b, y+dy, x+dx, n, t, h(c)]
                                           * g[b, y+dy, x+dx, c]
    dattn[b, y, x, n, t, h] = (1/nq) * sum_d v[b, n, y-dy, x-dx, hD+d]
                                           * g[b, y, x, hD+d]

(`csrc/tap_bwd.cu` on the card).  `tap_attention` is differentiable and
launches the kernels for CUDA tensors, the plain versions for CPU tensors.
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
TAP_BWD = Kernel("occ_tap_attention_bwd", [P, P, P, P, P, I32, I32, I32, I32,
                                           I32, I32, I32, P])


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
    """`tap_attention_plain` as one launch of the CUDA kernel (tiles of BEV
    cells staged in shared memory with their halo).  Raises ValueError on
    shapes the tiles cannot take (see `_check_tap_inputs`)."""
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    _check_tap_inputs("tap", vgrid, attn)
    out = torch.empty(B, H, W, C, dtype=torch.float32, device=vgrid.device)
    TAP(vgrid.data_ptr(), attn.data_ptr(), out.data_ptr(),
        int(vgrid.dtype == torch.bfloat16), B, nq, H, W, C, heads,
        torch.cuda.current_stream(vgrid.device).cuda_stream)
    return out


def tap_attention_bwd_plain(vgrid: torch.Tensor, attn: torch.Tensor,
                            g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form VJP, the shift loop of `tsa_pallas._tap_attention_bwd`:
    g (B, H, W, C) -> (dv in vgrid.dtype, dattn in attn.dtype), fp32 math."""
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    D = C // heads
    gh = g.float().reshape(B, H, W, heads, D)
    dv = torch.zeros(B, nq, H, W, C, dtype=torch.float32, device=g.device)
    dattn = []
    for t, (dy, dx) in enumerate(TSA_TAPS):
        w_t = attn[:, :, :, :, t, :].float()            # (B, H, W, nq, heads)
        wg = torch.einsum("bywnh,bywhd->bnywhd", w_t, gh)
        dv = dv + _shift2d(wg.reshape(B, nq, H, W, C), -dy, -dx)
        sv = _shift2d(vgrid.float(), dy, dx).reshape(B, nq, H, W, heads, D)
        dattn.append(torch.einsum("bnywhd,bywhd->bywnh", sv, gh))
    dattn = torch.stack(dattn, dim=4)                  # (B, H, W, nq, T, hd)
    return (dv / nq).to(vgrid.dtype), (dattn / nq).to(attn.dtype)


def tap_attention_bwd_cuda(vgrid: torch.Tensor, attn: torch.Tensor,
                           g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`tap_attention_bwd_plain` as one launch of the CUDA kernel (dv and
    dattn together, on the current stream)."""
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    _check_tap_inputs("tap_bwd", vgrid, attn)
    if g.device != vgrid.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (B, H, W, C) or not g.is_contiguous():
        raise ValueError(f"tap_bwd kernel: expected a contiguous float32 "
                         f"gradient {(B, H, W, C)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if g.data_ptr() % 16:
        raise ValueError("tap_bwd kernel: g must be 16-byte aligned")
    dv = torch.empty_like(vgrid)
    dattn = torch.empty_like(attn)
    TAP_BWD(vgrid.data_ptr(), attn.data_ptr(), g.data_ptr(), dv.data_ptr(),
            dattn.data_ptr(), int(vgrid.dtype == torch.bfloat16), B, nq, H,
            W, C, heads, torch.cuda.current_stream(vgrid.device).cuda_stream)
    return dv, dattn


def _check_tap_inputs(name, vgrid, attn):
    B, nq, H, W, C = vgrid.shape
    heads = attn.shape[-1]
    if not vgrid.is_cuda:
        raise ValueError(f"{name} kernel: tensors must be on a CUDA device, "
                         f"got {vgrid.device}")
    if attn.shape != (B, H, W, nq, len(TSA_TAPS), heads):
        raise ValueError(f"{name} kernel: attn {tuple(attn.shape)} does not "
                         f"match vgrid {tuple(vgrid.shape)}")
    if vgrid.dtype not in (torch.bfloat16, torch.float32) \
            or attn.dtype != vgrid.dtype or attn.device != vgrid.device:
        raise ValueError(f"{name} kernel: vgrid/attn must share one device "
                         f"and dtype bf16|f32, got {vgrid.dtype}/"
                         f"{attn.dtype}")
    if not (vgrid.is_contiguous() and attn.is_contiguous()):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    D = C // heads
    row_bytes = nq * len(TSA_TAPS) * heads * vgrid.element_size()
    if C % heads or C % 64 or D % 8 or 64 % D or row_bytes % 16 or nq > 2:
        raise ValueError(f"{name} kernel: C = {C} must be a multiple of "
                         f"64, the head width {C}/{heads} a multiple of 8 "
                         f"dividing 64, an attn row ({nq} x 9 x {heads} "
                         f"values) a multiple of 16 bytes, and at most 2 "
                         f"queue slots")
    if vgrid.data_ptr() % 16 or attn.data_ptr() % 16:
        raise ValueError(f"{name} kernel: vgrid and attn must be 16-byte "
                         f"aligned")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tap attention: no implementation for {t.device}")


def tap_attention_fwd(vgrid: torch.Tensor, attn: torch.Tensor
                      ) -> torch.Tensor:
    """The forward without autograd: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _on_cuda(vgrid):
        return tap_attention_cuda(vgrid, attn)
    return tap_attention_plain(vgrid, attn)


def tap_attention_bwd(vgrid: torch.Tensor, attn: torch.Tensor,
                      g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward (dv, dattn) for the fp32 gradient ``g``: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    g = g.float().contiguous()
    if _on_cuda(vgrid):
        return tap_attention_bwd_cuda(vgrid, attn, g)
    return tap_attention_bwd_plain(vgrid, attn, g)


class _TapAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vgrid, attn):
        ctx.save_for_backward(vgrid, attn)
        return tap_attention_fwd(vgrid, attn)

    @staticmethod
    def backward(ctx, g):
        return tap_attention_bwd(*ctx.saved_tensors, g)


def tap_attention(vgrid: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    differentiable in both inputs through the matching backward."""
    return _TapAttention.apply(vgrid, attn)
