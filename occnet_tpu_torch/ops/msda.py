"""Multi-scale deformable attention sampling: the CUDA kernel (`csrc/msda.cu`)
and its plain PyTorch version, the port of `occnet_tpu/ops/msda.py` and of the
Pallas kernels of `occnet_tpu/ops/msda_pallas.py`.

Contract of `multi_scale_deformable_attention` (the JAX package's):

    value (B, V, H, D), the L pyramid levels flattened row-major along V;
    loc   (B, Q, H, L, P, 2) normalised xy in [0, 1] (any value is allowed);
    attn  (B, Q, H, L, P), softmaxed over L*P;
    -> out (B, Q, H*D) in value's dtype, with

    out[b, q, h*D + d] = sum_{l, p} attn[b, q, h, l, p]
                         * bilinear(value_l[b, :, h, d], loc[b, q, h, l, p])

where `bilinear` is grid_sample with bilinear interpolation, zero padding and
align_corners=False: x = loc_x * w - 0.5, y = loc_y * h - 0.5, and a corner
outside the level adds nothing.  Corner weights and attention stay fp32 (the
packed form and the Pallas kernels do not round the attention to the value
dtype, unlike the JAX per-corner reference), sums are fp32, and the output is
rounded once to the value dtype (the plain version sums per level and
corner, the points through one PyTorch sum, and the kernel follows that
order).  The JAX function switches to its per-corner form for levels under 2
cells; in fp32 that form computes the same thing, and the tests keep bf16
values off such levels.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors, never falling back from one to the other.  The CUDA path is
forward-only: it raises on inputs that require grad (the MSDA backward kernel
comes with exact-mode training).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from occnet_tpu_torch.ops._build import I32, P, Kernel

MAX_LEVELS = 4
MSDA = Kernel("occ_msda", [P, P, P, P, ctypes.POINTER(ctypes.c_int), I32,
                           I32, I32, I32, I32, I32, I32, I32, P])

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def msda_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
               loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The contract above in plain PyTorch, level by level and corner by
    corner: gather the clipped corner rows, weight by bilinear x attention
    (fp32), sum over points."""
    B, V, H, D = value.shape
    Q, Pn = loc.shape[1], loc.shape[4]
    _check_shapes(value, spatial_shapes, loc, attn)
    dev = value.device
    rows = value.permute(0, 2, 1, 3).reshape(B * H * V, D).float()
    bh_base = (torch.arange(B * H, device=dev) * V)[:, None]   # (BH, 1)
    out = torch.zeros(B * H, Q, D, dtype=torch.float32, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        ll = loc[:, :, :, lvl].float().permute(0, 2, 1, 3, 4).reshape(
            B * H, Q * Pn, 2)
        a = attn[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(
            B * H, Q * Pn)
        # clamping far-away samples to just outside the level keeps the
        # float->int conversion defined and leaves every weight unchanged
        x = (ll[..., 0] * w - 0.5).clamp(-2.0, w + 1.0)
        y = (ll[..., 1] * h - 0.5).clamp(-2.0, h + 1.0)
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        for dy, dx in _CORNERS:
            cx, cy = x0 + dx, y0 + dy
            valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            wgt = (ty if dy else 1.0 - ty) * (tx if dx else 1.0 - tx) * a
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            idx = bh_base + start + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
            g = rows[idx.reshape(-1)].reshape(B * H, Q, Pn, D)
            out += (g * wgt.reshape(B * H, Q, Pn, 1)).sum(dim=2)
        start += h * w
    out = out.reshape(B, H, Q, D).permute(0, 2, 1, 3).reshape(B, Q, H * D)
    return out.to(value.dtype)


def msda_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """`msda_plain` as one launch of the CUDA kernel (forward only)."""
    B, V, H, D = value.shape
    Q, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_shapes(value, spatial_shapes, loc, attn)
    if any(t.requires_grad for t in (value, loc, attn)):
        raise ValueError("msda kernel: forward only, inputs must not require "
                         "grad (exact-mode training is not ported yet)")
    if not value.is_cuda:
        raise ValueError(f"msda kernel: tensors must be on a CUDA device, "
                         f"got {value.device}")
    if value.dtype not in (torch.bfloat16, torch.float32) \
            or loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise ValueError(f"msda kernel: value bf16|f32 and fp32 loc/attn, "
                         f"got {value.dtype}/{loc.dtype}/{attn.dtype}")
    if loc.device != value.device or attn.device != value.device:
        raise ValueError("msda kernel: value, loc and attn must share one "
                         "device")
    if not (value.is_contiguous() and loc.is_contiguous()
            and attn.is_contiguous()):
        raise ValueError("msda kernel: inputs must be contiguous")
    if L > MAX_LEVELS:
        raise ValueError(f"msda kernel: at most {MAX_LEVELS} levels, got {L}")
    vec = 16 // value.element_size()      # channels of one 16-byte load
    if D % vec or 32 % (D // vec) or value.data_ptr() % 16:
        raise ValueError(f"msda kernel: a head's D = {D} channels must be "
                         f"a multiple of {vec} ({value.dtype}) with "
                         f"32 / (D / {vec}) whole, and value 16-byte aligned")
    hw = (ctypes.c_int * (2 * MAX_LEVELS))(
        *[int(s) for hw_ in spatial_shapes for s in hw_],
        *([0] * (2 * (MAX_LEVELS - L))))
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    MSDA(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
         hw, int(value.dtype == torch.bfloat16), B, V, Q, H, D, L, Pn,
         torch.cuda.current_stream(value.device).cuda_stream)
    return out


def _check_shapes(value, spatial_shapes, loc, attn):
    B, V, H, D = value.shape
    L = len(spatial_shapes)
    if loc.ndim != 6 or loc.shape[0] != B or loc.shape[2] != H \
            or loc.shape[3] != L or loc.shape[5] != 2:
        raise ValueError(f"msda: loc {tuple(loc.shape)} does not match value "
                         f"{tuple(value.shape)} and {L} levels")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"msda: attn {tuple(attn.shape)} does not match loc "
                         f"{tuple(loc.shape)}")
    if sum(int(h) * int(w) for h, w in spatial_shapes) != V:
        raise ValueError(f"msda: value length {V} != sum of {spatial_shapes}")


def multi_scale_deformable_attention(
        value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if value.is_cuda:
        return msda_cuda(value, spatial_shapes, loc, attn)
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, loc, attn)
    raise ValueError(f"msda: no implementation for {value.device}")
