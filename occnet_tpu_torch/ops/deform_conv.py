"""Modulated deformable convolution (DCNv2): the sampling kernel
(`csrc/deform_conv.cu`), its plain PyTorch version, and the layer.  The port
of `occnet_tpu/ops/deform_conv.py` and of the Pallas window kernels of
`occnet_tpu/ops/dcn_window.py` (`_window_kernel_dymajor`, `_window_kernel`).

Contract of the sampling (`deform_sample_*`), 3x3 taps k = ky * 3 + kx,
padding 1, dilation 1, stride 1 or 2:

    x      (B, h, w, C) NHWC, bf16 or f32;
    offset (B, ho, wo, 9, 2) fp32, (dy, dx) per tap (mmcv order);
    mask   (B, ho, wo, 9) fp32 after the sigmoid, or None (all ones);
    -> cols (B, ho * wo, 9 * C) in x's dtype, ho = ceil(h / stride), with

    cols[b, oy * wo + ox, k * C + c] = sum over the corners (i, j) in {0, 1}^2
        wy_i * (wx_j * mask) * x[b, oy*stride - 1 + ky + floor(dy) + i,
                                    ox*stride - 1 + kx + floor(dx) + j, c]

where wy_0 = 1 - fy, wy_1 = fy with fy = dy - floor(dy) (likewise x), and a
corner outside the image adds nothing.  This is the window kernel's form
(integer part and fraction taken from the offset alone,
`dcn_window.py:79-86`): the fraction is exact, and `floor(dy)` is the very
value the certificate of `ops/dcn_window.py` tests.  Weights are fp32, taken
in that order; the corners are summed in fp32 in the order (0,0), (0,1),
(1,0), (1,1) from 0, with no fused multiply-add, and the sum is rounded once
to x's dtype.  Kernel and plain version therefore agree bitwise.

Unlike the Pallas window kernel, which zeroes samples outside its window,
this is exact at any offset: it equals the window kernel wherever that
kernel's certificate is 0, and the JAX gather form (`modulated_deform_conv`)
to fp32 rounding (that form rounds each position through a normalised
coordinate, and in bf16 rounds each corner product and multiplies the mask
after sampling).

`deform_sample` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors, never falling back from one to the other.  The
CUDA path is forward only: it raises on inputs that require grad (the DCN
backward comes with R101-DCN training).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.ops._build import I32, P, Kernel
from occnet_tpu_torch.ops.dcn_window import window_overflow, window_supported

DEFORM = Kernel("occ_deform_sample", [P, P, P, P, I32, I32, I32, I32, I32,
                                      I32, I32, I32, P])

TAPS = 9
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def out_size(h: int, w: int, stride: int) -> Tuple[int, int]:
    """Output size of a 3x3, pad 1 conv: ceil(h / stride)."""
    return -(-h // stride), -(-w // stride)


def deform_sample_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: Optional[torch.Tensor], stride: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """The contract above in plain PyTorch, corner by corner: gather the
    clamped corner rows and add weight * row in fp32."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, dilation)
    dev = x.device
    off = offset.float()
    k = torch.arange(TAPS, device=dev)
    by = (torch.arange(ho, device=dev) * stride - 1)[:, None, None] \
        + (k // 3)                                            # (ho, 1, 9)
    bx = (torch.arange(wo, device=dev) * stride - 1)[None, :, None] \
        + (k % 3)                                             # (1, wo, 9)
    fy, fx = torch.floor(off[..., 0]), torch.floor(off[..., 1])
    ty, tx = off[..., 0] - fy, off[..., 1] - fx
    ry, rx = by.float() + fy, bx.float() + fx                 # corner 0
    # the kernel's test, in float before any conversion to an integer: a
    # sample whose 2x2 support misses the image adds nothing, and clamping
    # the others' rows keeps far-away offsets' conversion defined
    inside = (ry > -2.0) & (ry < h) & (rx > -2.0) & (rx < w)
    y0 = ry.clamp(-1.0, h - 1.0).long()
    x0 = rx.clamp(-1.0, w - 1.0).long()
    wx = (1.0 - tx, tx)
    if mask is not None:
        m = mask.float()
        wx = (wx[0] * m, wx[1] * m)
    wy = (1.0 - ty, ty)
    rows = x.reshape(B * h * w, C)
    b_base = (torch.arange(B, device=dev) * h)[:, None, None, None]
    acc = torch.zeros(B, ho, wo, TAPS, C, dtype=torch.float32, device=dev)
    for i, j in _CORNERS:
        cy, cx = y0 + i, x0 + j
        valid = inside & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        wgt = torch.where(valid, wy[i] * wx[j], torch.zeros_like(ty))
        idx = (b_base + cy.clamp(0, h - 1)) * w + cx.clamp(0, w - 1)
        g = rows[idx.reshape(-1)].float().reshape(B, ho, wo, TAPS, C)
        acc = acc + wgt[..., None] * g
    return acc.to(x.dtype).reshape(B, ho * wo, TAPS * C)


def deform_sample_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], stride: int = 1,
                       dilation: int = 1) -> torch.Tensor:
    """`deform_sample_plain` as one launch of the CUDA kernel (forward
    only).  x must be a contiguous NHWC tensor (the trunk's channels-last
    NCHW activations permuted): the wrapper raises rather than copy."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, dilation)
    ins = [x, offset] + ([] if mask is None else [mask])
    if any(t.requires_grad for t in ins):
        raise ValueError("deform_sample kernel: forward only, inputs must "
                         "not require grad (R101-DCN training is not ported "
                         "yet)")
    if not x.is_cuda:
        raise ValueError(f"deform_sample kernel: tensors must be on a CUDA "
                         f"device, got {x.device}")
    if any(t.device != x.device for t in ins):
        raise ValueError("deform_sample kernel: x, offset and mask must "
                         "share one device")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != torch.float32 for t in ins[1:]):
        raise ValueError(f"deform_sample kernel: x bf16|f32 and fp32 "
                         f"offset/mask, got {[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("deform_sample kernel: inputs must be contiguous "
                         "(x NHWC: a channels-last NCHW tensor permuted)")
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16:
        raise ValueError(f"deform_sample kernel: x must be 16-byte aligned "
                         f"with C a multiple of {vec} for {x.dtype} (16-byte "
                         f"vectors), got C = {C}")
    cols = torch.empty(B, ho * wo, TAPS * C, dtype=x.dtype, device=x.device)
    DEFORM(x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), cols.data_ptr(),
           int(x.dtype == torch.bfloat16), B, h, w, C, ho, wo, stride,
           torch.cuda.current_stream(x.device).cuda_stream)
    return cols


def deform_sample(x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return deform_sample_cuda(x, offset, mask, stride, dilation)
    if x.device.type == "cpu":
        return deform_sample_plain(x, offset, mask, stride, dilation)
    raise ValueError(f"deform_sample: no implementation for {x.device}")


def _check(x, offset, mask, stride, dilation) -> Tuple[int, int]:
    if x.ndim != 4:
        raise ValueError(f"deform_sample: x must be NHWC, got {tuple(x.shape)}")
    if stride not in (1, 2) or dilation != 1:
        raise ValueError(f"deform_sample: stride 1 or 2 and dilation 1, got "
                         f"{stride} and {dilation}")
    B, h, w, _ = x.shape
    ho, wo = out_size(h, w, stride)
    if tuple(offset.shape) != (B, ho, wo, TAPS, 2):
        raise ValueError(f"deform_sample: offset {tuple(offset.shape)} != "
                         f"{(B, ho, wo, TAPS, 2)} (3x3 taps only)")
    if mask is not None and tuple(mask.shape) != (B, ho, wo, TAPS):
        raise ValueError(f"deform_sample: mask {tuple(mask.shape)} != "
                         f"{(B, ho, wo, TAPS)}")
    return ho, wo


class ModulatedDeformConv(nn.Module):
    """DCNv2 layer (port of the flax `ModulatedDeformConv`, mmcv
    `ModulatedDeformConv2dPack` layout): `conv_offset`, a 3x3 conv with bias
    in the compute dtype, predicts 2 * 9 offsets (channels 2k, 2k + 1 =
    dy, dx of tap k) and 9 mask logits (channel 18 + k); the offsets are
    then cast to fp32 and the mask is the fp32 sigmoid of its logits, as the
    JAX layer rounds them.  The taps are sampled into columns by
    `deform_sample` and contracted with `weight` (Cout, Cin, 3, 3) by one
    `torch.matmul` (the JAX package's XLA einsum, outside any kernel).

    Input and output are NCHW in channels-last memory (the trunk's layout).
    ``mode`` "window" marks the JAX layers that run the Pallas window kernel
    (`window_supported`): for those `forward` also returns their
    `window_overflow` at ``window_radius``, else None.  The sampling itself
    is the same exact kernel in both modes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 mode: str = "gather", window_radius: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("gather", "window"):
            raise ValueError(f"unknown DCN mode {mode!r}")
        self.conv_offset = nn.Conv2d(in_ch, 3 * TAPS, 3, stride=stride,
                                     padding=1, bias=True)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        nn.init.kaiming_normal_(self.weight)
        self.stride = stride
        self.mode = mode
        self.window_radius = window_radius
        self.compute_dtype = dtype

    def offset_and_mask(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, Cin, h, w) -> (offset (B, ho, wo, 9, 2) fp32, mask
        (B, ho, wo, 9) fp32), both contiguous."""
        dt = self.compute_dtype
        co = F.conv2d(x.to(dt), self.conv_offset.weight.to(dt),
                      self.conv_offset.bias.to(dt), self.stride, 1)
        co = co.permute(0, 2, 3, 1)                  # (B, ho, wo, 27)
        B, ho, wo, _ = co.shape
        off = co[..., :2 * TAPS].float().contiguous().view(B, ho, wo, TAPS, 2)
        mask = torch.sigmoid(co[..., 2 * TAPS:].float()).contiguous()
        return off, mask

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, Cin, h, w) -> (y (B, Cout, ho, wo) in channels-last memory,
        the window certificate or None)."""
        dt = self.compute_dtype
        B, cin, h, w = x.shape
        off, mask = self.offset_and_mask(x)
        cols = deform_sample(x.to(dt).permute(0, 2, 3, 1), off, mask,
                             self.stride)             # (B, ho*wo, 9*Cin)
        wmat = self.weight.to(dt).permute(2, 3, 1, 0).reshape(TAPS * cin, -1)
        ho, wo = off.shape[1:3]
        y = torch.matmul(cols, wmat).view(B, ho, wo, -1).permute(0, 3, 1, 2)
        overflow = None
        if self.mode == "window" and window_supported(w, 3, self.stride, 1):
            overflow = window_overflow(off, ho, wo, self.window_radius)
        return y, overflow
