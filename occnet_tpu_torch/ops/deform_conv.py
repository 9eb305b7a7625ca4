"""Modulated deformable convolution (DCNv2): the kernels of
`csrc/deform_conv.cu` (the fused sampling + product, and the sampling
alone), their plain PyTorch versions, and the layer.  The port of
`occnet_tpu/ops/deform_conv.py` and of the Pallas window kernels of
`occnet_tpu/ops/dcn_window.py` (`_window_kernel_dymajor`, `_window_kernel`)
with the einsum that follows them.

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

The layer's contraction (`deform_conv_*`): with the weight as a (9 * C,
Cout) matrix, tap-major rows (row k * C + c),

    y[b, oy, ox, n] = sum_j cols[b, oy * wo + ox, j] * wmat[j, n]

summed in fp32 and rounded once to x's dtype, y (B, ho, wo, Cout) NHWC.
For bf16 CUDA tensors `deform_conv` is ONE kernel (`occ_deform_conv`): the
columns stay in shared memory, the tensor cores sum in fp32 (in another
order than an fp32 matmul), and the window certificate of the layer is
counted in the same kernel.  For fp32 CUDA tensors it is the sampling
kernel followed by `torch.matmul`, and for CPU tensors the plain version.

The backward of the sampling (`deform_sample_backward_*`, the kernel
`occ_deform_sample_bwd` of `csrc/deform_conv_bwd.cu`) is its transpose:
dx in x's dtype (fp32 sums, one rounding), doffset and dmask in fp32, with
the same integer part and fraction as the forward and no gradient through a
corner outside the image.  `deform_conv` is differentiable
(`DeformConvFunction`): its backward recomputes the columns, takes
dwmat = cols^T dy and dcols = dy wmat^T with `torch.matmul` (plain large
products, which the JAX package leaves to XLA) and runs the sampling's
backward.  It saves x, offset, mask and wmat, never the 9-tap columns: the
counterpart of the JAX package's remat of DCN blocks.

Every wrapper launches its kernel for CUDA tensors and the plain version
runs for CPU tensors, never falling back from one to the other.  The
`*_cuda` wrappers are raw launches outside autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.ops._build import I32, I64, P, Kernel
from occnet_tpu_torch.ops.dcn_window import window_overflow, window_supported

DEFORM = Kernel("occ_deform_sample", [P, P, P, P, I32, I32, I32, I32, I32,
                                      I32, I32, I32, P])
DEFORM_CONV = Kernel("occ_deform_conv", [P, P, P, P, P, P, I32, I32, I32,
                                         I32, I32, I32, I32, I32, I32, P])
DEFORM_BWD = Kernel("occ_deform_sample_bwd", [P] * 8 + [I64] + [I32] * 8
                    + [P])
# occ_deform_sample_bwd's gather route (deform_conv_bwd.cu): C <= 256, at
# least 150 output pixels an SM; it gathers the samples with
# |floor(offset)| <= 4 px both ways
BWD_GATHER_MAX_C, BWD_GATHER_MIN_PIXELS, BWD_NEAR_PX = 256, 150, 4
CONV_K_STEP = 32            # input channels of one K step of occ_deform_conv
CONV_N_TILE = 256           # output channels of one of its blocks

TAPS = 9
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def out_size(h: int, w: int, stride: int) -> Tuple[int, int]:
    """Output size of a 3x3, pad 1 conv: ceil(h / stride)."""
    return -(-h // stride), -(-w // stride)


def _corners(B: int, h: int, w: int, offset: torch.Tensor, stride: int):
    """The sample arithmetic of the contract, shared by the plain forward
    and backward: the fractions (ty, tx) of every (pixel, tap) sample, each
    (B, ho, wo, 9) fp32, and for each corner (i, j) of `_CORNERS` whether it
    adds (inside the image) and the flat row of x (B * h * w, C) it reads,
    clamped into the image."""
    ho, wo = offset.shape[1:3]
    dev = offset.device
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
    b_base = (torch.arange(B, device=dev) * h)[:, None, None, None]
    corners = []
    for i, j in _CORNERS:
        cy, cx = y0 + i, x0 + j
        valid = inside & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        idx = (b_base + cy.clamp(0, h - 1)) * w + cx.clamp(0, w - 1)
        corners.append((valid, idx))
    return ty, tx, corners


def deform_sample_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: Optional[torch.Tensor], stride: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """The contract above in plain PyTorch, corner by corner: gather the
    clamped corner rows and add weight * row in fp32."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, dilation)
    ty, tx, corners = _corners(B, h, w, offset, stride)
    wx = (1.0 - tx, tx)
    if mask is not None:
        m = mask.float()
        wx = (wx[0] * m, wx[1] * m)
    wy = (1.0 - ty, ty)
    rows = x.reshape(B * h * w, C)
    acc = torch.zeros(B, ho, wo, TAPS, C, dtype=torch.float32,
                      device=x.device)
    for (i, j), (valid, idx) in zip(_CORNERS, corners):
        wgt = torch.where(valid, wy[i] * wx[j], torch.zeros_like(ty))
        g = rows[idx.reshape(-1)].float().reshape(B, ho, wo, TAPS, C)
        acc = acc + wgt[..., None] * g
    return acc.to(x.dtype).reshape(B, ho * wo, TAPS * C)


def deform_sample_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], stride: int = 1,
                       dilation: int = 1) -> torch.Tensor:
    """`deform_sample_plain` as one launch of the CUDA kernel (no
    autograd).  x must be a contiguous NHWC tensor (the trunk's
    channels-last NCHW activations permuted): the wrapper raises rather
    than copy."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, dilation)
    ins = [x, offset] + ([] if mask is None else [mask])
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


def deform_sample_backward_plain(x: torch.Tensor, offset: torch.Tensor,
                                 mask: Optional[torch.Tensor],
                                 dcols: torch.Tensor, stride: int = 1,
                                 need_dx: bool = True
                                 ) -> Tuple[Optional[torch.Tensor],
                                            torch.Tensor,
                                            Optional[torch.Tensor]]:
    """The transpose of `deform_sample_plain` for the columns' gradient
    ``dcols`` (B, ho * wo, 9 * C), written out corner by corner (not through
    autograd) -> (dx (B, h, w, C) in x's dtype, or None without
    ``need_dx``; doffset (B, ho, wo, 9, 2) fp32; dmask (B, ho, wo, 9) fp32,
    or None without a mask).  With x_ij a corner's row (0 outside the
    image), g a sample's column gradient and m its mask:

        dx[corner ij] += wy_i * (wx_j * m) * g
        doffset_y = m * sum_c g * [(1 - tx)(x10 - x00) + tx (x11 - x01)]
        doffset_x = m * sum_c g * [(1 - ty)(x01 - x00) + ty (x11 - x10)]
        dmask     = sum_c g * (the unmasked sample)"""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, 1)
    if tuple(dcols.shape) != (B, ho * wo, TAPS * C):
        raise ValueError(f"deform_sample backward: dcols "
                         f"{tuple(dcols.shape)} != {(B, ho * wo, TAPS * C)}")
    ty, tx, corners = _corners(B, h, w, offset, stride)
    m = torch.ones_like(ty) if mask is None else mask.float()
    wy, wxu = (1.0 - ty, ty), (1.0 - tx, tx)
    rows = x.reshape(B * h * w, C)
    g = dcols.reshape(B, ho, wo, TAPS, C).float()
    x00, x01, x10, x11 = [
        rows[idx.reshape(-1)].float().reshape(B, ho, wo, TAPS, C)
        * valid[..., None] for valid, idx in corners]
    un = (wy[0][..., None] * (wxu[0][..., None] * x00
                              + wxu[1][..., None] * x01)
          + wy[1][..., None] * (wxu[0][..., None] * x10
                                + wxu[1][..., None] * x11))
    gy = wxu[0][..., None] * (x10 - x00) + wxu[1][..., None] * (x11 - x01)
    gx = wy[0][..., None] * (x01 - x00) + wy[1][..., None] * (x11 - x10)
    doffset = torch.stack([m * (g * gy).sum(-1), m * (g * gx).sum(-1)], -1)
    dmask = None if mask is None else (g * un).sum(-1)
    dx = None
    if need_dx:
        acc = torch.zeros(B * h * w, C, dtype=torch.float32,
                          device=x.device)
        for (i, j), (valid, idx) in zip(_CORNERS, corners):
            wgt = torch.where(valid, wy[i] * (wxu[j] * m),
                              torch.zeros_like(ty))
            acc.index_add_(0, idx.reshape(-1),
                           (wgt[..., None] * g).reshape(-1, C))
        dx = acc.reshape(B, h, w, C).to(x.dtype)
    return dx, doffset, dmask


def deform_sample_backward_cuda(x: torch.Tensor, offset: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                dcols: torch.Tensor, stride: int = 1,
                                need_dx: bool = True
                                ) -> Tuple[Optional[torch.Tensor],
                                           torch.Tensor,
                                           Optional[torch.Tensor]]:
    """`deform_sample_backward_plain` as one launch of
    `occ_deform_sample_bwd` (dx gathered, or scattered, into an fp32
    buffer, rounded once to x's dtype, skipped without ``need_dx``; doffset
    and dmask from the corner dot products it leaves in a workspace)."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, 1)
    ins = [x, offset, dcols] + ([] if mask is None else [mask])
    if not x.is_cuda:
        raise ValueError(f"deform_sample backward kernel: tensors must be on "
                         f"a CUDA device, got {x.device}")
    if any(t.device != x.device for t in ins):
        raise ValueError("deform_sample backward kernel: x, offset, mask "
                         "and dcols must share one device")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or dcols.dtype != x.dtype or offset.dtype != torch.float32 \
            or (mask is not None and mask.dtype != torch.float32):
        raise ValueError(f"deform_sample backward kernel: x and dcols bf16 "
                         f"or f32 alike, fp32 offset/mask, got "
                         f"{[t.dtype for t in ins]}")
    if tuple(dcols.shape) != (B, ho * wo, TAPS * C):
        raise ValueError(f"deform_sample backward kernel: dcols "
                         f"{tuple(dcols.shape)} != {(B, ho * wo, TAPS * C)}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("deform_sample backward kernel: inputs must be "
                         "contiguous")
    if C % 4 or x.data_ptr() % 8 or dcols.data_ptr() % 8:
        raise ValueError(f"deform_sample backward kernel: C = {C} must be a "
                         f"multiple of 4, x and dcols 8-byte aligned")
    dx = (torch.empty(B, h, w, C, dtype=torch.float32, device=x.device)
          if need_dx else None)
    doffset = torch.empty_like(offset)
    dmask = None if mask is None else torch.empty_like(mask)
    # the kernel's workspace: 4 corner dots and a far-list entry a sample,
    # and the list's count (the C entry refuses a smaller one)
    ws_ints = 5 * B * ho * wo * TAPS + 1
    workspace = torch.empty(ws_ints, dtype=torch.int32, device=x.device)
    DEFORM_BWD(x.data_ptr(), offset.data_ptr(),
               None if mask is None else mask.data_ptr(), dcols.data_ptr(),
               None if dx is None else dx.data_ptr(), doffset.data_ptr(),
               None if dmask is None else dmask.data_ptr(),
               workspace.data_ptr(), 4 * ws_ints,
               int(x.dtype == torch.bfloat16), B, h, w, C, ho, wo, stride,
               torch.cuda.current_stream(x.device).cuda_stream)
    return (None if dx is None else dx.to(x.dtype)), doffset, dmask


def backward_far_share(offset: torch.Tensor, h: int, w: int, C: int,
                       stride: int, sms: int) -> float:
    """The share of the samples of one `occ_deform_sample_bwd` launch that
    take its scatter: on the gather route (C <= BWD_GATHER_MAX_C and at
    least BWD_GATHER_MIN_PIXELS output pixels an SM, of ``sms``) the
    samples inside the image with |floor(offset)| > BWD_NEAR_PX either
    way, on the other route every sample inside the image.  The kernel's
    route and tests mirrored, for reporting only."""
    B, ho, wo = offset.shape[:3]
    fl = offset.float().floor()
    k = torch.arange(TAPS, device=offset.device)
    oy = torch.arange(ho, device=offset.device).view(ho, 1, 1) * stride
    ox = torch.arange(wo, device=offset.device).view(1, wo, 1) * stride
    ry = oy - 1 + k // 3 + fl[..., 0]
    rx = ox - 1 + k % 3 + fl[..., 1]
    inside = (ry > -2) & (ry < h) & (rx > -2) & (rx < w)
    far = inside
    if C <= BWD_GATHER_MAX_C and B * ho * wo >= BWD_GATHER_MIN_PIXELS * sms:
        far = inside & (fl.abs() > BWD_NEAR_PX).any(-1)
    return far.float().mean().item()


def deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: Optional[torch.Tensor], wmat: torch.Tensor,
                      stride: int = 1, radius: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The contraction above in plain PyTorch: `deform_sample_plain`, an
    fp32 product rounded once to x's dtype -> (y (B, ho, wo, Cout), the
    `window_overflow` of the offsets at ``radius``, or None without one)."""
    B = x.shape[0]
    ho, wo = _check(x, offset, mask, stride, 1)
    cols = deform_sample_plain(x, offset, mask, stride)
    y = torch.matmul(cols.float(), wmat.float()).to(x.dtype)
    count = None if radius is None else window_overflow(offset, ho, wo,
                                                        radius)
    return y.view(B, ho, wo, -1), count


def deform_conv_cuda(x: torch.Tensor, offset: torch.Tensor,
                     mask: Optional[torch.Tensor], wmat: torch.Tensor,
                     stride: int = 1, radius: Optional[int] = None,
                     count: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`deform_conv_plain` for bf16 as one launch of `occ_deform_conv`
    (no autograd).  With ``radius`` the layer's window certificate is
    ADDED to ``count`` (a 1-element int32 tensor on x's device; a zeroed
    one is made when None) and returned; without, None is returned.  x must
    be a contiguous NHWC tensor (the trunk's channels-last NCHW activations
    permuted): the wrapper raises rather than copy."""
    B, h, w, C = x.shape
    ho, wo = _check(x, offset, mask, stride, 1)
    ins = [x, offset, wmat] + ([] if mask is None else [mask])
    if x.dtype != torch.bfloat16 or wmat.dtype != torch.bfloat16 \
            or offset.dtype != torch.float32 \
            or (mask is not None and mask.dtype != torch.float32):
        raise ValueError(f"deform_conv kernel: bf16 x and wmat, fp32 "
                         f"offset/mask, got {[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("deform_conv kernel: inputs must be contiguous "
                         "(x NHWC: a channels-last NCHW tensor permuted)")
    if wmat.ndim != 2 or wmat.shape[0] != TAPS * C:
        raise ValueError(f"deform_conv kernel: wmat {tuple(wmat.shape)} is "
                         f"not (9 * {C}, Cout)")
    N = wmat.shape[1]
    if C % CONV_K_STEP or N % CONV_N_TILE:
        raise ValueError(f"deform_conv kernel: C = {C} must be a multiple "
                         f"of {CONV_K_STEP} and Cout = {N} of {CONV_N_TILE} "
                         f"(its K step and N tile)")
    if not x.is_cuda:
        raise ValueError(f"deform_conv kernel: tensors must be on a CUDA "
                         f"device, got {x.device}")
    if any(t.device != x.device for t in ins):
        raise ValueError("deform_conv kernel: x, offset, mask and wmat must "
                         "share one device")
    if x.data_ptr() % 16 or wmat.data_ptr() % 16:
        raise ValueError("deform_conv kernel: x and wmat must be 16-byte "
                         "aligned")
    if radius is not None:
        if count is None:
            count = torch.zeros(1, dtype=torch.int32, device=x.device)
        elif count.dtype != torch.int32 or count.device != x.device \
                or count.numel() != 1:
            raise ValueError("deform_conv kernel: count must be one int32 "
                             "element on x's device")
    else:
        count = None
    y = torch.empty(B, ho, wo, N, dtype=x.dtype, device=x.device)
    DEFORM_CONV(x.data_ptr(), offset.data_ptr(),
                None if mask is None else mask.data_ptr(), wmat.data_ptr(),
                y.data_ptr(), None if count is None else count.data_ptr(),
                B, h, w, C, ho, wo, N, stride,
                -1 if radius is None else radius,
                torch.cuda.current_stream(x.device).cuda_stream)
    return y, count


def deform_conv_pair(x: torch.Tensor, offset: torch.Tensor,
                     mask: Optional[torch.Tensor], wmat: torch.Tensor,
                     stride: int = 1, radius: Optional[int] = None,
                     count: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer on the card in three steps: the sampling kernel into
    columns, `torch.matmul` with ``wmat``, then `window_overflow` at
    ``radius`` (the fp32 path; `deform_conv` for the arguments)."""
    B = x.shape[0]
    ho, wo = _check(x, offset, mask, stride, 1)
    cols = deform_sample_cuda(x, offset, mask, stride)
    y = torch.matmul(cols, wmat).view(B, ho, wo, -1)
    over = None if radius is None else window_overflow(offset, ho, wo,
                                                       radius)
    return y, _added(over, count)


def _deform_conv_forward(x, offset, mask, wmat, stride, radius, count):
    """`deform_conv`'s forward outside autograd: `occ_deform_conv` for bf16
    CUDA tensors, `deform_conv_pair` for fp32 CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        if x.dtype == torch.bfloat16:
            return deform_conv_cuda(x, offset, mask, wmat, stride, radius,
                                    count)
        return deform_conv_pair(x, offset, mask, wmat, stride, radius, count)
    if x.device.type == "cpu":
        y, over = deform_conv_plain(x, offset, mask, wmat, stride, radius)
        return y, _added(over, count)
    raise ValueError(f"deform_conv: no implementation for {x.device}")


class DeformConvFunction(torch.autograd.Function):
    """`deform_conv` differentiable in x, offset, mask and wmat.  Saves
    those four (never the 9-tap columns); the certificate is an output
    without gradient, counted once by the forward (a given counter is
    updated in place and returned), never by the backward.  The backward:
    the columns again by the sampling kernel (plain on the CPU),
    dwmat = cols^T dy and dcols = dy wmat^T by `torch.matmul`, then the
    sampling's backward; only the gradients asked for are computed."""

    @staticmethod
    def forward(ctx, x, offset, mask, wmat, stride, radius, count):
        y, cert = _deform_conv_forward(x, offset, mask, wmat, stride, radius,
                                       count)
        ctx.stride = stride
        ctx.save_for_backward(x, offset, mask, wmat)
        if cert is not None:
            if cert is count:
                ctx.mark_dirty(count)
            ctx.mark_non_differentiable(cert)
        return y, cert

    @staticmethod
    def backward(ctx, dy, _dcert):
        x, offset, mask, wmat = ctx.saved_tensors
        need_x, need_off, need_mask, need_w = ctx.needs_input_grad[:4]
        B, ho, wo, N = dy.shape
        dy = dy.reshape(B, ho * wo, N)
        cuda = x.is_cuda
        dx = doffset = dmask = dwmat = None
        if need_w:
            cols = (deform_sample_cuda if cuda else deform_sample_plain)(
                x, offset, mask, ctx.stride)
            dwmat = torch.matmul(cols.reshape(-1, cols.shape[-1]).t(),
                                 dy.reshape(-1, N))
            del cols
        if need_x or need_off or need_mask:
            dcols = torch.matmul(dy, wmat.t())
            bwd = (deform_sample_backward_cuda if cuda
                   else deform_sample_backward_plain)
            dx, doffset, dmask = bwd(x, offset, mask, dcols, ctx.stride,
                                     need_dx=need_x)
        return (dx, doffset if need_off else None,
                dmask if need_mask else None, dwmat, None, None, None)


def deform_conv(x: torch.Tensor, offset: torch.Tensor,
                mask: Optional[torch.Tensor], wmat: torch.Tensor,
                stride: int = 1, radius: Optional[int] = None,
                count: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's sampling and product -> (y (B, ho, wo, Cout), the window
    certificate at ``radius`` or None), differentiable in x, offset, mask
    and wmat (`DeformConvFunction`): `occ_deform_conv` for bf16 CUDA
    tensors, `deform_conv_pair` for fp32 CUDA tensors, the plain version
    for CPU tensors.  A given ``count`` (1-element int32) has the
    certificate added to it and is returned in its place."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"deform_conv: no implementation for {x.device}")
    return DeformConvFunction.apply(x, offset, mask, wmat, stride, radius,
                                    count)


def _added(over: Optional[torch.Tensor], count: Optional[torch.Tensor]
           ) -> Optional[torch.Tensor]:
    """``over`` added into ``count`` (returned) when both are given."""
    if over is None or count is None:
        return over
    return count.add_(over.to(count.dtype))


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
    JAX layer rounds them.  The taps are sampled and contracted with
    `weight` (Cout, Cin, 3, 3) by `deform_conv` (one kernel for bf16 on the
    card).

    Input and output are NCHW in channels-last memory (the trunk's layout).
    ``mode`` "window" marks the JAX layers that run the Pallas window kernel
    (`window_supported`): for those `forward` also returns their
    `window_overflow` at ``window_radius``, else None.  The sampling itself
    is exact in both modes."""

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

    def forward(self, x: torch.Tensor, count: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, Cin, h, w) -> (y (B, Cout, ho, wo) in channels-last memory,
        the window certificate or None).  A given ``count`` (1-element
        int32 on x's device) has the certificate added to it and is returned
        as the certificate, so that a trunk zeroes one counter a layer in a
        single launch."""
        dt = self.compute_dtype
        cin, w = x.shape[1], x.shape[3]
        off, mask = self.offset_and_mask(x)
        wmat = self.weight.to(dt).permute(2, 3, 1, 0).reshape(TAPS * cin, -1)
        radius = (self.window_radius if self.mode == "window"
                  and window_supported(w, 3, self.stride, 1) else None)
        y, overflow = deform_conv(x.to(dt).permute(0, 2, 3, 1), off, mask,
                                  wmat, self.stride, radius, count)
        return y.permute(0, 3, 1, 2), overflow
