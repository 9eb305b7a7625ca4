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

The backward (`msda_backward_*`, the kernel `csrc/msda_bwd.cu`) returns
dvalue in value's dtype (fp32 sums, one rounding), dloc and dattn in fp32:
the derivative of the contract, with a sample whose 2x2 support misses the
level taking no gradient.  `multi_scale_deformable_attention` is the
differentiable entry (`MSDAFunction`): the kernels for CUDA tensors, the
plain versions for CPU tensors, never falling back from one to the other.
`msda_cuda` and `msda_backward_cuda` are raw launches outside autograd.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from occnet_tpu_torch.ops._build import I32, P, Kernel

MAX_LEVELS = 4
MSDA = Kernel("occ_msda", [P, P, P, P, ctypes.POINTER(ctypes.c_int), I32,
                           I32, I32, I32, I32, I32, I32, I32, P])
MSDA_BWD = Kernel("occ_msda_bwd", [P, P, P, P, P, P, P,
                                   ctypes.POINTER(ctypes.c_int), I32, I32,
                                   I32, I32, I32, I32, I32, I32, P])

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _level_corners(ll: torch.Tensor, h: int, w: int):
    """The sample arithmetic of one h x w level, shared by the plain
    forward and backward: normalised xy ``ll`` (..., 2) fp32 -> the
    fractions (tx, ty) and, for each corner of `_CORNERS`, whether it lies
    inside the level and its row in the level (clamped into it)."""
    # clamping far-away samples to just outside the level keeps the
    # float->int conversion defined and leaves every weight unchanged (all
    # their corners lie outside)
    x = (ll[..., 0] * w - 0.5).clamp(-2.0, w + 1.0)
    y = (ll[..., 1] * h - 0.5).clamp(-2.0, h + 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    corners = []
    for dy, dx in _CORNERS:
        cx, cy = x0 + dx, y0 + dy
        valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        corners.append((valid, cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)))
    return tx, ty, corners


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
        tx, ty, corners = _level_corners(ll, h, w)
        for (dy, dx), (valid, row) in zip(_CORNERS, corners):
            wgt = (ty if dy else 1.0 - ty) * (tx if dx else 1.0 - tx) * a
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            idx = bh_base + start + row
            g = rows[idx.reshape(-1)].reshape(B * H, Q, Pn, D)
            out += (g * wgt.reshape(B * H, Q, Pn, 1)).sum(dim=2)
        start += h * w
    out = out.reshape(B, H, Q, D).permute(0, 2, 1, 3).reshape(B, Q, H * D)
    return out.to(value.dtype)


def msda_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
              loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """`msda_plain` as one launch of the CUDA kernel (no autograd)."""
    B, V, H, D = value.shape
    Q, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_cuda("msda kernel", value, spatial_shapes, loc, attn)
    vec = 16 // value.element_size()      # channels of one 16-byte load
    if D % vec or 32 % (D // vec) or value.data_ptr() % 16:
        raise ValueError(f"msda kernel: a head's D = {D} channels must be "
                         f"a multiple of {vec} ({value.dtype}) with "
                         f"32 / (D / {vec}) whole, and value 16-byte aligned")
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    MSDA(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
         _levels(spatial_shapes), int(value.dtype == torch.bfloat16), B, V,
         Q, H, D, L, Pn, torch.cuda.current_stream(value.device).cuda_stream)
    return out


def msda_backward_plain(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        loc: torch.Tensor, attn: torch.Tensor,
                        grad: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of `msda_plain` for the output gradient ``grad``
    (B, Q, H * D), written out level by level and corner by corner (not
    through autograd) -> (dvalue (B, V, H, D) in value's dtype, dloc
    (B, Q, H, L, P, 2) fp32, dattn (B, Q, H, L, P) fp32).  With v_c a corner's
    row (0 outside the level) and (tx, ty) the fractions:

        dattn  = sum_d g * bilinear
        dloc_x = w * attn * sum_d g * [(1 - ty)(v01 - v00) + ty (v11 - v10)]
        dloc_y = h * attn * sum_d g * [(1 - tx)(v10 - v00) + tx (v11 - v01)]
        dvalue[corner row] += (wy * wx) * attn * g

    A sample whose 2x2 support misses the level takes no gradient."""
    B, V, H, D = value.shape
    Q, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_shapes(value, spatial_shapes, loc, attn)
    if tuple(grad.shape) != (B, Q, H * D):
        raise ValueError(f"msda backward: grad {tuple(grad.shape)} != "
                         f"{(B, Q, H * D)}")
    dev = value.device
    rows = value.permute(0, 2, 1, 3).reshape(B * H * V, D).float()
    g = grad.reshape(B, Q, H, D).permute(0, 2, 1, 3).reshape(
        B * H, Q, 1, D).float()
    bh_base = (torch.arange(B * H, device=dev) * V)[:, None]   # (BH, 1)
    dvalue = torch.zeros(B * H * V, D, dtype=torch.float32, device=dev)
    dloc = torch.zeros(B * H, Q, L, Pn, 2, dtype=torch.float32, device=dev)
    dattn = torch.zeros(B * H, Q, L, Pn, dtype=torch.float32, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        ll = loc[:, :, :, lvl].float().permute(0, 2, 1, 3, 4).reshape(
            B * H, Q, Pn, 2)
        a = attn[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(
            B * H, Q, Pn)
        tx, ty, corners = _level_corners(ll, h, w)
        wx, wy = (1.0 - tx, tx), (1.0 - ty, ty)
        base = bh_base[:, :, None] + start                    # (BH, 1, 1)
        v00, v01, v10, v11 = [
            rows[(base + row).reshape(-1)].reshape(B * H, Q, Pn, D)
            * valid[..., None] for valid, row in corners]
        bil = (wy[0][..., None] * (wx[0][..., None] * v00
                                   + wx[1][..., None] * v01)
               + wy[1][..., None] * (wx[0][..., None] * v10
                                     + wx[1][..., None] * v11))
        gx = wy[0][..., None] * (v01 - v00) + wy[1][..., None] * (v11 - v10)
        gy = wx[0][..., None] * (v10 - v00) + wx[1][..., None] * (v11 - v01)
        dattn[:, :, lvl] = (g * bil).sum(-1)
        dloc[:, :, lvl, :, 0] = w * (a * (g * gx).sum(-1))
        dloc[:, :, lvl, :, 1] = h * (a * (g * gy).sum(-1))
        for (dy, dx), (valid, row) in zip(_CORNERS, corners):
            wgt = torch.where(valid, wy[dy] * wx[dx] * a,
                              torch.zeros_like(a))
            dvalue.index_add_(0, (base + row).reshape(-1),
                              (wgt[..., None] * g).reshape(-1, D))
        start += h * w
    dvalue = dvalue.reshape(B, H, V, D).permute(0, 2, 1, 3).contiguous()
    dloc = dloc.reshape(B, H, Q, L, Pn, 2).permute(0, 2, 1, 3, 4, 5)
    dattn = dattn.reshape(B, H, Q, L, Pn).permute(0, 2, 1, 3, 4)
    return (dvalue.to(value.dtype), dloc.contiguous(), dattn.contiguous())


def msda_backward_cuda(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       loc: torch.Tensor, attn: torch.Tensor,
                       grad: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`msda_backward_plain` as one launch of `occ_msda_bwd` (fp32 atomics
    into a zeroed fp32 dvalue, rounded once to value's dtype)."""
    B, V, H, D = value.shape
    Q, L, Pn = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_cuda("msda backward kernel", value, spatial_shapes, loc, attn)
    if tuple(grad.shape) != (B, Q, H * D) or grad.dtype != value.dtype \
            or grad.device != value.device or not grad.is_contiguous():
        raise ValueError(f"msda backward kernel: grad must be a contiguous "
                         f"{(B, Q, H * D)} {value.dtype} tensor on "
                         f"{value.device}, got {tuple(grad.shape)} "
                         f"{grad.dtype} on {grad.device}")
    if D % 4 or 32 % (D // 4) or value.data_ptr() % 8 or grad.data_ptr() % 8:
        raise ValueError(f"msda backward kernel: a head's D = {D} channels "
                         f"must be a multiple of 4 with 32 / (D / 4) whole, "
                         f"and value and grad 8-byte aligned")
    dvalue = torch.zeros(B, V, H, D, dtype=torch.float32,
                         device=value.device)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    MSDA_BWD(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
             grad.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
             dattn.data_ptr(), _levels(spatial_shapes),
             int(value.dtype == torch.bfloat16), B, V, Q, H, D, L, Pn,
             torch.cuda.current_stream(value.device).cuda_stream)
    return dvalue.to(value.dtype), dloc, dattn


def _levels(spatial_shapes):
    """(h, w) of each level, padded to MAX_LEVELS, as a C int array."""
    flat = [int(s) for hw in spatial_shapes for s in hw]
    return (ctypes.c_int * (2 * MAX_LEVELS))(
        *flat, *([0] * (2 * MAX_LEVELS - len(flat))))


def _check_cuda(what, value, spatial_shapes, loc, attn):
    """What both kernels take: CUDA tensors on one device, bf16 or f32
    value with fp32 loc / attn, contiguous, at most MAX_LEVELS levels."""
    _check_shapes(value, spatial_shapes, loc, attn)
    if not value.is_cuda:
        raise ValueError(f"{what}: tensors must be on a CUDA device, got "
                         f"{value.device}")
    if value.dtype not in (torch.bfloat16, torch.float32) \
            or loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise ValueError(f"{what}: value bf16|f32 and fp32 loc/attn, got "
                         f"{value.dtype}/{loc.dtype}/{attn.dtype}")
    if loc.device != value.device or attn.device != value.device:
        raise ValueError(f"{what}: value, loc and attn must share one "
                         f"device")
    if not (value.is_contiguous() and loc.is_contiguous()
            and attn.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if len(spatial_shapes) > MAX_LEVELS:
        raise ValueError(f"{what}: at most {MAX_LEVELS} levels, got "
                         f"{len(spatial_shapes)}")


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


class MSDAFunction(torch.autograd.Function):
    """The differentiable sampling: forward and backward by the kernels for
    CUDA tensors, by the plain versions for CPU tensors.  Only value, loc
    and attn are saved, and the backward recomputes every sample's corners:
    no gather temporary lives from forward to backward (the counterpart of
    the JAX package's query-chunked, rematerialised backward)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = tuple((int(h), int(w))
                                   for h, w in spatial_shapes)
        ctx.save_for_backward(value, loc, attn)
        fwd = msda_cuda if value.is_cuda else msda_plain
        return fwd(value, ctx.spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad):
        value, loc, attn = ctx.saved_tensors
        bwd = msda_backward_cuda if value.is_cuda else msda_backward_plain
        dvalue, dloc, dattn = bwd(value, ctx.spatial_shapes, loc, attn,
                                  grad.contiguous())
        need = ctx.needs_input_grad
        return (dvalue if need[0] else None, None, dloc if need[2] else None,
                dattn if need[3] else None)


def multi_scale_deformable_attention(
        value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The sampling, differentiable in value, loc and attn: the kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    if value.is_cuda or value.device.type == "cpu":
        return MSDAFunction.apply(value, spatial_shapes, loc, attn)
    raise ValueError(f"msda: no implementation for {value.device}")
