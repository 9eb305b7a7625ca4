"""The exactness certificate of the window DCN path (port of the certificate
helpers of `occnet_tpu/ops/dcn_window.py`).

In the JAX package, a window-mode DCN layer samples through a Pallas kernel
that only sees a (2R+2)^2 window round each tap: a sample whose
`floor(offset)` lies outside [-R, R] on either axis is ZEROED, and the
layer's `dcn_window_overflow` counts those of them that would have
contributed.  The port samples every layer with one CUDA kernel that is
exact at any offset (`ops/deform_conv.py`), so it never zeroes a sample, but
it computes the same count from the offsets: a nonzero count means the JAX
window model would have answered differently, and `serve.Predictor` refuses
the request, as the JAX inference entry does.

Offsets here are the port's layout, (B, h, w, 9, 2) fp32 with (dy, dx) per
tap in mmcv order; (B, h, w, 18) is accepted too.
"""

from __future__ import annotations

import torch

WINDOW_MAX_WIDTH = 128      # the Pallas kernel keeps image columns on lanes


def window_supported(w: int, kernel: int, stride: int,
                     dilation: int) -> bool:
    """Whether the JAX package runs this DCN layer on the window kernel:
    3x3, stride 1, dilation 1, input width <= 128.  The stride-2 stage-entry
    layers and wider maps take the gather path there, and carry no
    certificate."""
    return (kernel == 3 and stride == 1 and dilation == 1
            and w <= WINDOW_MAX_WIDTH)


def _taps(offset: torch.Tensor, h: int, w: int):
    """(off_y, off_x, contributes) each (B, ho, wo, 9) for offsets on an
    ho x wo grid and an h x w image: a sample contributes when its bilinear
    support meets the image, py = (iy + (ky - 1)) + dy summed in that order
    in fp32 (as `_window_weights` and `needed_radius` do)."""
    B, ho, wo = offset.shape[:3]
    off = offset.float().reshape(B, ho, wo, 9, 2)
    dev = offset.device
    k = torch.arange(9, device=dev)
    ky = (k // 3).float() - 1.0
    kx = (k % 3).float() - 1.0
    iy = torch.arange(ho, dtype=torch.float32, device=dev)[:, None, None]
    jx = torch.arange(wo, dtype=torch.float32, device=dev)[None, :, None]
    py = (iy + ky) + off[..., 0]
    px = (jx + kx) + off[..., 1]
    contributes = (py > -1.0) & (py < h) & (px > -1.0) & (px < w)
    return off[..., 0], off[..., 1], contributes


def window_overflow(offset: torch.Tensor, h: int, w: int,
                    radius: int) -> torch.Tensor:
    """The `overflow` of `_window_weights` (`occnet_tpu/ops/dcn_window.py`):
    the number of samples with `floor(dy)` or `floor(dx)` outside
    [-radius, radius] whose bilinear support meets the image.  Returns a
    0-d int64 tensor on the offsets' device (no host synchronisation)."""
    oy, ox, contributes = _taps(offset, h, w)
    fy, fx = torch.floor(oy), torch.floor(ox)
    over = (fy < -radius) | (fy > radius) | (fx < -radius) | (fx > radius)
    return (over & contributes).sum()


def needed_radius(offset: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The smallest radius at which `window_overflow` is 0: max
    |floor(offset)| over contributing samples (samples fully outside the
    h x w image never constrain it).  Returns a 0-d int64 tensor."""
    oy, ox, contributes = _taps(offset, h, w)
    f = torch.maximum(torch.floor(oy).abs(), torch.floor(ox).abs())
    return torch.where(contributes, f, torch.zeros_like(f)).max().long()
