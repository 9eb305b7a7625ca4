"""GridMask augmentation (port of `occnet_tpu/ops/grid_mask.py`), split into
a draw from a `torch.Generator` and an apply from explicit draws.

With grid period d, strip length l = clip(int(0.5 * d + 0.5), 1, d - 1) and
random phases st_h / st_w on a 1.5x canvas cropped centrally, a pixel is kept
when it lies in a row strip OR a column strip (mode 1; rotate=1 means no
rotation).  One draw covers every image of the batch.  The draws stay on the
device as 0-d tensors, so neither step waits for the device.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Draw = Union[int, bool, torch.Tensor]


def grid_mask_draw(generator: Optional[torch.Generator], h: int,
                   prob: float = 0.7, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(apply, d, st_h, st_w): apply with probability ``prob``, d uniform in
    [2, h), each phase uniform in [0, d)."""
    dev = generator.device if generator is not None else device

    def uni():
        return torch.rand((), generator=generator, device=dev)

    apply = uni() < prob
    d = torch.randint(2, h, (), generator=generator, device=dev)
    st_h = (uni() * d).floor().long().clamp(max=d - 1)
    st_w = (uni() * d).floor().long().clamp(max=d - 1)
    return apply, d, st_h, st_w


def grid_mask_apply(imgs: torch.Tensor, apply: Draw, d: Draw, st_h: Draw,
                    st_w: Draw, ratio: float = 0.5) -> torch.Tensor:
    """imgs (N, H, W, C) -> imgs * mask, the mask of the JAX package's
    `grid_mask` for the given draws (all ones when ``apply`` is false)."""
    n, h, w, c = imgs.shape
    dev = imgs.device
    d = torch.as_tensor(d, device=dev)
    l = (d.float() * ratio + 0.5).long().clamp(min=1)
    l = torch.minimum(l, d - 1)
    off_h = ((3 * h) // 2 - h) // 2
    off_w = ((3 * w) // 2 - w) // 2
    ys = torch.arange(h, device=dev) + off_h
    xs = torch.arange(w, device=dev) + off_w
    row_strip = torch.remainder(ys - torch.as_tensor(st_h, device=dev), d) < l
    col_strip = torch.remainder(xs - torch.as_tensor(st_w, device=dev), d) < l
    keep = row_strip[:, None] | col_strip[None, :]
    mask = torch.where(torch.as_tensor(apply, device=dev), keep,
                       torch.ones_like(keep))
    return imgs * mask[None, :, :, None].to(imgs.dtype)
