"""Linear and convolution layers that compute in a given dtype, and dropout.

Parameters stay float32 (as the JAX package keeps them); input and weights are
cast to the compute dtype at use, like a flax `Dense`/`Conv` built with
``dtype=...``.  Convolutions take NCHW / NCDHW tensors (any memory format).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """Square kernel, symmetric padding k // 2 (the JAX package's explicit
    padding), optional stride; ``groups`` = channels is the depthwise conv
    of flax's ``feature_group_count``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k // 2,
                         bias=bias, groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, 1, self.groups)


class Conv3d(nn.Conv3d):
    """3x3x3, padding 1, no bias (the voxel decoder's conv)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, padding=1, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), None, 1, 1)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: in training keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); the mask is drawn from
    ``generator`` (on x's device), so a train step's masks follow its seed.
    Identity outside training or at rate 0."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
