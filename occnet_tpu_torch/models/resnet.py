"""ResNet-50/101 image trunk, eval path (port of `occnet_tpu/models/resnet.py`).

"pytorch style" bottlenecks (stride on the 3x3 conv), `FrozenBatchNorm`
(running statistics always, folded into one multiply-add in the compute
dtype), explicit symmetric padding: 7x7/2 pad 3 stem, 3/2 pad 1 max pool with
-inf padding.  Convolutions are cuDNN (`F.conv2d`): the JAX package leaves
them to XLA, outside any Pallas kernel.  Tensors are NCHW inside.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.models.layers import Conv2d

STAGE_BLOCKS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed running statistics (`norm_eval=True`)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (N, C, H, W)
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(self.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(self.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = mid * 4
        self.conv1 = Conv2d(in_ch, mid, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype=dtype)
        self.conv2 = Conv2d(mid, mid, 3, stride=stride, bias=False,
                            dtype=dtype)
        self.bn2 = FrozenBatchNorm(mid, dtype=dtype)
        self.conv3 = Conv2d(mid, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_ch, dtype=dtype)
        self.has_downsample = in_ch != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                          bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


def stage_channels(out_indices: Sequence[int]) -> Tuple[int, ...]:
    """Output channels of the stages named by out_indices (0..3 -> C2..C5)."""
    return tuple(64 * 2 ** s * 4 for s in out_indices)


class ResNet(nn.Module):
    """Returns the feature maps named by out_indices, NCHW."""

    def __init__(self, depth: int = 50, out_indices: Tuple[int, ...] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        self.stages: List[List[str]] = []
        in_ch, mid = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(in_ch, mid, stride, dtype))
                names.append(name)
                in_ch = mid * 4
            self.stages.append(names)
            mid *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
