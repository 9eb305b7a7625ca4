"""FPN neck (port of `occnet_tpu/models/fpn.py`): lateral 1x1 convs, top-down
nearest 2x upsampling cropped to the lateral's size, 3x3 output convs, and
extra stride-2 levels on the last output (`on_output`, ReLU before an extra
conv only for i > 0).  Tensors are NCHW."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.models.layers import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, relu_before_extra_convs: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_in = len(in_channels)
        self.n_extra = num_outs - self.n_in
        self.relu_before_extra_convs = relu_before_extra_convs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv2d(c, out_channels, 1,
                                                   dtype=dtype))
            self.add_module(f"fpn_{i}", Conv2d(out_channels, out_channels, 3,
                                               dtype=dtype))
        for i in range(self.n_extra):
            self.add_module(f"fpn_extra_{i}", Conv2d(
                out_channels, out_channels, 3, stride=2, dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(inputs)]
        for i in range(self.n_in - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode="nearest")
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[..., :h, :w]
        outs = [getattr(self, f"fpn_{i}")(laterals[i])
                for i in range(self.n_in)]
        for i in range(self.n_extra):
            src = outs[-1]
            if self.relu_before_extra_convs and i > 0:
                src = F.relu(src)
            outs.append(getattr(self, f"fpn_extra_{i}")(src))
        return outs
