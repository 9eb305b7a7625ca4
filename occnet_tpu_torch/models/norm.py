"""`LayerNorm32`: last-axis LayerNorm with fp32 statistics and output cast to
the compute dtype (port of `occnet_tpu/models/norm.py`)."""

from __future__ import annotations

import torch
import torch.nn as nn


class LayerNorm32(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.out_dtype)
