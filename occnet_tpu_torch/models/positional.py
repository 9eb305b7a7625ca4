"""Learned 2D positional encoding of the BEV query grid (port of
`occnet_tpu/models/positional.py`): separate row/column tables, channels
[col_embed, row_embed], rows-major."""

from __future__ import annotations

import torch
import torch.nn as nn


class LearnedPositionalEncoding2D(nn.Module):
    def __init__(self, num_feats: int, row_num_embed: int, col_num_embed: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.row_embed = nn.Parameter(torch.rand(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.rand(col_num_embed, num_feats))
        self.dtype = dtype

    def forward(self, batch: int) -> torch.Tensor:
        """Returns (batch, H*W, 2*num_feats)."""
        h, f = self.row_embed.shape
        w = self.col_embed.shape[0]
        pos = torch.cat([self.col_embed[None, :, :].expand(h, w, f),
                         self.row_embed[:, None, :].expand(h, w, f)], dim=-1)
        pos = pos.reshape(h * w, 2 * f).to(self.dtype)
        return pos[None].expand(batch, h * w, 2 * f)
