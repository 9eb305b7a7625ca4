"""Positional encodings (port of `occnet_tpu/models/positional.py`): the
learned 2D encoding of the BEV query grid (separate row / column tables,
channels [col_embed, row_embed], rows-major), its 3D variant with a height
table, and the sin / cos relative position embedding with its projection."""

from __future__ import annotations

import torch
import torch.nn as nn

from occnet_tpu_torch.models.layers import Linear


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


class LearnedPositionalEncoding3D(nn.Module):
    """Row / column / height tables, channels [col, row, height], laid out
    (row, column, height)-major."""

    def __init__(self, num_feats: int, row_num_embed: int, col_num_embed: int,
                 height_num_embed: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.row_embed = nn.Parameter(torch.rand(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.rand(col_num_embed, num_feats))
        self.height_embed = nn.Parameter(torch.rand(height_num_embed,
                                                    num_feats))
        self.dtype = dtype

    def forward(self, batch: int) -> torch.Tensor:
        """Returns (batch, H*W*Z, 3*num_feats)."""
        h, f = self.row_embed.shape
        w, z = self.col_embed.shape[0], self.height_embed.shape[0]
        pos = torch.cat([
            self.col_embed[None, :, None, :].expand(h, w, z, f),
            self.row_embed[:, None, None, :].expand(h, w, z, f),
            self.height_embed[None, None, :, :].expand(h, w, z, f)], dim=-1)
        pos = pos.reshape(h * w * z, 3 * f).to(self.dtype)
        return pos[None].expand(batch, *pos.shape)


def relative_position_features(h: int, w: int, num_pos_feats: int
                               ) -> torch.Tensor:
    """(h * w, 2 * num_pos_feats) float32 [x_feat, y_feat] of each cell,
    x_feat = [sin, cos](x / w * freqs), freqs = 1 / 10000^(i / (half - 1)).
    Built on the host: the table depends on no input, and one table serves
    every device."""
    half = num_pos_feats // 2
    i = torch.arange(half, dtype=torch.float32)
    freqs = 1.0 / (10000.0 ** (i / float(max(half - 1, 1))))
    ys = (torch.arange(h, dtype=torch.float32) / float(h))[:, None] \
        * freqs[None, :]
    xs = (torch.arange(w, dtype=torch.float32) / float(w))[:, None] \
        * freqs[None, :]
    y_feat = torch.cat([torch.sin(ys), torch.cos(ys)], dim=-1)
    x_feat = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    return torch.cat([x_feat[None].expand(h, w, num_pos_feats),
                      y_feat[:, None].expand(h, w, num_pos_feats)],
                     dim=-1).reshape(h * w, 2 * num_pos_feats)


class RelPositionEmbedding(nn.Module):
    """sin / cos 2D relative position features of an h x w grid projected
    by a Linear (``proj``) to ``out_dim``."""

    def __init__(self, num_pos_feats: int = 64, out_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.proj = Linear(2 * num_pos_feats, out_dim, dtype)
        self.dtype = dtype

    def forward(self, h: int, w: int) -> torch.Tensor:
        """Returns (h * w, out_dim) on the module's device."""
        pos = relative_position_features(h, w, self.num_pos_feats)
        return self.proj(pos.to(self.proj.weight.device, self.dtype))
