"""Dense attention modules of the turbo encoder (port of
`occnet_tpu/models/dense_attention.py`).

- `DenseSpatialCrossAttention` attends each BEV query over the L x Z
  (level, z-anchor) slots of the camera-averaged planar lift U_bar.
- `DenseTemporalSelfAttention` attends each BEV query over a 3x3 tap set of
  the (prev, current) BEV value grids (`ops.tsa.tap_attention`: the CUDA
  kernels on the card, the plain versions on the CPU, forward and backward).

Both apply dropout after `output_proj` in training, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from occnet_tpu_torch.config import SCAConfig, TSAConfig
from occnet_tpu_torch.models.layers import Linear, dropout
from occnet_tpu_torch.ops.tsa import TSA_TAPS, tap_attention


class DenseSpatialCrossAttention(nn.Module):
    def __init__(self, cfg: SCAConfig, embed_dims: int = 256,
                 num_levels: int = 4, num_z: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.num_levels, self.num_z = num_levels, num_z
        self.attention_weights = Linear(
            embed_dims, cfg.num_heads * num_levels * num_z, dtype)
        self.output_proj = Linear(embed_dims, embed_dims, dtype)
        self.dtype = dtype
        self.dropout = cfg.dropout

    def forward(self, query: torch.Tensor, lifted: torch.Tensor,
                query_pos: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Q, C), lifted (B, L, Z, Q, C) -> (B, Q, C)."""
        B, Q, C = query.shape
        H, L, Z = self.num_heads, self.num_levels, self.num_z
        residual = query
        if query_pos is not None:
            query = query + query_pos
        attn = self.attention_weights(query).reshape(B, Q, H, L * Z)
        attn = torch.softmax(attn.float(), dim=-1)
        attn = attn.reshape(B, Q, H, L, Z).to(lifted.dtype)
        v = lifted.reshape(B, L, Z, Q, H, C // H)
        out = torch.einsum("blzqhd,bqhlz->bqhd", v, attn)
        out = out.reshape(B, Q, C).to(self.dtype)
        out = dropout(self.output_proj(out), self.dropout, train, generator)
        return out + residual


class DenseTemporalSelfAttention(nn.Module):
    def __init__(self, cfg: TSAConfig, embed_dims: int = 256,
                 bev_hw: Tuple[int, int] = (200, 200),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.nq = cfg.num_bev_queue
        self.bev_hw = bev_hw
        T = len(TSA_TAPS)
        self.value_proj = Linear(embed_dims, embed_dims, dtype)
        self.attention_weights = Linear(
            2 * embed_dims, self.nq * cfg.num_heads * T, dtype)
        self.output_proj = Linear(embed_dims, embed_dims, dtype)
        self.dtype = dtype
        self.dropout = cfg.dropout

    def forward(self, query: torch.Tensor, prev_bev: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Q, C), prev_bev (B, 2, Q, C) or None -> (B, Q, C)."""
        B, Q, C = query.shape
        H, nq, T = self.num_heads, self.nq, len(TSA_TAPS)
        bh, bw = self.bev_hw
        identity = query
        value = (torch.stack([query, query], dim=1) if prev_bev is None
                 else prev_bev)
        if query_pos is not None:
            query = query + query_pos
        query_aug = torch.cat([value[:, 0], query], dim=-1)
        value = self.value_proj(value)
        attn = self.attention_weights(query_aug).reshape(B, Q, H, nq, T)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        vgrid = value.reshape(B, nq, bh, bw, C)
        # (B, Q, H, nq, T) -> (B, bh, bw, nq, T, H), the tap op's layout
        attn6 = attn.permute(0, 1, 3, 4, 2).reshape(B, bh, bw, nq, T, H)
        out = tap_attention(vgrid.contiguous(), attn6.contiguous())
        out = out.reshape(B, Q, C).to(self.dtype)
        out = dropout(self.output_proj(out), self.dropout, train, generator)
        return out + identity
