"""Dense BEVFormer encoder (port of the dense branch of
`occnet_tpu/models/encoder.py`): num_layers x (temporal self-attention, LN,
spatial cross-attention over the lift, LN, FFN, LN).  The gather encoder's
reference-point projection is unused in dense mode and not ported."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu.config import EncoderConfig
from occnet_tpu_torch.models.dense_attention import (
    DenseSpatialCrossAttention,
    DenseTemporalSelfAttention,
)
from occnet_tpu_torch.models.layers import Linear
from occnet_tpu_torch.models.norm import LayerNorm32


class FFN(nn.Module):
    """Linear -> ReLU -> Linear + residual (dropout is identity in eval)."""

    def __init__(self, embed_dims: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(embed_dims, ffn_dim, dtype)
        self.fc2 = Linear(ffn_dim, embed_dims, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x))) + x


class BEVFormerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, embed_dims: int,
                 bev_hw: Tuple[int, int], num_levels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = DenseTemporalSelfAttention(cfg.tsa, embed_dims,
                                                    bev_hw, dtype)
        self.norm1 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.cross_attn = DenseSpatialCrossAttention(
            cfg.sca, embed_dims, num_levels, cfg.num_points_in_pillar, dtype)
        self.norm2 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.ffn = FFN(embed_dims, cfg.ffn_dim, dtype)
        self.norm3 = LayerNorm32(embed_dims, out_dtype=dtype)

    def forward(self, query: torch.Tensor, lifted: torch.Tensor,
                bev_pos: torch.Tensor,
                prev_bev: Optional[torch.Tensor]) -> torch.Tensor:
        query = self.norm1(self.self_attn(query, prev_bev, bev_pos))
        query = self.norm2(self.cross_attn(query, lifted))
        return self.norm3(self.ffn(query))


class BEVFormerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, embed_dims: int,
                 bev_hw: Tuple[int, int], num_levels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.mode != "dense":
            raise ValueError(f"occnet_tpu_torch ports the dense encoder only, "
                             f"got mode={cfg.mode!r}")
        self.num_layers = cfg.num_layers
        for lid in range(cfg.num_layers):
            self.add_module(f"layer{lid}", BEVFormerLayer(
                cfg, embed_dims, bev_hw, num_levels, dtype))

    def forward(self, bev_query: torch.Tensor, lifted: torch.Tensor,
                bev_pos: torch.Tensor) -> torch.Tensor:
        """bev_query/bev_pos (B, Q, C), lifted (B, L, Z, Q, C); single frame
        (no history BEV: each TSA layer attends over [query, query])."""
        for lid in range(self.num_layers):
            bev_query = getattr(self, f"layer{lid}")(bev_query, lifted,
                                                     bev_pos, None)
        return bev_query
