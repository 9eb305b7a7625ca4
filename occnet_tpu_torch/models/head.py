"""OccHead inference path (port of `occnet_tpu/models/head.py`): the BEV
query table, the learned positional encoding, TransformerOcc, and the argmax
decode `get_occ`.  The losses belong to training and are not ported yet."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from occnet_tpu.config import ModelConfig
from occnet_tpu_torch.models.positional import LearnedPositionalEncoding2D
from occnet_tpu_torch.models.transformer_occ import TransformerOcc


class OccHead(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.bev_embedding = nn.Parameter(
            torch.randn(c.bev_h * c.bev_w, c.embed_dims))
        self.positional_encoding = LearnedPositionalEncoding2D(
            c.embed_dims // 2, c.bev_h, c.bev_w, dtype)
        self.transformer = TransformerOcc(c, dtype)

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                ego2img: torch.Tensor) -> Dict[str, torch.Tensor]:
        bev_pos = self.positional_encoding(mlvl_feats[0].shape[0])
        bev_embed, occ, flow = self.transformer(
            mlvl_feats, self.bev_embedding, bev_pos, ego2img)
        return {"bev_embed": bev_embed, "occ": occ, "flow": flow}


def get_occ(outs: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-argmax semantic decode + raw flow."""
    return outs["occ"].float().argmax(dim=-1), outs["flow"]
