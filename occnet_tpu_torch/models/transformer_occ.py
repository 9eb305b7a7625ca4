"""TransformerOcc, dense mode (port of `occnet_tpu/models/transformer_occ.py`):
camera/level embeddings + the layer-shared value projection, the planar lift,
the BEVFormer encoder, the Conv3d voxel decoder and the occ/flow MLP heads.

Output grids are (B, X, Y, Z, .) like the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu.config import ModelConfig
from occnet_tpu_torch.models.encoder import BEVFormerEncoder
from occnet_tpu_torch.models.layers import Conv3d, Linear
from occnet_tpu_torch.ops.planar_lift import lift_and_average


class BatchNorm3dEval(nn.Module):
    """Eval-mode BatchNorm over dim 1 in fp32, flax `BatchNorm` order:
    ((x - mean) * (rsqrt(var + eps) * scale)) + bias."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape)


class ConvBNReLU3D(nn.Module):
    """Conv3d(3x3x3, no bias) + BatchNorm3d (eval) + ReLU on NCDHW."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(in_ch, features, dtype)
        self.bn = BatchNorm3dEval(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x))).to(self.dtype)


class MLPHead(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int,
                 activation: str = "softplus",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, dtype)
        self.fc2 = Linear(hidden, out, dtype)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = F.softplus(x) if self.activation == "softplus" else F.relu(x)
        return self.fc2(x)


class TransformerOcc(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.level_embeds = nn.Parameter(
            torch.randn(c.num_feature_levels, c.embed_dims))
        self.cams_embeds = nn.Parameter(torch.randn(c.num_cams, c.embed_dims))
        self.encoder = BEVFormerEncoder(
            c.encoder, c.embed_dims, (c.bev_h, c.bev_w),
            c.num_feature_levels, dtype)
        self.shared_value_proj = Linear(c.embed_dims, c.embed_dims, dtype)
        middle = c.embed_dims // c.pillar_h
        self.decoder0 = ConvBNReLU3D(middle, c.out_dim, dtype)
        self.decoder1 = ConvBNReLU3D(c.out_dim, c.out_dim, dtype)
        self.predicter = MLPHead(c.out_dim, c.out_dim * 2, c.num_classes,
                                 "softplus", dtype)
        self.flow_predicter = MLPHead(c.out_dim, c.out_dim * 2, 2, "relu",
                                      dtype)

    def flat_embed(self, mlvl_feats: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Camera/level embeddings on the (B, cams, h, w, C) maps."""
        out = []
        for lvl, f in enumerate(mlvl_feats):
            if self.cfg.use_cams_embeds:
                f = f + self.cams_embeds[None, :, None, None, :].to(f.dtype)
            out.append(f + self.level_embeds[lvl].to(f.dtype))
        return out

    def get_bev_features(self, mlvl_feats: Sequence[torch.Tensor],
                         bev_queries: torch.Tensor, bev_pos: torch.Tensor,
                         ego2img: torch.Tensor) -> torch.Tensor:
        """Shared value projection on the camera maps (it commutes with the
        channel-linear lift), the lift, then the encoder.  -> (B, Q, C)."""
        c = self.cfg
        b = mlvl_feats[0].shape[0]
        feats = [self.shared_value_proj(f) for f in self.flat_embed(mlvl_feats)]
        lifted, _count = lift_and_average(
            feats, ego2img, c.pc_range, c.encoder.num_points_in_pillar,
            (c.bev_h, c.bev_w), (c.img_h, c.img_w), out_dtype=self.dtype)
        queries = bev_queries[None].expand(b, *bev_queries.shape).to(
            self.dtype)
        return self.encoder(queries, lifted, bev_pos)

    def decode_voxels(self, bev_embed: torch.Tensor) -> torch.Tensor:
        """(B, Q, C) -> (B, X, Y, Z, out_dim).  C splits middle-major x
        pillar; the decoder runs NCDHW with D = pillar (z)."""
        c = self.cfg
        b = bev_embed.shape[0]
        middle = c.embed_dims // c.pillar_h
        x = bev_embed.reshape(b, c.bev_h, c.bev_w, middle, c.pillar_h)
        x = x.permute(0, 3, 4, 1, 2)                     # (B, mid, Z, H, W)
        x = self.decoder1(self.decoder0(x))
        return x.permute(0, 4, 3, 2, 1)                  # (B, X=W, Y=H, Z, C')

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                bev_queries: torch.Tensor, bev_pos: torch.Tensor,
                ego2img: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        bev_embed = self.get_bev_features(mlvl_feats, bev_queries, bev_pos,
                                          ego2img)
        vox = self.decode_voxels(bev_embed)
        return bev_embed, self.predicter(vox), self.flow_predicter(vox)
