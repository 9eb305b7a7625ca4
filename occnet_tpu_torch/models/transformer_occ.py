"""TransformerOcc (port of `occnet_tpu/models/transformer_occ.py`):
camera/level embeddings, then in dense mode the layer-shared value projection
and the planar lift, in gather mode the flattened camera pyramid; the
BEVFormer encoder, the Conv3d voxel decoder and the occ/flow MLP heads.

Output grids are (B, X, Y, Z, .) like the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.config import ModelConfig
from occnet_tpu_torch.models.encoder import BEVFormerEncoder
from occnet_tpu_torch.models.layers import Conv3d, Linear
from occnet_tpu_torch.ops.planar_lift import lift_and_average
from occnet_tpu_torch.parallel.multihost import all_reduce_sum, world_size


class BatchNorm3d(nn.Module):
    """BatchNorm over dim 1 in fp32 with flax `BatchNorm` semantics
    (momentum 0.9): ((x - mean) * (rsqrt(var + eps) * scale)) + bias, with
    the running statistics in eval and, in training, the batch mean and the
    biased variance E[x^2] - E[x]^2 (flax's fast variance, clipped at 0),
    the running statistics becoming 0.9 * running + 0.1 * batch.

    Under a process group of more than one rank the batch is the global
    one, as under the JAX package's jit over the data axis: one
    differentiable all-reduce of [sum x, sum x^2, count] per call.  At
    world size 1 the arithmetic is the single-process one, bit for bit."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        xf = x.float()
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            if world_size() > 1:
                count = xf.new_full((1, x.shape[1]), x.numel() // x.shape[1])
                s = all_reduce_sum(torch.cat([
                    xf.sum(dim=dims)[None], (xf * xf).sum(dim=dims)[None],
                    count]))
                mean = s[0] / s[2]
                var = (s[1] / s[2] - mean * mean).clamp(min=0.0)
            else:
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(
                    min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape)


class ConvBNReLU3D(nn.Module):
    """Conv3d(3x3x3, no bias) + BatchNorm3d + ReLU on NCDHW."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(in_ch, features, dtype)
        self.bn = BatchNorm3d(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), train)).to(self.dtype)


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
            c.num_feature_levels, c.num_cams, c.pc_range, (c.img_h, c.img_w),
            dtype)
        if c.encoder.mode == "dense":
            # layer-shared pre-lift value projection (dense mode only; the
            # gather encoder keeps a value projection per layer)
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

    def flatten_mlvl_feats(self, mlvl_feats: Sequence[torch.Tensor]
                           ) -> Tuple[torch.Tensor, Tuple[Tuple[int, int],
                                                          ...]]:
        """Gather mode: the embedded (B, cams, h, w, C) maps flattened and
        concatenated level by level -> (B, cams, V, C) + the level shapes."""
        flat = [f.reshape(*f.shape[:2], -1, f.shape[-1])
                for f in self.flat_embed(mlvl_feats)]
        shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in mlvl_feats)
        return torch.cat(flat, dim=2), shapes

    def get_bev_features(self, mlvl_feats: Sequence[torch.Tensor],
                         bev_queries: torch.Tensor, bev_pos: torch.Tensor,
                         ego2img: torch.Tensor,
                         prev_bev: Optional[torch.Tensor] = None,
                         shift_ref_2d: Optional[torch.Tensor] = None,
                         train: bool = False,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Dense: shared value projection on the camera maps (it commutes
        with the channel-linear lift), the lift, then the encoder.  Gather:
        the flattened pyramid into the encoder.  ``prev_bev`` /
        ``shift_ref_2d`` go to the encoder's TSA.  -> ((B, Q, C),
        sca_topk_overflow or None)."""
        c = self.cfg
        b = mlvl_feats[0].shape[0]
        queries = bev_queries[None].expand(b, *bev_queries.shape).to(
            self.dtype)
        if c.encoder.mode == "gather":
            value, shapes = self.flatten_mlvl_feats(mlvl_feats)
            return self.encoder(queries, value, bev_pos, ego2img, shapes,
                                prev_bev, shift_ref_2d, train, generator)
        feats = [self.shared_value_proj(f)
                 for f in self.flat_embed(mlvl_feats)]
        lifted, _count = lift_and_average(
            feats, ego2img, c.pc_range, c.encoder.num_points_in_pillar,
            (c.bev_h, c.bev_w), (c.img_h, c.img_w), out_dtype=self.dtype)
        return self.encoder(queries, lifted, bev_pos, prev_bev=prev_bev,
                            shift_ref_2d=shift_ref_2d, train=train,
                            generator=generator)

    def decode_voxels(self, bev_embed: torch.Tensor, train: bool = False
                      ) -> torch.Tensor:
        """(B, Q, C) -> (B, X, Y, Z, out_dim).  C splits middle-major x
        pillar; the decoder runs NCDHW with D = pillar (z)."""
        c = self.cfg
        b = bev_embed.shape[0]
        middle = c.embed_dims // c.pillar_h
        x = bev_embed.reshape(b, c.bev_h, c.bev_w, middle, c.pillar_h)
        x = x.permute(0, 3, 4, 1, 2)                     # (B, mid, Z, H, W)
        x = self.decoder1(self.decoder0(x, train), train)
        return x.permute(0, 4, 3, 2, 1)                  # (B, X=W, Y=H, Z, C')

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                bev_queries: torch.Tensor, bev_pos: torch.Tensor,
                ego2img: torch.Tensor,
                prev_bev: Optional[torch.Tensor] = None,
                shift_ref_2d: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """-> (bev_embed, occ logits, flow, sca_topk_overflow or None)."""
        bev_embed, overflow = self.get_bev_features(
            mlvl_feats, bev_queries, bev_pos, ego2img, prev_bev, shift_ref_2d,
            train, generator)
        vox = self.decode_voxels(bev_embed, train)
        return (bev_embed, self.predicter(vox), self.flow_predicter(vox),
                overflow)
