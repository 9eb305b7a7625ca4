"""PerceptionTransformer, the object-query (detection) BEVFormer transformer
(port of `occnet_tpu/models/perception.py`): the BEVFormer encoder, always
in gather mode (the exact one), then the object-query decoder
(`models/decoder.py`) with a box-regression branch a layer.

`get_bev_features`, as in the JAX package:

- the can-bus ego-motion shift of the prev slot's reference points
  (`ops/transforms.shift_bev_ref` of can_bus[:2] and the yaw can_bus[-2] in
  degrees); the degrees are can_bus[-2] * fl32(180 / fl32(pi)), one fp32
  multiplication, as XLA compiles the JAX package's ``s / pi * 180``;
- the prev BEV rotated by can_bus[-1] degrees about the grid centre
  (`ops/transforms.rotate_bev`, tie-exact against XLA);
- the can-bus MLP's embedding added to the BEV queries;
- camera / level embeddings on the flattened camera pyramid, the encoder.

`forward` returns (bev_embed, inter_states, init_reference,
inter_references, sca_topk_overflow): the JAX tuple and the gather
encoder's certificate, the number of visible BEV queries the static top-K
dropped (a 0-d int64 tensor).  The JAX package answers whatever it is; a
caller of the port that answers must raise on a nonzero value, as
`serve.Predictor` does, since the two packages then select different
queries (`models/attention.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.config import ModelConfig
from occnet_tpu_torch.models.decoder import DetectionTransformerDecoder
from occnet_tpu_torch.models.encoder import BEVFormerEncoder
from occnet_tpu_torch.models.layers import Linear
from occnet_tpu_torch.models.norm import LayerNorm32
from occnet_tpu_torch.models.positional import LearnedPositionalEncoding2D
from occnet_tpu_torch.ops.transforms import rotate_bev, shift_bev_ref

# XLA's folding of `s / jnp.pi * 180.0`: one multiplication by this fp32
DEG_PER_RAD_XLA = float(np.float32(np.float32(180.0) / np.float32(np.pi)))


class CanBusMLP(nn.Module):
    """18-dim can-bus signal -> embed_dims: Linear -> ReLU -> Linear ->
    ReLU (-> LayerNorm with ``can_bus_norm``)."""

    def __init__(self, embed_dims: int, can_bus_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(18, embed_dims // 2, dtype)
        self.fc2 = Linear(embed_dims // 2, embed_dims, dtype)
        self.norm = (LayerNorm32(embed_dims, out_dtype=dtype)
                     if can_bus_norm else None)

    def forward(self, can_bus: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc2(F.relu(self.fc1(can_bus))))
        return x if self.norm is None else self.norm(x)


class RegBranch(nn.Module):
    """A decoder layer's box regression branch, fp32: Linear -> ReLU ->
    Linear -> ReLU -> Linear(code_size)."""

    def __init__(self, embed_dims: int, code_size: int = 10):
        super().__init__()
        self.fc1 = Linear(embed_dims, embed_dims)
        self.fc2 = Linear(embed_dims, embed_dims)
        self.out = Linear(embed_dims, code_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.out(F.relu(self.fc2(F.relu(self.fc1(x)))))


class PerceptionTransformer(nn.Module):
    """``rotate_center`` None is the grid centre (bev_w / 2, bev_h / 2).
    ``dtype`` is the compute dtype (float32 by default, as the JAX
    module's field)."""

    def __init__(self, cfg: ModelConfig, num_query: int = 900,
                 code_size: int = 10, decoder_layers: int = 6,
                 rotate_prev_bev: bool = True, use_shift: bool = True,
                 use_can_bus: bool = True, can_bus_norm: bool = True,
                 rotate_center: Optional[Tuple[float, float]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.rotate_prev_bev, self.use_shift = rotate_prev_bev, use_shift
        self.use_can_bus = use_can_bus
        self.rotate_center = rotate_center
        # detection always runs the exact encoder
        enc_cfg = dataclasses.replace(c.encoder, mode="gather")
        C = c.embed_dims
        self.level_embeds = nn.Parameter(torch.randn(c.num_feature_levels,
                                                     C))
        self.cams_embeds = nn.Parameter(torch.randn(c.num_cams, C))
        self.bev_embedding = nn.Parameter(torch.randn(c.bev_h * c.bev_w, C))
        self.query_embedding = nn.Parameter(torch.randn(num_query, 2 * C))
        self.positional_encoding = LearnedPositionalEncoding2D(
            C // 2, c.bev_h, c.bev_w, dtype)
        self.can_bus_mlp = CanBusMLP(C, can_bus_norm, dtype)
        self.reference_points = Linear(C, 3, torch.float32)
        self.encoder = BEVFormerEncoder(
            enc_cfg, C, (c.bev_h, c.bev_w), c.num_feature_levels, c.num_cams,
            c.pc_range, (c.img_h, c.img_w), dtype)
        self.decoder = DetectionTransformerDecoder(
            decoder_layers, C, ffn_dim=c.encoder.ffn_dim,
            internal_refine=False, dtype=dtype)
        self.decoder_layers = decoder_layers
        for i in range(decoder_layers):
            self.add_module(f"reg_branch{i}", RegBranch(C, code_size))

    @property
    def reg_branches(self):
        return [getattr(self, f"reg_branch{i}")
                for i in range(self.decoder_layers)]

    def flatten_mlvl_feats(self, mlvl_feats: Sequence[torch.Tensor]
                           ) -> Tuple[torch.Tensor,
                                      Tuple[Tuple[int, int], ...]]:
        """(B, cams, h, w, C) per level -> (B, cams, V, C) with camera and
        level embeddings, and the level shapes."""
        flat, shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            b, n_cam, h, w, ch = feat.shape
            shapes.append((int(h), int(w)))
            f = feat.reshape(b, n_cam, h * w, ch)
            f = f + self.cams_embeds[None, :, None, :].to(f.dtype)
            f = f + self.level_embeds[lvl].to(f.dtype)
            flat.append(f)
        return torch.cat(flat, dim=2), tuple(shapes)

    def get_bev_features(self, mlvl_feats: Sequence[torch.Tensor],
                         ego2img: torch.Tensor,
                         can_bus: Optional[torch.Tensor] = None,
                         prev_bev: Optional[torch.Tensor] = None,
                         train: bool = False,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mlvl_feats (B, cams, h, w, C) a level, ego2img (B, cams, 4, 4),
        can_bus (B, 18), prev_bev (B, Q, C) -> (bev (B, Q, C),
        sca_topk_overflow)."""
        c = self.cfg
        b = mlvl_feats[0].shape[0]
        queries = self.bev_embedding[None].expand(
            b, *self.bev_embedding.shape).to(self.dtype)
        bev_pos = self.positional_encoding(b)
        if prev_bev is not None and can_bus is None and (
                self.rotate_prev_bev or self.use_shift):
            raise ValueError(
                "prev_bev requires can_bus when rotate_prev_bev/use_shift "
                "are enabled (pass can_bus, or disable both for "
                "pre-aligned prev maps)")
        shift_ref_2d = None
        if can_bus is not None:
            cb = can_bus.float()
            if self.use_shift:
                grid_length = ((c.pc_range[4] - c.pc_range[1]) / c.bev_h,
                               (c.pc_range[3] - c.pc_range[0]) / c.bev_w)
                shift = shift_bev_ref(cb[:, :2], cb[:, -2] * DEG_PER_RAD_XLA,
                                      grid_length, (c.bev_h, c.bev_w))
                shift_ref_2d = (self.encoder.ref_2d[None]
                                + shift[:, None, None, :])   # (B, Q, 1, 2)
            if prev_bev is not None and self.rotate_prev_bev:
                maps = prev_bev.reshape(b, c.bev_h, c.bev_w, c.embed_dims)
                center = (self.rotate_center if self.rotate_center is not None
                          else (c.bev_w / 2.0, c.bev_h / 2.0))
                prev_bev = rotate_bev(maps, cb[:, -1], center=center).reshape(
                    b, c.bev_h * c.bev_w, c.embed_dims)
            if self.use_can_bus:
                queries = queries + self.can_bus_mlp(cb)[:, None, :].to(
                    queries.dtype)
        value, shapes = self.flatten_mlvl_feats(mlvl_feats)
        return self.encoder(queries, value, bev_pos, ego2img, shapes,
                            prev_bev, shift_ref_2d, train, generator)

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                ego2img: torch.Tensor,
                can_bus: Optional[torch.Tensor] = None,
                prev_bev: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """-> (bev_embed (B, Q, C), inter_states (L, B, Nq, C),
        init_reference (B, Nq, 3), inter_references (L, B, Nq, 3),
        sca_topk_overflow)."""
        c = self.cfg
        b = mlvl_feats[0].shape[0]
        bev_embed, overflow = self.get_bev_features(
            mlvl_feats, ego2img, can_bus, prev_bev, train, generator)
        query_pos, query = torch.split(self.query_embedding, c.embed_dims,
                                       dim=1)
        query_pos = query_pos[None].expand(b, *query_pos.shape).to(self.dtype)
        query = query[None].expand(b, *query.shape).to(self.dtype)
        ref = torch.sigmoid(self.reference_points(query_pos.float()))
        inter_states, inter_references = self.decoder(
            query, bev_embed, query_pos, ref, [(c.bev_h, c.bev_w)],
            reg_branches=self.reg_branches, train=train, generator=generator)
        return bev_embed, inter_states, ref, inter_references, overflow
