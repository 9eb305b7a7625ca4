"""BEVFormer encoder (port of `occnet_tpu/models/encoder.py`): num_layers x
(temporal self-attention, LN, spatial cross-attention, LN, FFN, LN), in
either mode of the JAX package:

- "dense" (turbo): TSA is the 3x3 tap attention, SCA attends over the
  camera-averaged planar lift;
- "gather" (exact): deformable TSA and SCA (`models/attention.py`), with the
  pillar reference points projected into the cameras once per forward
  (`geometry.py`) and shared by every layer.

Without a history BEV each TSA layer attends over [query, query].  With one
(the temporal path), the queue [prev_bev, initial query] is built once
before the layer loop and shared by every layer; in gather mode the prev
slot is sampled at the shifted reference points (``shift_ref_2d``), while
the dense tap attention has no reference points and ignores the shift, as
the JAX package's `DenseTemporalSelfAttention` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.config import EncoderConfig
from occnet_tpu_torch.geometry import (
    bev_reference_points_2d,
    bev_reference_points_3d,
    project_bev_points_to_cameras,
)
from occnet_tpu_torch.models.attention import (
    SpatialCrossAttention,
    TemporalSelfAttention,
)
from occnet_tpu_torch.models.dense_attention import (
    DenseSpatialCrossAttention,
    DenseTemporalSelfAttention,
)
from occnet_tpu_torch.models.layers import Linear, dropout
from occnet_tpu_torch.models.norm import LayerNorm32
from occnet_tpu_torch.utils.profiling import span


class FFN(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear -> Dropout + residual (dropout
    only in training)."""

    def __init__(self, embed_dims: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(embed_dims, ffn_dim, dtype)
        self.fc2 = Linear(ffn_dim, embed_dims, dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = dropout(F.relu(self.fc1(x)), self.dropout, train, generator)
        return dropout(self.fc2(y), self.dropout, train, generator) + x


class BEVFormerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, embed_dims: int,
                 bev_hw: Tuple[int, int], num_levels: int, num_cams: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode = cfg.mode
        dense = cfg.mode == "dense"
        self.self_attn = (
            DenseTemporalSelfAttention(cfg.tsa, embed_dims, bev_hw, dtype)
            if dense else TemporalSelfAttention(cfg.tsa, embed_dims, dtype))
        self.norm1 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.cross_attn = (
            DenseSpatialCrossAttention(cfg.sca, embed_dims, num_levels,
                                       cfg.num_points_in_pillar, dtype)
            if dense else SpatialCrossAttention(cfg.sca, embed_dims,
                                                num_cams, dtype))
        self.norm2 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.ffn = FFN(embed_dims, cfg.ffn_dim, dtype, cfg.ffn_dropout)
        self.norm3 = LayerNorm32(embed_dims, out_dtype=dtype)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                bev_pos: torch.Tensor, prev_bev: Optional[torch.Tensor],
                geometry: Optional[tuple] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, shard=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Dense: value is the lift (B, L, Z, Q, C).  Gather: value is the
        camera pyramid (B, cams, V, C) and ``geometry`` holds (hybrid_ref_2d,
        ref_cam, bev_mask, bev_hw, img_spatial_shapes).  ``shard`` goes to
        both attentions (`BEVFormerEncoder.forward`).  Returns the query and
        the SCA certificate (None in dense mode)."""
        if self.mode == "dense":
            query = self.norm1(self.self_attn(query, prev_bev, bev_pos, train,
                                              generator, shard))
            query = self.norm2(self.cross_attn(query, value, None, train,
                                               generator))
            overflow = None
        else:
            ref_2d, ref_cam, bev_mask, bev_hw, shapes = geometry
            query = self.norm1(self.self_attn(query, prev_bev, bev_pos,
                                              ref_2d, [bev_hw], train,
                                              generator, shard))
            query, overflow = self.cross_attn(query, value, None, ref_cam,
                                              bev_mask, shapes, train,
                                              generator, shard)
            query = self.norm2(query)
        return self.norm3(self.ffn(query, train, generator)), overflow


class BEVFormerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, embed_dims: int,
                 bev_hw: Tuple[int, int], num_levels: int, num_cams: int,
                 pc_range: Sequence[float], img_hw: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.mode not in ("dense", "gather"):
            raise ValueError(f"unknown encoder mode {cfg.mode!r}")
        self.cfg = cfg
        self.bev_hw = bev_hw
        self.pc_range = tuple(pc_range)
        self.img_hw = img_hw
        self.num_layers = cfg.num_layers
        for lid in range(cfg.num_layers):
            self.add_module(f"layer{lid}", BEVFormerLayer(
                cfg, embed_dims, bev_hw, num_levels, num_cams, dtype))
        if cfg.mode == "gather":
            # input-independent reference points, built once on the host
            # (fp32, true division) and moved with the module; not weights
            bev_h, bev_w = bev_hw
            self.register_buffer("ref_2d", torch.from_numpy(
                bev_reference_points_2d(bev_h, bev_w)), persistent=False)
            self.register_buffer("ref_3d", torch.from_numpy(
                bev_reference_points_3d(bev_h, bev_w,
                                        self.pc_range[5] - self.pc_range[2],
                                        cfg.num_points_in_pillar)),
                persistent=False)

    def gather_geometry(self, B: int, ego2img: torch.Tensor,
                        img_spatial_shapes: Sequence[Tuple[int, int]],
                        shift_ref_2d: Optional[torch.Tensor] = None,
                        shard=None) -> tuple:
        """The layer-invariant geometry of gather mode: TSA's hybrid
        reference [shift_ref_2d, ref_2d] (B, 2, Q, 1, 2), the prev slot's
        points shifted when ``shift_ref_2d`` (broadcastable to (B, Q, 1, 2))
        is given, and the pillar anchors' camera projection (ref_cam,
        bev_mask), computed once per forward; with ``shard``, for its
        queries alone (``shift_ref_2d`` already cut to them)."""
        with span("encoder.geometry"):
            ref_2d, ref_3d = self.ref_2d, self.ref_3d
            if shard is not None:
                ref_2d = shard.slice_q(ref_2d, 0)
                ref_3d = shard.slice_q(ref_3d)
            ref_2d = ref_2d[None].expand(B, *ref_2d.shape)
            shifted = (ref_2d if shift_ref_2d is None
                       else shift_ref_2d.float().expand(ref_2d.shape))
            hybrid = torch.stack([shifted, ref_2d], dim=1)
            ref_cam, bev_mask = project_bev_points_to_cameras(
                ref_3d, self.pc_range, ego2img, self.img_hw)
        return (hybrid, ref_cam, bev_mask, self.bev_hw,
                tuple(img_spatial_shapes))

    def forward(self, bev_query: torch.Tensor, value: torch.Tensor,
                bev_pos: torch.Tensor, ego2img: Optional[torch.Tensor] = None,
                img_spatial_shapes: Sequence[Tuple[int, int]] = (),
                prev_bev: Optional[torch.Tensor] = None,
                shift_ref_2d: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                shard=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """bev_query/bev_pos (B, Q, C); value the lift (B, L, Z, Q, C) in
        dense mode, the flattened camera pyramid (B, cams, V, C) with
        ``ego2img`` and ``img_spatial_shapes`` in gather mode.  ``prev_bev``
        (B, Q, C) is the aligned history BEV (None: single frame) and
        ``shift_ref_2d`` (B, Q, 1, 2) the prev slot's shifted reference
        points (gather mode only).  Dropout in training draws its masks
        from ``generator``.  Returns (bev (B, Q, C), sca_topk_overflow
        summed over the layers as the JAX inference entry sums the sown
        values; None in dense mode).

        With ``shard`` (a `parallel.qshard.QShard`, the JAX package's
        ``shard_q``) the encoder runs on the shard's block of BEV rows:
        bev_query, bev_pos, prev_bev and shift_ref_2d are the whole BEV's
        and are cut to the block here, a dense value is the row-range
        lift of the block (`lift_and_average(rows=...)`), the dropout
        masks are the unsharded ones' rows, and the result is the block's
        rows (B, Q / mp, C)."""
        if shard is not None:
            bev_query, bev_pos, prev_bev, shift_ref_2d = (
                shard.slice_q(t) for t in (bev_query, bev_pos, prev_bev,
                                           shift_ref_2d))
            generator = shard.draws(generator)
        geometry = None
        if self.cfg.mode == "gather":
            geometry = self.gather_geometry(bev_query.shape[0], ego2img,
                                            img_spatial_shapes, shift_ref_2d,
                                            shard)
        prev_queue = None
        if prev_bev is not None:
            prev_queue = torch.stack([prev_bev.to(bev_query.dtype),
                                      bev_query], dim=1)
        total = None
        for lid in range(self.num_layers):
            bev_query, overflow = getattr(self, f"layer{lid}")(
                bev_query, value, bev_pos, prev_queue, geometry, train,
                generator, shard)
            if overflow is not None:
                total = overflow if total is None else total + overflow
        return bev_query, total
