"""Attention modules of the exact (gather) encoder, the port of
`occnet_tpu/models/attention.py`: `MSDeformableAttention3D`,
`SpatialCrossAttention` (static top-K camera compaction, or dense-masked) and
`TemporalSelfAttention`.  All deformable sampling goes through
`ops.msda.multi_scale_deformable_attention`, forward and backward (the CUDA
kernels on the card, the plain versions on the CPU); in training the
gradients reach the gathered queries and values through `torch.gather`,
and the camera outputs' through `scatter_add_`, as in JAX.

`SpatialCrossAttention` returns its exactness certificate,
`sca_topk_overflow`: the number of visible queries that did not fit the
static top-K of their camera (max over batch and cameras).  While it is 0 the
compaction is exact.  `torch.topk` breaks ties in another order than
`jax.lax.top_k`, and many queries tie on their visible-anchor count, so the
two packages select the same set, and give the same output, only while the
certificate is 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from occnet_tpu_torch.config import SCAConfig, TSAConfig
from occnet_tpu_torch.models.layers import Linear, dropout
from occnet_tpu_torch.ops.msda import multi_scale_deformable_attention
from occnet_tpu_torch.utils import profiling


def radial_offset_bias(num_heads: int, num_level_slots: int,
                       num_points: int) -> np.ndarray:
    """Initial sampling offsets: head h points along angle 2*pi*h/H, scaled
    1..num_points across points (the deformable-DETR init), flattened."""
    thetas = np.arange(num_heads, dtype=np.float32) * (
        2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (H, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :],
                   (1, num_level_slots, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1)


def _normalizer(spatial_shapes, device) -> torch.Tensor:
    """(L, 2) float32 (w, h) per level: offsets are divided by it tensor by
    tensor (a division by a Python scalar multiplies by the reciprocal on
    CUDA and would round differently from the CPU)."""
    return torch.tensor([[w, h] for h, w in spatial_shapes],
                        dtype=torch.float32, device=device)


class MSDeformableAttention3D(nn.Module):
    """Deformable attention where each query carries Z reference points per
    camera; the P points of each (head, level) are spread over the Z anchors
    (P // Z each).  No output projection."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        self.value_proj = Linear(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Linear(
            embed_dims, num_heads * num_levels * num_points * 2, dtype)
        self.attention_weights = Linear(
            embed_dims, num_heads * num_levels * num_points, dtype)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (N, Q, C), value (N, V, C), reference_points (N, Q, Z, 2)
        normalised -> (N, Q, C) in the compute dtype."""
        bs, nq, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        value = self.value_proj(value).reshape(bs, -1, H, C // H)
        offsets = self.sampling_offsets(query).reshape(bs, nq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(bs, nq, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(bs, nq, H, L, P)
        Z = reference_points.shape[2]
        if P % Z:
            raise ValueError(f"num_points {P} is not a multiple of the {Z} "
                             f"z-anchors")
        norm = _normalizer(spatial_shapes, query.device)
        offsets = offsets.float() / norm[None, None, None, :, None, :]
        offsets = offsets.reshape(bs, nq, H, L, P // Z, Z, 2)
        ref = reference_points.float()[:, :, None, None, None, :, :]
        loc = (ref + offsets).reshape(bs, nq, H, L, P, 2)
        return multi_scale_deformable_attention(
            value.contiguous(), spatial_shapes, loc.contiguous(),
            attn.contiguous())


class SpatialCrossAttention(nn.Module):
    """BEV -> image cross attention over the camera feature pyramid: per
    camera, the visible queries sample that camera's pyramid; the camera
    outputs are summed per query and divided by its visible-camera count.

    The visibility counts, the top-K, the gathers of the selected queries
    and references and the scatter-add of their outputs are the span
    ``sca.select`` (MSDA is not in it); the counters ``sca.visible`` and
    ``sca.slots`` add the visible (query, camera) pairs and the MSDA slots
    (B x the cameras' K, or B x cameras x Q on the dense-masked branch)."""

    def __init__(self, cfg: SCAConfig, embed_dims: int = 256,
                 num_cams: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.num_cams = num_cams
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, cfg.num_heads, cfg.num_levels, cfg.num_points, dtype)
        self.output_proj = Linear(embed_dims, embed_dims, dtype)
        self.dtype = dtype

    def topk_sizes(self, Q: int) -> Tuple[int, ...]:
        """Per-camera K (capped at Q), or () for the dense-masked branch."""
        ks = tuple(int(k) for k in self.cfg.per_cam_topk)
        if ks and len(ks) != self.num_cams:
            raise ValueError(f"per_cam_topk has {len(ks)} entries for "
                             f"{self.num_cams} cameras")
        if not ks and self.cfg.max_queries_per_cam:
            ks = (int(self.cfg.max_queries_per_cam),) * self.num_cams
        if ks and min(ks) < Q:
            return tuple(min(k, Q) for k in ks)
        return ()

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                query_pos: Optional[torch.Tensor],
                reference_points_cam: torch.Tensor, bev_mask: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """query (B, Q, C), value (B, cams, V, C), reference_points_cam
        (cams, B, Q, Z, 2), bev_mask (cams, B, Q, Z) -> ((B, Q, C),
        sca_topk_overflow, a 0-d int64 tensor; 0 on the dense branch).

        With ``shard`` (a `parallel.qshard.QShard`) the Q queries are its
        block: they are compacted with ``topk_sizes(Q)``, and the
        certificate is the unsharded one, the per-camera visible counts
        summed over the model group against the unsharded K.  While it is
        0 every visible query of the block fits its K, and the block's
        output is the unsharded output's rows."""
        B, Q, C = query.shape
        n_cam = self.num_cams
        msda = self.deformable_attention
        residual = query
        if query_pos is not None:
            query = query + query_pos
        ref_bc = reference_points_cam.permute(1, 0, 2, 3, 4)   # (B,cam,Q,Z,2)
        Z = ref_bc.shape[3]
        ks = self.topk_sizes(Q)
        with profiling.span("sca.select"):
            vis_cnt = bev_mask.sum(dim=-1)                     # (cam, B, Q)
            visible = (vis_cnt > 0).permute(1, 0, 2)           # (B, cam, Q)
            count = visible.sum(dim=1).clamp(min=1).float()    # (B, Q)
            overflow = torch.zeros((), dtype=torch.int64,
                                   device=query.device)
            ks_cert = ks if shard is None \
                else self.topk_sizes(shard.num_queries)
            if ks_cert:
                n_visible = visible.sum(dim=2)                 # (B, cam)
                if shard is not None:
                    n_visible = shard.sum_(n_visible)
                k_t = torch.tensor(ks_cert, dtype=torch.int64,
                                   device=query.device)
                overflow = (n_visible - k_t).clamp(min=0).max()
        profiling.count("sca.visible", visible)
        profiling.count("sca.slots", B * (sum(ks) if ks else n_cam * Q))
        if ks:
            scores = vis_cnt.permute(1, 0, 2)                  # (B, cam, Q)
            groups: dict = {}
            for ci, k in enumerate(ks):
                groups.setdefault(k, []).append(ci)
            slots = None
            for K_g, cams in sorted(groups.items()):
                g = len(cams)
                with profiling.span("sca.select"):
                    cam_idx = torch.tensor(cams, device=query.device)
                    sel = torch.topk(scores[:, cam_idx], K_g, dim=-1).indices
                    q_sel = torch.gather(
                        query[:, None].expand(B, g, Q, C), 2,
                        sel[..., None].expand(B, g, K_g, C))
                    ref_sel = torch.gather(
                        ref_bc[:, cam_idx], 2,
                        sel[..., None, None].expand(B, g, K_g, Z, 2))
                out_sel = msda(
                    q_sel.reshape(B * g, K_g, C),
                    value[:, cam_idx].reshape(B * g, -1, C),
                    ref_sel.reshape(B * g, K_g, Z, 2), spatial_shapes)
                with profiling.span("sca.select"):
                    out_sel = out_sel.reshape(B, g, K_g, C)
                    vis_sel = torch.gather(visible[:, cam_idx], 2, sel)
                    out_sel = out_sel * vis_sel[..., None].to(out_sel.dtype)
                    if slots is None:
                        slots = torch.zeros(B, Q, C, dtype=out_sel.dtype,
                                            device=query.device)
                    # top-k indices are distinct per (batch, camera): the
                    # camera contributions of a query sum as on the dense
                    # branch
                    slots.scatter_add_(
                        1, sel.reshape(B, g * K_g, 1).expand(B, g * K_g, C),
                        out_sel.reshape(B, g * K_g, C))
        else:
            q_all = query[:, None].expand(B, n_cam, Q, C).reshape(
                B * n_cam, Q, C)
            out = msda(q_all, value.reshape(B * n_cam, -1, C),
                       ref_bc.reshape(B * n_cam, Q, Z, 2), spatial_shapes)
            with profiling.span("sca.select"):
                out = out.reshape(B, n_cam, Q, C)
                slots = (out * visible[..., None].to(out.dtype)).sum(dim=1)
        slots = (slots.float() / count[..., None]).to(self.dtype)
        slots = dropout(self.output_proj(slots), self.cfg.dropout, train,
                        generator)
        return slots + residual, overflow


class TemporalSelfAttention(nn.Module):
    """BEV self-attention over the 2-slot queue [prev, current] ([query,
    query] without history): offsets and weights are predicted from
    concat(queue[0], query), each slot is sampled at its reference points,
    and the two slot outputs are averaged."""

    def __init__(self, cfg: TSAConfig, embed_dims: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.num_bev_queue != 2:
            raise ValueError(f"num_bev_queue must be 2, got "
                             f"{cfg.num_bev_queue}")
        self.cfg = cfg
        H, L, P, nq = (cfg.num_heads, cfg.num_levels, cfg.num_points,
                       cfg.num_bev_queue)
        self.value_proj = Linear(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Linear(2 * embed_dims, nq * H * L * P * 2,
                                       dtype)
        self.attention_weights = Linear(2 * embed_dims, nq * H * L * P, dtype)
        self.output_proj = Linear(embed_dims, embed_dims, dtype)
        self.dtype = dtype

    def forward(self, query: torch.Tensor, prev_bev: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        """query (B, Q, C), prev_bev (B, 2, Q, C) or None, reference_points
        (B, 2, Q, L, 2) -> (B, Q, C).  With ``shard`` (a `parallel.qshard.
        QShard`) the Q queries are its block, and the projected value of
        both slots is gathered over the model group: the queries sample the
        whole BEV."""
        B, Q, C = query.shape
        H, L, P = self.cfg.num_heads, self.cfg.num_levels, self.cfg.num_points
        nq = self.cfg.num_bev_queue
        identity = query
        value = (torch.stack([query, query], dim=1) if prev_bev is None
                 else prev_bev)
        if query_pos is not None:
            query = query + query_pos
        query_aug = torch.cat([value[:, 0], query], dim=-1)
        value = self.value_proj(value.reshape(B * nq, Q, C))
        if shard is not None:
            value = shard.gather(value)
        value = value.reshape(B * nq, -1, H, C // H)
        offsets = self.sampling_offsets(query_aug).reshape(
            B, Q, H, nq, L, P, 2)
        attn = self.attention_weights(query_aug).reshape(B, Q, H, nq, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, H, nq, L, P)
        # queue-major batch: (B*2, Q, H, L, P[, 2])
        attn = attn.permute(0, 3, 1, 2, 4, 5).reshape(B * nq, Q, H, L, P)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            B * nq, Q, H, L, P, 2)
        norm = _normalizer(spatial_shapes, query.device)
        ref = reference_points.reshape(B * nq, Q, L, 2).float()
        loc = ref[:, :, None, :, None, :] + offsets.float() / norm[
            None, None, None, :, None, :]
        out = multi_scale_deformable_attention(
            value.contiguous(), spatial_shapes, loc.contiguous(),
            attn.contiguous())                                 # (B*2, Q, C)
        out = out.reshape(B, nq, Q, C).float().mean(dim=1)
        out = dropout(self.output_proj(out), self.cfg.dropout, train,
                      generator)
        return out + identity
