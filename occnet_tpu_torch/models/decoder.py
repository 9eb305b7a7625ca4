"""DETR-style detection decoder with iterative reference-point refinement
(port of `occnet_tpu/models/decoder.py`): object queries self-attend, then
cross-attend into the BEV map through single-level deformable attention,
and refine sigmoid-space reference points layer by layer.

- `CustomMSDeformableAttention`: deformable attention over one value
  source with an output projection, at 2D point references (offsets
  divided by each level's (w, h)) or 4D box references (cx, cy, w, h:
  offsets / P * (w, h) * 0.5).  Its sampling is
  `ops.msda.multi_scale_deformable_attention`: on the card the kernel
  `csrc/msda.cu` and, in training, its backward `csrc/msda_bwd.cu`.
- `MultiHeadDotProductAttention`: flax's layer of the same name written out
  in its layout and rounding: `query` / `key` / `value` kernels (C, H, D)
  with (H, D) biases and an `out` kernel (H, D, C); the query scaled by
  fl(1 / fl(sqrt(D))) in the compute dtype before the product, as XLA
  compiles flax's division by sqrt(D) (a multiplication by the constant's
  reciprocal); the softmax in the compute dtype, as flax takes it without
  ``force_fp32_for_softmax``.
- `DetectionTransformerDecoder`: the JAX pairing convention holds:
  ``inter_references[lvl]`` is layer lvl's POST-refinement reference, so a
  head decodes layer lvl's box code against ``init_reference`` (lvl 0) or
  ``inter_references[lvl - 1]`` (`models/bbox.decode_layer_boxes`).

Other divisions take tensor divisors: CUDA multiplies a tensor divided by a
Python scalar by the scalar's reciprocal, which rounds differently from the
CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.models.attention import _normalizer
from occnet_tpu_torch.models.layers import Linear, dropout
from occnet_tpu_torch.models.norm import LayerNorm32
from occnet_tpu_torch.ops.msda import multi_scale_deformable_attention


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


class CustomMSDeformableAttention(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.dropout = num_points, dropout
        H, L, P = num_heads, num_levels, num_points
        self.value_proj = Linear(embed_dims, embed_dims, dtype)
        self.sampling_offsets = Linear(embed_dims, H * L * P * 2, dtype)
        self.attention_weights = Linear(embed_dims, H * L * P, dtype)
        self.output_proj = Linear(embed_dims, embed_dims, dtype)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Q, C), value (B, V, C), reference_points (B, Q, 2)
        point or (B, Q, 4) box -> (B, Q, C)."""
        B, Q, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        value = self.value_proj(value).reshape(B, -1, H, C // H)
        offsets = self.sampling_offsets(query).reshape(
            B, Q, H, L, P, 2).float()
        attn = self.attention_weights(query).reshape(B, Q, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, H, L, P)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            norm = _normalizer(spatial_shapes, query.device)
            loc = ref[:, :, None, None, None, :] \
                + offsets / norm[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, None, None, :2] \
                + offsets / offsets.new_full((), float(P)) \
                * ref[:, :, None, None, None, 2:] * 0.5
        out = multi_scale_deformable_attention(
            value.contiguous(), spatial_shapes, loc.contiguous(),
            attn.contiguous())
        out = dropout(self.output_proj(out), self.dropout, train, generator)
        return out + identity


class DenseGeneral(nn.Module):
    """flax `DenseGeneral` with its kernel in flax's layout: ``in_shape``
    axes contracted into ``out_shape`` axes (weight in_shape + out_shape,
    bias out_shape), computed in ``dtype``."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.empty(*in_shape, *out_shape))
        nn.init.normal_(self.weight, std=math.prod(in_shape) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        n_in = len(self.in_shape)
        lead = x.shape[:x.ndim - n_in]
        w = self.weight.to(dt).reshape(-1, self.bias.numel())
        y = F.linear(x.to(dt).reshape(*lead, -1), w.t(),
                     self.bias.to(dt).reshape(-1))
        return y.reshape(*lead, *self.out_shape)


class MultiHeadDotProductAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` without dropout or mask (its
    defaults): softmax(q k^T / sqrt(D)) v per head, then ``out``."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, D = num_heads, embed_dims // num_heads
        self.query = DenseGeneral((embed_dims,), (H, D), dtype)
        self.key = DenseGeneral((embed_dims,), (H, D), dtype)
        self.value = DenseGeneral((embed_dims,), (H, D), dtype)
        self.out = DenseGeneral((H, D), (embed_dims,), dtype)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor,
                inputs_v: torch.Tensor) -> torch.Tensor:
        q, k, v = (self.query(inputs_q), self.key(inputs_k),
                   self.value(inputs_v))                     # (B, L, H, D)
        q = q * float(1.0 / torch.tensor(float(q.shape[-1]) ** 0.5,
                                         dtype=q.dtype))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class DecoderLayer(nn.Module):
    """self-attention -> norm -> deformable cross-attention into the BEV ->
    norm -> FFN -> norm."""

    def __init__(self, embed_dims: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(embed_dims, num_heads,
                                                      dtype)
        self.norm1 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.cross_attn = CustomMSDeformableAttention(
            embed_dims, num_heads, dropout=dropout, dtype=dtype)
        self.norm2 = LayerNorm32(embed_dims, out_dtype=dtype)
        self.ffn_fc1 = Linear(embed_dims, ffn_dim, dtype)
        self.ffn_fc2 = Linear(ffn_dim, embed_dims, dtype)
        self.norm3 = LayerNorm32(embed_dims, out_dtype=dtype)

    def forward(self, query: torch.Tensor, bev_value: torch.Tensor,
                query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q = query + query_pos if query_pos is not None else query
        query = self.norm1(query + self.self_attn(q, q, query))
        query = self.norm2(self.cross_attn(
            query, bev_value, query_pos, reference_points, spatial_shapes,
            train, generator))
        y = self.ffn_fc2(F.relu(self.ffn_fc1(query)))
        return self.norm3(query + y)


class DetectionTransformerDecoder(nn.Module):
    """Stacked decoder layers with per-layer sigmoid-space reference
    refinement, in one of the JAX package's two modes:

    - ``reg_branches`` given to `forward`, 3D references (the
      `PerceptionTransformer` box refinement): new_xy = code[..., :2] +
      inverse_sigmoid(ref_xy), new_z = code[..., 4:5] +
      inverse_sigmoid(ref_z); sampling uses ref[..., :2].  Build it with
      ``internal_refine=False``;
    - standalone (``internal_refine``): a zero-init Linear(2) a layer,
      ``ref_refine{lid}``, refines the 2D reference directly.

    The refined reference is detached (the JAX `stop_gradient`)."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, ffn_dim: int = 512,
                 return_intermediate: bool = True,
                 internal_refine: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.return_intermediate = return_intermediate
        self.internal_refine = internal_refine
        for lid in range(num_layers):
            self.add_module(f"layer{lid}", DecoderLayer(
                embed_dims, num_heads, ffn_dim, dtype=dtype))
            if internal_refine:
                refine = Linear(embed_dims, 2, torch.float32)
                nn.init.zeros_(refine.weight)
                nn.init.zeros_(refine.bias)
                self.add_module(f"ref_refine{lid}", refine)

    def forward(self, query: torch.Tensor, bev_value: torch.Tensor,
                query_pos: Optional[torch.Tensor],
                reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                reg_branches: Optional[Sequence[Callable]] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (inter_states (L, B, Q, C), inter_references (L, B, Q, 2|3)),
        or the last layer's (query, reference) without
        ``return_intermediate``."""
        if (reg_branches is None) == (not self.internal_refine):
            raise ValueError("reg_branches must be given exactly when the "
                             "decoder was built with internal_refine=False")
        states, refs = [], []
        ref = reference_points
        for lid in range(self.num_layers):
            query = getattr(self, f"layer{lid}")(
                query, bev_value, query_pos, ref[..., :2], spatial_shapes,
                train, generator)
            if reg_branches is not None:
                if ref.shape[-1] != 3:
                    raise ValueError(f"box refinement needs 3D references, "
                                     f"got {tuple(ref.shape)}")
                tmp = reg_branches[lid](query.float())
                new_xy = tmp[..., :2] + inverse_sigmoid(ref[..., :2])
                new_z = tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3])
                ref = torch.sigmoid(torch.cat([new_xy, new_z], dim=-1))
            else:
                delta = getattr(self, f"ref_refine{lid}")(query.float())
                ref = torch.sigmoid(delta + inverse_sigmoid(ref))
            ref = ref.detach()
            states.append(query)
            refs.append(ref)
        if self.return_intermediate:
            return torch.stack(states), torch.stack(refs)
        return query, ref
