"""BEV-query sharding over the model axis (counterpart of the JAX package's
``bev_shard_axis = "model"``, `BEVFormerEncoder.shard_q`).

Rank m of a model group of mp ranks holds the BEV rows [m * bev_h / mp,
(m + 1) * bev_h / mp): a contiguous block of the queries q = y * bev_w + x.
The encoder's query-local work (SCA, FFN, the LayerNorms, the projections)
runs on those rows alone; three places need the other ranks' rows:

- the dense TSA's 3x3 taps reach one row beyond the block: `halo_tap`
  exchanges the edge rows of the value grid (zeros at the global top and
  bottom, where the unsharded tap pads with zeros) and, in the backward,
  those of the attention and of the incoming gradient, so that each rank
  computes its rows' dvalue and dattn whole, as the unsharded kernel does;
- the gather TSA samples anywhere in the BEV: `gather` all-gathers its
  projected value over the group once a layer (the backward sums the
  ranks' gradients and keeps this rank's rows: a reduce-scatter);
- the decoder takes the whole BEV: `gather` once after the encoder.

The gather SCA's certificate is the unsharded one: `sum_` all-reduces the
per-camera visible counts before the static top-K's overflow is taken.
Dropout masks are drawn at the unsharded shape and cut to the block
(`draws`), so a sharded step draws the unsharded step's masks.

`active_qshard(model_cfg)` is the shard of the active layout
(`parallel.mesh.active`), None when nothing is sharded.  For timing,
inside ``with collective_events() as events`` each collective here
appends its (start, end) CUDA events on the current stream to ``events``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from occnet_tpu_torch.models.layers import RowDraws
from occnet_tpu_torch.ops.tsa import tap_attention_bwd, tap_attention_fwd
from occnet_tpu_torch.parallel.mesh import check_layout, current


_EVENTS: Optional[List[Tuple[Any, Any]]] = None


@contextlib.contextmanager
def collective_events() -> Iterator[List[Tuple[Any, Any]]]:
    """A list that collects the (start, end) CUDA events of the
    collectives run inside the block (see the module doc)."""
    global _EVENTS
    prev, _EVENTS = _EVENTS, []
    try:
        yield _EVENTS
    finally:
        _EVENTS = prev


@contextlib.contextmanager
def _timed() -> Iterator[None]:
    if _EVENTS is None or not torch.cuda.is_available():
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _EVENTS.append((start, end))


@dataclasses.dataclass(frozen=True)
class QShard:
    """This model rank's block of BEV rows and its model group."""
    mp: int
    rank: int
    group: Any
    bev_h: int
    bev_w: int

    @property
    def rows(self) -> Tuple[int, int]:
        n = self.bev_h // self.mp
        return self.rank * n, (self.rank + 1) * n

    @property
    def num_queries(self) -> int:
        """The unsharded query count Q."""
        return self.bev_h * self.bev_w

    @property
    def queries(self) -> slice:
        r0, r1 = self.rows
        return slice(r0 * self.bev_w, r1 * self.bev_w)

    def slice_q(self, x: Optional[torch.Tensor], dim: int = 1
                ) -> Optional[torch.Tensor]:
        """``x``'s block of queries along ``dim`` (a size-1 dim, broadcast,
        and None pass through)."""
        if x is None or x.shape[dim] == 1:
            return x
        if x.shape[dim] != self.num_queries:
            raise ValueError(f"expected {self.num_queries} queries on dim "
                             f"{dim}, got {tuple(x.shape)}")
        q = self.queries
        return x.narrow(dim, q.start, q.stop - q.start)

    def draws(self, generator: Optional[torch.Generator]) -> RowDraws:
        q = self.queries
        return RowDraws(generator, q.start, q.stop, self.num_queries)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The group's blocks of ``x`` joined along ``dim`` (differentiable:
        the backward is a reduce-scatter sum)."""
        return _GatherRows.apply(x, self, dim)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In-place sum over the group, outside autograd; returns x."""
        with _timed():
            dist.all_reduce(x, group=self.group)
        return x

    def neighbour_rows(self, x: torch.Tensor, dim: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the row above this block, the row below it) of ``x``, whose
        ``dim`` runs over this block's rows: the neighbours' edge rows,
        zeros at the global top and bottom."""
        n = x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)],
                          dim).contiguous()
        parts = [torch.empty_like(edges) for _ in range(self.mp)]
        with _timed():
            dist.all_gather(parts, edges, group=self.group)
        zero = torch.zeros_like(edges.narrow(dim, 0, 1))
        above = parts[self.rank - 1].narrow(dim, 1, 1) if self.rank > 0 \
            else zero
        below = parts[self.rank + 1].narrow(dim, 0, 1) \
            if self.rank < self.mp - 1 else zero
        return above, below

    def halo_tap(self, vgrid: torch.Tensor, attn: torch.Tensor
                 ) -> torch.Tensor:
        """`ops.tsa.tap_attention` on this block's rows: vgrid (B, nq, R,
        W, C) and attn (B, R, W, nq, T, heads) -> (B, R, W, C) fp32, equal
        to the unsharded op's rows."""
        return _HaloTap.apply(vgrid, attn, self)


def active_qshard(model_cfg) -> Optional[QShard]:
    """The BEV-query shard of the active layout (`parallel.mesh.active`):
    None without one, at mp = 1 or with ``bev_shard_axis = ""``; raises
    ValueError for an unknown axis or rows that mp does not divide."""
    mesh = current()
    if mesh is None or not check_layout(model_cfg, mesh):
        return None
    return QShard(mesh.mp, mesh.model_rank, mesh.model_group,
                  model_cfg.bev_h, model_cfg.bev_w)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.mp)]
        with _timed():
            dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        shard, dim = ctx.shard, ctx.dim
        g = g.contiguous().clone()
        with _timed():
            dist.all_reduce(g, group=shard.group)
        n = g.shape[dim] // shard.mp
        return g.narrow(dim, shard.rank * n, n), None, None


class _HaloTap(torch.autograd.Function):
    """The tap attention on the block's rows plus a one-row halo: the value
    halo in the forward, the attention and gradient halos in the backward.
    The halo rows' attention is zero in the forward (their output is
    dropped) and their dvalue / dattn are dropped in the backward."""

    @staticmethod
    def forward(ctx, vgrid, attn, shard):
        above, below = shard.neighbour_rows(vgrid, 2)
        vpad = torch.cat([above, vgrid, below], dim=2).contiguous()
        apad = F.pad(attn, (0,) * 8 + (1, 1)).contiguous()
        ctx.save_for_backward(vpad, attn)
        ctx.shard = shard
        return tap_attention_fwd(vpad, apad)[:, 1:-1]

    @staticmethod
    def backward(ctx, g):
        vpad, attn = ctx.saved_tensors
        shard = ctx.shard
        g = g.float().contiguous()
        a_above, a_below = shard.neighbour_rows(attn, 1)
        g_above, g_below = shard.neighbour_rows(g, 1)
        apad = torch.cat([a_above, attn, a_below], dim=1).contiguous()
        gpad = torch.cat([g_above, g, g_below], dim=1)
        dv, dattn = tap_attention_bwd(vpad, apad, gpad)
        return dv[:, :, 1:-1], dattn[:, 1:-1], None
