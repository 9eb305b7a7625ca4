"""Differentiable expected-depth render and point-splat grid init (port of
`occnet_tpu/ops/render_diff.py`, the counterparts of the reference dvr
extension's `render` and `init`).

- `splat_points`: (M, 3) voxel-unit end points -> (T, X, Y, Z) occupancy
  with a 1 at each in-bounds point of each time slot; out-of-bounds and
  ``tindex < 0`` points are dropped.
- `render_expected_depth`: a fixed-length geometric march of each ray
  (independent of sigma: the ordered voxels inside the grid, each with its
  exit distance d_i and in-voxel length delta_i), then

      csd_i = cumsum(sigma_i * delta_i)
      p_i   = exp(-csd_{i-1}) - exp(-csd_i)
      exp_d = sum_i p_i * d_i + exp(-csd_last) * max_d

  with max_d the exit distance of the last voxel inside the grid; rays
  padded (``tindex`` < 0) or never entering the grid give -1.
- `render_depth_loss`: l1 / l2 / absrel over the valid rays.

The JAX package computes all of it in XLA (no Pallas kernel), its gradient
by `jax.grad`; the port is plain torch, its gradient by autograd, on any
device.  The sigma gather's adjoint on CUDA is an atomic scatter, so the
card's gradient changes its summation order from run to run.  The march
repeats XLA's compiled arithmetic of the jitted JAX march: the norm
sqrt(fma(z, z, fma(y, y, x * x))) taken in float64 and rounded once, and
``x / (r / |r|)`` computed as ``(x * |r|) / r``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from occnet_tpu_torch.ops.ray_march import fma

_BIG = 1e30


def splat_points(points: torch.Tensor, tindex: Optional[torch.Tensor],
                 grid_shape: Tuple[int, int, int], num_t: int = 1
                 ) -> torch.Tensor:
    """(M, 3) voxel-unit points -> (num_t, X, Y, Z) float32 occupancy."""
    X, Y, Z = grid_shape
    v = torch.floor(points.float()).to(torch.int64)
    t = (torch.zeros(points.shape[:-1], dtype=torch.int64,
                     device=points.device) if tindex is None
         else tindex.to(torch.int64))
    ts = torch.zeros_like(t) if num_t == 1 else t
    # a slot past num_t lies outside the grid (XLA drops such a scatter)
    ok = ((t >= 0) & (ts < num_t) & (v[..., 0] >= 0) & (v[..., 0] < X)
          & (v[..., 1] >= 0) & (v[..., 1] < Y) & (v[..., 2] >= 0)
          & (v[..., 2] < Z))
    flat = (ts * X + v[..., 0]) * (Y * Z) + v[..., 1] * Z + v[..., 2]
    occ = torch.zeros(num_t * X * Y * Z, dtype=torch.float32,
                      device=points.device)
    occ[flat[ok]] = 1.0
    return occ.reshape(num_t, X, Y, Z)


@torch.no_grad()
def march_path(grid_shape: Tuple[int, int, int], origins: torch.Tensor,
               points: torch.Tensor, max_steps: int):
    """The geometric walk of each ray from ``origins`` to ``points`` (R, 3)
    voxel units, ``max_steps`` steps, until it leaves the grid, or while it
    never entered, until its last crossing passes the end point.  Returns
    per step (R, S) the flat voxel index, exit distance, in-voxel length
    and validity, and (R,) the origin-to-end distance."""
    X, Y, Z = grid_shape
    dev = origins.device
    sizes = torch.tensor([X, Y, Z], dtype=torch.int32, device=dev)
    o = origins.float()
    r = points.float() - o
    x, y, z = r[:, 0], r[:, 1], r[:, 2]
    gt_d = torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()
    nrm = torch.clamp(gt_d, min=1e-12)[:, None]
    d = r / nrm
    R = o.shape[0]
    v = torch.floor(o).to(torch.int32)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    nb = v.float() + (step > 0).float()
    # x / (r / |r|) as XLA rewrites it: (x * |r|) / r
    tmax = torch.where(d != 0, ((nb - o) * nrm) / r, _BIG)
    tdelta = torch.where(d != 0, (step.float() * nrm) / r, _BIG)
    last_d = torch.zeros(R, dtype=torch.float32, device=dev)
    was_inside = torch.zeros(R, dtype=torch.bool, device=dev)
    done = torch.zeros_like(was_inside)
    axes = torch.arange(3, device=dev)
    flats, exits, deltas, valids = [], [], [], []
    for _ in range(max_steps):
        inside = ((v >= 0) & (v < sizes)).all(dim=-1)
        done = done | (was_inside & ~inside) \
            | (~was_inside & ~inside & (last_d > gt_d))
        active = ~done
        tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
        axis = torch.where(tx < ty, torch.where(tx < tz, 0, 2),
                           torch.where(ty < tz, 1, 2))
        exit_d = tmax.amin(dim=-1)
        vc = torch.minimum(torch.clamp(v, min=0), sizes - 1).long()
        flats.append(vc[:, 0] * (Y * Z) + vc[:, 1] * Z + vc[:, 2])
        exits.append(exit_d)
        deltas.append(torch.clamp(exit_d - last_d, min=0.0))
        valids.append(active & inside)
        adv = active[:, None] & (axis[:, None] == axes)
        v = torch.where(adv, v + step, v)
        tmax = torch.where(adv, tmax + tdelta, tmax)
        last_d = torch.where(active, exit_d, last_d)
        was_inside = was_inside | inside
    return (torch.stack(flats, 1), torch.stack(exits, 1),
            torch.stack(deltas, 1), torch.stack(valids, 1), gt_d)


def render_expected_depth(sigma: torch.Tensor, origins: torch.Tensor,
                          points: torch.Tensor,
                          tindex: Optional[torch.Tensor] = None,
                          max_steps: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma (T, X, Y, Z) non-negative densities, origins (T, 3) and ray
    end points (M, 3) in voxel units, tindex (M,) (< 0: padded) ->
    (pred_dist (M,), gt_dist (M,)), -1 where padded or never entering;
    ``pred_dist`` is differentiable in ``sigma``, ``gt_dist`` =
    min(|end - origin|, max_d).  ``max_steps`` defaults to X + Y + Z + 3."""
    T, X, Y, Z = sigma.shape
    if max_steps is None:
        max_steps = X + Y + Z + 3
    t = (torch.zeros(points.shape[:-1], dtype=torch.int64,
                     device=points.device) if tindex is None
         else tindex.to(torch.int64))
    ts = torch.zeros_like(t) if T == 1 else torch.clamp(t, min=0)
    flat, exit_d, delta, valid, gt_d = march_path(
        (X, Y, Z), origins[ts], points, max_steps)
    vf = valid.float()
    sig = sigma.reshape(-1)[ts[:, None] * (X * Y * Z) + flat] * vf
    sd = sig * delta
    csd = torch.cumsum(sd, dim=1)
    trans = torch.exp(-csd)
    p = torch.exp(-(csd - sd)) - trans
    entered = valid.sum(dim=1) > 0
    # valid steps are no prefix when the origin lies outside the grid: the
    # last valid step is the last set one
    S = valid.shape[1]
    last_idx = torch.where(
        entered, (S - 1) - torch.argmax(valid.flip(1).to(torch.int32), 1),
        0)[:, None]
    max_d = torch.gather(exit_d, 1, last_idx)[:, 0]
    p_out = torch.gather(trans, 1, last_idx)[:, 0]
    exp_d = (p * exit_d * vf).sum(dim=1) + p_out * max_d
    ok = entered & (t >= 0)
    minus1 = torch.full_like(max_d, -1.0)
    return (torch.where(ok, exp_d, minus1),
            torch.where(ok, torch.minimum(gt_d, max_d), minus1))


def render_depth_loss(sigma: torch.Tensor, origins: torch.Tensor,
                      points: torch.Tensor,
                      tindex: Optional[torch.Tensor] = None,
                      loss: str = "l1", max_steps: Optional[int] = None
                      ) -> torch.Tensor:
    """Scalar depth loss over the valid rays: 'l1' |pred - gt|, 'l2'
    0.5 (pred - gt)^2, 'absrel' |pred - gt| / gt; differentiable in
    ``sigma``."""
    pred, gt = render_expected_depth(sigma, origins, points, tindex,
                                     max_steps)
    ok = (gt >= 0).float()
    err = pred - gt
    if loss == "l1":
        per = err.abs()
    elif loss == "l2":
        per = 0.5 * err * err
    elif loss == "absrel":
        per = err.abs() / torch.clamp(gt, min=1e-6)
    else:
        raise ValueError(f"unknown loss {loss!r}")
    return (per * ok).sum() / torch.clamp(ok.sum(), min=1.0)
