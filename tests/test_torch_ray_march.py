"""The port's plain ray marchers (occnet_tpu_torch.ops.ray_march /
ray_march_vec) against the JAX package's, on the same numpy-seeded grids,
origins and directions: coords and hits bitwise, distances within 1e-6
relative (the port repeats XLA's compiled fp32 operations, fused
multiply-adds and rewritten divisions included, so they are bitwise equal
here).  Axis-aligned and 45-degree rays from voxel corners exercise the
tie rules; origins outside the grid and rays that never enter exercise the
zero outputs.  The CUDA wrappers refuse CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occnet_tpu.evaluation.ray_metrics import (fan_parameters as
                                               jax_fan_parameters)
from occnet_tpu.evaluation.ray_metrics import generate_lidar_rays
from occnet_tpu.ops.ray_march import dda_raymarch as jax_dda
from occnet_tpu.ops.ray_march_fast import pack_columns as jax_pack
from occnet_tpu.ops.ray_march_vec import dda_raymarch_fan_vec as jax_fan
from occnet_tpu_torch.evaluation.ray_metrics import fan_parameters
from occnet_tpu_torch.ops import ray_march, ray_march_vec
from occnet_tpu_torch.ops.lift_pass2 import lift_pass2_cuda

DIST_RTOL = 1e-6


def _assert_same(got, want):
    dist, coord, hit = (t.numpy() for t in got)
    wd, wc, wh = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(hit, wh)
    np.testing.assert_array_equal(coord, wc)
    np.testing.assert_allclose(dist, wd, rtol=DIST_RTOL, atol=0)


def _rays(rng, n, size):
    """Origins inside and outside the grid (some on voxel corners) and
    random, axis-aligned and 45-degree directions."""
    o = rng.uniform(-4, max(size) + 4, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    special = np.array([[1, 1, 0], [1, -1, 0], [-1, -1, 1], [0, 0, 1],
                        [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [1, 1, 1], [0, 0, 0]], np.float32)
    d[:len(special) * 8] = np.repeat(special, 8, axis=0)
    o[:40] = np.floor(o[:40])                       # voxel corners
    o[40:120] = np.floor(o[40:120]) + 0.5           # voxel centres
    o[120:140] = [-3.0, 5.0, 4.0]                   # outside, some away
    return o, d


@pytest.mark.parametrize("seed", [0, 1])
def test_dda_plain_matches_jax(seed):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(24, 20, 8) < 0.05).astype(np.float32)
    o, d = _rays(rng, 600, occ.shape)
    want = jax_dda(jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d),
                   max_steps=60)
    got = ray_march.dda_raymarch(torch.from_numpy(occ), torch.from_numpy(o),
                                 torch.from_numpy(d), 60)
    _assert_same(got, want)
    hit, coord = got[2].numpy(), got[1].numpy()
    assert 0 < hit.sum() < len(hit)
    # some rays never enter the grid and return zeros
    assert ((coord == 0).all(1) & ~hit).sum() > 0


def _sub_fan(step=15):
    rays = generate_lidar_rays()
    K = rays.shape[0] // 360
    fan = rays.reshape(K, 360, 3)[:, ::step]
    return fan.reshape(-1, 3), fan.shape[1]


def test_fan_parameters_bitwise_equal_to_jax():
    rays = generate_lidar_rays()
    for got, want in zip(fan_parameters(rays),
                         jax_fan_parameters(jnp.asarray(rays))):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("origins", [
    # the JAX test's origins: inside, near a corner, one outside the grid
    [[20.3, 19.7, 8.2], [5.0, 35.0, 4.1], [-3.0, 20.0, 7.7]],
    # voxel corners: 45-degree azimuths cross exact ties
    [[20.0, 20.0, 8.0], [10.0, 30.0, 2.0], [41.0, -2.0, 15.5]],
])
def test_fan_plain_matches_jax(origins):
    rng = np.random.RandomState(0)
    occs = (rng.rand(2, 40, 40, 16) < 0.03).astype(np.float32)
    origins = np.array(origins, np.float32)
    rays, num_az = _sub_fan()
    az, dz, scale = fan_parameters(rays, num_az)
    want = jax_fan(jnp.asarray(occs), jnp.asarray(origins), jnp.asarray(az),
                   jnp.asarray(dz), jnp.asarray(scale), max_xy_steps=100)
    got = ray_march_vec.dda_raymarch_fan_vec(
        *(torch.from_numpy(a) for a in (occs, origins, az, dz, scale)),
        max_xy_steps=100)
    _assert_same(got, want)
    assert 0 < got[2].sum() < got[2].numel()


def test_fan_empty_grid_and_pack_columns():
    rng = np.random.RandomState(2)
    occ = (rng.rand(2, 7, 5, 16) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        ray_march_vec.pack_columns(torch.from_numpy(occ)).numpy(),
        np.stack([np.asarray(jax_pack(jnp.asarray(g))) for g in occ]))
    occs = torch.zeros(1, 20, 20, 8)
    rays, num_az = _sub_fan(step=60)
    az, dz, scale = (torch.from_numpy(a)
                     for a in fan_parameters(rays, num_az))
    dist, _, hit = ray_march_vec.dda_raymarch_fan_vec(
        occs, torch.tensor([[10.0, 10.0, 4.0]]), az, dz, scale,
        max_xy_steps=60)
    assert not hit.any() and torch.isfinite(dist).all() and (dist >= 0).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    occ = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march.dda_raymarch_cuda(occ, torch.zeros(2, 3),
                                    torch.ones(2, 3), 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march_vec.dda_raymarch_fan_vec_cuda(
            occ[None], torch.zeros(1, 3), torch.ones(2, 2), torch.ones(3),
            torch.ones(3))
    with pytest.raises(ValueError, match="CUDA device"):
        lift_pass2_cuda(torch.zeros(8, 1, 4), torch.zeros(8, 1, 4),
                        torch.ones(4, 1, 4),
                        torch.zeros(8, 1, 8, 8, dtype=torch.bfloat16),
                        torch.zeros(8, 1, 8, 8, dtype=torch.bfloat16), 8, 4)
