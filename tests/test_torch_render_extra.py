"""The port's other renders and small helpers against the JAX package on the
CPU, on numpy inputs from a seed: `render_sample` (per-ray DDA) and
`render_sample_fast` (the loop-free fan marcher) with labels and voxels
equal and distances within 1e-5 m + 1e-6 |d| of the JAX function that
marches the same way (and the fast render against JAX's fan loop as JAX's
tests hold them), the fan loop of `ops/ray_march_fast.py` against JAX's,
the differentiable expected depth
(`ops/render_diff.py`: depths, losses and gradients within 1e-5, the splat
equal), the host photometric distortion and random rescale on the same
`RandomState`, `quaternion_yaw`, `compose_ego2img` and the numpy part of
`utils/vis.py`."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.data import pipeline as jax_pipeline
from occnet_tpu.data.quat import quaternion_yaw as jax_quaternion_yaw
from occnet_tpu.evaluation import ray_metrics as jax_rm
from occnet_tpu.geometry import compose_ego2img as jax_compose
from occnet_tpu.ops import ray_march_fast as jax_fast
from occnet_tpu.ops import render_diff as jax_rd
from occnet_tpu.utils import vis as jax_vis
from occnet_tpu_torch.data import pipeline
from occnet_tpu_torch.data.quat import quaternion_yaw
from occnet_tpu_torch.evaluation import ray_metrics as rm
from occnet_tpu_torch.geometry import compose_ego2img
from occnet_tpu_torch.ops import ray_march_fast, render_diff
from occnet_tpu_torch.utils import vis
from _torch_threads import one_torch_thread  # noqa: E402,F401

ORIGINS = np.array([[0.5, 0.3, 1.8], [5.0, -3.0, 1.9]], np.float32)


@pytest.fixture(scope="module")
def scene():
    """tests/test_ray_march_fast.py's 200 x 200 x 16 grid (1 % occupied),
    a prediction with 0.2 % of its voxels changed, random flow."""
    rng = np.random.RandomState(1)
    sem = np.full((200, 200, 16), 16, np.int32)
    blob = rng.rand(200, 200, 16) < 0.01
    sem[blob] = rng.randint(0, 16, int(blob.sum()))
    pred = sem.copy()
    flip = rng.rand(200, 200, 16) < 0.002
    pred[flip] = rng.randint(0, 17, int(flip.sum()))
    flow = rng.randn(200, 200, 16, 2).astype(np.float32)
    return sem, pred, flow, jax_rm.generate_lidar_rays()


def _held(got, want, label):
    for k in ("label", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{label} {k}")
    np.testing.assert_array_equal(got["flow"].numpy(),
                                  np.asarray(want["flow"]), err_msg=label)
    # 1e-5 m, and 1e-6 of the distance (as tests/test_torch_eval.py holds
    # the fan render): a whole jitted JAX render may round otherwise than
    # its marcher jitted alone (9 ulps on one ray at 55 m in JAX's fan-loop
    # render)
    np.testing.assert_allclose(got["dist"].numpy(), np.asarray(want["dist"]),
                               rtol=1e-6, atol=1e-5, err_msg=label)


def test_render_sample_matches_jax(scene):
    """The per-ray render, 448 steps, 14,040 rays from 2 origins (one of
    them padded): labels, flow and valid equal (so the same voxels), dist
    within 1e-5 m."""
    sem, _, flow, rays = scene
    valid = np.array([True, False])
    want = jax_rm.render_sample(jnp.asarray(sem), jnp.asarray(flow),
                                jnp.asarray(rays), jnp.asarray(ORIGINS),
                                jnp.asarray(valid))
    got = rm.render_sample(torch.from_numpy(sem), torch.from_numpy(flow),
                           rays, ORIGINS, valid)
    _held(got, want, "render_sample")


def test_render_sample_fast_matches_jax_and_render_pred_gt(scene):
    """The fast render is the loop-free fan marcher on every device: equal
    to JAX's `render_sample_vec` (dist within 1e-5) and to the port's
    `render_pred_gt`, and, as JAX's own test holds them, label, valid and
    flow equal to JAX's `render_sample_fast` (the fan loop) with dist
    within 2e-3."""
    sem, pred, flow, rays = scene
    valid = np.array([True, True])
    pred_gt = rm.render_pred_gt(torch.from_numpy(pred), torch.from_numpy(flow),
                                torch.from_numpy(sem), torch.from_numpy(flow),
                                rays, ORIGINS, valid)
    for grid, vec in ((pred, pred_gt[0]), (sem, pred_gt[1])):
        args = (jnp.asarray(grid), jnp.asarray(flow), jnp.asarray(rays),
                jnp.asarray(ORIGINS), jnp.asarray(valid))
        got = rm.render_sample_fast(torch.from_numpy(grid),
                                    torch.from_numpy(flow), rays, ORIGINS,
                                    valid)
        _held(got, jax_rm.render_sample_vec(*args), "render_sample_fast")
        for k in ("dist", "label", "flow", "valid"):
            assert torch.equal(got[k], vec[k]), k
        loop = jax_rm.render_sample_fast(*args)
        for k in ("label", "flow", "valid"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(loop[k]),
                                          err_msg=f"fan loop {k}")
        np.testing.assert_allclose(got["dist"].numpy(),
                                   np.asarray(loop["dist"]), rtol=0,
                                   atol=2e-3)


def test_fan_loop_matches_jax_raw():
    """`dda_raymarch_fan` (the fan loop) against JAX's on a
    40 x 40 x 16 grid from inside and outside the grid, axis-aligned and
    45-degree azimuths among them: hits and voxels equal, dist 1e-5."""
    rng = np.random.RandomState(0)
    occ = (rng.rand(40, 40, 16) < 0.03).astype(np.float32)
    rays = jax_rm.generate_lidar_rays()
    fan = rays.reshape(-1, 360, 3)[:, ::15]
    az, dz, scale = rm.fan_parameters(fan.reshape(-1, 3), fan.shape[1])
    for o in ([20.3, 19.7, 8.2], [-3.0, 20.0, 7.7], [20.0, 20.0, 8.0]):
        o = np.asarray(o, np.float32)
        want = jax_fast.dda_raymarch_fan(
            jnp.asarray(occ), jnp.asarray(o), jnp.asarray(az),
            jnp.asarray(dz), jnp.asarray(scale), max_xy_steps=100)
        got = ray_march_fast.dda_raymarch_fan(
            torch.from_numpy(occ), torch.from_numpy(o), torch.from_numpy(az),
            torch.from_numpy(dz), torch.from_numpy(scale), max_xy_steps=100)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        ray_march_fast.pack_columns(torch.from_numpy(occ)).numpy(),
        np.asarray(jax_fast.pack_columns(jnp.asarray(occ))))


# ---------------------------------------------------------------------------
# the differentiable expected depth

GRID = (12, 10, 6)


def _depth_case(seed=0):
    """tests/test_render_diff.py's rays from inside the grid, plus rays
    from an origin outside it (T = 2), a padded ray and a ray that never
    enters."""
    rng = np.random.RandomState(seed)
    X, Y, Z = GRID
    sigma = (np.abs(rng.randn(2, *GRID)) * 0.8).astype(np.float32)
    inside = np.array([X / 2 + 0.3, Y / 2 - 0.2, Z / 2 + 0.1])
    outside = np.array([-4.3, -2.6, -1.7])
    pts = np.concatenate([
        inside + rng.randn(30, 3) * np.array([8.0, 8.0, 4.0]),
        np.array([[X / 2, Y / 2, Z / 2]]) + rng.randn(20, 3)
        * np.array([4.0, 4.0, 2.0]),
        [[-20.0, -20.0, -20.0], [3.0, 3.0, 3.0]]]).astype(np.float32)
    tindex = np.array([0] * 30 + [1] * 20 + [1, -1], np.int32)
    origins = np.stack([inside, outside]).astype(np.float32)
    return sigma, origins, pts, tindex


def test_expected_depth_matches_jax():
    sigma, origins, pts, tindex = _depth_case()
    want = jax_rd.render_expected_depth(
        jnp.asarray(sigma), jnp.asarray(origins), jnp.asarray(pts),
        jnp.asarray(tindex))
    got = render_diff.render_expected_depth(
        torch.from_numpy(sigma), torch.from_numpy(origins),
        torch.from_numpy(pts), torch.from_numpy(tindex))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    p = got[0].numpy()
    assert p[-1] == -1.0 and p[-2] == -1.0 and (p[:50] > 0).sum() >= 40


@pytest.mark.parametrize("loss", ["l1", "l2", "absrel"])
def test_depth_loss_and_gradient_match_jax(loss):
    """The loss and d loss / d sigma (torch autograd against `jax.grad`)
    within 1e-5 of max|g|."""
    sigma, origins, pts, tindex = _depth_case(1)
    args = (jnp.asarray(origins), jnp.asarray(pts), jnp.asarray(tindex))
    want, wg = jax.value_and_grad(lambda s: jax_rd.render_depth_loss(
        s, *args, loss=loss))(jnp.asarray(sigma))
    s = torch.from_numpy(sigma).requires_grad_(True)
    got = render_diff.render_depth_loss(
        s, torch.from_numpy(origins), torch.from_numpy(pts),
        torch.from_numpy(tindex), loss=loss)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    wg = np.asarray(wg)
    assert np.abs(wg).max() > 0
    np.testing.assert_allclose(s.grad.numpy(), wg, rtol=0,
                               atol=1e-5 * np.abs(wg).max())


def test_splat_points_matches_jax():
    pts = np.array([[1.2, 2.7, 3.1], [5.0, 0.0, 0.9], [-1.0, 2.0, 2.0],
                    [11.9, 9.9, 5.9], [40.0, 0.0, 0.0], [1.2, 2.7, 3.9],
                    [2.0, 2.0, 2.0]], np.float32)
    tindex = np.array([0, 1, 0, 1, 0, 0, 2], np.int32)
    for num_t, t in ((2, tindex), (1, None)):
        want = jax_rd.splat_points(jnp.asarray(pts), None if t is None
                                   else jnp.asarray(t), GRID, num_t)
        got = render_diff.splat_points(torch.from_numpy(pts), None if t is None
                                       else torch.from_numpy(t), GRID, num_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# host helpers

def test_photometric_distortion_host_matches_jax():
    """The same `RandomState` gives the same draws and pixels (float32
    numpy on both sides)."""
    imgs = np.random.RandomState(0).uniform(0, 255, (6, 9, 11, 3)).astype(
        np.float32)
    for seed in range(4):
        want = jax_pipeline.photometric_distortion(
            imgs, np.random.RandomState(seed))
        got = pipeline.photometric_distortion(imgs,
                                              np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


def test_random_scale_image_matches_jax():
    rng = np.random.RandomState(1)
    imgs = rng.uniform(0, 255, (2, 17, 23, 3)).astype(np.float32)
    l2i = rng.randn(2, 4, 4).astype(np.float32)
    for seed in range(6):
        want = jax_pipeline.random_scale_image(imgs, l2i,
                                               np.random.RandomState(seed))
        got = pipeline.random_scale_image(imgs, l2i,
                                          np.random.RandomState(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_quaternion_yaw_and_compose_ego2img_match_jax():
    rng = np.random.RandomState(2)
    for q in rng.randn(20, 4):
        assert quaternion_yaw(q) == jax_quaternion_yaw(q)
    l2i = rng.randn(2, 6, 4, 4).astype(np.float32) * 100
    e2l = rng.randn(2, 4, 4).astype(np.float32)
    want = np.asarray(jax.jit(jax_compose)(l2i, e2l))
    got = compose_ego2img(l2i, e2l).numpy()
    np.testing.assert_array_equal(got, want)


def test_vis_numpy_parts_match_jax(tmp_path):
    """`occupancy_to_bev_image` and the palette equal to JAX's; the
    drawing functions write their files."""
    rng = np.random.RandomState(3)
    sem = np.full((20, 16, 8), 16, np.int32)
    sem[rng.rand(20, 16, 8) < 0.1] = rng.randint(0, 16)
    np.testing.assert_array_equal(vis.CLASS_COLORS, jax_vis.CLASS_COLORS)
    np.testing.assert_array_equal(vis.occupancy_to_bev_image(sem),
                                  jax_vis.occupancy_to_bev_image(sem))
    feat = rng.randn(4, 6, 5).astype(np.float32)
    t = vis.normalized_image(feat)
    assert t.shape == (4, 6) and t.min() == 0.0 and t.max() == 1.0
    for fn, arg in ((vis.save_occupancy_bev, sem), (vis.save_tensor, feat)):
        path = str(tmp_path / f"{fn.__name__}.png")
        fn(arg, path)
        assert os.path.getsize(path) > 0
