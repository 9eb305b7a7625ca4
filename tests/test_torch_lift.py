"""The port's plain planar lift (occnet_tpu_torch.ops.planar_lift) against the
JAX einsum lift and the Pallas lift (interpret mode on the CPU), on the same
numpy-seeded features and camera rigs.  `count` must match exactly; U_bar
within the bf16 bound the JAX package uses between its own two lift forms
(tests/test_lift_pallas.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occnet_tpu.ops.lift_pallas import lift_and_average_pallas
from occnet_tpu.ops.planar_lift import lift_and_average as lift_jax
from occnet_tpu_torch.ops import planar_lift
from occnet_tpu_torch.ops.lift_cuda import lift_level

PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
IMG_HW = (64, 96)


def _ring_cameras(n_cam=3, batch=1, yaw0=0.0):
    ego2img = np.zeros((batch, n_cam, 4, 4), np.float32)
    K = np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]])
    base = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    for b in range(batch):
        for ci in range(n_cam):
            a = yaw0 + 2 * np.pi * ci / n_cam + 0.1 * b
            Rz = np.array([[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = K @ (Rz @ base).T
            ego2img[b, ci] = m
    return ego2img


def _feats(rng, n_cam=3, batch=1, ch=16, strides=(8, 16)):
    return [rng.randn(batch, n_cam, IMG_HW[0] // s, IMG_HW[1] // s,
                      ch).astype(np.float32) for s in strides]


def _compare(feats, ego2img, bev_hw=(14, 14), num_z=4, pallas=True):
    ref = [lift_jax([jnp.asarray(f) for f in feats], jnp.asarray(ego2img),
                    PC_RANGE, num_z, bev_hw, IMG_HW)]
    if pallas:
        ref.append(lift_and_average_pallas(
            [jnp.asarray(f) for f in feats], jnp.asarray(ego2img), PC_RANGE,
            num_z, bev_hw, IMG_HW))
    u, c = planar_lift.lift_and_average(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(ego2img),
        PC_RANGE, num_z, bev_hw, IMG_HW)
    assert u.dtype == torch.bfloat16 and u.shape == ref[0][0].shape
    u = u.float().numpy()
    assert np.isfinite(u).all()
    for a, cnt in ref:
        np.testing.assert_array_equal(np.asarray(cnt), c.numpy())
        d = np.abs(np.asarray(a, np.float32) - u)
        assert d.max() < 0.05, d.max()
    assert c.numpy().max() >= 1
    return u, c.numpy()


@pytest.mark.parametrize("batch", [1, 2])
def test_lift_matches_jax(batch):
    rng = np.random.RandomState(batch)
    _compare(_feats(rng, batch=batch), _ring_cameras(batch=batch))


def test_lift_windowed_level_batch2():
    """Feature maps wider than the Pallas K-window (w = 48 > 32): the
    `_pass1w` path on the JAX side, at B = 2."""
    rng = np.random.RandomState(4)
    _compare(_feats(rng, ch=8, strides=(2,), batch=2), _ring_cameras(batch=2))


def test_lift_camera_with_no_live_rows_in_one_order():
    """In this 4-camera rig cameras 0 and 2 see every live BEV row as a steep
    image line, so they have zero live rows in pass order A — the rig of the
    r4 NaN fault (tmp rows read through zero weights).  The lift must still
    match JAX, and cells no camera sees must come out exactly zero."""
    rng = np.random.RandomState(5)
    ego2img = _ring_cameras(n_cam=4, batch=1)
    feats = _feats(rng, n_cam=4, ch=8, strides=(4, 8))
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, 4))
    H = planar_lift.plane_homographies(torch.from_numpy(ego2img), PC_RANGE,
                                       z, (14, 14))
    Ml = planar_lift.feature_homographies(H, 16, 24, IMG_HW)
    _, _, steep, valid = planar_lift.level_geometry(Ml, (14, 14), 16, 24)
    row_live = valid.any(-1).reshape(steep.shape)
    live_a = (~steep & row_live).sum(-1)[0]
    live_b = (steep & row_live).sum(-1)[0]
    assert (live_a == 0).any() and (live_a > 0).any(), live_a
    assert (live_b > 0).all(), live_b
    u, _ = _compare(feats, ego2img)
    seen = valid.any(2).any(1).reshape(-1).numpy()   # any cam, any z, lvl 0
    assert (~seen).any()
    assert (u[0, 0][:, ~seen] == 0).all()


def test_lift_level_plain_writes_every_element():
    """The plain level lift overwrites its whole output, including cells no
    camera sees (a NaN-filled buffer must come back finite)."""
    rng = np.random.RandomState(6)
    feats = torch.from_numpy(_feats(rng, ch=8, strides=(8,))[0])
    e2i = torch.from_numpy(_ring_cameras())
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, 2))
    H = planar_lift.plane_homographies(e2i, PC_RANGE, z, (6, 6))
    Ml = planar_lift.feature_homographies(H, 8, 12, IMG_HW)
    pos1, pos2, steep, valid = planar_lift.level_geometry(Ml, (6, 6), 8, 12)
    inv = torch.ones(1, 36)
    out = torch.full((1, 12, 6, 8), float("nan"))
    lift_level(feats, pos1, pos2, steep, inv, out)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        lift_level(feats, pos1, pos2, steep, inv, out, impl="bogus")
