"""The port's exact (gather) encoder against the JAX package on the CPU: the
geometry (`occnet_tpu_torch/geometry.py`), the deformable TSA and SCA
modules (`models/attention.py`), the whole gather-mode model, the weight
bridge and `serve.Predictor`'s certificate check.  Everything runs in fp32
with numpy-seeded inputs and random-filled weights; deformable sampling runs
as the plain version of `ops/msda.py`.

`torch.topk` and `jax.lax.top_k` break ties in different orders, so outputs
are compared only where the `sca_topk_overflow` certificate is 0 (then both
select every visible query); a too-small K is compared by its certificate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import geometry as jgeo
from occnet_tpu.config import SCAConfig, TSAConfig, tiny_occ
from occnet_tpu.models.attention import SpatialCrossAttention as JaxSCA
from occnet_tpu.models.attention import TemporalSelfAttention as JaxTSA
from occnet_tpu.models.attention import radial_offset_bias
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu_torch import geometry
from occnet_tpu_torch.convert import (
    from_jax_variables,
    init_jax_style_variables,
    randomize_variables,
    to_jax_variables,
)
from occnet_tpu_torch.models.attention import (
    SpatialCrossAttention,
    TemporalSelfAttention,
)
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.serve import Predictor

# the whole model: the bound of tests/test_parity_oracle.py:181-186
MODEL_TOL = 1e-4
# one module in fp32: the bound of tests/test_attention.py
MODULE_ATOL, MODULE_RTOL = 2e-5, 1e-5
# camera projection: fp32 against XLA's einsum, which may sum in another
# order; no projected point lies within EDGE_MARGIN of an image edge, so the
# visibility mask must be equal
PROJ_ATOL = 1e-6
EDGE_MARGIN = 1e-4
PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
IMG_HW = (96, 128)


def small_cfg(**sca):
    """tiny_occ (gather encoder) cut to 2 layers, 64 channels, a 10x10 BEV,
    fp32; FPN levels (12, 16), (6, 8), (3, 4), (2, 2)."""
    cfg = tiny_occ()
    enc = cfg.model.encoder
    model = dataclasses.replace(
        cfg.model, img_h=IMG_HW[0], img_w=IMG_HW[1], bev_h=10, bev_w=10,
        pillar_h=4, embed_dims=64, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(
            enc, num_layers=2, ffn_dim=64, num_points_in_pillar=4,
            sca=dataclasses.replace(enc.sca, **sca)))
    return dataclasses.replace(cfg, model=model)


def ring_rig(n_cam=6, yaw0=0.13, focal=90.0):
    """Outward cameras round the ego, yawed by yaw0, slightly offset."""
    h, w = IMG_HW
    e = np.tile(np.eye(4, dtype=np.float32), (1, n_cam, 1, 1))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    for ci in range(n_cam):
        a = 2 * np.pi * ci / n_cam + yaw0
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        e[0, ci, :3, :3] = (K @ R).astype(np.float32)
        e[0, ci, :3, 3] = (K @ np.array([0.0, 0.4, 0.3])).astype(np.float32)
    return e


def random_rig(seed, B=2, n_cam=3):
    rng = np.random.RandomState(seed)
    h, w = IMG_HW
    e = np.tile(np.eye(4, dtype=np.float32), (B, n_cam, 1, 1))
    for bi in range(B):
        for ci in range(n_cam):
            a = rng.uniform(0, 2 * np.pi)
            R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                          [np.sin(a), np.cos(a), 0.0]])
            f = rng.uniform(50, 120)
            K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
            e[bi, ci, :3, :3] = (K @ R).astype(np.float32)
            e[bi, ci, :3, 3] = (K @ rng.uniform(-2, 2, 3)).astype(np.float32)
    return e


def edge_margin(ref3d, e2i):
    """float64 distance of the nearest in-front projected point to an image
    edge (normalised units)."""
    pc = np.asarray(PC_RANGE)
    xyz = ref3d.astype(np.float64) * (pc[3:] - pc[:3]) + pc[:3]
    xyz1 = np.concatenate([xyz, np.ones_like(xyz[..., :1])], -1)
    pts = np.einsum("bcij,dqj->bcdqi", e2i.astype(np.float64), xyz1)
    d = pts[..., 2]
    xy = pts[..., :2] / np.maximum(d, 1e-5)[..., None] / [IMG_HW[1],
                                                          IMG_HW[0]]
    return np.minimum(np.abs(xy), np.abs(xy - 1)).min(-1)[d > 2e-5].min()


@pytest.mark.parametrize("h,w,z_range,Z", [
    (200, 200, 6.4, 8), (50, 50, 6.4, 4), (10, 10, 6.4, 4), (7, 13, 5.0, 3)])
def test_reference_points_bitwise_equal_to_jax(h, w, z_range, Z):
    ref3 = geometry.bev_reference_points_3d(h, w, z_range, Z)
    ref2 = geometry.bev_reference_points_2d(h, w)
    want3 = np.asarray(jgeo.bev_reference_points_3d(h, w, z_range, Z))
    want2 = np.asarray(jgeo.bev_reference_points_2d(h, w))
    assert ref3.dtype == ref2.dtype == np.float32
    np.testing.assert_array_equal(ref3, want3)
    np.testing.assert_array_equal(ref2, want2)


@pytest.mark.parametrize("rig", ["ring", "random"])
def test_projection_matches_jax(rig):
    ref3d = geometry.bev_reference_points_3d(12, 12, 6.4, 4)
    e2i = ring_rig() if rig == "ring" else random_rig(seed=4)
    assert edge_margin(ref3d, e2i) > EDGE_MARGIN
    ref_cam, mask = geometry.project_bev_points_to_cameras(
        ref3d, PC_RANGE, torch.from_numpy(e2i), IMG_HW)
    want_ref, want_mask = jgeo.project_bev_points_to_cameras(
        jnp.asarray(ref3d), PC_RANGE, jnp.asarray(e2i), IMG_HW)
    assert ref_cam.shape == want_ref.shape and mask.shape == want_mask.shape
    assert mask.dtype == torch.bool and 0 < mask.float().mean() < 1
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    got, want = ref_cam.numpy(), np.asarray(want_ref)
    vis = mask.numpy()
    np.testing.assert_allclose(got[vis], want[vis], rtol=0, atol=PROJ_ATOL)
    # invisible points (behind a camera they divide by eps and reach |xy| ~
    # 1e6, after cancellation in the projection sums) only need to stay
    # where they are, far outside the image: relative 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=PROJ_ATOL)


@pytest.mark.parametrize("rig", ["ring", "random"])
def test_calibration_topk_matches_jax(rig):
    m = small_cfg().model
    e2i = ring_rig() if rig == "ring" else random_rig(seed=4, n_cam=6)
    for per_camera in (False, True):
        for multiple in (8, 1024):
            got = geometry.calibration_topk(m, e2i, multiple=multiple,
                                            per_camera=per_camera)
            want = jgeo.calibration_topk(m, jnp.asarray(e2i),
                                         multiple=multiple,
                                         per_camera=per_camera)
            assert got == want, (per_camera, multiple, got, want)


def sca_inputs(seed=0, B=2, Q=40, C=64, n_cam=3, Z=4):
    rng = np.random.RandomState(seed)
    shapes = [(6, 8), (3, 4)]
    V = sum(h * w for h, w in shapes)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, n_cam, V, C).astype(np.float32)
    ref = rng.uniform(0, 1, (n_cam, B, Q, Z, 2)).astype(np.float32)
    # asymmetric visibility: camera 0 sees less than cameras 1-2
    mask = rng.rand(n_cam, B, Q, Z) < np.array([0.05, 0.2, 0.3])[
        :, None, None, None]
    pos = rng.randn(B, Q, C).astype(np.float32)
    return query, value, pos, ref, mask, shapes


def random_variables(module, *args, seed):
    """A flax module's variable tree with every leaf random: the tree's
    structure from `jax.eval_shape` (no init forward), all-zero leaves
    filled by `randomize_variables` (xavier kernels, N(0, 0.1^2) biases)."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return randomize_variables(zeros, seed=seed)


def certificate(aux):
    return sum(int(np.asarray(x).sum())
               for x in jax.tree_util.tree_leaves(aux.get("intermediates",
                                                          {})))


@pytest.mark.parametrize("branch", ["dense", "topk", "per_cam", "overflow"])
def test_spatial_cross_attention_matches_flax(branch):
    query, value, pos, ref, mask, shapes = sca_inputs()
    vis = mask.any(-1).sum(-1).max(-1)                  # (n_cam,)
    sca = {"dense": dict(max_queries_per_cam=0),
           "topk": dict(max_queries_per_cam=int(vis.max()) + 3),
           # cameras 1 and 2 share one K group, camera 0 has its own
           "per_cam": dict(per_cam_topk=(int(vis[0]) + 1,
                                         int(vis[1:].max()) + 2,
                                         int(vis[1:].max()) + 2)),
           "overflow": dict(per_cam_topk=(2, int(vis.max()) + 2,
                                          int(vis.max()) + 2))}[branch]
    cfg = SCAConfig(num_levels=2, num_points=8, **sca)
    jm = JaxSCA(cfg, embed_dims=64, num_cams=3, dtype=jnp.float32)
    args = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(pos),
            jnp.asarray(ref), jnp.asarray(mask), shapes)
    v = random_variables(jm, *args, seed=1)
    want, aux = jax.jit(lambda v, *a: jm.apply(
        v, *a, shapes, mutable=["intermediates"]))(v, *args[:5])
    mod = SpatialCrossAttention(cfg, 64, 3)
    mod.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got, overflow = mod(torch.from_numpy(query), torch.from_numpy(value),
                            torch.from_numpy(pos), torch.from_numpy(ref),
                            torch.from_numpy(mask), shapes)
    assert int(overflow) == certificate(aux)
    assert (int(overflow) > 0) == (branch == "overflow")
    assert torch.isfinite(got).all()
    if branch != "overflow":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODULE_ATOL, rtol=MODULE_RTOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_temporal_self_attention_matches_flax(with_prev):
    rng = np.random.RandomState(4)
    B, bh, bw, C = 2, 6, 7, 64
    Q = bh * bw
    query = rng.randn(B, Q, C).astype(np.float32)
    pos = rng.randn(B, Q, C).astype(np.float32)
    prev = rng.randn(B, 2, Q, C).astype(np.float32) if with_prev else None
    ref = rng.uniform(0, 1, (B, 2, Q, 1, 2)).astype(np.float32)
    cfg = TSAConfig()
    jm = JaxTSA(cfg, embed_dims=C, dtype=jnp.float32)
    args = (jnp.asarray(query), None if prev is None else jnp.asarray(prev),
            jnp.asarray(pos), jnp.asarray(ref), [(bh, bw)])
    v = random_variables(jm, *args, seed=2)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, [(bh, bw)]))(v, *args[:4])
    mod = TemporalSelfAttention(cfg, C)
    mod.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = mod(torch.from_numpy(query),
                  None if prev is None else torch.from_numpy(prev),
                  torch.from_numpy(pos), torch.from_numpy(ref), [(bh, bw)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODULE_ATOL, rtol=MODULE_RTOL)


@pytest.fixture(scope="module")
def model_setup():
    cfg = small_cfg()
    rng = np.random.RandomState(0)
    img = rng.randn(1, 6, *IMG_HW, 3).astype(np.float32)
    e2i = ring_rig()
    flax_shapes = jax.eval_shape(lambda: JaxOccNet(cfg.model).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
        jnp.asarray(e2i)))
    v = randomize_variables(init_jax_style_variables(cfg, seed=0), seed=1)
    return cfg, flax_shapes, v, img, e2i


@pytest.mark.parametrize("branch", ["topk", "dense"])
def test_gather_model_matches_jax(model_setup, branch):
    """Logits, flow and BEV of the whole model; "topk" runs static top-K
    SCA with K sized by `calibration_topk` (certificate 0 on both sides),
    "dense" the dense-masked SCA (max_queries_per_cam=0)."""
    cfg, _, v, img, e2i = model_setup
    k = (geometry.calibration_topk(cfg.model, e2i, multiple=8)
         if branch == "topk" else 0)
    assert k < cfg.model.bev_h * cfg.model.bev_w
    cfg = small_cfg(max_queries_per_cam=k)
    ref, aux = jax.jit(lambda v, i, e: JaxOccNet(cfg.model).apply(
        v, i, e, mutable=["intermediates"]))(v, jnp.asarray(img),
                                             jnp.asarray(e2i))
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        outs = model.eval()(torch.from_numpy(img), torch.from_numpy(e2i))
    assert int(outs["sca_topk_overflow"]) == certificate(aux) == 0
    occ_r = np.asarray(ref["occ"])
    assert outs["occ"].shape == occ_r.shape == (1, 10, 10, 4, 17)
    assert np.std(occ_r) > 1e-2                 # not a degenerate output
    for key in ("occ", "flow", "bev_embed"):
        np.testing.assert_allclose(outs[key].numpy(), np.asarray(ref[key]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=key)


def test_init_jax_style_variables_matches_flax_gather_tree(model_setup):
    cfg, flax_shapes, v, *_ = model_setup

    def leaves(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): x
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    ours = leaves(init_jax_style_variables(cfg, seed=0))
    assert {k: np.shape(a) for k, a in ours.items()} == \
        {k: tuple(s.shape) for k, s in leaves(flax_shapes).items()}
    assert not any("shared_value_proj" in k for k in ours)
    # the deterministic initialisers: zero kernels and attention biases, the
    # radial grid as the sampling_offsets bias (TSA: L x 2 queue slots)
    e = cfg.model.encoder
    det = [k for k in ours if "sampling_offsets" in k
           or "attention_weights" in k]
    assert len(det) == 2 * 2 * 2 * e.num_layers
    for k in det:
        if k.endswith("sampling_offsets/bias"):
            a = e.tsa if "self_attn" in k else e.sca
            slots = a.num_levels * (2 if "self_attn" in k else 1)
            want = radial_offset_bias(a.num_heads, slots, a.num_points)
        else:
            want = np.zeros_like(ours[k])
        np.testing.assert_array_equal(ours[k], want, err_msg=k)
    # the tree loads into the port strictly, and round-trips
    sd = from_jax_variables(v)
    OccNet(cfg.model).load_state_dict(sd)
    back = leaves(to_jax_variables(sd))
    assert back.keys() == leaves(v).keys()
    for k, a in leaves(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_predictor_serves_and_refuses_overflow(model_setup):
    cfg, _, v, _, e2i = model_setup
    imgs = np.random.RandomState(5).randint(0, 256, (1, 6, 90, 128, 3),
                                            dtype=np.uint8)
    k = geometry.calibration_topk(cfg.model, e2i, multiple=8)
    pred = Predictor(small_cfg(max_queries_per_cam=k), from_jax_variables(v),
                     "cpu")
    occ, flow, logits = pred(imgs, e2i, with_logits=True)
    assert occ.shape == (1, 10, 10, 4) and flow.shape == (1, 10, 10, 4, 2)
    assert torch.equal(occ, logits.argmax(-1))
    assert torch.isfinite(logits).all()
    small = Predictor(small_cfg(max_queries_per_cam=4),
                      from_jax_variables(v), "cpu")
    with pytest.raises(RuntimeError, match="sca_topk_overflow="):
        small(imgs, e2i)
