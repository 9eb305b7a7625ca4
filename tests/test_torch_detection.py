"""The port's detection path (`occnet_tpu_torch/models/{decoder,perception,
bbox}.py`) and its positional encodings against the JAX package on the
CPU, on numpy inputs from a seed and the same weights carried across, at
tests/test_decoder.py's and tests/test_perception.py's sizes: fp32 modules
within 1e-4 of max|ref| (`CustomMSDeformableAttention` at point and box
references, the decoder in both refinement modes, `PerceptionTransformer`
with and without can-bus / prev BEV, the 3D and relative positional
encodings), the box codec and costs within 1e-6, the Hungarian indices
equal on a matrix without ties, `decode_layer_boxes` / `nms_free_decode`
equal in indices and labels and within 1e-6 in codes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import config as jax_config
from occnet_tpu.models import bbox as jax_bbox
from occnet_tpu.models import decoder as jax_decoder
from occnet_tpu.models import positional as jax_positional
from occnet_tpu.models.perception import PerceptionTransformer as JaxPT
from occnet_tpu.models.perception import RegBranch as JaxRegBranch
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_perception_variables,
                                      randomize_variables, to_jax_variables)
from occnet_tpu_torch.models import bbox, decoder, positional
from occnet_tpu_torch.models.perception import (DEG_PER_RAD_XLA,
                                                PerceptionTransformer,
                                                RegBranch)
from _torch_threads import one_torch_thread  # noqa: E402,F401


def close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def jax_init(module, *args, **kw):
    """A random tree of ``module``'s structure (flax init, then every zero
    or identity leaf randomised)."""
    v = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0))
    return randomize_variables(jax.tree_util.tree_map(np.asarray, v), 1)


def test_inverse_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(0.0, 1.0, 101), [1e-7, 1 - 1e-7]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jax_decoder.inverse_sigmoid)(jnp.asarray(x)))
    close(decoder.inverse_sigmoid(torch.from_numpy(x)), want, 1e-6)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_custom_msda_matches_jax(ref_dim):
    """Point (B, Q, 2) and box (B, Q, 4) references, two levels, with
    samples off the map."""
    rng = np.random.RandomState(0)
    B, Nq, C, H = 2, 8, 32, 4
    shapes = [(6, 6), (3, 5)]
    q = rng.randn(B, Nq, C).astype(np.float32)
    pos = rng.randn(B, Nq, C).astype(np.float32)
    v = rng.randn(B, 36 + 15, C).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (B, Nq, ref_dim)).astype(np.float32)
    jm = jax_decoder.CustomMSDeformableAttention(embed_dims=C, num_heads=H,
                                                 num_levels=2)
    var = jax_init(jm, q, v, pos, ref, shapes)
    want = jax.jit(lambda var, *a: jm.apply(var, *a, shapes))(
        var, q, v, pos, ref)
    m = decoder.CustomMSDeformableAttention(C, H, num_levels=2)
    m.load_state_dict(from_jax_variables(var))
    got = m(*(torch.from_numpy(a) for a in (q, v, pos, ref)), shapes)
    close(got, want)


def _decoder_inputs(ref_dim):
    rng = np.random.RandomState(1)
    B, Nq, C = 1, 20, 64
    return (rng.randn(B, Nq, C).astype(np.float32),
            rng.randn(B, 100, C).astype(np.float32),
            rng.randn(B, Nq, C).astype(np.float32),
            rng.uniform(0.2, 0.8, (B, Nq, ref_dim)).astype(np.float32))


def test_decoder_internal_refine_matches_jax():
    """Standalone mode (2D references refined by ref_refine{lid}): the
    states and references of every layer."""
    q, bev, qpos, ref = _decoder_inputs(2)
    jd = jax_decoder.DetectionTransformerDecoder(
        num_layers=2, embed_dims=64, num_heads=4, ffn_dim=128)
    var = jax_init(jd, q, bev, qpos, ref, [(10, 10)])
    states, refs = jax.jit(lambda var, *a: jd.apply(var, *a, [(10, 10)]))(
        var, q, bev, qpos, ref)
    d = decoder.DetectionTransformerDecoder(2, 64, 4, 128)
    d.load_state_dict(from_jax_variables(var))
    gs, gr = d(*(torch.from_numpy(a) for a in (q, bev, qpos, ref)),
               [(10, 10)])
    close(gs, states)
    close(gr, refs)


def test_decoder_box_refine_and_pairing_match_jax():
    """The regression-branch mode on 3D references with the port's and
    JAX's branches on the same weights; each layer's decoded boxes against
    the reference it saw equal the post-refinement reference (the pairing
    of tests/test_decoder.py), and JAX's within 1e-6."""
    q, bev, qpos, ref = _decoder_inputs(3)
    L, C = 3, 64
    pc_range = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    jbr = [JaxRegBranch(C, 10) for _ in range(L)]
    bvars = [jax_init(b, q) for b in jbr]
    bound = [lambda x, b=b, p=p: b.apply(p, x) for b, p in zip(jbr, bvars)]
    jd = jax_decoder.DetectionTransformerDecoder(
        num_layers=L, embed_dims=C, num_heads=4, ffn_dim=128)
    var = jax_init(jd, q, bev, qpos, ref, [(10, 10)], reg_branches=bound)
    states, refs = jax.jit(lambda var, *a: jd.apply(
        var, *a, [(10, 10)], reg_branches=bound))(var, q, bev, qpos, ref)
    branches = []
    for p in bvars:
        b = RegBranch(C, 10)
        b.load_state_dict(from_jax_variables(p))
        branches.append(b)
    d = decoder.DetectionTransformerDecoder(L, C, 4, 128,
                                            internal_refine=False)
    d.load_state_dict(from_jax_variables(var))
    t = [torch.from_numpy(a) for a in (q, bev, qpos, ref)]
    gs, gr = d(*t, [(10, 10)], reg_branches=branches)
    close(gs, states)
    close(gr, refs)
    pc = np.asarray(pc_range, np.float32)
    for lvl in range(L):
        codes = branches[lvl](gs[lvl])
        got = bbox.decode_layer_boxes(codes, lvl, t[3], gr, pc_range)
        want = jax_bbox.decode_layer_boxes(
            jnp.asarray(codes.detach().numpy()), lvl, ref, refs, pc_range)
        close(got, want, 1e-6)
        xy = (got[..., 0:2].detach().numpy() - pc[0:2]) / (pc[3:5] - pc[0:2])
        np.testing.assert_allclose(xy, gr[lvl, ..., :2].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="reg_branches"):
        d(*t, [(10, 10)])


# ---------------------------------------------------------------------------
# PerceptionTransformer

PT = {"model.img_h": "32", "model.img_w": "48", "model.bev_h": "8",
      "model.bev_w": "8", "model.pillar_h": "2", "model.embed_dims": "32",
      "model.num_cams": "2", "model.num_feature_levels": "2",
      "model.compute_dtype": "float32", "model.encoder.mode": "gather",
      "model.encoder.num_layers": "1", "model.encoder.ffn_dim": "64",
      "model.encoder.num_points_in_pillar": "2",
      "model.encoder.sca.num_levels": "2"}


def pt_rig():
    """tests/test_perception.py's two cameras facing apart, turned by 0.3
    rad about the ego z axis, off the cells' field-of-view edges."""
    e2i = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    for ci in range(2):
        a = np.pi * ci + 0.3
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        K = np.array([[30.0, 0, 24], [0, 30, 16], [0, 0, 1]])
        e2i[0, ci, :3, :3] = K @ R
    return e2i


@pytest.fixture(scope="module")
def perception():
    cfg = config.apply_overrides(config.tiny_occ(), PT)
    jcfg = jax_config.apply_overrides(jax_config.tiny_occ(), PT)
    rng = np.random.RandomState(0)
    feats = [rng.randn(1, 2, 8, 12, 32).astype(np.float32),
             rng.randn(1, 2, 4, 6, 32).astype(np.float32)]
    jm = JaxPT(jcfg.model, num_query=12, decoder_layers=2)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, feats, pt_rig(),
        can_bus=jnp.zeros((1, 18)), prev_bev=jnp.zeros((1, 64, 32))))
    v = randomize_variables(init_jax_style_perception_variables(
        cfg, num_query=12, decoder_layers=2, seed=2), seed=3)
    model = PerceptionTransformer(cfg.model, num_query=12, decoder_layers=2)
    model.load_state_dict(from_jax_variables(v))
    return cfg, jm, shapes, v, model.eval(), feats


def test_perception_init_tree_is_jax_structure(perception):
    """`init_jax_style_perception_variables` builds the JAX module's tree:
    the same leaves and shapes, and the weight bridge round-trips it."""
    _, _, shapes, v, model, _ = perception

    def flat(t, p=()):
        for k, x in t.items():
            if hasattr(x, "items"):
                yield from flat(x, p + (k,))
            else:
                yield p + (k,), tuple(np.shape(x))
    assert dict(flat(v["params"])) == dict(flat(shapes["params"]))
    back = to_jax_variables(model.state_dict())
    assert dict(flat(back["params"])) == dict(flat(v["params"]))


@pytest.mark.parametrize("temporal", [False, True])
def test_perception_transformer_matches_jax(perception, temporal):
    """bev_embed, inter_states, init_reference and inter_references within
    1e-4 of max|ref|; with can-bus (ego moving 1.5 m, yaw 0.3 rad, the prev
    BEV turned by 10 degrees) and a prev BEV too; the certificate 0."""
    cfg, jm, _, v, model, feats = perception
    kw = {}
    if temporal:
        rng = np.random.RandomState(1)
        can_bus = np.zeros((1, 18), np.float32)
        can_bus[0, 0], can_bus[0, 1] = 1.5, -0.5
        can_bus[0, -2], can_bus[0, -1] = 0.3, 10.0
        kw = {"can_bus": can_bus,
              "prev_bev": rng.randn(1, 64, 32).astype(np.float32)}
    want = jax.jit(lambda v, f, e, kw: jm.apply(v, f, e, **kw))(
        v, feats, pt_rig(), kw)
    with torch.no_grad():
        got = model([torch.from_numpy(f) for f in feats],
                    torch.from_numpy(pt_rig()),
                    **{k: torch.from_numpy(a) for k, a in kw.items()})
    for g, w in zip(got[:4], want):
        close(g, w)
    assert int(got[4]) == 0
    with pytest.raises(ValueError, match="can_bus"):
        model([torch.from_numpy(f) for f in feats],
              torch.from_numpy(pt_rig()), prev_bev=torch.zeros(1, 64, 32))


def test_can_bus_angle_and_shift_match_xla():
    """The yaw in degrees is can_bus[-2] x fl32(180 / fl32(pi)), as XLA
    compiles ``s / jnp.pi * 180.0``: equal on 10^4 draws.  The shift of
    `get_bev_features` (taken in float64, rounded once) lies within 32
    ulps of its magnitude from JAX's jitted fp32 chain on 2,000 draws: not
    bitwise, as XLA's fp32 atan2 is correctly rounded on only ~84 % of
    draws and its sin / cos on ~98.6 % (measured), and the degree round
    trip through fp32 costs JAX up to ~18 ulps."""
    from occnet_tpu.ops.transforms import shift_bev_ref as jax_shift
    from occnet_tpu_torch.ops.transforms import shift_bev_ref
    rng = np.random.RandomState(2)
    s = rng.uniform(-7, 7, 10000).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: s / jnp.pi * 180.0)(s))
    got = (torch.from_numpy(s) * DEG_PER_RAD_XLA).numpy()
    np.testing.assert_array_equal(got, want)
    cb = np.zeros((2000, 18), np.float32)
    cb[:, :2] = rng.uniform(-3, 3, (2000, 2))
    cb[:, -2] = rng.uniform(-7, 7, 2000)
    gl, hw = (0.4, 0.4), (200, 200)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jax_shift(
        s[:2], s[-2] / jnp.pi * 180.0, gl, hw)))(cb)).astype(np.float64)
    t = torch.from_numpy(cb)
    got = shift_bev_ref(t[:, :2], t[:, -2] * DEG_PER_RAD_XLA, gl, hw)
    ulp = np.spacing(np.linalg.norm(want, axis=1, keepdims=True).astype(
        np.float32)).astype(np.float64)
    assert (np.abs(got.numpy() - want) / ulp).max() <= 32


def test_positional_encodings_3d_and_relative_match_jax():
    j3 = jax_positional.LearnedPositionalEncoding3D(4, 3, 5, 2)
    v3 = jax_init(j3, 2)
    p3 = positional.LearnedPositionalEncoding3D(4, 3, 5, 2)
    p3.load_state_dict(from_jax_variables(v3))
    close(p3(2), j3.apply(v3, 2), 0.0)
    jr = jax_positional.RelPositionEmbedding(num_pos_feats=16, out_dim=24)
    vr = jax_init(jr, 6, 7)
    pr = positional.RelPositionEmbedding(16, 24)
    pr.load_state_dict(from_jax_variables(vr))
    close(pr(6, 7), jax.jit(lambda v: jr.apply(v, 6, 7))(vr))


# ---------------------------------------------------------------------------
# the box stack

def _boxes(rng, n):
    return np.concatenate([
        rng.uniform(-40, 40, (n, 2)), rng.uniform(-1, 5, (n, 1)),
        rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
        rng.randn(n, 2)], axis=1).astype(np.float32)


def test_box_codec_and_costs_match_jax():
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 30)
    codes = jax_bbox.normalize_bbox(jnp.asarray(boxes))
    close(bbox.normalize_bbox(torch.from_numpy(boxes)), codes, 1e-6)
    close(bbox.normalize_bbox(torch.from_numpy(boxes[:, :7])),
          jax_bbox.normalize_bbox(jnp.asarray(boxes[:, :7])), 1e-6)
    pred = rng.randn(30, 10).astype(np.float32)
    close(bbox.denormalize_bbox(torch.from_numpy(pred)),
          jax_bbox.denormalize_bbox(jnp.asarray(pred)), 1e-6)
    gt = np.array(codes)[:7]
    close(bbox.bbox3d_l1_cost(torch.from_numpy(pred), torch.from_numpy(gt),
                              0.25),
          jax_bbox.bbox3d_l1_cost(pred, gt, 0.25), 1e-6)
    logits = (rng.randn(30, 10) * 3).astype(np.float32)
    labels = rng.randint(0, 10, 7)
    close(bbox.focal_loss_cost(torch.from_numpy(logits),
                               torch.from_numpy(labels)),
          jax_bbox.focal_loss_cost(jnp.asarray(logits), jnp.asarray(labels)),
          1e-6)
    close(bbox.classification_cost(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 1.5),
          jax_bbox.classification_cost(jnp.asarray(logits),
                                       jnp.asarray(labels), 1.5), 1e-6)


def test_hungarian_assignment_matches_jax():
    """Indices and labels equal; the solve's optimum is unique (no two
    assignments within 1e-3 of the best cost); empty cases."""
    rng = np.random.RandomState(5)
    pred = rng.randn(25, 10).astype(np.float32)
    logits = rng.randn(25, 10).astype(np.float32)
    boxes = _boxes(rng, 6)
    labels = rng.randint(0, 10, 6)
    want = jax_bbox.hungarian_assign_3d(pred, logits, boxes, labels)
    got = bbox.hungarian_assign_3d(torch.from_numpy(pred), logits, boxes,
                                   labels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] > 0).sum() == 6
    empty = bbox.hungarian_assign_3d(pred, logits, boxes[:0], labels[:0])
    assert not empty[0].any() and (empty[1] == -1).all()


def test_nms_free_decode_matches_jax():
    """Top-k over distinct scores: indices (labels) equal, boxes within
    1e-6; the centre-range mask and the decaying score threshold."""
    rng = np.random.RandomState(6)
    Q, ncls = 40, 10
    logits = rng.permutation(Q * ncls).reshape(Q, ncls).astype(
        np.float32) / 50.0 - 4.0                      # no ties
    codes = rng.randn(Q, 10).astype(np.float32) * np.array(
        [30, 30, 1, 1, 3, 1, 1, 1, 1, 1], np.float32)
    pcr = [-35.0, -35.0, -5.0, 35.0, 35.0, 5.0]
    for thr in (None, 0.3, 0.999):
        want = jax_bbox.nms_free_decode(jnp.asarray(logits),
                                        jnp.asarray(codes), pcr, max_num=25,
                                        score_threshold=thr)
        got = bbox.nms_free_decode(torch.from_numpy(logits),
                                   torch.from_numpy(codes), pcr, max_num=25,
                                   score_threshold=thr)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(want["valid"]))
        close(got["scores"], want["scores"], 1e-6)
        close(got["bboxes"], want["bboxes"], 1e-6)
    assert 0 < int(got["valid"].sum()) < 25
