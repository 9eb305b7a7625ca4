"""The port's DCNv2 (`occnet_tpu_torch/ops/deform_conv.py`,
`ops/dcn_window.py`, the DCN trunk of `models/resnet.py`) against the JAX
package on the CPU: the plain sampling against the Pallas window kernels it
replaces (run in interpret mode, as tests/test_dcn_window.py runs them) and
against the XLA gather form; the window certificate and `needed_radius`;
one layer against the flax `ModulatedDeformConv`; the weight bridge; the
whole model with a DCN trunk in both encoder modes; and the refusals of
`serve.Predictor` and of the CUDA wrapper.  The kernel itself
(`csrc/deform_conv.cu`) runs only on the card (`chip_smoke.py`).  Inputs
and weights come from numpy seeds; fp32 unless stated."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.config import tiny_occ
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.models.resnet import dcn_layer_indices as jax_dcn_indices
from occnet_tpu.ops import dcn_window as jdw
from occnet_tpu.ops.deform_conv import ModulatedDeformConv as JaxDCN
from occnet_tpu.ops.deform_conv import modulated_deform_conv
from occnet_tpu_torch.convert import (
    calibrate_dcn_offsets,
    from_jax_variables,
    init_jax_style_variables,
    randomize_variables,
    to_jax_variables,
)
from occnet_tpu_torch.data.pipeline import make_device_normalizer
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.resnet import ResNet, dcn_layer_indices
from occnet_tpu_torch.ops import deform_conv as port
from occnet_tpu_torch.ops.dcn_window import (
    needed_radius,
    window_overflow,
    window_supported,
)
from occnet_tpu_torch.serve import Predictor
from _torch_threads import one_torch_thread  # noqa: E402,F401

# fp32 sampling against fp32: the bound of tests/test_dcn_window.py:38
TOL = 2e-4
# the whole model: the bound of tests/test_torch_gather.py
MODEL_TOL = 1e-4
BF16_STEP = 2.0 ** -7      # one bf16 step, relative to the largest |value|


def rand_case(seed, B=2, h=7, w=9, C=4, off_scale=1.5, ho=None, wo=None):
    """x (B, h, w, C), offset (B, ho, wo, 18) mmcv (dy, dx) per tap, mask
    (B, ho, wo, 9) in [0, 1)."""
    rng = np.random.RandomState(seed)
    ho, wo = ho or h, wo or w
    x = rng.randn(B, h, w, C).astype(np.float32)
    offset = (rng.randn(B, ho, wo, 18) * off_scale).astype(np.float32)
    mask = rng.rand(B, ho, wo, 9).astype(np.float32)
    return x, offset, mask


def plain(x, offset, mask, stride=1, dtype=torch.float32):
    """The port's sampling (plain version) -> numpy (B, ho * wo, 9, C)."""
    B, ho, wo, _ = offset.shape
    launches = port.DEFORM.launches
    got = port.deform_sample_plain(
        torch.from_numpy(x).to(dtype),
        torch.from_numpy(offset).reshape(B, ho, wo, 9, 2),
        None if mask is None else torch.from_numpy(mask), stride)
    assert port.DEFORM.launches == launches      # the CPU never launches
    assert got.dtype == dtype
    return got.float().numpy().reshape(B, ho * wo, 9, x.shape[-1])


@pytest.mark.parametrize("radius,use_mask,C,variant", [
    (0, True, 4, "dymajor"), (0, False, 32, "legacy"),
    (1, True, 32, "legacy"), (1, False, 4, "dymajor"),
    (3, True, 4, "dymajor")])
def test_plain_matches_pallas_window(monkeypatch, radius, use_mask, C,
                                     variant):
    """#11 `_window_kernel_dymajor` and #12 `_window_kernel` (chosen by
    OCCNET_DCN_KERNEL), offsets clipped so floor(offset) stays in
    [-R, R]: certificate 0 on both sides, samples equal.  (R = 3 is the
    served radius; the interpret-mode compile grows with the (2R + 2)^2
    window, so R = 3 runs once.)"""
    monkeypatch.setenv("OCCNET_DCN_KERNEL", variant)
    x, offset, mask = rand_case(radius * 10 + C, C=C)
    offset = np.clip(offset, -radius, radius + 0.99)
    mask = mask if use_mask else None
    want, over = jax.jit(jdw._sampled_window, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), radius)
    got = plain(x, offset, mask)
    assert int(over) == 0
    assert int(window_overflow(torch.from_numpy(offset), 7, 9, radius)) == 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def jax_overflow(offset, mask, radius):
    B, h, w, _ = offset.shape
    return int(jdw._window_weights(jnp.asarray(offset), jnp.asarray(mask),
                                   h, w, 9, radius)[2])


def test_window_overflow_counts_only_contributing_samples():
    """The case of tests/test_dcn_window.py:55-65: one in-image sample past
    R = 1 counts; one pushed fully out of the image does not."""
    x, offset, mask = rand_case(2)
    offset = np.clip(offset, -0.9, 0.9)
    offset[0, 3, 4, 0] = 2.7
    offset[1, 0, 0, 0] = -30.0
    got = window_overflow(torch.from_numpy(offset), 7, 9, 1)
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == jax_overflow(offset, mask, 1) == 1
    offset[0, 3, 4, 0] = 0.5
    assert int(window_overflow(torch.from_numpy(offset), 7, 9, 1)) == \
        jax_overflow(offset, mask, 1) == 0


@pytest.mark.parametrize("seed,scale,radius", [(3, 1.5, 0), (4, 2.0, 1),
                                               (5, 3.0, 2), (6, 8.0, 3)])
def test_window_overflow_matches_jax(seed, scale, radius):
    """Random offset fields, many samples past R and many off the image."""
    _, offset, mask = rand_case(seed, off_scale=scale)
    got = int(window_overflow(torch.from_numpy(offset), 7, 9, radius))
    assert got == jax_overflow(offset, mask, radius) > 0


@pytest.mark.parametrize("scale,far", [(0.0, False), (1.5, False),
                                       (4.0, True)])
def test_needed_radius_matches_jax(scale, far):
    _, offset, _ = rand_case(7, off_scale=scale)
    if far:
        offset[0, 2, 2, 1] = -30.0        # off the image: never constrains R
    got = needed_radius(torch.from_numpy(offset), 7, 9)
    want = int(jdw.needed_radius(jnp.asarray(offset), 7, 9))
    assert got.dtype == torch.int64 and int(got) == want
    assert (want == 0) == (scale == 0.0)


@pytest.mark.parametrize("case", ["far", "normal3", "wide"])
def test_plain_matches_xla_gather(case):
    """`_sampled_gather` (stride 1, mask after sampling): offsets of +/-30 px
    (most samples off the image), N(0, 3^2), and a 3 x 130 map, which the
    JAX model sends to the gather path (wider than 128)."""
    if case == "far":
        x, offset, mask = rand_case(8, C=8)
        offset = np.random.RandomState(9).uniform(
            -30, 30, offset.shape).astype(np.float32)
    elif case == "normal3":
        x, offset, mask = rand_case(10, C=8, off_scale=3.0)
    else:
        x, offset, mask = rand_case(11, B=1, h=3, w=130, C=8, off_scale=2.0)
    want = np.asarray(jax.jit(jdw._sampled_gather)(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask)))
    np.testing.assert_allclose(plain(x, offset, mask), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("h,w", [(7, 9), (8, 6), (5, 5)])
def test_plain_stride2_matches_modulated_deform_conv(h, w):
    """Stride 2 (the stage-entry blocks), odd and even sizes: the columns
    contracted with a weight against `modulated_deform_conv`."""
    ho, wo = -(-h // 2), -(-w // 2)
    x, offset, mask = rand_case(12 + h, B=2, h=h, w=w, C=4, ho=ho, wo=wo)
    weight = np.random.RandomState(13).randn(3, 3, 4, 5).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: modulated_deform_conv(
        *a, stride=2))(jnp.asarray(x), jnp.asarray(offset),
                       jnp.asarray(mask), jnp.asarray(weight)))
    cols = plain(x, offset, mask, stride=2).reshape(2, ho * wo, 36)
    got = (cols.astype(np.float64) @ weight.reshape(36, 5)).reshape(
        2, ho, wo, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_bf16_rounds_the_fp32_sum_once():
    """bf16 x: the fp32 sampling of the bf16-rounded input, rounded once."""
    x, offset, mask = rand_case(14, C=16, off_scale=2.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = plain(xb.float().numpy(), offset, mask, dtype=torch.bfloat16)
    ref = torch.from_numpy(plain(xb.float().numpy(), offset, mask))
    np.testing.assert_array_equal(got, ref.to(torch.bfloat16).float().numpy())


def flax_layer(seed, cin, cout, stride, mode, dtype):
    """A flax DCN layer at R = 0, its random-filled variables and an input
    (B, h, w, cin); the offset biases are 0.5 px and the conv_offset kernel
    is scaled so that every offset stays in (0, 1) px: fractional
    positions, floor(offset) = 0, inside the R = 0 window."""
    layer = JaxDCN(cout, stride=stride, mode=mode, window_radius=0,
                   dtype=dtype)
    x = np.random.RandomState(seed).randn(2, 9, 11, cin).astype(np.float32)
    v = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = randomize_variables(v, seed + 1)
    v["params"]["conv_offset"]["kernel"] *= 0.1
    v["params"]["conv_offset"]["bias"][:18] = 0.5
    return layer, v, x


@pytest.mark.parametrize("mode,stride,dtype", [
    ("window", 1, "float32"), ("gather", 1, "float32"),
    ("gather", 2, "float32"), ("window", 1, "bfloat16"),
    ("gather", 2, "bfloat16")])
def test_layer_matches_flax(mode, stride, dtype):
    """`ModulatedDeformConv` against the flax layer, weights moved across by
    `from_jax_variables`, offsets in (0, 1) px (R = 0).  fp32 to 2e-4; bf16
    within one bf16 step of max|out| (the JAX gather form rounds each corner
    product to bf16, the port rounds the fp32 sum once)."""
    jdt = jnp.dtype(dtype)
    layer, v, x = flax_layer(15, 16, 8, stride, mode, jdt)
    want, aux = jax.jit(lambda v, x: layer.apply(
        v, x, mutable=["intermediates"]))(v, jnp.asarray(x).astype(jdt))
    want = np.asarray(want, np.float32)
    mod = port.ModulatedDeformConv(16, 8, stride, mode, 0,
                                   getattr(torch, dtype))
    mod.load_state_dict(from_jax_variables(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with torch.inference_mode():
        y, over = mod(xt)
        off, _ = mod.offset_and_mask(xt)
    got = y.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    assert ((off > 0) & (off < 1)).all() and off.std() > 0.02
    sown = jax.tree_util.tree_leaves(
        aux.get("intermediates", {}).get("dcn_window_overflow", ()))
    if mode == "window" and stride == 1:
        assert int(over) == int(sown[0]) == 0
    else:
        assert over is None and not sown
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        step = BF16_STEP * np.abs(want).max()
        assert np.abs(got - want).max() <= step, np.abs(got - want).max()


def test_dcn_layer_indices_and_window_supported_match_jax():
    """Arithmetic only: the R101-DCN layer indexing and which of its four
    DCN shapes the JAX package runs on the window kernel (input width,
    stride): layer3_0 (200, 2), layer3_1.. (100, 1), layer4_0 (100, 2),
    layer4_1.. (50, 1)."""
    stages = (False, False, True, True)
    assert dcn_layer_indices(101, stages) == jax_dcn_indices(101, stages)
    assert len(dcn_layer_indices(101, stages)) == 26
    for w, stride in ((200, 2), (100, 1), (100, 2), (50, 1), (128, 1),
                      (130, 1)):
        assert window_supported(w, 3, stride, 1) == \
            jdw.window_supported(w, 3, stride, 1)
    assert window_supported(100, 3, 1, 1) and window_supported(50, 3, 1, 1)
    assert not window_supported(200, 3, 2, 1)
    assert not window_supported(100, 3, 1, 2)


def test_per_layer_radii_follow_dcn_layer_indices():
    """`dcn_window_radii[i]` is the radius of the i-th DCN block in
    `dcn_layer_indices` order (the JAX `ResNet.__call__` indexing); blocks
    past its end take `dcn_window_radius`."""
    stages = (False, False, True, True)
    trunk = ResNet(50, dcn_stages=stages, dcn_mode="window",
                   dcn_window_radius=3, dcn_window_radii=(1, 0, 2, 1))
    got = {name: getattr(trunk, name).conv2.window_radius
           for name in dcn_layer_indices(50, stages)}
    assert got == {"layer3_0": 1, "layer3_1": 0, "layer3_2": 2,
                   "layer3_3": 1, "layer3_4": 3, "layer3_5": 3,
                   "layer4_0": 3, "layer4_1": 3, "layer4_2": 3}
    assert not isinstance(trunk.layer2_0.conv2, port.ModulatedDeformConv)


IMG_HW = (64, 96)


def dcn_cfg(depth=50, mode="dense", dcn_mode="window", radius=0, **kw):
    """tiny_occ cut to 64 channels, a 6 x 6 BEV, 2 layers, fp32, with a
    DCN trunk: stages 3-4 (the depth of tests/test_dcn_window.py).  R = 0
    keeps the interpret-mode compile of each of the 7 window layers short
    (it grows with the (2R + 2)^2 window)."""
    cfg = tiny_occ()
    enc = cfg.model.encoder
    bb = dataclasses.replace(cfg.model.backbone, type=f"resnet{depth}",
                             dcn_stages=(False, False, True, True),
                             dcn_mode=dcn_mode, dcn_window_radius=radius,
                             **kw)
    model = dataclasses.replace(
        cfg.model, img_h=IMG_HW[0], img_w=IMG_HW[1], bev_h=6, bev_w=6,
        pillar_h=4, embed_dims=64, out_dim=8, compute_dtype="float32",
        backbone=bb, encoder=dataclasses.replace(
            enc, mode=mode, num_layers=2, ffn_dim=64, num_points_in_pillar=4,
            sca=dataclasses.replace(enc.sca, max_queries_per_cam=0)))
    return dataclasses.replace(cfg, model=model)


def ring_rig(n_cam=6, focal=50.0):
    h, w = IMG_HW
    e = np.tile(np.eye(4, dtype=np.float32), (1, n_cam, 1, 1))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    for ci in range(n_cam):
        a = 2 * np.pi * ci / n_cam + 0.1
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        e[0, ci, :3, :3] = (K @ R).astype(np.float32)
        e[0, ci, :3, 3] = (K @ np.array([0.0, 0.4, 0.3])).astype(np.float32)
    return e


def scale_offsets(v, factors):
    """Copy of the flax variables with the offset and mask-logit columns of
    each conv_offset kernel scaled by the factors of `calibrate_dcn_offsets`
    (a dict keyed by state_dict key), or all by one number."""
    params = jax.tree_util.tree_map(lambda a: np.array(a), v["params"])
    for name, blk in params["backbone"].items():
        if "conv_offset" in blk.get("conv2", {}):
            f_off, f_mask = (factors, factors) if np.isscalar(factors) else \
                factors[f"backbone.{name}.conv2.conv_offset.weight"]
            kernel = blk["conv2"]["conv_offset"]["kernel"]
            kernel[..., :18] *= f_off
            kernel[..., 18:] *= f_mask
    return {**v, "params": params}


def calibrated(cfg, v, img, e2i, max_px):
    """The variables with every DCN layer's offsets at most max_px on this
    input (the port's model on the CPU calibrates, both sides get the
    factors)."""
    model = OccNet(cfg.model).eval()
    model.load_state_dict(from_jax_variables(v))
    return scale_offsets(v, calibrate_dcn_offsets(
        model, torch.as_tensor(img, dtype=torch.float32),
        torch.from_numpy(e2i), max_px))


@pytest.fixture(scope="module")
def dcn_setup():
    rng = np.random.RandomState(0)
    img = rng.randn(1, 6, *IMG_HW, 3).astype(np.float32)
    v = {m: randomize_variables(init_jax_style_variables(dcn_cfg(mode=m),
                                                         seed=0), seed=1)
         for m in ("dense", "gather")}
    return img, ring_rig(), v


@pytest.fixture
def lift_on_port_inputs(monkeypatch):
    """Both dense lifts round their input features to bf16, so trunk
    features that differ in their last fp32 bits (as two convolution
    libraries' do) round to neighbouring bf16 values and move the BEV by
    more than the 1e-4 bound.  The port's lift inputs are captured, JAX's lift runs on them at
    the port's rounding points (bf16 features, fp32 hat weights, as
    tests/test_torch_train.py does), and JAX's own inputs are returned for
    comparison.  Run the port first."""
    from occnet_tpu.ops import planar_lift as jax_lift
    import occnet_tpu_torch.models.transformer_occ as port_tr
    port_in, jax_in = [], []
    port_lift = port_tr.lift_and_average

    def capture(feats, *a, **k):
        port_in[:] = [f.detach().numpy() for f in feats]
        return port_lift(feats, *a, **k)

    def stash(*feats):
        jax_in[:] = [np.asarray(f) for f in feats]

    lift, warp = jax_lift.lift_and_average, jax_lift.warp_level_multi_z

    def on_port_inputs(feats, *a, **k):
        jax.debug.callback(stash, *feats)
        return lift([jnp.asarray(p).astype(jnp.bfloat16).astype(f.dtype)
                     for p, f in zip(port_in, feats)], *a, **k)

    monkeypatch.setattr(port_tr, "lift_and_average", capture)
    monkeypatch.setattr(jax_lift, "warp_level_multi_z",
                        lambda *a, **k: warp(*a, band_dtype=jnp.float32, **k))
    monkeypatch.setattr(jax_lift, "lift_and_average", on_port_inputs)
    return port_in, jax_in


@pytest.mark.parametrize("mode,dcn_mode", [("dense", "window"),
                                           ("gather", "gather")])
def test_dcn_model_matches_jax(dcn_setup, mode, dcn_mode,
                               lift_on_port_inputs):
    """The whole model, R50 with DCN stages 3-4, in the two pairings that
    serve: window DCN with the dense encoder (`turbo_r101_dcn_occ`; the JAX
    side runs the Pallas window kernel in interpret mode on its 7 eligible
    layers) and gather DCN with the exact encoder (`r101_dcn_occ`; XLA
    gathers).  Random-filled weights; each conv_offset's offset bias set to
    0.5 px and its kernel scaled to keep every offset in (0.05, 0.95) px:
    fractional positions, floor(offset) = 0, so the R = 0 window is exact.
    Certificate 0 on both sides; the lift inputs (DCN trunk, FPN, value
    projection) within 1e-4 of their largest value; logits, flow and BEV
    within 1e-4."""
    img, e2i, v = dcn_setup
    cfg = dcn_cfg(mode=mode, dcn_mode=dcn_mode)
    v = jax.tree_util.tree_map(lambda a: np.array(a), v[mode])
    for blk in v["params"]["backbone"].values():
        if "conv_offset" in blk.get("conv2", {}):
            blk["conv2"]["conv_offset"]["bias"][:18] = 0.5
    v = calibrated(cfg, v, img, e2i, 0.95)
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        outs = model.eval()(torch.from_numpy(img), torch.from_numpy(e2i))
    ref, aux = jax.jit(lambda v, i, e: JaxOccNet(cfg.model).apply(
        v, i, e, mutable=["intermediates"]))(v, jnp.asarray(img),
                                             jnp.asarray(e2i))
    jax.effects_barrier()
    sown = [int(x) for p, x in jax.tree_util.tree_leaves_with_path(
        aux["intermediates"]) if "dcn_window_overflow" in str(p)]
    need = [int(x) for p, x in jax.tree_util.tree_leaves_with_path(
        aux["intermediates"]) if "dcn_radius_needed" in str(p)]
    port_in, jax_in = lift_on_port_inputs
    assert len(port_in) == len(jax_in) == (4 if mode == "dense" else 0)
    for ours, theirs in zip(port_in, jax_in):
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=MODEL_TOL * np.abs(theirs).max())
    assert need == [0] * 7
    if dcn_mode == "window":
        assert len(sown) == 7
        assert outs["dcn_window_overflow"].dtype == torch.int64
        assert int(outs["dcn_window_overflow"]) == sum(sown) == 0
    else:
        assert not sown and "dcn_window_overflow" not in outs
    occ_r = np.asarray(ref["occ"])
    assert outs["occ"].shape == occ_r.shape == (1, 6, 6, 4, 17)
    assert np.std(occ_r) > 1e-2                   # not a degenerate output
    for key in ("occ", "flow", "bev_embed"):
        np.testing.assert_allclose(outs[key].numpy(), np.asarray(ref[key]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=key)


def test_init_tree_matches_flax_r101_dcn():
    """`init_jax_style_variables` for an R101-DCN config at tiny widths has
    the key set and shapes of the flax init (`jax.eval_shape`, no forward)
    and zero conv_offset leaves; the trunk's leaves (the DCN ones drawn at
    random) load into the port's ResNet-101-DCN through
    `from_jax_variables` and come back unchanged through
    `to_jax_variables`."""
    cfg = dcn_cfg(depth=101, mode="gather")
    img = np.zeros((1, 6, *IMG_HW, 3), np.float32)
    shapes = jax.eval_shape(lambda: JaxOccNet(cfg.model).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
        jnp.asarray(ring_rig())))

    def leaves(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): x
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    full = init_jax_style_variables(cfg, seed=0)
    ours = leaves(full)
    assert {k: np.shape(a) for k, a in ours.items()} == \
        {k: tuple(s.shape) for k, s in leaves(shapes).items()}
    dcn = [k for k in ours if "conv_offset" in k]
    assert len(dcn) == 2 * 26
    assert all(not ours[k].any() for k in dcn)

    v = jax.tree_util.tree_map(lambda a: np.array(a), {
        c: {"backbone": full[c]["backbone"]} for c in full})
    rng = np.random.RandomState(1)
    for k in dcn:
        _, _, block, _, _, leaf = k.split("/")
        co = v["params"]["backbone"][block]["conv2"]["conv_offset"]
        co[leaf] = rng.randn(*co[leaf].shape).astype(np.float32)
    bb = cfg.model.backbone
    trunk = ResNet(101, bb.out_indices, dcn_stages=bb.dcn_stages)
    trunk.load_state_dict({k[len("backbone."):]: t for k, t in
                           from_jax_variables(v).items()})
    conv2 = trunk.layer3_5.conv2
    assert isinstance(conv2, port.ModulatedDeformConv)
    np.testing.assert_array_equal(
        conv2.conv_offset.weight.detach().numpy(),
        v["params"]["backbone"]["layer3_5"]["conv2"]["conv_offset"][
            "kernel"].transpose(3, 2, 0, 1))
    back = leaves(to_jax_variables({f"backbone.{k}": t for k, t in
                                    trunk.state_dict().items()}))
    assert back.keys() == leaves(v).keys()
    for k, a in leaves(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_predictor_refuses_dcn_overflow(dcn_setup):
    """Offsets far past R: the window certificate is nonzero and the
    request raises; in gather mode (no certificate) the same weights
    serve."""
    _, e2i, v = dcn_setup
    imgs = np.random.RandomState(5).randint(0, 256, (1, 6, *IMG_HW, 3),
                                            dtype=np.uint8)
    norm = make_device_normalizer(dcn_cfg().data)(torch.from_numpy(imgs))
    far = from_jax_variables(calibrated(dcn_cfg(), v["dense"], norm, e2i,
                                        6.0))
    pred = Predictor(dcn_cfg(), far, "cpu")
    with pytest.raises(RuntimeError, match="dcn_window_overflow="):
        pred(imgs, e2i)
    assert pred.dcn_window_overflow > 0
    ok = Predictor(dcn_cfg(dcn_mode="gather"), far, "cpu")
    occ, flow = ok(imgs, e2i)
    assert occ.shape == (1, 6, 6, 4) and ok.dcn_window_overflow is None
    # zero kernels: the offsets are the conv_offset biases, N(0, 0.1^2),
    # so floor(offset) is -1 or 0 and the R = 1 window is exact
    fine = Predictor(dcn_cfg(radius=1), from_jax_variables(
        scale_offsets(v["dense"], 0.0)), "cpu")
    fine(imgs, e2i)
    assert fine.dcn_window_overflow == 0


def test_cuda_wrapper_refusals():
    x, offset, mask = rand_case(16, C=8)
    xt, ot, mt = (torch.from_numpy(a) for a in (x, offset, mask))
    ot = ot.reshape(2, 7, 9, 9, 2)
    launches = port.DEFORM.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.deform_sample_cuda(xt, ot, mt)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        port.deform_sample_cuda(xt, ot, mt, stride=3)
    with pytest.raises(ValueError, match="dilation 1"):
        port.deform_sample_cuda(xt, ot, mt, dilation=2)
    with pytest.raises(ValueError, match="3x3 taps"):
        port.deform_sample_cuda(xt, ot[..., :4, :], mt)
    with pytest.raises(ValueError, match="mask"):
        port.deform_sample_cuda(xt, ot, mt[..., :4])
    assert port.DEFORM.launches == launches
    dcols = torch.zeros(2, 7 * 9, 9 * 8)
    launches = port.DEFORM_BWD.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.deform_sample_backward_cuda(xt, ot, mt, dcols)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        port.deform_sample_backward_cuda(xt, ot, mt, dcols, stride=3)
    assert port.DEFORM_BWD.launches == launches


def conv_case(seed, B=2, h=7, w=9, C=8, cout=6, off_scale=1.5, ho=None,
              wo=None):
    """`rand_case` plus a weight (3, 3, C, cout): the JAX layout, whose
    reshape to (9 * C, cout) is the port's tap-major `wmat`."""
    x, offset, mask = rand_case(seed, B, h, w, C, off_scale, ho, wo)
    weight = np.random.RandomState(seed + 100).randn(3, 3, C, cout).astype(
        np.float32) / np.sqrt(9 * C)
    return x, offset, mask, weight


def port_conv(x, offset, mask, weight, stride=1, radius=None,
              dtype=torch.float32):
    """`deform_conv_plain` -> (y numpy fp32 (B, ho, wo, cout), count)."""
    B, ho, wo, _ = offset.shape
    launches = port.DEFORM_CONV.launches, port.DEFORM.launches
    y, count = port.deform_conv_plain(
        torch.from_numpy(x).to(dtype),
        torch.from_numpy(offset).reshape(B, ho, wo, 9, 2),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(weight).reshape(-1, weight.shape[-1]).to(dtype),
        stride, radius)
    assert (port.DEFORM_CONV.launches, port.DEFORM.launches) == launches
    assert y.dtype == dtype
    return y.float().numpy(), count


@pytest.mark.parametrize("radius,use_mask,dtype", [
    (0, True, "float32"), (1, False, "float32"), (1, True, "bfloat16"),
    (0, False, "bfloat16")])
def test_conv_plain_matches_pallas_window_conv(radius, use_mask, dtype):
    """`deform_conv_plain` against `modulated_deform_conv_window` (#11
    through `_sampled_window` in interpret mode, then the einsum), offsets
    inside the window: y and the certificate (0 on both sides).  fp32 to
    2e-4; bf16 within one bf16 step of max|y| (the window kernel sums its
    slots in another order before its one rounding of the samples)."""
    x, offset, mask, weight = conv_case(20 + radius, C=16)
    offset = np.clip(offset, -radius, radius + 0.99)
    mask = mask if use_mask else None
    jdt = jnp.dtype(dtype)
    want, over = jax.jit(jdw.modulated_deform_conv_window,
                         static_argnames="radius")(
        jnp.asarray(x).astype(jdt), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask),
        jnp.asarray(weight).astype(jdt), radius=radius)
    want = np.asarray(want, np.float32)
    xd = np.array(jnp.asarray(x).astype(jdt), np.float32)
    wd = np.array(jnp.asarray(weight).astype(jdt), np.float32)
    got, count = port_conv(xd, offset, mask, wd, radius=radius,
                           dtype=getattr(torch, dtype))
    assert got.shape == want.shape == (2, 7, 9, 6)
    assert count.dtype == torch.int64 and int(count) == int(over) == 0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        step = BF16_STEP * np.abs(want).max()
        assert np.abs(got - want).max() <= step, np.abs(got - want).max()


@pytest.mark.parametrize("seed,scale,radius", [(21, 2.0, 0), (22, 4.0, 1)])
def test_conv_plain_count_matches_pallas_window_conv(seed, scale, radius):
    """Offsets past the window and off the image: the count of
    `deform_conv_plain` equals the overflow of `modulated_deform_conv_window`
    (nonzero; the outputs then differ by design: JAX zeroes those
    samples)."""
    x, offset, mask, weight = conv_case(seed, C=8, off_scale=scale)
    _, over = jax.jit(jdw.modulated_deform_conv_window,
                      static_argnames="radius")(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(weight), radius=radius)
    _, count = port_conv(x, offset, mask, weight, radius=radius)
    assert int(count) == int(over) > 0


@pytest.mark.parametrize("h,w,use_mask,dtype", [
    (7, 9, True, "float32"), (8, 6, False, "float32"),
    (7, 9, True, "bfloat16")])
def test_conv_plain_stride2_matches_gather_form(h, w, use_mask, dtype):
    """Stride 2 against the XLA gather form `modulated_deform_conv` (no
    certificate on either side).  fp32 to 2e-4; bf16 within one bf16 step
    of max|y| (the gather form rounds each corner product to bf16)."""
    ho, wo = -(-h // 2), -(-w // 2)
    x, offset, mask, weight = conv_case(30 + h, h=h, w=w, ho=ho, wo=wo)
    mask = mask if use_mask else None
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax.jit(lambda *a: modulated_deform_conv(
        *a, stride=2))(jnp.asarray(x).astype(jdt), jnp.asarray(offset),
                       None if mask is None else jnp.asarray(mask),
                       jnp.asarray(weight).astype(jdt)), np.float32)
    xd = np.array(jnp.asarray(x).astype(jdt), np.float32)
    wd = np.array(jnp.asarray(weight).astype(jdt), np.float32)
    got, count = port_conv(xd, offset, mask, wd, stride=2,
                           dtype=getattr(torch, dtype))
    assert count is None and got.shape == want.shape == (2, ho, wo, 6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        step = BF16_STEP * np.abs(want).max()
        assert np.abs(got - want).max() <= step, np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_on_cpu_is_deform_conv_plain(dtype):
    """`ModulatedDeformConv` (window mode, R = 1) on the CPU returns
    `deform_conv_plain`'s y and count bitwise, on offsets whose count is
    nonzero; a counter handed in gets the count added and comes back as
    the certificate."""
    dt = getattr(torch, dtype)
    torch.manual_seed(3)
    mod = port.ModulatedDeformConv(16, 8, 1, "window", 1, dt)
    with torch.no_grad():
        mod.conv_offset.weight.normal_(0.0, 0.5)
    x = torch.randn(2, 16, 7, 9).to(dt).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        y, over = mod(x)
        off, mask = mod.offset_and_mask(x)
        wmat = mod.weight.to(dt).permute(2, 3, 1, 0).reshape(9 * 16, 8)
        want, count = port.deform_conv_plain(x.permute(0, 2, 3, 1), off,
                                             mask, wmat, 1, 1)
        slot = torch.full((1,), 5, dtype=torch.int32)
        y2, over2 = mod(x, slot)
    assert y.dtype == dt and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y.permute(0, 2, 3, 1), want) and torch.equal(y2, y)
    assert int(over) == int(count) > 0
    assert over2 is slot and int(slot) == 5 + int(count)


def test_fused_cuda_wrapper_refusals():
    """`deform_conv_cuda` (the fused kernel's wrapper) refuses what the
    kernel does not take, with a message, before any build or launch."""
    x, offset, mask, weight = conv_case(40, C=32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ot = torch.from_numpy(offset).reshape(2, 7, 9, 9, 2)
    mt = torch.from_numpy(mask)
    wt = torch.from_numpy(np.random.RandomState(41).randn(9 * 32, 256)).to(
        torch.bfloat16)
    launches = port.DEFORM_CONV.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.deform_conv_cuda(xt, ot, mt, wt)
    with pytest.raises(ValueError, match="bf16 x and wmat"):
        port.deform_conv_cuda(xt.float(), ot, mt, wt)
    with pytest.raises(ValueError, match="bf16 x and wmat"):
        port.deform_conv_cuda(xt, ot, mt, wt.float())
    with pytest.raises(ValueError, match="contiguous"):
        port.deform_conv_cuda(xt.permute(0, 2, 1, 3).contiguous().permute(
            0, 2, 1, 3), ot, mt, wt)
    with pytest.raises(ValueError, match="multiple of 32"):
        port.deform_conv_cuda(xt[..., :16].contiguous(), ot, mt,
                              wt[:9 * 16].contiguous())
    with pytest.raises(ValueError, match="Cout = 128"):
        port.deform_conv_cuda(xt, ot, mt, wt[:, :128].contiguous())
    with pytest.raises(ValueError, match=r"not \(9 \* 32, Cout\)"):
        port.deform_conv_cuda(xt, ot, mt, wt[:8 * 32].contiguous())
    with pytest.raises(ValueError, match="stride 1 or 2"):
        port.deform_conv_cuda(xt, ot, mt, wt, stride=3)
    assert port.DEFORM_CONV.launches == launches
    with pytest.raises(ValueError, match="no implementation"):
        port.deform_conv(xt.to("meta"), ot.to("meta"), mt.to("meta"),
                         wt.to("meta"))
