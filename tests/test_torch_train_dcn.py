"""R101-DCN training of the port against the JAX package on the CPU: the
plain backward of the DCNv2 sampling
(`ops/deform_conv.deform_sample_backward_plain`) against autograd of the
plain forward and against the JAX VJPs it stands in for (the window path's
`_svw_bwd`, XLA autodiff of `modulated_deform_conv` at stride 2), the
layer's autograd Function (every gradient, the certificate counter), and
whole train steps of the small R50-DCN config in its two pairings against
JAX's `make_train_step`.  The CUDA backward kernel
(`csrc/deform_conv_bwd.cu`) runs only on the card (`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occnet_tpu.ops.dcn_window as jdw
from occnet_tpu.ops.deform_conv import modulated_deform_conv
from occnet_tpu_torch.convert import (
    init_jax_style_variables,
    randomize_variables,
)
from occnet_tpu_torch.ops import deform_conv as pdc
from occnet_tpu_torch.ops.dcn_window import window_overflow
from tests.test_torch_dcn import calibrated, dcn_cfg, ring_rig
from tests.test_torch_train import jax_lift_at_port_rounding  # noqa: F401
from tests.test_torch_train_exact import (
    AUTOGRAD_TOL,
    JAX_TOL,
    deterministic,
    held,
    train_step_against_jax,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

def dcn_case(seed, B=2, h=7, w=9, C=8, stride=1, off_scale=1.5,
             use_mask=True):
    """x NHWC, offsets N(0, off_scale^2) px with a few far outside the image,
    mask U(0, 1) and a columns gradient, as numpy."""
    rng = np.random.RandomState(seed)
    ho, wo = pdc.out_size(h, w, stride)
    x = rng.randn(B, h, w, C).astype(np.float32)
    off = (rng.randn(B, ho, wo, 9, 2) * off_scale).astype(np.float32)
    off[0, 0, 0] = 40.0                   # every corner outside the image
    mask = rng.rand(B, ho, wo, 9).astype(np.float32) if use_mask else None
    dcols = rng.randn(B, ho * wo, 9 * C).astype(np.float32)
    return x, off, mask, dcols


def dcn_backward(x, off, mask, dcols, stride):
    got = pdc.deform_sample_backward_plain(
        torch.from_numpy(x), torch.from_numpy(off),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(dcols), stride)
    return [None if t is None else t.numpy() for t in got]


@pytest.mark.parametrize("stride,use_mask,hw", [
    (1, True, (7, 9)), (1, False, (5, 6)), (2, True, (7, 9)),
    (2, True, (8, 6))])
def test_deform_backward_plain_matches_autograd(stride, use_mask, hw):
    x, off, mask, dcols = dcn_case(10 + stride, h=hw[0], w=hw[1],
                                   stride=stride, use_mask=use_mask)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, off) + ((mask,) if use_mask else ())]
    cols = pdc.deform_sample_plain(leaves[0], leaves[1],
                                   leaves[2] if use_mask else None, stride)
    want = torch.autograd.grad(cols, leaves, torch.from_numpy(dcols))
    got = dcn_backward(x, off, mask, dcols, stride)
    assert (got[2] is None) == (not use_mask)
    for name, g, w in zip(("dx", "doffset", "dmask"), got, want):
        held(g, w.numpy(), AUTOGRAD_TOL, name)
    assert not got[1][0, 0, 0].any()      # a sample off the image: none


def test_deform_backward_plain_matches_jax_window_vjp():
    """Stride 1: the VJP of `dcn_window._sampled_window_vjp` (forward the
    Pallas window kernel in interpret mode, backward `_svw_bwd`) at R = 1,
    offsets clipped to floor in [-1, 1], so its certificate is 0 (counted
    by `window_overflow`, held to JAX's count in tests/test_torch_dcn.py)."""
    x, off, mask, dcols = dcn_case(20)
    off = np.clip(off, -1.0, 1.99)
    B, ho, wo = off.shape[:3]
    assert int(window_overflow(torch.from_numpy(off), ho, wo, 1)) == 0
    _, vjp = jax.vjp(lambda a, o, m: jdw._sampled_window_vjp(a, o, m, 1),
                     jnp.asarray(x), jnp.asarray(off.reshape(B, ho, wo, 18)),
                     jnp.asarray(mask))
    want = vjp(jnp.asarray(dcols.reshape(B, ho * wo, 9, -1)))
    got = dcn_backward(x, off, mask, dcols, 1)
    held(got[0], np.asarray(want[0]), JAX_TOL, "dx")
    held(got[1], np.asarray(want[1]).reshape(off.shape), JAX_TOL, "doffset")
    held(got[2], np.asarray(want[2]), JAX_TOL, "dmask")


def test_deform_backward_plain_matches_modulated_deform_conv_vjp():
    """Stride 2 (the stage-entry layers, XLA autodiff in JAX): the VJP of
    `modulated_deform_conv` with a weight that copies each (tap, channel)
    to its own output channel, so that its output is the columns."""
    x, off, mask, dcols = dcn_case(30, stride=2)
    B, ho, wo = off.shape[:3]
    C = x.shape[-1]
    eye = np.eye(9 * C, dtype=np.float32).reshape(3, 3, C, 9 * C)
    _, vjp = jax.vjp(lambda a, o, m: modulated_deform_conv(
        a, o, m, jnp.asarray(eye), stride=2), jnp.asarray(x),
        jnp.asarray(off.reshape(B, ho, wo, 18)), jnp.asarray(mask))
    want = vjp(jnp.asarray(dcols.reshape(B, ho, wo, 9 * C)))
    got = dcn_backward(x, off, mask, dcols, 2)
    held(got[0], np.asarray(want[0]), JAX_TOL, "dx")
    held(got[1], np.asarray(want[1]).reshape(off.shape), JAX_TOL, "doffset")
    held(got[2], np.asarray(want[2]), JAX_TOL, "dmask")


# the window radius of the served window-DCN layers
R = 3


def halo_case(seed, stride, B=2, C=8):
    """`dcn_case` with offsets across the served window's edge: every
    |offset| in [R, R + 2] px, either sign (floor(offset) from +/-3, inside
    the R = 3 window, to +/-5 outside it), and 1 % at +/-30 px (off the
    image), on a 12 x 14 output grid."""
    h, w = 12 * stride, 14 * stride
    x, _, mask, dcols = dcn_case(seed, B, h, w, C, stride)
    rng = np.random.RandomState(seed + 1)
    shape = (B,) + pdc.out_size(h, w, stride) + (9, 2)
    sign = rng.choice([-1.0, 1.0], size=shape)
    off = sign * rng.uniform(R, R + 2, size=shape)
    far = rng.rand(*shape) < 0.01
    off = np.where(far, sign * 30.0, off).astype(np.float32)
    return x, off, mask, dcols


@pytest.mark.parametrize("stride,ref", [(1, "window"), (1, "modulated"),
                                        (2, "modulated")])
def test_deform_backward_plain_halo_offsets_match_jax(stride, ref):
    """Offsets across the window's edge (`halo_case`) against autograd of
    the plain forward and against JAX: the window VJP (`_svw_bwd`, at the
    radius R + 2 that keeps its certificate 0: the +/-30 px samples miss
    the image) or XLA autodiff of `modulated_deform_conv`."""
    x, off, mask, dcols = halo_case(50 + stride, stride)
    B, ho, wo = off.shape[:3]
    C = x.shape[-1]
    got = dcn_backward(x, off, mask, dcols, stride)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, off, mask)]
    cols = pdc.deform_sample_plain(*leaves, stride)
    auto = torch.autograd.grad(cols, leaves, torch.from_numpy(dcols))
    for name, g, w in zip(("dx", "doffset", "dmask"), got, auto):
        held(g, w.numpy(), AUTOGRAD_TOL, f"autograd {name}")
    if ref == "window":
        radius = R + 2
        assert int(window_overflow(torch.from_numpy(off), ho, wo,
                                   radius)) == 0
        _, vjp = jax.vjp(
            lambda a, o, m: jdw._sampled_window_vjp(a, o, m, radius),
            jnp.asarray(x), jnp.asarray(off.reshape(B, ho, wo, 18)),
            jnp.asarray(mask))
        want = vjp(jnp.asarray(dcols.reshape(B, ho * wo, 9, -1)))
    else:
        eye = np.eye(9 * C, dtype=np.float32).reshape(3, 3, C, 9 * C)
        _, vjp = jax.vjp(lambda a, o, m: modulated_deform_conv(
            a, o, m, jnp.asarray(eye), stride=stride), jnp.asarray(x),
            jnp.asarray(off.reshape(B, ho, wo, 18)), jnp.asarray(mask))
        want = vjp(jnp.asarray(dcols.reshape(B, ho, wo, 9 * C)))
    held(got[0], np.asarray(want[0]), JAX_TOL, "dx")
    held(got[1], np.asarray(want[1]).reshape(off.shape), JAX_TOL, "doffset")
    held(got[2], np.asarray(want[2]), JAX_TOL, "dmask")


@pytest.mark.parametrize("stride,x_grad", [(1, True), (2, True), (1, False)])
def test_deform_conv_function_gradients_and_certificate(stride, x_grad):
    """`deform_conv` under autograd on the CPU: y and the certificate as
    `deform_conv_plain` gives them; every gradient within AUTOGRAD_TOL of
    autograd of `deform_conv_plain`; an x that needs no gradient (a frozen
    input) gets none; the counter handed in holds one forward's count
    after the backward too; no kernel launches."""
    x, off, mask, _ = dcn_case(40 + stride, stride=stride)
    wmat = np.random.RandomState(41).randn(9 * 8, 6).astype(np.float32)
    radius = 1 if stride == 1 else None

    def leaves():
        return (torch.from_numpy(x).requires_grad_(x_grad),
                torch.from_numpy(off).requires_grad_(),
                torch.from_numpy(mask).requires_grad_(),
                torch.from_numpy(wmat).requires_grad_())

    ref = leaves()
    y_ref, over = pdc.deform_conv_plain(*ref, stride, radius)
    gy = torch.from_numpy(np.random.RandomState(42).randn(
        *y_ref.shape).astype(np.float32))
    want = torch.autograd.grad(y_ref, [t for t in ref if t.requires_grad],
                               gy)
    ins = leaves()
    counts = torch.full((3,), 7, dtype=torch.int32)
    launches = (pdc.DEFORM.launches, pdc.DEFORM_CONV.launches,
                pdc.DEFORM_BWD.launches)
    y, cert = pdc.deform_conv(*ins, stride, radius, counts[1:2])
    assert torch.equal(y, y_ref)
    if radius is None:
        assert cert is None
        assert counts.tolist() == [7, 7, 7]
    else:
        assert int(over) > 0 and cert.data_ptr() == counts[1:2].data_ptr()
        assert counts.tolist() == [7, 7 + int(over), 7]
        assert not cert.requires_grad
    y.backward(gy)
    assert counts.tolist() == [7, 7 + (0 if over is None else int(over)), 7]
    got = [t.grad for t in ins if t.requires_grad]
    assert (ins[0].grad is None) == (not x_grad)
    for g, w in zip(got, want):
        held(g.numpy(), w.numpy(), AUTOGRAD_TOL, "grad")
    assert (pdc.DEFORM.launches, pdc.DEFORM_CONV.launches,
            pdc.DEFORM_BWD.launches) == launches


@pytest.mark.parametrize("mode,dcn_mode", [("dense", "window"),
                                           ("gather", "gather")])
def test_dcn_train_step_matches_jax(mode, dcn_mode,
                                    jax_lift_at_port_rounding):
    """The small R50-DCN config of tests/test_torch_dcn.py (DCN stages
    3-4) in the two pairings that train: window DCN + dense encoder (the
    JAX side runs the Pallas window kernel in interpret mode forward and
    `_svw_bwd` backward; its lift at the port's rounding points) and gather
    DCN + gather encoder.  Offsets calibrated into (0.05, 0.95) px, as that
    file sets them, so the R = 0 window is exact: certificate 0.  Every
    leaf within the per-leaf bound, the 18 conv_offset leaves included."""
    cfg = deterministic(dcn_cfg(mode=mode, dcn_mode=dcn_mode))
    m = cfg.model
    e2i = ring_rig()
    img = np.random.RandomState(0).randn(
        1, m.num_cams, m.img_h, m.img_w, 3).astype(np.float32)
    v = jax.tree_util.tree_map(np.array, randomize_variables(
        init_jax_style_variables(cfg, seed=5), seed=6))
    for blk in v["params"]["backbone"].values():
        if "conv_offset" in blk.get("conv2", {}):
            blk["conv2"]["conv_offset"]["bias"][:18] = 0.5
    launches = pdc.DEFORM_BWD.launches
    model = train_step_against_jax(cfg, calibrated(cfg, v, img, e2i, 0.95),
                                   e2i, img)
    offsets = [n for n, p in model.named_parameters()
               if "conv_offset" in n and p.grad is not None]
    assert len(offsets) == 18
    assert pdc.DEFORM_BWD.launches == launches     # the CPU never launches


@pytest.mark.parametrize("stride,C,sms", [(1, 8, 1), (2, 8, 1),
                                          (1, 512, 1), (1, 8, 132)])
def test_backward_far_share_counts_the_scattered_samples(stride, C, sms):
    """`backward_far_share` against a loop over every sample of
    `halo_case`'s offsets (|offset| in [3, 5] px across the kernel's 4 px
    near test, 1 % at +/-30 px): on the gather route (few SMs, C <= 256)
    the samples inside the image with |floor(offset)| > 4 either way, on
    the scatter route (C = 512, or fewer than 150 output pixels an SM)
    every sample inside the image."""
    _, off, _, _ = halo_case(70 + stride, stride)
    B, ho, wo = off.shape[:3]
    h, w = ho * stride, wo * stride
    gather = C <= pdc.BWD_GATHER_MAX_C and \
        B * ho * wo >= pdc.BWD_GATHER_MIN_PIXELS * sms
    far = n = 0
    for b, oy, ox, k in np.ndindex(B, ho, wo, 9):
        fy, fx = np.floor(off[b, oy, ox, k])
        ry = oy * stride - 1 + k // 3 + fy
        rx = ox * stride - 1 + k % 3 + fx
        inside = -2 < ry < h and -2 < rx < w
        near = max(abs(fy), abs(fx)) <= pdc.BWD_NEAR_PX
        far += inside and not (gather and near)
        n += 1
    got = pdc.backward_far_share(torch.from_numpy(off), h, w, C, stride, sms)
    assert got == pytest.approx(far / n, abs=1e-7)
    assert 0.0 < got < 1.0
