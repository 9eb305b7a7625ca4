"""Exact-mode training of the port against the JAX package on the CPU:
the plain backward of the deformable-attention sampling
(`ops/msda.msda_backward_plain`) against autograd of the plain forward and
against the JAX VJPs it stands in for (the chunked XLA form and the Pallas
form's `_bwd`), the autograd Function that runs it, and one whole train
step of the small gather config against JAX's `make_train_step`.  Inputs
are numpy-seeded and handed to both packages.  The CUDA backward kernel
(`csrc/msda_bwd.cu`) runs only on the card (`chip_smoke.py`); the DCN half
of training is in tests/test_torch_train_dcn.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occnet_tpu.ops.msda_pallas as jmp
from occnet_tpu.config import apply_overrides
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.ops.msda import multi_scale_deformable_attention as jax_msda
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu.training.train import make_train_step as jax_train_step
from occnet_tpu_torch import geometry
from occnet_tpu_torch.convert import (
    from_jax_variables,
    init_jax_style_variables,
    randomize_variables,
)
from occnet_tpu_torch.ops import msda as pmsda
from occnet_tpu_torch.training.train import (
    create_train_state,
    lr_mult,
    make_train_step,
)
from tests.test_torch_gather import ring_rig as gather_rig
from tests.test_torch_gather import small_cfg as gather_cfg
from _torch_threads import one_torch_thread  # noqa: E402,F401

# the plain backward against autograd of the same plain forward: the same
# fp32 operations summed in other orders
AUTOGRAD_TOL = 1e-5
# against the JAX VJPs: fp32, other summation orders (and for DCN the JAX
# position's round trip through a normalised coordinate)
JAX_TOL = 1e-4
# whole train steps: the bounds of tests/test_torch_train.py, per leaf
LOSS_RTOL, GRAD_RTOL = 1e-3, 5e-2
# ... and its relative L2 bound for trunk leaves whose gradients fp32 does
# not determine: in the small gather config JAX's and the port's trunk
# gradients differ by up to 5.3 % of max|g| (layer3_1.bn3.bias) but at most
# 0.7 % in L2, while the FPN and every leaf after it agree to 1e-5 (this
# test held per leaf)
TRUNK_L2_RTOL = 0.1


def held(got, want, tol, name):
    """max|got - want| <= tol x max|want|, on numpy-able tensors."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


def msda_case(seed, B=2, H=4, D=8, Q=37, P=6,
              shapes=((9, 13), (5, 7), (3, 4)), span=(-0.2, 1.2),
              pinned=1 / 3):
    """value, loc, attn and an output gradient.  Locations in ``span``
    ([-0.2, 1.2]); a share ``pinned`` (a third) of them pinned to the
    border band of their level (x or y within 0.3 cells of -1, -0.5, n - 1
    or n - 0.5), where some corners are outside and the dloc of the others
    is taken over the valid ones."""
    rng = np.random.RandomState(seed)
    L, V = len(shapes), sum(h * w for h, w in shapes)
    value = rng.randn(B, V, H, D).astype(np.float32)
    loc = rng.uniform(*span, size=(B, Q, H, L, P, 2))
    ext = np.array([[w, h] for h, w in shapes], np.float64)[:, None, :]
    edge = rng.choice([-1.0, -0.5, 0.0, 1.0], size=loc.shape)
    edge = np.where(edge > 0.5, ext - 0.5, np.where(edge > -0.1, ext - 1.0,
                                                    edge))
    pos = edge + rng.uniform(-0.3, 0.3, size=loc.shape)
    pin = rng.rand(*loc.shape) < pinned
    loc = np.where(pin, (pos + 0.5) / ext, loc).astype(np.float32)
    attn = rng.rand(B, Q, H, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    grad = rng.randn(B, Q, H * D).astype(np.float32)
    return value, shapes, loc, attn, grad


def msda_backward(value, shapes, loc, attn, grad):
    return [t.numpy() for t in pmsda.msda_backward_plain(
        torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(attn), torch.from_numpy(grad))]


# hot rows: every location inside its level, 256 queries x 8 points on a
# pyramid whose coarsest levels are 3 x 4 and 2 x 3, so that each coarse
# cell takes hundreds of corner hits per (batch, head): many additions
# into one dvalue row, and runs of a query's points on one cell (which
# the CUDA kernel merges into one addition)
HOT_ROWS = dict(seed=6, B=1, H=2, D=8, Q=256, P=8,
                shapes=((6, 8), (3, 4), (2, 3)), span=(0.0, 1.0), pinned=0.0)


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=1, B=1, H=2, D=16, Q=50, P=8),                  # SCA-like
    dict(seed=2, B=2, H=8, D=4, Q=30, P=4, shapes=((12, 10),)),   # TSA-like
    dict(seed=3, B=1, H=2, D=8, Q=20, P=2,
         shapes=((6, 8), (3, 4), (2, 2), (1, 2))),            # sub-2-cell
    HOT_ROWS,
])
def test_msda_backward_plain_matches_autograd(kw):
    value, shapes, loc, attn, grad = msda_case(**kw)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (value, loc, attn)]
    out = pmsda.msda_plain(leaves[0], shapes, leaves[1], leaves[2])
    want = torch.autograd.grad(out, leaves, torch.from_numpy(grad))
    got = msda_backward(value, shapes, loc, attn, grad)
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        held(g, w.numpy(), AUTOGRAD_TOL, name)


@pytest.mark.parametrize("impl", ["xla_chunked", "pallas"])
def test_msda_backward_plain_matches_jax_vjp(impl):
    """JAX's gradients of the exact encoder's sampling: the VJP of the XLA
    patch-table form with a query_chunk that pads (37 queries in chunks of
    16), and the VJP of the Pallas form, whose forward runs in interpret
    mode and whose backward is `msda_pallas._bwd`."""
    value, shapes, loc, attn, grad = msda_case(seed=4)
    if impl == "pallas":
        fn = jmp.multi_scale_deformable_attention_pallas
    else:
        def fn(v, s, l, a):
            return jax_msda(v, s, l, a, query_chunk=16)
    _, vjp = jax.vjp(lambda v, l, a: fn(v, shapes, l, a), jnp.asarray(value),
                     jnp.asarray(loc), jnp.asarray(attn))
    want = vjp(jnp.asarray(grad))
    got = msda_backward(value, shapes, loc, attn, grad)
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        held(g, np.asarray(w), JAX_TOL, f"{impl} {name}")


def jax_msda_vjp(impl, value, shapes, loc, attn, grad):
    """JAX's gradients of the sampling: the VJP of the XLA patch-table
    form with a query_chunk that pads, or of the Pallas form (forward in
    interpret mode, backward `msda_pallas._bwd`)."""
    if impl == "pallas":
        fn = jmp.multi_scale_deformable_attention_pallas
    else:
        def fn(v, s, l, a):
            return jax_msda(v, s, l, a, query_chunk=16)
    _, vjp = jax.vjp(lambda v, l, a: fn(v, shapes, l, a), jnp.asarray(value),
                     jnp.asarray(loc), jnp.asarray(attn))
    return vjp(jnp.asarray(grad))


@pytest.mark.parametrize("impl", ["xla_chunked", "pallas"])
def test_msda_backward_plain_hot_rows_matches_jax_vjp(impl):
    """The hot-row case (HOT_ROWS) against both JAX VJPs: hundreds of
    samples meet on every cell of the coarse levels."""
    value, shapes, loc, attn, grad = msda_case(**HOT_ROWS)
    want = jax_msda_vjp(impl, value, shapes, loc, attn, grad)
    got = msda_backward(value, shapes, loc, attn, grad)
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        held(g, np.asarray(w), JAX_TOL, f"{impl} {name}")


def test_msda_function_runs_the_plain_backward_on_the_cpu():
    """`multi_scale_deformable_attention` under autograd: the plain forward,
    and gradients that are `msda_backward_plain`'s bitwise; inputs that do
    not require grad get none, and no kernel launches."""
    value, shapes, loc, attn, grad = msda_case(seed=5)
    v = torch.from_numpy(value).requires_grad_()
    lo = torch.from_numpy(loc).requires_grad_()
    a = torch.from_numpy(attn)
    launches = pmsda.MSDA.launches, pmsda.MSDA_BWD.launches
    out = pmsda.multi_scale_deformable_attention(v, shapes, lo, a)
    assert torch.equal(out, pmsda.msda_plain(v.detach(), shapes,
                                             lo.detach(), a))
    out.backward(torch.from_numpy(grad))
    want = msda_backward(value, shapes, loc, attn, grad)
    assert np.array_equal(v.grad.numpy(), want[0])
    assert np.array_equal(lo.grad.numpy(), want[1])
    assert a.grad is None
    assert (pmsda.MSDA.launches, pmsda.MSDA_BWD.launches) == launches


def deterministic(cfg):
    """Nothing random in the step (dropout 0, grid mask off) and nothing
    clipped, so JAX's first Adam moment is 0.1 x grad."""
    return apply_overrides(cfg, {
        "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
        "model.encoder.tsa.dropout": "0", "model.encoder.sca.dropout": "0",
        "optim.grad_clip_norm": "1e9"})


def train_step_against_jax(cfg, v, e2i, img, trunk_l2=False):
    """One whole step of JAX's `make_train_step` against the port's, same
    weights and batch (float images, nothing random, no clipping): loss to
    1e-3 relative, every gradient (JAX's from its first Adam moment,
    mu = 0.1 g) within GRAD_RTOL x max|g_jax| per leaf (with ``trunk_l2``
    the trunk's leaves within TRUNK_L2_RTOL in L2), certificate 0 on both
    sides, frozen leaves without gradient.  Returns the port's model."""
    m = cfg.model
    rng = np.random.RandomState(7)
    batch = {"img": img, "ego2img": e2i,
             "voxel_semantics": rng.randint(
                 0, 17, (1, m.bev_w, m.bev_h, m.pillar_h)).astype(np.int32),
             "voxel_flow": rng.randn(1, m.bev_w, m.bev_h, m.pillar_h,
                                     2).astype(np.float32)}
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, v["batch_stats"]),
                       opt_state=jax_optimizer(cfg, params).init(params))
    js2, jmet = jax.jit(jax_train_step(cfg, JaxOccNet(m)))(
        js, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / np.float32(0.1), js2.opt_state[1].mu)})

    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    met = make_train_step(cfg)(state, {k: torch.from_numpy(x)
                                       for k, x in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    assert int(jmet["cert_overflow"]) == int(met["cert_overflow"]) == 0
    trained = 0
    for n, p in state.model.named_parameters():
        ref = jgrads[n]
        if lr_mult(n, cfg) == 0.0:
            assert p.grad is None and not ref.any(), n
            continue
        trained += 1
        if trunk_l2 and n.startswith("backbone."):
            err = (p.grad - ref).norm().item()
            assert err <= TRUNK_L2_RTOL * ref.norm().item(), (n, err)
            continue
        scale = max(ref.abs().max().item(), 1e-12)
        err = (p.grad - ref).abs().max().item()
        assert err <= GRAD_RTOL * scale, (n, err, scale)
    assert trained > 0
    return state.model


def test_gather_train_step_matches_jax():
    """The small gather config of tests/test_torch_gather.py with static
    top-K SCA, K sized by `calibration_topk` (certificate 0): gather ->
    MSDA -> scatter_add_ in the forward, MSDAFunction's backward."""
    e2i = gather_rig()
    k = geometry.calibration_topk(gather_cfg().model, e2i, multiple=8)
    cfg = deterministic(gather_cfg(max_queries_per_cam=k))
    m = cfg.model
    assert k < m.bev_h * m.bev_w                  # the top-K branch
    img = np.random.RandomState(0).randn(
        1, m.num_cams, m.img_h, m.img_w, 3).astype(np.float32)
    v = randomize_variables(init_jax_style_variables(cfg, seed=3), seed=4)
    launches = pmsda.MSDA_BWD.launches
    train_step_against_jax(cfg, v, e2i, img, trunk_l2=True)
    assert pmsda.MSDA_BWD.launches == launches     # the CPU never launches
