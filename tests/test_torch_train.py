"""The port's training pieces against the JAX package on the CPU: trainable
BatchNorm and the decoder BN3d in train mode, the grid mask and photometric
distortion on draws taken from the JAX key, `occ_flow_loss` in all its
branches, the lr schedule, the optimizer, one whole train step (loss, every
gradient, batch statistics) on a small fp32 config, loss decrease over 4
steps, and the weight bridge round trip.  Inputs are numpy-seeded and handed
to both packages."""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from occnet_tpu.config import LossConfig, apply_overrides, tiny_turbo_occ
from occnet_tpu.data.pipeline import photometric_distortion_device as jax_pd
from occnet_tpu.models import head as jax_head
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.models.resnet import TrainableBatchNorm as JaxTrainableBN
from occnet_tpu.ops.grid_mask import grid_mask as jax_grid_mask
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import _lr_mult_tree
from occnet_tpu.training.train import make_lr_schedule as jax_schedule
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu.training.train import make_train_step as jax_train_step
from occnet_tpu_torch.convert import (
    from_jax_variables,
    init_jax_style_variables,
    randomize_variables,
    to_jax_variables,
)
from occnet_tpu_torch.data.pipeline import (
    photometric_distortion_device,
    photometric_draws,
)
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.head import NUM_FLOW_CLASSES, occ_flow_loss
from occnet_tpu_torch.models.resnet import TrainableBatchNorm
from occnet_tpu_torch.models.transformer_occ import BatchNorm3d
from occnet_tpu_torch.ops.grid_mask import grid_mask_apply, grid_mask_draw
from occnet_tpu_torch.tools.train import ring_rig
from occnet_tpu_torch.training import checkpoint
from occnet_tpu_torch.training.train import (
    apply_gradients,
    create_train_state,
    lr_mult,
    make_lr_schedule,
    make_train_step,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401


def small_cfg(norm_eval=True, frozen_stages=1, deterministic=True):
    """The small dense config of tests/test_torch_model.py; with
    ``deterministic`` nothing in the step is random (dropout 0, grid mask
    off) and nothing is clipped, so JAX's first Adam moment is 0.1 x grad."""
    cfg = tiny_turbo_occ()
    m = cfg.model
    model = dataclasses.replace(
        m, img_h=64, img_w=96, bev_h=10, bev_w=10, pillar_h=4,
        embed_dims=32, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(m.encoder, num_layers=2, ffn_dim=64,
                                    num_points_in_pillar=4),
        backbone=dataclasses.replace(m.backbone, norm_eval=norm_eval,
                                     frozen_stages=frozen_stages))
    cfg = dataclasses.replace(cfg, model=model)
    if deterministic:
        cfg = apply_overrides(cfg, {
            "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
            "model.encoder.tsa.dropout": "0",
            "model.encoder.sca.dropout": "0", "optim.grad_clip_norm": "1e9"})
    return cfg


def _batch(cfg, seed=0, uint8=False):
    m = cfg.model
    rng = np.random.RandomState(seed)
    if uint8:
        img = rng.randint(0, 256, (1, m.num_cams, m.img_h, m.img_w, 3),
                          dtype=np.uint8)
    else:
        img = rng.randn(1, m.num_cams, m.img_h, m.img_w, 3).astype(
            np.float32)
    return {"img": img, "ego2img": ring_rig(m, 1),
            "voxel_semantics": rng.randint(
                0, 17, (1, m.bev_w, m.bev_h, m.pillar_h)).astype(np.int32),
            "voxel_flow": rng.randn(1, m.bev_w, m.bev_h, m.pillar_h,
                                    2).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_trainable_batchnorm_matches_flax_train_mode():
    """Output and updated running statistics after one train-mode call:
    fp32 statistics of the same activations, 1e-5."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 7, 6) * 2 + 1).astype(np.float32)     # NHWC
    jbn = JaxTrainableBN(6)
    v = randomize_variables(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            seed=1)
    ref, mut = jbn.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    bn = TrainableBatchNorm(6)
    bn.load_state_dict(from_jax_variables(v))
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_decoder_bn3d_matches_flax_train_mode():
    """flax `BatchNorm(momentum=0.9)` in train mode on NDHWC vs the port's
    BatchNorm3d on NCDHW: output and running statistics, fp32, 1e-5."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 4, 5, 6) * 3 - 1).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    v = randomize_variables(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            seed=2)
    ref, mut = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm3d(6)
    bn.load_state_dict(from_jax_variables(v))
    got = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_grid_mask_matches_jax_on_the_jax_draws(seed):
    """The apply half on the draws `grid_mask` takes from its key: the same
    mask, bitwise (seeds 0-3 cover both apply outcomes)."""
    imgs = np.random.RandomState(seed).randn(2, 37, 53, 3).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    d = int(jax.random.randint(k_d, (), 2, 37))
    draws = (bool(jax.random.uniform(k_apply) < 0.7), d,
             int(jax.random.randint(k_sh, (), 0, d)),
             int(jax.random.randint(k_sw, (), 0, d)))
    ref = np.asarray(jax_grid_mask(key, jnp.asarray(imgs), prob=0.7))
    got = grid_mask_apply(torch.from_numpy(imgs), *draws).numpy()
    np.testing.assert_array_equal(got, ref)
    # the port's own draw lies in the same ranges
    apply, d, st_h, st_w = grid_mask_draw(
        torch.Generator().manual_seed(seed), 37, 0.7)
    assert 2 <= int(d) < 37 and 0 <= int(st_h) < int(d) \
        and 0 <= int(st_w) < int(d)


def test_photometric_distortion_matches_jax_on_the_jax_draws():
    """The apply half on the per-image draws `photometric_distortion_device`
    takes from its keys (gates, brightness, contrast pre/post, saturation,
    hue, channel permutation): the same fp32 elementwise math, so equal to
    1e-3 on the [0, 255] scale (XLA may fuse a division differently)."""
    n = 12
    imgs = np.random.RandomState(4).randint(0, 256, (2, n // 2, 9, 11, 3)
                                            ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_pd(key, jnp.asarray(imgs)))
    draws = {k: [] for k in photometric_draws(None, 1, device="cpu")}
    for k in jax.random.split(key, n):
        ks = jax.random.split(k, 13)

        def uni(kk, lo, hi):
            return float(jax.random.uniform(kk, (), minval=lo, maxval=hi))

        def gate(kk):
            return bool(jax.random.bernoulli(kk, 0.5))

        for name, val in (
                ("bright_on", gate(ks[0])), ("bright", uni(ks[1], -32, 32)),
                ("mode1", gate(ks[2])), ("contrast_pre_on", gate(ks[3])),
                ("contrast_pre", uni(ks[4], 0.5, 1.5)),
                ("sat_on", gate(ks[5])), ("sat", uni(ks[6], 0.5, 1.5)),
                ("hue_on", gate(ks[7])), ("hue", uni(ks[8], -18, 18)),
                ("contrast_post_on", gate(ks[9])),
                ("contrast_post", uni(ks[10], 0.5, 1.5)),
                ("perm", np.asarray(jax.random.permutation(ks[11], 3))),
                ("swap_on", gate(ks[12]))):
            draws[name].append(val)
    draws = {k: torch.as_tensor(np.asarray(v)) for k, v in draws.items()}
    assert draws["swap_on"].any() and not draws["swap_on"].all()
    got = photometric_distortion_device(torch.from_numpy(imgs), draws)
    assert got.shape == imgs.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 5, 4, 3, 17).astype(np.float32) * 2
    flow = rng.randn(2, 5, 4, 3, 2).astype(np.float32)
    sem = rng.randint(0, 17, (2, 5, 4, 3)).astype(np.int32)
    sem[0, 0] = 7           # both sides of the flow-class bound
    sem[0, 1] = 8
    gt_flow = rng.randn(2, 5, 4, 3, 2).astype(np.float32)
    mask = (rng.rand(2, 5, 4, 3) > 0.3).astype(np.float32)
    return logits, flow, sem, gt_flow, mask


@pytest.mark.parametrize("branch", [
    dict(), dict(class_weights=tuple(np.linspace(0.1, 3.0, 17))),
    dict(flow_fg_weight=50.0), dict(use_mask=True, flow_fg_weight=5.0),
    dict(use_mask=True, class_weights=tuple(np.linspace(2.0, 0.2, 17)))])
def test_occ_flow_loss_matches_jax(branch):
    """Unweighted, class-weighted (torch reduction), flow_fg_weight and
    masked branches: the same fp32 reductions, 1e-6 relative."""
    logits, flow, sem, gt_flow, mask = _loss_inputs()
    cfg = LossConfig(**branch)
    ref = jax_head.occ_flow_loss(jnp.asarray(logits), jnp.asarray(flow),
                                 jnp.asarray(sem), jnp.asarray(gt_flow), cfg,
                                 mask_camera=jnp.asarray(mask))
    got = occ_flow_loss(torch.from_numpy(logits), torch.from_numpy(flow),
                        torch.from_numpy(sem), torch.from_numpy(gt_flow), cfg,
                        mask_camera=torch.from_numpy(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_flow_class_bound_matches_the_jax_literal():
    """The port derives the flow-class bound from FLOW_CLASS_NAMES; it must
    equal the literal the JAX loss hard-codes, and flow_fg_weight=50 (the
    synthetic benchmark's setting) must give JAX's flow loss."""
    src = inspect.getsource(jax_head.occ_flow_loss)
    literal = int(re.search(r"labels < (\d+)", src).group(1))
    assert NUM_FLOW_CLASSES == literal == 8
    logits, flow, sem, gt_flow, _ = _loss_inputs(1)
    cfg = LossConfig(flow_fg_weight=50.0)
    _, ref = jax_head.occ_flow_loss(jnp.asarray(logits), jnp.asarray(flow),
                                    jnp.asarray(sem), jnp.asarray(gt_flow),
                                    cfg)
    _, got = occ_flow_loss(torch.from_numpy(logits), torch.from_numpy(flow),
                           torch.from_numpy(sem), torch.from_numpy(gt_flow),
                           cfg)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_lr_schedule_matches_jax():
    """Warmup start, mid-warmup, warmup end, cosine, the end: JAX computes
    in fp32, the port in Python floats, so 1e-6 relative."""
    cfg = tiny_turbo_occ()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, steps_per_epoch=100))
    total = cfg.optim.total_epochs * 100
    ref, got = jax_schedule(cfg), make_lr_schedule(cfg)
    for step in (0, 250, 500, 1000, total):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


def test_optimizer_matches_optax_chain():
    """Three steps on fixed random gradients (the third above the clip
    norm) through `apply_gradients` vs the optax chain of `make_optimizer`:
    parameters to 1e-6, frozen leaves (stem, layer1_*) bitwise unchanged.
    Frozen leaves get zero gradients, as `stop_gradient` gives them in the
    JAX step (the port keeps them out of the optimizer)."""
    cfg = small_cfg(deterministic=False)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_iters=2, steps_per_epoch=5, total_epochs=1))
    v = randomize_variables(init_jax_style_variables(cfg, seed=0), seed=1)
    params = v["params"]
    tx = jax_optimizer(cfg, params)
    opt_state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    apply_updates = jax.jit(optax.apply_updates)
    live = _lr_mult_tree(params, cfg)
    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    rng = np.random.RandomState(2)
    for scale in (0.01, 0.1, 100.0):
        grads = jax.tree_util.tree_map(
            lambda p, m: (rng.randn(*p.shape) * scale * (m != 0.0)).astype(
                np.float32), params, live)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        tg = from_jax_variables({"params": grads})
        for n, p in state.model.named_parameters():
            p.grad = tg[n].clone() if lr_mult(n, cfg) else None
        norm, _ = apply_gradients(state, cfg, make_lr_schedule(cfg))
        # fp32 sums of squares over ~25M elements vs a float64 reference
        ref_norm = np.sqrt(sum(np.square(g, dtype=np.float64).sum()
                               for g in jax.tree_util.tree_leaves(grads)))
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-4)
        state.step += 1
    assert float(norm) > cfg.optim.grad_clip_norm        # clip exercised
    ref = from_jax_variables({"params": params})
    frozen = 0
    for n, p in state.model.named_parameters():
        if lr_mult(n, cfg) == 0.0:
            frozen += 1
            assert torch.equal(p.detach(), before[n]), n
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)
    assert frozen > 0


@pytest.fixture
def jax_lift_at_port_rounding(monkeypatch):
    """JAX's einsum lift rounds its hat weights and pass-1 intermediate to
    bf16 (`warp_level_multi_z`'s band_dtype) where the port's lift rounds
    only the features.  This model amplifies such a ~0.2 % change of U_bar
    into up to ~20 % of some gradients (measured: rounding the port's own
    U_bar to bf16 moves them that much), so the whole-step reference runs
    JAX's einsum lift in fp32 on bf16-rounded features: the port's rounding
    points.  The lift's own rounding is held against both JAX lift forms in
    tests/test_torch_lift.py."""
    from occnet_tpu.ops import planar_lift as jax_lift
    lift, warp = jax_lift.lift_and_average, jax_lift.warp_level_multi_z
    monkeypatch.setattr(jax_lift, "warp_level_multi_z",
                        lambda *a, **k: warp(*a, band_dtype=jnp.float32, **k))
    monkeypatch.setattr(jax_lift, "lift_and_average", lambda feats, *a, **k:
                        lift([f.astype(jnp.bfloat16).astype(f.dtype)
                              for f in feats], *a, **k))


@pytest.mark.parametrize("norm_eval,frozen_stages", [(True, 1), (False, -1)])
def test_train_step_matches_jax(norm_eval, frozen_stages,
                                jax_lift_at_port_rounding):
    """One whole step of JAX's `make_train_step` vs the port's on a small
    fp32 config, same weights and batch (float images, dropout 0, grid mask
    off, no clipping), the lift rounding at the same points on both sides:
    loss to 1e-3 relative; every gradient (JAX's from its first Adam moment,
    mu = 0.1 g) to max|diff| <= 5e-2 x max|g_jax| per leaf, the bf16 bound
    of tests/test_torch_model.py (the port returns the lift's feature
    gradient in bf16, as the JAX package does); the updated batch statistics
    to 1e-3; frozen leaves unchanged.  Run with `turbo_occ`'s
    norm_eval=True, frozen_stages=1 and with `synth_tiny_turbo_occ`'s
    norm_eval=False, frozen_stages=-1.

    With norm_eval=False the trunk normalises with batch statistics, and at
    this size fp32 does not determine its gradients to 5 % of their maximum:
    the port's own fp32 and float64 trunk gradients differ by up to 15-28 %
    of max|g| in train mode (measured; 1 % in eval mode).  Trunk leaves are
    then held to the relative L2 error ||diff|| <= 0.1 ||g_jax|| (measured
    worst 0.053), every other leaf to the max bound above."""
    cfg = small_cfg(norm_eval, frozen_stages)
    v = randomize_variables(init_jax_style_variables(cfg, seed=3), seed=4)
    batch = _batch(cfg)
    jm = JaxOccNet(cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, v["batch_stats"]),
                       opt_state=jax_optimizer(cfg, params).init(params))
    js2, jmet = jax.jit(jax_train_step(cfg, jm))(
        js, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / np.float32(0.1), js2.opt_state[1].mu)})
    jstats = from_jax_variables({"params": {},
                                 "batch_stats": js2.batch_stats})

    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    met = make_train_step(cfg)(state, _torch_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert int(jmet["cert_overflow"]) == int(met["cert_overflow"]) == 0
    n_frozen = 0
    for n, p in state.model.named_parameters():
        ref = jgrads[n]
        if lr_mult(n, cfg) == 0.0:
            n_frozen += 1
            assert p.grad is None and not ref.any(), n
            assert torch.equal(p.detach(), before[n]), n
            continue
        if not norm_eval and n.startswith("backbone."):
            err = (p.grad - ref).norm().item()
            assert err <= 0.1 * ref.norm().item(), (n, err)
            continue
        scale = max(ref.abs().max().item(), 1e-12)
        err = (p.grad - ref).abs().max().item()
        assert err <= 5e-2 * scale, (n, err, scale)
    assert n_frozen == (0 if frozen_stages < 0 else 33)
    for n, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), jstats[n].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=n)


def test_train_steps_lower_the_loss():
    """4 steps on one uint8 batch with the training defaults (photometric
    distortion, grid mask, dropout 0.1, clip 35): finite, and the loss
    goes down, as tests/test_training.py checks for the JAX step."""
    cfg = small_cfg(deterministic=False)
    v = init_jax_style_variables(cfg, seed=5)
    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    step = make_train_step(cfg, seed=1)
    batch = _torch_batch(_batch(cfg, seed=6, uint8=True))
    losses = [float(step(state, batch)["loss"]) for _ in range(4)]
    assert np.isfinite(losses).all() and state.step == 4
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("norm_eval", [True, False])
def test_to_jax_variables_round_trip(norm_eval):
    """JAX tree -> port state_dict (through a model with Frozen or
    Trainable BN) -> JAX tree is bitwise the tree it started from."""
    cfg = small_cfg(norm_eval, 1 if norm_eval else -1)
    v = randomize_variables(init_jax_style_variables(cfg, seed=6), seed=7)
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    back = to_jax_variables(model.state_dict())
    a = jax.tree_util.tree_flatten_with_path(v)[0]
    b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y)


def test_checkpoint_round_trip(tmp_path):
    """save -> restore into a fresh state gives the same step, parameters,
    BN statistics and optimizer moments, and the next step of both states
    is the same step."""
    cfg = small_cfg(norm_eval=False, frozen_stages=-1)
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=8))
    batch = _torch_batch(_batch(cfg, seed=9))
    step = make_train_step(cfg)
    state = create_train_state(cfg, sd, "cpu")
    step(state, batch)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, state, cfg)
    fresh = checkpoint.restore(path, create_train_state(cfg, sd, "cpu"))
    assert fresh.step == state.step == 1
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert float(step(fresh, batch)["loss"]) == float(step(state,
                                                           batch)["loss"])
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
