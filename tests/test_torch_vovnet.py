"""The port's VoVNet trunk (`occnet_tpu_torch/models/vovnet.py`), its
reference-checkpoint converter and a VoVNet `OccNet` against the JAX
package on the CPU, on numpy inputs from a seed: all 7 presets at an odd
input size (the ceil-mode pools hang off the edge) within 1e-4 of
max|ref| in fp32, the ceil pool bitwise, the frozen stages' zero gradients,
`convert_vovnet` bitwise with and without the conv1 flip, and a tiny
exact-encoder VoVNet `OccNet`: logits within 1e-4 and one train step of
JAX's `make_train_step` (loss 1e-3 relative, gradients 5e-2 x max|g| a
leaf, frozen leaves moved by AdamW's decay alone, as optax moves them)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import config as jax_config
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.models.vovnet import VoVNet as JaxVoVNet
from occnet_tpu.models.vovnet import _ceil_maxpool
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu.training.train import make_train_step as jax_train_step
from occnet_tpu.utils import torch_convert as jax_convert
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.vovnet import (VOVNET_SPECS, VoVNet,
                                            ceil_maxpool)
from occnet_tpu_torch.tools.train import ring_rig
from occnet_tpu_torch.training.train import (create_train_state, lr_mult,
                                             make_train_step)
from occnet_tpu_torch.utils import torch_convert

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_vovnet import _fabricate_vovnet_sd  # noqa: E402

HW = (37, 45)      # odd: every stage's pool has a window off the edge


def random_variables(spec, frozen_stages=-1, seed=0):
    """(JAX VoVNet, a random flax tree of its structure): he-scaled
    kernels, biases N(0, 0.1^2), BN scales and variances U(0.5, 1.5), means
    N(0, 0.1^2)."""
    model = JaxVoVNet(spec=spec, out_indices=(1, 2, 3),
                      frozen_stages=frozen_stages)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(tree, collection):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if hasattr(v, "items"):
                out[k] = fill(v, collection)
            elif collection == "batch_stats":
                out[k] = (rng.normal(0, 0.1, v.shape) if k == "mean"
                          else rng.uniform(0.5, 1.5, v.shape))
            elif k == "kernel":
                out[k] = rng.randn(*v.shape) * np.sqrt(
                    2.0 / np.prod(v.shape[:-1]))
            elif k == "bias":
                out[k] = rng.normal(0, 0.1, v.shape)
            else:
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            if not hasattr(v, "items"):
                out[k] = np.asarray(out[k], np.float32)
        return out

    return model, {c: fill(shapes[c], c) for c in shapes}


def port_vovnet(spec, variables, frozen_stages=-1):
    net = VoVNet(spec, (1, 2, 3), frozen_stages)
    net.load_state_dict(from_jax_variables(variables))
    return net


@pytest.mark.parametrize("spec", sorted(VOVNET_SPECS))
def test_vovnet_spec_matches_jax(spec):
    """Each preset's three outputs within 1e-4 of max|ref|, fp32, at an odd
    input size."""
    model, v = random_variables(spec)
    x = np.random.RandomState(1).randn(2, *HW, 3).astype(np.float32)
    want = jax.jit(model.apply)(v, jnp.asarray(x))
    got, cert = port_vovnet(spec, v)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert cert is None and len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_ceil_maxpool_matches_jax_bitwise():
    rng = np.random.RandomState(1)
    for h, w in ((57, 55), (13, 13), (14, 20), (9, 4), (3, 3)):
        x = rng.randn(2, h, w, 5).astype(np.float32)
        want = np.asarray(_ceil_maxpool(jnp.asarray(x)))
        got = ceil_maxpool(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_frozen_stage_gradients_match_jax():
    """frozen_stages=1: the stem and stage 2 get no gradient (None in the
    port, zeros in JAX), every other leaf JAX's within 1e-4 of max|g|."""
    spec = "V-19-slim-eSE"
    model, v = random_variables(spec, frozen_stages=1, seed=2)
    x = np.random.RandomState(3).randn(1, *HW, 3).astype(np.float32)

    def loss(params):
        outs = model.apply({"params": params,
                            "batch_stats": v["batch_stats"]},
                           jnp.asarray(x))
        return sum(jnp.sum(o * o) for o in outs)

    jg = from_jax_variables({"params": jax.jit(jax.grad(loss))(
        v["params"])})
    net = port_vovnet(spec, v, frozen_stages=1)
    outs, _ = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((o * o).sum() for o in outs).backward()
    frozen = 0
    for n, p in net.named_parameters():
        ref = jg[n]
        if n.startswith(("stem", "stage2_")):
            frozen += 1
            assert p.grad is None and not ref.any(), n
            continue
        assert p.grad is not None and ref.any(), n
        np.testing.assert_allclose(p.grad.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * ref.abs().max().item(),
                                   err_msg=n)
    assert frozen > 0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("spec,flip", [("V-19-slim-eSE", False),
                                       ("V-19-slim-dw-eSE", False),
                                       ("V-19-dw-eSE", True),
                                       ("V-39-eSE", True)])
def test_convert_vovnet_matches_jax(spec, flip):
    """A reference-layout state dict fabricated as tests/test_vovnet.py
    does: the port's (params, batch_stats) equal JAX's leaf for leaf, and
    the port's state_dict after `load_vovnet_into_state_dict` equals JAX's
    `load_vovnet_into_variables` through the weight bridge."""
    _, v = random_variables(spec, seed=4)
    rng = np.random.RandomState(5)
    rand = {c: {k: x for k, x in jax.tree_util.tree_map(
        lambda a: rng.randn(*np.shape(a)).astype(np.float32), v[c]).items()}
        for c in v}
    sd = _fabricate_vovnet_sd(rand["params"], rand["batch_stats"], spec)
    sd = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}
    for ours, theirs in zip(
            torch_convert.convert_vovnet(sd, spec, flip),
            jax_convert.convert_vovnet(sd, spec, flip)):
        a, b = dict(_flat(ours)), dict(_flat(theirs))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    base = {"params": {"backbone": v["params"]},
            "batch_stats": {"backbone": v["batch_stats"]}}
    want = from_jax_variables(jax_convert.load_vovnet_into_variables(
        base, sd, spec=spec, flip_input_channels=flip))
    got = torch_convert.load_vovnet_into_state_dict(
        from_jax_variables(base), sd, spec, flip)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    conv1 = got["backbone.stem0.conv.weight"]
    src = sd["stem.stem_1/conv.weight"]
    assert torch.equal(conv1, src.flip(1) if flip else src)


# ---------------------------------------------------------------------------
# a tiny VoVNet OccNet (exact encoder, fp32)

TINY = {"model.img_h": "64", "model.img_w": "96", "model.bev_h": "6",
        "model.bev_w": "6", "model.pillar_h": "2", "model.embed_dims": "16",
        "model.out_dim": "4", "model.num_cams": "2",
        "model.compute_dtype": "float32", "model.encoder.num_layers": "1",
        "model.encoder.ffn_dim": "32",
        "model.encoder.num_points_in_pillar": "2",
        "model.backbone.type": "vovnet",
        "model.backbone.vovnet_spec": "V-19-slim-eSE",
        "data.occ_size": "(6,6,2)",
        # nothing random in a step, nothing clipped (JAX's first Adam
        # moment is then 0.1 x grad)
        "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
        "model.encoder.tsa.dropout": "0", "model.encoder.sca.dropout": "0",
        "optim.grad_clip_norm": "1e9"}


def tiny_cfgs():
    return (config.apply_overrides(config.tiny_occ(), TINY),
            jax_config.apply_overrides(jax_config.tiny_occ(), TINY))


def rig(m, b):
    """The 2-camera ring turned by 0.3 rad off the field-of-view edges
    (tests/test_torch_temporal.py)."""
    c, s = np.cos(0.3), np.sin(0.3)
    rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return (ring_rig(m, b) @ rz).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = tiny_cfgs()
    v = randomize_variables(init_jax_style_variables(cfg, seed=3), seed=4)
    m = cfg.model
    rng = np.random.RandomState(6)
    batch = {"img": rng.randn(1, m.num_cams, m.img_h, m.img_w, 3).astype(
                 np.float32),
             "ego2img": rig(m, 1),
             "voxel_semantics": rng.randint(
                 0, 17, (1, m.bev_w, m.bev_h, m.pillar_h)).astype(np.int32),
             "voxel_flow": rng.randn(1, m.bev_w, m.bev_h, m.pillar_h,
                                     2).astype(np.float32)}
    return cfg, jcfg, v, batch


def test_vovnet_occnet_logits_match_jax(tiny):
    """The port's init tree is the JAX model's (it applies it); logits,
    flow and the certificate within 1e-4 of max|ref|."""
    cfg, jcfg, v, batch = tiny
    jm = JaxOccNet(jcfg.model)
    want = jax.jit(lambda v, i, e: jm.apply(v, i, e, mutable=[
        "intermediates"])[0])(v, jnp.asarray(batch["img"]),
                              jnp.asarray(batch["ego2img"]))
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batch["img"]),
                           torch.from_numpy(batch["ego2img"]))
    assert isinstance(model.backbone, VoVNet)
    for k in ("occ", "flow", "bev_embed"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert int(got["sca_topk_overflow"]) == 0


def test_vovnet_train_step_matches_jax(tiny):
    """One whole step of JAX's `make_train_step` vs the port's (the
    tolerances of tests/test_torch_train.py): frozen_stages=1 freezes the
    stem and stage 2 by stop_gradient / no_grad; JAX's multiplier leaves
    them in the optimizer, so their gradients are zero on both sides and
    AdamW's decay moves them the same (1e-6)."""
    cfg, jcfg, v, batch = tiny
    assert cfg.model.backbone.frozen_stages == 1
    jm = JaxOccNet(jcfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, v["batch_stats"]),
                       opt_state=jax_optimizer(jcfg, params).init(params))
    js2, jmet = jax.jit(jax_train_step(jcfg, jm))(
        js, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / np.float32(0.1), js2.opt_state[1].mu)})
    jparams = from_jax_variables({"params": js2.params})

    init = from_jax_variables(v)
    state = create_train_state(cfg, init, "cpu")
    met = make_train_step(cfg)(state, {k: torch.from_numpy(x)
                                       for k, x in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert int(jmet["cert_overflow"]) == int(met["cert_overflow"]) == 0
    frozen = 0
    for n, p in state.model.named_parameters():
        ref = jgrads[n]
        assert lr_mult(n, cfg) != 0.0, n          # no VoVNet leaf is cut
        if n.startswith(("backbone.stem", "backbone.stage2_")):
            frozen += 1
            assert not ref.any() and not p.grad.any(), n
            assert not torch.equal(p.detach(), init[n]) \
                or not init[n].any(), n
            np.testing.assert_allclose(p.detach().numpy(),
                                       jparams[n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=n)
            continue
        scale = max(ref.abs().max().item(), 1e-12)
        err = (p.grad - ref).abs().max().item()
        assert err <= 5e-2 * scale, (n, err, scale)
    assert frozen > 0


def test_train_cli_refuses_a_vovnet_backbone_checkpoint(tmp_path):
    """As the JAX CLI, `--backbone-checkpoint` takes a torchvision ResNet:
    on a VoVNet config it exits naming the library converter."""
    from occnet_tpu_torch.tools import train as train_cli
    argv = ["--config", "tiny_occ", "--synthetic-data", "--max-steps", "1",
            "--device", "cpu", "--work-dir", str(tmp_path / "run"),
            "--backbone-checkpoint", str(tmp_path / "vovnet.pth"), "--set"]
    argv += [f"{k}={v}" for k, v in TINY.items()]
    with pytest.raises(SystemExit, match="load_vovnet_into_state_dict"):
        train_cli.main(argv)
