"""The whole serving slice of the port against `occnet_tpu.models.detector.
OccNet` on the CPU: a small dense (turbo) config in fp32, every parameter
random-filled (attention weights and BN statistics included), weights moved
across by `convert.from_jax_variables`.  Logits are held to the
cross-implementation bound of tests/test_dense_model.py (the lift rounds
features to bf16 on both sides, at different points)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.config import DataConfig, tiny_turbo_occ
from occnet_tpu.data.pipeline import make_device_normalizer as jax_normalizer
from occnet_tpu.models.dense_attention import (
    DenseTemporalSelfAttention as JaxTSA,
)
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu_torch.convert import (
    from_jax_variables,
    init_jax_style_variables,
    randomize_variables,
)
from occnet_tpu_torch.data.pipeline import make_device_normalizer
from occnet_tpu_torch.models.dense_attention import DenseTemporalSelfAttention
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.serve import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg():
    cfg = tiny_turbo_occ()
    model = dataclasses.replace(
        cfg.model, img_h=64, img_w=96, bev_h=10, bev_w=10, pillar_h=4,
        embed_dims=32, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(cfg.model.encoder, num_layers=2,
                                    ffn_dim=64, num_points_in_pillar=4))
    return dataclasses.replace(cfg, model=model)


def ring_rig(n_cam=6):
    ego2img = np.zeros((1, n_cam, 4, 4), np.float32)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    K = np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]])
    for ci in range(n_cam):
        a = 2 * np.pi * ci / n_cam
        Rz = np.array([[np.cos(a), -np.sin(a), 0],
                       [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = K @ np.linalg.inv(Rz @ base)
        ego2img[0, ci] = m
    return ego2img


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    jm = JaxOccNet(cfg.model)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 6, 64, 96, 3).astype(np.float32)
    ego2img = ring_rig()
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
                jnp.asarray(ego2img))
    v = randomize_variables(v, seed=1)
    ref = jm.apply(v, jnp.asarray(img), jnp.asarray(ego2img))
    return cfg, v, img, ego2img, ref


def test_model_logits_match_jax(setup):
    cfg, v, img, ego2img, ref = setup
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        outs = model.eval()(torch.from_numpy(img), torch.from_numpy(ego2img))
    occ_r, flow_r = np.asarray(ref["occ"]), np.asarray(ref["flow"])
    assert outs["occ"].shape == occ_r.shape == (1, 10, 10, 4, 17)
    assert outs["flow"].shape == flow_r.shape
    assert np.abs(occ_r).max() > 0.1            # not a degenerate output
    np.testing.assert_allclose(outs["occ"].numpy(), occ_r, rtol=0, atol=5e-2)
    np.testing.assert_allclose(outs["flow"].numpy(), flow_r, rtol=0,
                               atol=5e-2)
    np.testing.assert_allclose(outs["bev_embed"].numpy(),
                               np.asarray(ref["bev_embed"]), rtol=0,
                               atol=5e-2)
    agree = (outs["occ"].numpy().argmax(-1) == occ_r.argmax(-1)).mean()
    assert agree >= 0.99, agree


def test_temporal_self_attention_with_prev_bev(setup):
    """The TSA module on an explicit (prev, current) queue, random weights."""
    cfg = small_cfg().model
    rng = np.random.RandomState(2)
    q = rng.randn(1, 100, 32).astype(np.float32)
    prev = rng.randn(1, 2, 100, 32).astype(np.float32)
    pos = rng.randn(1, 100, 32).astype(np.float32)
    jt = JaxTSA(cfg.encoder.tsa, embed_dims=32, bev_hw=(10, 10))
    v = randomize_variables(jt.init(jax.random.PRNGKey(0), jnp.asarray(q),
                                    jnp.asarray(prev), jnp.asarray(pos)), 3)
    ref = jt.apply(v, jnp.asarray(q), jnp.asarray(prev), jnp.asarray(pos))
    mod = DenseTemporalSelfAttention(cfg.encoder.tsa, 32, (10, 10))
    mod.load_state_dict(from_jax_variables(v))
    got = mod(torch.from_numpy(q), torch.from_numpy(prev),
              torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_init_jax_style_variables_matches_flax_tree(setup):
    cfg, v, *_ = setup
    ours = init_jax_style_variables(cfg, seed=0)

    def shapes(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                np.shape(x)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert shapes(ours) == shapes(v)
    # and the tree loads into the port without missing or extra keys
    OccNet(cfg.model).load_state_dict(from_jax_variables(ours))


def test_normalizer_bitwise_equal_to_jax():
    cfg = DataConfig()
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (1, 2, 45, 70, 3)).astype(np.uint8)
    ref = np.asarray(jax_normalizer(cfg)(jnp.asarray(imgs)))
    got = make_device_normalizer(cfg)(torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape == (1, 2, 64, 96, 3)
    np.testing.assert_array_equal(got, ref)


def test_predictor_serves_small_config(setup):
    cfg, v, *_ = setup
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, img_h=64, img_w=96))
    pred = Predictor(cfg, from_jax_variables(v), "cpu")
    imgs = np.random.RandomState(4).randint(0, 256, (1, 6, 60, 90, 3),
                                            dtype=np.uint8)
    occ, flow, logits = pred(imgs, ring_rig(), with_logits=True)
    assert occ.shape == (1, 10, 10, 4) and occ.dtype == torch.int64
    assert flow.shape == (1, 10, 10, 4, 2)
    assert torch.equal(occ, logits.argmax(-1))
    assert torch.isfinite(logits).all()


def test_port_imports_no_jax():
    """Importing the port, running a tiny forward in each encoder mode
    (dense and gather), a tiny R101-DCN window-mode forward and one CPU
    train step through `occnet_tpu_torch.training` needs neither jax nor
    the JAX package: with `import jax`/`flax`/`occnet_tpu` made to fail,
    all still run (the config comes from `occnet_tpu_torch.config`), and
    no jax or `occnet_tpu` module is loaded afterwards."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'jaxlib', 'occnet_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import dataclasses, numpy as np, torch\n"
        "from occnet_tpu_torch.config import tiny_turbo_occ, \\\n"
        "    turbo_r101_dcn_occ\n"
        "import occnet_tpu_torch.serve as s, occnet_tpu_torch.convert as c\n"
        "cfg = tiny_turbo_occ()\n"
        "m = dataclasses.replace(cfg.model, img_h=32, img_w=32, bev_h=4,\n"
        "    bev_w=4, pillar_h=2, embed_dims=16, out_dim=4, num_cams=2,\n"
        "    compute_dtype='float32', encoder=dataclasses.replace(\n"
        "    cfg.model.encoder, num_layers=1, ffn_dim=16,\n"
        "    num_points_in_pillar=2))\n"
        "cfg = dataclasses.replace(cfg, model=m)\n"
        "p = s.Predictor(cfg, c.from_jax_variables(\n"
        "    c.init_jax_style_variables(cfg, 0)), 'cpu')\n"
        "e = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))\n"
        "occ, flow = p(np.zeros((1, 2, 32, 32, 3), np.uint8), e)\n"
        "assert occ.shape == (1, 4, 4, 2)\n"
        "g = dataclasses.replace(cfg, model=dataclasses.replace(m,\n"
        "    encoder=dataclasses.replace(m.encoder, mode='gather')))\n"
        "p = s.Predictor(g, c.from_jax_variables(\n"
        "    c.init_jax_style_variables(g, 0)), 'cpu')\n"
        "occ, flow = p(np.zeros((1, 2, 32, 32, 3), np.uint8), e)\n"
        "assert occ.shape == (1, 4, 4, 2)\n"
        "r = turbo_r101_dcn_occ()\n"
        "r = dataclasses.replace(r, model=dataclasses.replace(m,\n"
        "    backbone=r.model.backbone))\n"
        "p = s.Predictor(r, c.from_jax_variables(\n"
        "    c.init_jax_style_variables(r, 0)), 'cpu')\n"
        "occ, flow = p(np.zeros((1, 2, 32, 32, 3), np.uint8), e)\n"
        "assert occ.shape == (1, 4, 4, 2) and p.dcn_window_overflow == 0\n"
        "from occnet_tpu_torch.training import create_train_state, \\\n"
        "    make_train_step\n"
        "st = create_train_state(cfg, c.from_jax_variables(\n"
        "    c.init_jax_style_variables(cfg, 0)), 'cpu')\n"
        "rng = np.random.RandomState(0)\n"
        "batch = {'img': torch.from_numpy(rng.randint(0, 256,\n"
        "    (1, 2, 30, 32, 3), dtype=np.uint8)),\n"
        "    'ego2img': torch.from_numpy(e),\n"
        "    'voxel_semantics': torch.from_numpy(rng.randint(0, 17,\n"
        "    (1, 4, 4, 2))), 'voxel_flow': torch.zeros(1, 4, 4, 2, 2)}\n"
        "met = make_train_step(cfg)(st, batch)\n"
        "assert st.step == 1 and np.isfinite(float(met['loss']))\n"
        "bad = [k for k, m in sys.modules.items() if m is not None and "
        "k.split('.')[0] in ('jax', 'flax', 'jaxlib', 'occnet_tpu')]\n"
        "assert not bad, bad\n"
        "print('NOJAX OK')\n")
    env = {k: val for k, val in os.environ.items()
           if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NOJAX OK" in r.stdout, r.stderr[-2000:]


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["tiny_turbo_occ", "tiny_occ"])
def test_init_distributions_match_flax_init(name):
    """`init_jax_style_variables` draws every leaf from the distribution
    flax's `OccNet.init` draws it from: per leaf and seed (0, 1, 2), mean,
    std, min and max agree.  For n iid draws of std s (the larger of the
    two leaves' stds): |mean diff| <= 6 s sqrt(2/n) (six standard errors of
    a difference of means), |std diff| <= 6 s / sqrt(n) (the sample std's
    standard error is <= s / sqrt(2n) for the normal, truncated normal and
    uniform laws used), and |min diff|, |max diff| <= 6 s / sqrt(2 ln n)
    (the extremes of n normal draws spread as 1 / sqrt(2 ln n); bounded laws
    spread less).  Constant leaves (zeros, ones, the radial offset grid)
    have s = 0 and must agree exactly.  Leaf shapes are independent of the
    image size, so the flax init runs on 64 x 96 images, compiled at XLA's
    lowest optimisation level (the draws are integer threefry arithmetic,
    the same at any level; the compile is most of the test's time)."""
    from occnet_tpu import config as jax_config
    cfg = getattr(jax_config, name)()
    m = dataclasses.replace(cfg.model, img_h=64, img_w=96)
    jm = JaxOccNet(m)
    img = jnp.zeros((1, m.num_cams, 64, 96, 3), jnp.float32)
    e2i = jnp.asarray(np.tile(np.eye(4, dtype=np.float32),
                              (1, m.num_cams, 1, 1)))
    init = jax.jit(lambda key: jm.init({"params": key}, img, e2i)).lower(
        jax.random.PRNGKey(0)).compile({"xla_backend_optimization_level": 0})
    for seed in range(3):
        ref = _leaves(init(jax.random.PRNGKey(seed)))
        ours = _leaves(init_jax_style_variables(cfg, seed=seed))
        assert ours.keys() == ref.keys()
        for path, a in ours.items():
            b = ref[path].astype(np.float64)
            a = a.astype(np.float64)
            assert a.shape == b.shape, path
            n = a.size
            s = max(a.std(), b.std())
            tol = {"mean": 6 * s * np.sqrt(2 / n), "std": 6 * s / np.sqrt(n),
                   "min": 6 * s / np.sqrt(2 * np.log(max(n, 2))),
                   "max": 6 * s / np.sqrt(2 * np.log(max(n, 2)))}
            for stat, t in tol.items():
                x, y = getattr(a, stat)(), getattr(b, stat)()
                assert abs(x - y) <= t, (name, seed, path, stat, x, y, t)
