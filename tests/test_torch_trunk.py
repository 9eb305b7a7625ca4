"""The port's image trunk and small layers against the JAX package in fp32 on
the CPU, on the same random weights (JAX init, then every zero/identity leaf
random-filled) moved across by `convert.from_jax_variables`."""

import numpy as np
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from occnet_tpu.models.encoder import FFN as JaxFFN
from occnet_tpu.models.fpn import FPN as JaxFPN
from occnet_tpu.models.norm import LayerNorm32 as JaxLN
from occnet_tpu.models.positional import LearnedPositionalEncoding2D as JaxPE
from occnet_tpu.models.resnet import ResNet as JaxResNet
from occnet_tpu_torch.convert import from_jax_variables, randomize_variables
from occnet_tpu_torch.models.encoder import FFN
from occnet_tpu_torch.models.fpn import FPN
from occnet_tpu_torch.models.norm import LayerNorm32
from occnet_tpu_torch.models.positional import LearnedPositionalEncoding2D
from occnet_tpu_torch.models.resnet import ResNet, stage_channels


def _load(module: nn.Module, variables, prefix=""):
    sd = from_jax_variables(variables)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module.eval()


def test_resnet50_fpn_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(1, 64, 96, 3).astype(np.float32)
    jr, jf = JaxResNet(depth=50), JaxFPN(out_channels=32)
    vr = jr.init(jax.random.PRNGKey(0), jnp.asarray(img))
    feats_j = jr.apply(vr, jnp.asarray(img))
    vf = jf.init(jax.random.PRNGKey(1), feats_j)
    v = randomize_variables(
        {"params": {"backbone": vr["params"], "neck": vf["params"]},
         "batch_stats": {"backbone": vr["batch_stats"]}}, seed=1)
    ref = jf.apply({"params": v["params"]["neck"]}, jr.apply(
        {"params": v["params"]["backbone"],
         "batch_stats": v["batch_stats"]["backbone"]}, jnp.asarray(img)))

    trunk = nn.Module()
    trunk.backbone = ResNet(50)
    trunk.neck = FPN(stage_channels((1, 2, 3)), 32)
    _load(trunk, v)
    with torch.inference_mode():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)
        outs = trunk.neck(trunk.backbone(x))
    assert [tuple(o.shape[2:]) for o in outs] == [(8, 12), (4, 6), (2, 3),
                                                 (1, 2)]
    for o, r in zip(outs, ref):
        o = o.permute(0, 2, 3, 1).numpy()
        r = np.asarray(r)
        rel = np.abs(o - r).max() / np.abs(r).max()
        assert rel <= 1e-4, rel


def test_layernorm_ffn_positional_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 32).astype(np.float32) * 3 + 1

    ln = JaxLN()
    v = randomize_variables(ln.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                            seed=3)
    got = _load(LayerNorm32(32), v)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(ln.apply(v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)

    ffn = JaxFFN(32, 64, 0.1)
    v = randomize_variables(ffn.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                            seed=4)
    got = _load(FFN(32, 64), v)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(ffn.apply(v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)

    pe = JaxPE(num_feats=16, row_num_embed=5, col_num_embed=7)
    v = pe.init(jax.random.PRNGKey(2), 2)
    got = _load(LearnedPositionalEncoding2D(16, 5, 7), v)(2)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(pe.apply(v, 2)),
                               rtol=1e-5, atol=1e-5)
