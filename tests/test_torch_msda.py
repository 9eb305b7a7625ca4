"""The port's multi-scale deformable attention (`occnet_tpu_torch/ops/msda.py`)
against the JAX package on the CPU: the plain version against the XLA
patch-table form and against the three Pallas kernels it replaces (run in
interpret mode, as tests/test_msda.py runs them), and the CUDA wrapper's
refusals.  The kernel itself (`csrc/msda.cu`) runs only on the card
(`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import occnet_tpu.ops.msda_pallas as mp
from occnet_tpu.ops.msda import multi_scale_deformable_attention as jax_msda
from occnet_tpu_torch.ops import msda as port

# fp32 against fp32: the bound of tests/test_msda.py (summation order only)
ATOL, RTOL = 2e-5, 1e-5
from _torch_threads import one_torch_thread  # noqa: E402,F401
# bf16 values: both round the fp32 sum to bf16 once (tests/test_msda.py)
BF16_TOL = 6e-3


def make_inputs(seed=0, B=2, H=4, D=8, Q=37, P=6,
                shapes=((9, 13), (5, 7), (3, 4))):
    """Locations in [-0.2, 1.2], so samples cross the zero-padded border."""
    rng = np.random.RandomState(seed)
    L = len(shapes)
    V = sum(h * w for h, w in shapes)
    value = rng.randn(B, V, H, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, H, L, P, 2)).astype(np.float32)
    w = rng.rand(B, Q, H, L, P).astype(np.float32)
    w = w / w.sum(axis=(3, 4), keepdims=True)
    return value, shapes, loc, w


def plain(value, shapes, loc, w, dtype=torch.float32):
    return port.multi_scale_deformable_attention(
        torch.from_numpy(value).to(dtype), shapes, torch.from_numpy(loc),
        torch.from_numpy(w))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(seed=1, B=3, H=2, D=16, Q=50, P=8),            # D = 16, SCA-like P
    dict(seed=2, B=2, H=8, D=4, Q=30, P=4,
         shapes=((12, 10),)),                            # one level, TSA-like
    dict(seed=3, B=1, H=2, D=8, Q=20, P=2,
         shapes=((6, 8), (3, 4), (2, 2), (1, 2))),       # a sub-2-cell level
])
def test_plain_matches_jax_xla(kw):
    value, shapes, loc, w = make_inputs(**kw)
    want = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                               jnp.asarray(w)))
    launches = port.MSDA.launches
    got = plain(value, shapes, loc, w)
    assert port.MSDA.launches == launches       # the CPU never launches
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_level_kernel():
    """#8 `_level_kernel`: every level fits the VMEM row budget."""
    value, shapes, loc, w = make_inputs(seed=5, B=1, H=2, D=8, Q=70, P=4)
    want = np.asarray(mp.multi_scale_deformable_attention_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w)))
    np.testing.assert_allclose(plain(value, shapes, loc, w).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_banded_kernel(monkeypatch):
    """#10 `_level_kernel_banded`: a row budget of 48 puts both levels over
    it, and OCCNET_MSDA_LEVEL0=banded sends them to the band kernel."""
    monkeypatch.setattr(mp, "_VMEM_ROW_BUDGET", 48)
    monkeypatch.setenv("OCCNET_MSDA_LEVEL0", "banded")
    value, shapes, loc, w = make_inputs(seed=7, B=1, H=2, D=8, Q=70, P=4,
                                        shapes=((9, 13), (8, 9)))
    want = np.asarray(mp.multi_scale_deformable_attention_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w)))
    np.testing.assert_allclose(plain(value, shapes, loc, w).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_aligned_bf16_kernel(monkeypatch):
    """#9 `_level_kernel_aligned`: bf16 values with OCCNET_MSDA_BF16_VMEM=1;
    both sides return bf16."""
    monkeypatch.setenv("OCCNET_MSDA_BF16_VMEM", "1")
    value, shapes, loc, w = make_inputs(seed=9, B=1, H=2, D=8, Q=70, P=4)
    want = mp.multi_scale_deformable_attention_pallas(
        jnp.asarray(value, jnp.bfloat16), shapes, jnp.asarray(loc),
        jnp.asarray(w))
    got = plain(value, shapes, loc, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_cuda_wrapper_refuses_cpu_and_grad_inputs():
    value, shapes, loc, w = make_inputs(B=1, Q=5)
    v, l, a = (torch.from_numpy(x) for x in (value, loc, w))
    launches = port.MSDA.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.msda_cuda(v, shapes, l, a)
    with pytest.raises(ValueError, match="value length"):
        port.msda_cuda(v[:, 1:], shapes, l, a)
    assert port.MSDA.launches == launches
    g = torch.zeros(1, 5, v.shape[2] * v.shape[3])
    launches = port.MSDA_BWD.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.msda_backward_cuda(v, shapes, l, a, g)
    with pytest.raises(ValueError, match="value length"):
        port.msda_backward_cuda(v[:, 1:], shapes, l, a, g)
    assert port.MSDA_BWD.launches == launches
