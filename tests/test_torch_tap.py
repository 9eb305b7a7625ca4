"""The port's plain TSA tap attention (occnet_tpu_torch.ops.tsa) against the
JAX shift loop (fp32, 1e-5) and the Pallas kernel in interpret mode (which
rounds v/attn to bf16: the 2e-2 bound of tests/test_tsa_pallas.py), forward
and backward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.ops.tsa_pallas import (
    TSA_TAPS as JAX_TAPS,
    _shift2d as jax_shift2d,
    tap_attention_pallas,
    tap_attention_xla,
)
from occnet_tpu_torch.ops.tsa import (
    TSA_TAPS,
    _shift2d,
    tap_attention,
    tap_attention_plain,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _case(B=1, nq=2, H=16, W=16, heads=4, D=8, seed=0):
    rng = np.random.RandomState(seed)
    vgrid = rng.randn(B, nq, H, W, heads * D).astype(np.float32)
    logits = rng.randn(B, H, W, nq, len(TSA_TAPS), heads)
    attn = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32),
                                   axis=4))
    return vgrid, attn


def test_taps_and_shift_match_jax():
    assert TSA_TAPS == JAX_TAPS
    x = np.arange(2 * 5 * 7 * 3, dtype=np.float32).reshape(2, 5, 7, 3)
    for dy, dx in TSA_TAPS:
        np.testing.assert_array_equal(
            _shift2d(torch.from_numpy(x), dy, dx).numpy(),
            np.asarray(jax_shift2d(jnp.asarray(x), dy, dx)))


@pytest.mark.parametrize("shape", [
    dict(), dict(B=2, H=8, W=8), dict(H=6, W=10, heads=2, D=4)])
def test_plain_tap_matches_xla_fp32(shape):
    vgrid, attn = _case(**shape)
    ref = np.asarray(tap_attention_xla(jnp.asarray(vgrid), jnp.asarray(attn)))
    got = tap_attention(torch.from_numpy(vgrid), torch.from_numpy(attn))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_tap_matches_pallas_interpret():
    vgrid, attn = _case(H=8, W=12, seed=3)
    ref = np.asarray(tap_attention_pallas(jnp.asarray(vgrid),
                                          jnp.asarray(attn)))
    got = tap_attention_plain(torch.from_numpy(vgrid), torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", [dict(B=2, H=9, W=13),
                                   dict(B=2, H=11, W=7, heads=8, D=8)])
def test_plain_tap_matches_xla_and_pallas_odd_grid(shape):
    """H and W that are not multiples of the CUDA kernel's 8 x 8 tile, at
    B = 2, so that every tile edge and the halo on all four borders is
    exercised: the plain version against the XLA shift loop (fp32, 1e-5)
    and the Pallas kernel in interpret mode (bf16 inputs, 2e-2)."""
    vgrid, attn = _case(seed=7, **shape)
    got = tap_attention_plain(torch.from_numpy(vgrid),
                              torch.from_numpy(attn)).numpy()
    ref = np.asarray(tap_attention_xla(jnp.asarray(vgrid), jnp.asarray(attn)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref = np.asarray(tap_attention_pallas(jnp.asarray(vgrid),
                                          jnp.asarray(attn)))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    # each sample alone gives its rows of the batch, bitwise
    for b in range(vgrid.shape[0]):
        one = tap_attention_plain(torch.from_numpy(vgrid[b:b + 1]),
                                  torch.from_numpy(attn[b:b + 1])).numpy()
        np.testing.assert_array_equal(one[0], got[b])


def test_plain_tap_bf16_inputs():
    """bf16 inputs (the serving dtype) give the fp32-accumulated result of
    the bf16-rounded values, as the JAX shift loop does."""
    vgrid, attn = _case(seed=4)
    v16 = jnp.asarray(vgrid, jnp.bfloat16)
    a16 = jnp.asarray(attn, jnp.bfloat16)
    ref = np.asarray(tap_attention_xla(v16, a16))
    got = tap_attention(torch.from_numpy(vgrid).bfloat16(),
                        torch.from_numpy(attn).bfloat16())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run on CPU tensors (no silent fallback, no
    host pointers handed to a kernel): they raise before any build."""
    from occnet_tpu_torch.ops.lift_cuda import lift_level_cuda
    from occnet_tpu_torch.ops.tsa import tap_attention_cuda
    vgrid, attn = _case(H=4, W=4)
    with pytest.raises(ValueError, match="CUDA"):
        tap_attention_cuda(torch.from_numpy(vgrid), torch.from_numpy(attn))
    feat = torch.zeros(1, 2, 4, 6, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        lift_level_cuda(feat, torch.zeros(1, 2, 6, 10), torch.zeros(1, 2, 6, 3),
                        torch.zeros(1, 2, 6, dtype=torch.bool),
                        torch.ones(1, 6), torch.empty(1, 6, 3, 8))


def _port_vjp(vgrid, attn, g, dtype):
    """(dv, dattn) of the port's differentiable `tap_attention` (its
    autograd Function and plain backward) for the cotangent g."""
    v = torch.from_numpy(vgrid).to(dtype).requires_grad_()
    a = torch.from_numpy(attn).to(dtype).requires_grad_()
    tap_attention(v, a).backward(torch.from_numpy(g))
    assert v.grad.dtype == a.grad.dtype == dtype
    return v.grad.float().numpy(), a.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [dict(B=2, H=8, W=10),
                                   dict(H=6, W=7, heads=2, D=4)])
def test_tap_backward_matches_jax_vjp(dtype, shape):
    """dv / dattn against `jax.vjp` of the Pallas tap attention (its closed-
    form backward `_tap_attention_bwd`, the function the CUDA backward
    replaces) and of the XLA shift loop (autodiff).  fp32: same sums, 1e-5.
    bf16: both round dv / dattn to bf16 once (the closed form) or at every
    tap (autodiff of the bf16 shift loop), so rtol = atol = 2e-2."""
    vgrid, attn = _case(seed=5, **shape)
    g = np.random.RandomState(6).randn(
        vgrid.shape[0], vgrid.shape[2], vgrid.shape[3],
        vgrid.shape[4]).astype(np.float32)
    jdt = getattr(jnp, dtype)
    got = _port_vjp(vgrid, attn, g, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for fn in (tap_attention_pallas, tap_attention_xla):
        _, vjp = jax.vjp(fn, jnp.asarray(vgrid, jdt), jnp.asarray(attn, jdt))
        ref = vjp(jnp.asarray(g))
        for a, b in zip(got, ref):
            assert b.dtype == jdt
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=tol, atol=tol)
