"""The port's plain pass-2 from a tmp slab (occnet_tpu_torch.ops.lift_pass2,
the counterpart of Pallas kernel #7) against the JAX package's
`lift_pallas._pass2` run in interpret mode on the CPU, on the same
numpy-seeded bf16 tmp slabs and positions: dead (-2) positions, integer
positions (one tap of weight 1, the other 0), positions next to the padded
edge, padded zr rows that are not computed.  Tolerance: one bf16 step of
max |out| (the two sum the same exact bf16 products in another fp32
order, then round once)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occnet_tpu.ops import lift_pallas
from occnet_tpu_torch.ops.lift_pass2 import lift_pass2

Z, BEV_H, A, M, C = 2, 8, 3, 16, 16
W, H = 24, 16
ZR, ZR_PAD = Z * BEV_H, 24
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _inputs(seed):
    rng = np.random.RandomState(seed)
    pos2A = rng.uniform(-1.5, W + 0.5, (ZR_PAD, A, M)).astype(np.float32)
    pos2B = rng.uniform(-1.5, H + 0.5, (ZR_PAD, A, M)).astype(np.float32)
    for pos, n in ((pos2A, W), (pos2B, H)):
        dead = rng.rand(*pos.shape) < 0.3
        pos[dead] = -2.0                            # the dead sentinel
        pos[:, 0, :4] = np.arange(4)                # integer positions
        pos[:, 1, :4] = [n - 1, n - 0.5, n - 1e-3, n - 1 + 2 ** -10]
    inv = rng.uniform(0.2, 1.0, (BEV_H, 1, M)).astype(np.float32)
    tmpA = rng.randn(ZR_PAD, A, W, C).astype(np.float32)
    tmpB = rng.randn(ZR_PAD, A, H, C).astype(np.float32)
    bf = [np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (tmpA, tmpB)]
    return pos2A, pos2B, inv, bf[0], bf[1]


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("seed,out_dtype", [(0, "bf16"), (1, "bf16"),
                                            (2, "f32")])
def test_pass2_plain_matches_pallas_interpret(seed, out_dtype):
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[out_dtype]
    args = _inputs(seed)
    want = np.asarray(lift_pallas._pass2(
        *(jnp.asarray(a) for a in args), ZR, BEV_H, jdt), np.float32)
    got = lift_pass2(*(_torch(a) for a in args), ZR, BEV_H, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (ZR, M, C)
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * scale)
    if out_dtype == "f32":
        # fp32 output: only the summation order differs
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_pass2_reads_only_weighted_taps():
    """A NaN in a tmp row no nonzero weight reaches stays out of the
    output (the TPU kernel's dense contraction would give 0 * NaN)."""
    pos2A, pos2B, inv, tmpA, tmpB = (_torch(a) for a in _inputs(3))
    pos2A[:] = 2.0                       # tap 2 has weight 1, tap 3 weight 0
    pos2B[:] = -2.0
    tmpA[:, :, 3] = float("nan")
    tmpB[:] = float("nan")
    out = lift_pass2(pos2A, pos2B, inv, tmpA, tmpB, ZR, BEV_H)
    assert torch.isfinite(out.float()).all()
    want = tmpA[:ZR, :, 2].float().sum(1)[:, None, :] \
        * inv[:, 0].repeat(Z, 1)[..., None]
    torch.testing.assert_close(out.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
