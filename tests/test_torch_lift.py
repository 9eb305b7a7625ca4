"""The port's plain planar lift (occnet_tpu_torch.ops.planar_lift) against the
JAX einsum lift and the Pallas lift (interpret mode on the CPU), on the same
numpy-seeded features and camera rigs.  `count` must match exactly; U_bar
within the bf16 bound the JAX package uses between its own two lift forms
(tests/test_lift_pallas.py).  The backward (the lift's transpose) is held
against `jax.grad` of both JAX forms, per-sample gradients and the adjoint
identity."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.ops.lift_pallas import lift_and_average_pallas
from occnet_tpu.ops.planar_lift import lift_and_average as lift_jax
from occnet_tpu_torch.ops import planar_lift
from occnet_tpu_torch.ops.lift_cuda import lift_level, lift_level_bwd
from _torch_threads import one_torch_thread  # noqa: E402,F401

PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
IMG_HW = (64, 96)


def _ring_cameras(n_cam=3, batch=1, yaw0=0.0, spacing=None):
    """Cameras yawed 2*pi/n_cam apart (``spacing`` rad apart if given),
    each 0.1 rad more a batch element; 77-degree fields of view."""
    ego2img = np.zeros((batch, n_cam, 4, 4), np.float32)
    K = np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]])
    base = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    step = 2 * np.pi / n_cam if spacing is None else spacing
    for b in range(batch):
        for ci in range(n_cam):
            a = yaw0 + step * ci + 0.1 * b
            Rz = np.array([[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = K @ (Rz @ base).T
            ego2img[b, ci] = m
    return ego2img


def _feats(rng, n_cam=3, batch=1, ch=16, strides=(8, 16)):
    return [rng.randn(batch, n_cam, IMG_HW[0] // s, IMG_HW[1] // s,
                      ch).astype(np.float32) for s in strides]


def _compare(feats, ego2img, bev_hw=(14, 14), num_z=4, pallas=True):
    ref = [lift_jax([jnp.asarray(f) for f in feats], jnp.asarray(ego2img),
                    PC_RANGE, num_z, bev_hw, IMG_HW)]
    if pallas:
        ref.append(lift_and_average_pallas(
            [jnp.asarray(f) for f in feats], jnp.asarray(ego2img), PC_RANGE,
            num_z, bev_hw, IMG_HW))
    u, c = planar_lift.lift_and_average(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(ego2img),
        PC_RANGE, num_z, bev_hw, IMG_HW)
    assert u.dtype == torch.bfloat16 and u.shape == ref[0][0].shape
    u = u.float().numpy()
    assert np.isfinite(u).all()
    for a, cnt in ref:
        np.testing.assert_array_equal(np.asarray(cnt), c.numpy())
        d = np.abs(np.asarray(a, np.float32) - u)
        assert d.max() < 0.05, d.max()
    assert c.numpy().max() >= 1
    return u, c.numpy()


@pytest.mark.parametrize("batch", [1, 2])
def test_lift_matches_jax(batch):
    rng = np.random.RandomState(batch)
    _compare(_feats(rng, batch=batch), _ring_cameras(batch=batch))


def test_lift_matches_jax_with_overlapping_cameras():
    """Six cameras yawed 20 degrees apart, so that their 77-degree fields of
    view overlap and some cells are seen by 3 or more cameras (the tap lists
    of the CUDA kernel are at their longest there): the count exactly, U_bar
    within the bf16 bound, against the einsum and the Pallas lift."""
    rng = np.random.RandomState(9)
    ego2img = _ring_cameras(n_cam=6, batch=2, spacing=np.pi / 9)
    _, count = _compare(_feats(rng, n_cam=6, batch=2), ego2img)
    assert count.max() >= 3, count.max()


def _edge_positions(rng, B, A, ZR, M, h, w):
    """Positions that probe the sampler's edges: uniform over (-1.5, n + 0.5)
    of each axis extent n, a fifth made integral, band-limited to (-1, n)
    as `level_geometry` does (the rest dead, -2), a fifth more dead, and a
    random pass order a plane."""
    steep = rng.rand(B, A, ZR) < 0.5

    def draw(n):
        p = (rng.rand(*n.shape) * (n + 2.0) - 1.5).astype(np.float32)
        p = np.where(rng.rand(*n.shape) < 0.2, np.round(p), p)
        dead = (rng.rand(*n.shape) < 0.2) | (p <= -1.0) | (p >= n)
        return np.where(dead, np.float32(-2.0), p).astype(np.float32)

    n2 = np.broadcast_to(np.where(steep, h, w)[..., None], (B, A, ZR, M))
    n1 = np.broadcast_to(np.r_[np.full(w, h), np.full(h, w)],
                         (B, A, ZR, w + h))
    return draw(n1.astype(np.float32)), draw(n2.astype(np.float32)), steep


def _lift_loop(feat, pos1, pos2, steep, inv_count):
    """The level lift as an explicit float32 loop in numpy: per cell,
    camera ascending, then dk, then dj, each step acc + (w2 * w1) * f in
    separate float32 roundings (taps outside the axis skipped), then
    acc * inv_count.  Returns float32 (B, ZR, M, C)."""
    B, A, h, w, C = feat.shape
    ZR, M = pos2.shape[2:]
    R = inv_count.shape[1] // M
    one = np.float32(1.0)
    out = np.zeros((B, ZR, M, C), np.float32)
    for b, zr, m in np.ndindex(B, ZR, M):
        acc = np.zeros(C, np.float32)
        for a in range(A):
            st = bool(steep[b, a, zr])
            n2, n1 = (h, w) if st else (w, h)
            p2 = pos2[b, a, zr, m]
            k0 = np.floor(p2)
            f2 = p2 - k0
            for dk in (0, 1):
                k = int(k0) + dk
                if not 0 <= k < n2:
                    continue
                w2 = f2 if dk else one - f2
                p1 = pos1[b, a, zr, (w if st else 0) + k]
                j0 = np.floor(p1)
                f1 = p1 - j0
                for dj in (0, 1):
                    j = int(j0) + dj
                    if not 0 <= j < n1:
                        continue
                    wt = w2 * (f1 if dj else one - f1)
                    y, x = (k, j) if st else (j, k)
                    acc = acc + wt * feat[b, a, y, x]
        out[b, zr, m] = acc * inv_count[b, (zr % R) * M + m]
    return out


def test_lift_level_plain_is_the_ordered_fp32_loop():
    """`lift_level_plain` pins the summation order the CUDA kernel repeats
    (camera, dk, dj; separate fp32 roundings; then 1/count): bitwise equal
    to an explicit float32 loop on edge positions (dead, integral, k = -1
    and k = n - 1 taps, both pass orders), in fp32 and, rounded once, in
    bf16."""
    rng = np.random.RandomState(10)
    B, A, R, Z, M, h, w, C = 2, 3, 3, 2, 5, 4, 6, 8
    pos1, pos2, steep = _edge_positions(rng, B, A, Z * R, M, h, w)
    feat = torch.from_numpy(rng.randn(B, A, h, w, C).astype(np.float32)
                            ).bfloat16()
    inv = (1.0 / rng.randint(1, 4, (B, R * M))).astype(np.float32)
    want = _lift_loop(feat.float().numpy(), pos1, pos2, steep, inv)
    assert (pos2 > -2).any() and (pos2 == np.round(pos2)).any()
    args = [torch.from_numpy(x) for x in (pos1, pos2, steep, inv)]
    out = torch.empty(B, Z * R, M, C)
    lift_level(feat, *args, out)
    np.testing.assert_array_equal(out.numpy(), want)
    assert np.abs(want).max() > 0
    out16 = torch.empty(B, Z * R, M, C, dtype=torch.bfloat16)
    lift_level(feat, *args, out16)
    assert torch.equal(out16, torch.from_numpy(want).bfloat16())


def test_lift_windowed_level_batch2():
    """Feature maps wider than the Pallas K-window (w = 48 > 32): the
    `_pass1w` path on the JAX side, at B = 2."""
    rng = np.random.RandomState(4)
    _compare(_feats(rng, ch=8, strides=(2,), batch=2), _ring_cameras(batch=2))


def test_lift_camera_with_no_live_rows_in_one_order():
    """In this 4-camera rig cameras 0 and 2 see every live BEV row as a steep
    image line, so they have zero live rows in pass order A — the rig of the
    r4 NaN fault (tmp rows read through zero weights).  The lift must still
    match JAX, and cells no camera sees must come out exactly zero."""
    rng = np.random.RandomState(5)
    ego2img = _ring_cameras(n_cam=4, batch=1)
    feats = _feats(rng, n_cam=4, ch=8, strides=(4, 8))
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, 4))
    H = planar_lift.plane_homographies(torch.from_numpy(ego2img), PC_RANGE,
                                       z, (14, 14))
    Ml = planar_lift.feature_homographies(H, 16, 24, IMG_HW)
    _, _, steep, valid = planar_lift.level_geometry(Ml, (14, 14), 16, 24)
    row_live = valid.any(-1).reshape(steep.shape)
    live_a = (~steep & row_live).sum(-1)[0]
    live_b = (steep & row_live).sum(-1)[0]
    assert (live_a == 0).any() and (live_a > 0).any(), live_a
    assert (live_b > 0).all(), live_b
    u, _ = _compare(feats, ego2img)
    seen = valid.any(2).any(1).reshape(-1).numpy()   # any cam, any z, lvl 0
    assert (~seen).any()
    assert (u[0, 0][:, ~seen] == 0).all()


def test_lift_level_plain_writes_every_element():
    """The plain level lift overwrites its whole output, including cells no
    camera sees (a NaN-filled buffer must come back finite)."""
    rng = np.random.RandomState(6)
    feats = torch.from_numpy(_feats(rng, ch=8, strides=(8,))[0])
    e2i = torch.from_numpy(_ring_cameras())
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, 2))
    H = planar_lift.plane_homographies(e2i, PC_RANGE, z, (6, 6))
    Ml = planar_lift.feature_homographies(H, 8, 12, IMG_HW)
    pos1, pos2, steep, valid = planar_lift.level_geometry(Ml, (6, 6), 8, 12)
    inv = torch.ones(1, 36)
    out = torch.full((1, 12, 6, 8), float("nan"))
    lift_level(feats, pos1, pos2, steep, inv, out)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        lift_level(feats, pos1, pos2, steep, inv, out, impl="bogus")


def _port_grads(feats, ego2img, cot, bev_hw=(14, 14), num_z=4):
    """d sum(U_bar * cot) / d feats through the port's autograd Function."""
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    u, _ = planar_lift.lift_and_average(fs, torch.from_numpy(ego2img),
                                        PC_RANGE, num_z, bev_hw, IMG_HW)
    (u.float() * torch.from_numpy(cot)).sum().backward()
    return [f.grad.numpy() for f in fs]


def test_lift_grads_match_jax_einsum_and_pallas():
    """The plain backward (the transpose, scattered in fp32) against
    `jax.grad` of the einsum lift and of the Pallas lift in interpret mode
    (which runs backward kernels #5/#6).  Both JAX forms round the
    cotangent and intermediates to bf16, so the bound is the one of
    tests/test_lift_pallas.py: max|diff| < 0.04 x max|g|."""
    rng = np.random.RandomState(2)
    feats = _feats(rng, ch=8, strides=(16,))
    ego2img = _ring_cameras()
    cot = rng.randn(1, 1, 4, 14 * 14, 8).astype(np.float32)
    got = _port_grads(feats, ego2img, cot)
    for fn in (lift_jax, lift_and_average_pallas):
        def loss(fs):
            u, _ = fn(fs, jnp.asarray(ego2img), PC_RANGE, 4, (14, 14),
                      IMG_HW)
            return jnp.sum(u.astype(jnp.float32) * jnp.asarray(cot))

        ref = jax.grad(loss)([jnp.asarray(f) for f in feats])
        for a, b in zip(got, ref):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape and np.isfinite(a).all()
            scale = max(np.abs(b).max(), 1e-3)
            assert np.abs(a - b).max() / scale < 0.04, np.abs(a - b).max()


def test_lift_grads_batch2_match_per_sample():
    """B=2 gradients == per-sample gradients (the r5 fault of the Pallas
    backward), with ZR = 4 x 33 = 132 spanning more than one 128-row zr
    block.  Same fp32 sums in the same order, so to 1e-5 relative."""
    rng = np.random.RandomState(3)
    feats = _feats(rng, ch=8, strides=(16,), batch=2)
    ego2img = _ring_cameras(batch=2)
    cot = rng.randn(2, 1, 4, 33 * 14, 8).astype(np.float32)
    g2 = _port_grads(feats, ego2img, cot, bev_hw=(33, 14))
    for bi in range(2):
        g1 = _port_grads([f[bi:bi + 1] for f in feats], ego2img[bi:bi + 1],
                         cot[bi:bi + 1], bev_hw=(33, 14))
        for a, b in zip(g2, g1):
            assert np.isfinite(a[bi]).all() and np.abs(b).max() > 0
            scale = max(np.abs(b[0]).max(), 1e-3)
            assert np.abs(a[bi] - b[0]).max() / scale < 1e-5


def test_lift_backward_is_the_adjoint():
    """<lift(f), g> == <f, lift_bwd(g)> with fp32 output both ways (bf16-
    representable features, the kernel's input rounding): fp32 sums only,
    to 1e-5 relative.  At B=2 over a 4-camera rig."""
    rng = np.random.RandomState(7)
    e2i = torch.from_numpy(_ring_cameras(n_cam=4, batch=2))
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, 3))
    H = planar_lift.plane_homographies(e2i, PC_RANGE, z, (9, 11))
    for h, w in ((8, 12), (16, 24)):
        Ml = planar_lift.feature_homographies(H, h, w, IMG_HW)
        pos1, pos2, steep, valid = planar_lift.level_geometry(Ml, (9, 11), h,
                                                              w)
        count = valid.any(dim=2).sum(dim=1).float().clamp(min=1.0)
        inv = (1.0 / count).reshape(2, -1)
        f = torch.from_numpy(rng.randn(2, 4, h, w, 8).astype(np.float32)
                             ).bfloat16().float()
        g = torch.from_numpy(rng.randn(2, 27, 11, 8).astype(np.float32))
        u = torch.empty(2, 27, 11, 8)
        lift_level(f, pos1, pos2, steep, inv, u)
        df = lift_level_bwd(g, pos1, pos2, steep, inv, (h, w),
                            out_dtype=torch.float32)
        lhs = (u.double() * g.double()).sum().item()
        rhs = (f.double() * df.double()).sum().item()
        assert abs(lhs) > 1.0
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)
        # the default output is the same gradient rounded to bf16
        d16 = lift_level_bwd(g, pos1, pos2, steep, inv, (h, w))
        assert d16.dtype == torch.bfloat16
        assert torch.equal(d16, df.bfloat16())


def test_feat_grad_reaches_through_the_autograd_function():
    """The lift is an autograd Function: gradients reach bf16 and fp32
    features, the geometry gets none, and the count stays constant."""
    rng = np.random.RandomState(8)
    feats = _feats(rng, ch=8, strides=(8, 16))
    fs = [torch.from_numpy(feats[0]).requires_grad_(),
          torch.from_numpy(feats[1]).bfloat16().requires_grad_()]
    e2i = torch.from_numpy(_ring_cameras()).requires_grad_()
    u, count = planar_lift.lift_and_average(fs, e2i, PC_RANGE, 4, (14, 14),
                                            IMG_HW)
    assert u.requires_grad and not count.requires_grad
    u.float().square().sum().backward()
    for f in fs:
        assert f.grad is not None and f.grad.dtype == f.dtype
        assert torch.isfinite(f.grad.float()).all()
        assert f.grad.float().abs().max() > 0
    assert e2i.grad is None


def _gather_through_index(g, pos2, inv_count, index, hw):
    """The kernel's sum (`csrc/lift_bwd.cu`) in plain PyTorch: for every
    line (b, camera, kk) and every plane with a run on it, every cell of the
    run [m_lo, m_hi): the forward's weight w2 * w1 (dead cells and cells
    whose pass-2 hat misses the line's tap skipped) times g * inv_count,
    added to the line's pixels j0 and j0 + 1 = floor(pos1) (+ 1) that lie
    on the image.  Returns fp32 dfeat (B, A, h, w, C)."""
    B, ZR, M, C = g.shape
    A = pos2.shape[1]
    h, w = hw
    R = inv_count.shape[1] // M
    lo = index.runs[..., 0] & 0xffff
    hi = index.runs[..., 0] >> 16
    p1 = index.runs[..., 1].contiguous().view(torch.float32)
    b, a, kk, zr = (hi > lo).nonzero(as_tuple=True)
    n_m = (hi - lo)[b, a, kk, zr]
    i_c = torch.repeat_interleave(torch.arange(b.numel()), n_m)
    m = lo[b, a, kk, zr][i_c] + torch.arange(int(n_m.sum())) \
        - torch.repeat_interleave(torch.cumsum(n_m, 0) - n_m, n_m)
    b, a, kk, zr = b[i_c], a[i_c], kk[i_c], zr[i_c]
    order_b = kk >= w
    k = torch.where(order_b, kk - w, kk)
    n1 = torch.where(order_b, w, h)
    p2 = pos2[b, a, zr, m]
    k0 = torch.floor(p2)
    f2 = p2 - k0
    w2 = torch.where(k0 == k, 1.0 - f2, torch.where(k0 + 1 == k, f2, 0.0))
    w2 = torch.where(p2 > -1.0, w2, 0.0)
    p1c = p1[b, a, kk, zr]
    j0 = torch.floor(p1c)
    f1 = p1c - j0
    gi = g.float()[b, zr, m] * inv_count[b, (zr % R) * M + m][:, None]
    out = torch.zeros(B * A * h * w, C)
    for j, w1 in ((j0.long(), 1.0 - f1), (j0.long() + 1, f1)):
        ok = (p1c > -1.0) & (j >= 0) & (j < n1) & (w2 != 0)
        y, x = torch.where(order_b, k, j), torch.where(order_b, j, k)
        pix = ((b * A + a) * h + y) * w + x
        out.index_add_(0, pix[ok], (w2 * w1)[ok][:, None] * gi[ok])
    return out.reshape(B, A, h, w, C)


def _level_geometry(e2i, h, w, bev_hw=(14, 14), num_z=4):
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, num_z))
    H = planar_lift.plane_homographies(e2i, PC_RANGE, z, bev_hw)
    Ml = planar_lift.feature_homographies(H, h, w, IMG_HW)
    pos1, pos2, steep, valid = planar_lift.level_geometry(Ml, bev_hw, h, w)
    count = valid.any(dim=2).sum(dim=1).float().clamp(min=1.0)
    return pos1, pos2, steep, (1.0 / count).reshape(e2i.shape[0], -1)


@pytest.mark.parametrize("stride", [4, 8, 16, 32])
@pytest.mark.parametrize("rig", ["yawed_b2", "no_live_rows_in_order_a"])
def test_lift_bwd_index_gathers_the_plain_scatter(rig, stride):
    """The kernel's transposed index: a gather through each line's runs
    [m_lo, m_hi) of BEV columns equals `lift_level_bwd_plain` at every level
    (strides 4-32), within fp32 summation order (1e-5 of max|dfeat|).  Rigs:
    a 4-camera ring yawed by 0.1 rad per batch element at B = 2, and the rig
    of `test_lift_camera_with_no_live_rows_in_one_order`.  A plane has runs
    only on the lines of its own pass order, and the runs hold exactly the
    live (cell, tap) pairs."""
    from occnet_tpu_torch.ops import lift_cuda
    rng = np.random.RandomState(11 + stride)
    batch = 2 if rig == "yawed_b2" else 1
    e2i = torch.from_numpy(_ring_cameras(n_cam=4, batch=batch,
                                         yaw0=0.3 if batch == 2 else 0.0))
    h, w = IMG_HW[0] // stride, IMG_HW[1] // stride
    pos1, pos2, steep, inv = _level_geometry(e2i, h, w)
    ZR = pos2.shape[2]
    g = torch.from_numpy(rng.randn(batch, ZR, 14, 8).astype(np.float32))
    index = lift_cuda.lift_bwd_index(pos1, pos2, steep, (h, w))
    assert index.runs.dtype == torch.int32
    assert index.runs.shape == (batch, 4, w + h, ZR, 2)
    assert int(index.excess[0]) == 0
    has_run = (index.runs[..., 0] != 0)                 # (B, A, w + h, ZR)
    st = steep[:, :, None, :]
    assert not (has_run[:, :, :w] & st).any()
    assert not (has_run[:, :, w:] & ~st).any()
    if rig == "no_live_rows_in_order_a":
        assert has_run[:, :, w:].any() and not has_run[0, 0, :w].any()
    got = _gather_through_index(g, pos2, inv, index, (h, w))
    want = lift_cuda.lift_level_bwd_plain(g, pos1, pos2, steep, inv,
                                          (h, w), out_dtype=torch.float32)
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_lift_bwd_index_raises_when_a_run_is_not_monotone():
    """The index rests on the cells that reach a tap being one contiguous
    run of BEV columns.  Killing the middle one of three live cells whose
    outer two share a tap breaks it (the run of that tap now holds a cell
    that does not reach it), and the index build raises instead of returning a
    different gradient."""
    from occnet_tpu_torch.ops.lift_cuda import lift_bwd_index
    e2i = torch.from_numpy(_ring_cameras(n_cam=4, batch=1))
    pos1, pos2, steep, _ = _level_geometry(e2i, 16, 24)
    lift_bwd_index(pos1, pos2, steep, (16, 24))
    p2 = pos2[0]
    k = torch.floor(p2)
    three = (p2[..., :-2] > -1) & (p2[..., 1:-1] > -1) & (p2[..., 2:] > -1)
    shared = (k[..., :-2] - k[..., 2:]).abs() <= 1
    a, zr, m = [int(i) for i in (three & shared).nonzero()[0]]
    bad = pos2.clone()
    bad[0, a, zr, m + 1] = -2.0
    with pytest.raises(ValueError, match="not one monotone run"):
        lift_bwd_index(pos1, bad, steep, (16, 24))


def test_bench_edits_match_the_kernel_sources():
    """The development builds of `tools/bench_lift_tap.py` edit this
    checkout's `csrc/lift.cu` and `csrc/tap.cu` by exact text; each edit
    must still match once, or the tool would stop on the card."""
    import os
    from occnet_tpu_torch.ops import _build
    from occnet_tpu_torch.tools import bench_lift_tap as bench
    csrc = os.path.dirname(_build.BUILD_DIR)
    for edits in (bench.CHANGE_NO_GATHER, bench.CHANGE_NO_LOAD,
                  bench.CHANGE_STORE_ONLY, bench.CHANGE_BATCH8,
                  bench.CHANGE_TAP16):
        for name, old, _ in edits:
            with open(os.path.join(csrc, name)) as f:
                assert f.read().count(old) == 1, old


@pytest.mark.parametrize("tool", ["bench_lift_tap", "profile_turbo"])
def test_card_tools_refuse_to_run_without_a_card(tool, monkeypatch):
    """The timing tools measure the card only: without one they exit with a
    message instead of timing the CPU."""
    import importlib
    mod = importlib.import_module(f"occnet_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--parent", "."] if tool == "bench_lift_tap" else []
    with pytest.raises(SystemExit, match="CUDA device"):
        mod.main(args)
