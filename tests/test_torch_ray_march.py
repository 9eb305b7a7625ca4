"""The port's plain ray marchers (occnet_tpu_torch.ops.ray_march /
ray_march_vec) against the JAX package's, on the same numpy-seeded grids,
origins and directions: coords and hits bitwise, distances within 1e-6
relative (the port repeats XLA's compiled fp32 operations, fused
multiply-adds and rewritten divisions included, so they are bitwise equal
here).  Axis-aligned and 45-degree rays from voxel corners exercise the
tie rules; origins outside the grid and rays that never enter exercise the
zero outputs.  The CUDA wrappers refuse CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occnet_tpu.evaluation.ray_metrics import (fan_parameters as
                                               jax_fan_parameters)
from occnet_tpu.evaluation.ray_metrics import generate_lidar_rays
from occnet_tpu.ops.ray_march import dda_raymarch as jax_dda
from occnet_tpu.ops.ray_march_fast import pack_columns as jax_pack
from occnet_tpu.ops.ray_march_vec import dda_raymarch_fan_vec as jax_fan
from occnet_tpu_torch.evaluation.ray_metrics import fan_parameters
from occnet_tpu_torch.ops import ray_march, ray_march_vec
from occnet_tpu_torch.ops.lift_pass2 import lift_pass2_cuda
from _torch_threads import one_torch_thread  # noqa: E402,F401

DIST_RTOL = 1e-6


def _assert_same(got, want):
    dist, coord, hit = (t.numpy() for t in got)
    wd, wc, wh = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(hit, wh)
    np.testing.assert_array_equal(coord, wc)
    np.testing.assert_allclose(dist, wd, rtol=DIST_RTOL, atol=0)


def _rays(rng, n, size):
    """Origins inside and outside the grid (some on voxel corners) and
    random, axis-aligned and 45-degree directions."""
    o = rng.uniform(-4, max(size) + 4, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    special = np.array([[1, 1, 0], [1, -1, 0], [-1, -1, 1], [0, 0, 1],
                        [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                        [1, 1, 1], [0, 0, 0]], np.float32)
    d[:len(special) * 8] = np.repeat(special, 8, axis=0)
    o[:40] = np.floor(o[:40])                       # voxel corners
    o[40:120] = np.floor(o[40:120]) + 0.5           # voxel centres
    o[120:140] = [-3.0, 5.0, 4.0]                   # outside, some away
    return o, d


@pytest.mark.parametrize("seed", [0, 1])
def test_dda_plain_matches_jax(seed):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(24, 20, 8) < 0.05).astype(np.float32)
    o, d = _rays(rng, 600, occ.shape)
    want = jax_dda(jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d),
                   max_steps=60)
    got = ray_march.dda_raymarch(torch.from_numpy(occ), torch.from_numpy(o),
                                 torch.from_numpy(d), 60)
    _assert_same(got, want)
    hit, coord = got[2].numpy(), got[1].numpy()
    assert 0 < hit.sum() < len(hit)
    # some rays never enter the grid and return zeros
    assert ((coord == 0).all(1) & ~hit).sum() > 0


def _sub_fan(step=15):
    rays = generate_lidar_rays()
    K = rays.shape[0] // 360
    fan = rays.reshape(K, 360, 3)[:, ::step]
    return fan.reshape(-1, 3), fan.shape[1]


def test_fan_parameters_bitwise_equal_to_jax():
    rays = generate_lidar_rays()
    for got, want in zip(fan_parameters(rays),
                         jax_fan_parameters(jnp.asarray(rays))):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("origins", [
    # the JAX test's origins: inside, near a corner, one outside the grid
    [[20.3, 19.7, 8.2], [5.0, 35.0, 4.1], [-3.0, 20.0, 7.7]],
    # voxel corners: 45-degree azimuths cross exact ties
    [[20.0, 20.0, 8.0], [10.0, 30.0, 2.0], [41.0, -2.0, 15.5]],
])
def test_fan_plain_matches_jax(origins):
    rng = np.random.RandomState(0)
    occs = (rng.rand(2, 40, 40, 16) < 0.03).astype(np.float32)
    origins = np.array(origins, np.float32)
    rays, num_az = _sub_fan()
    az, dz, scale = fan_parameters(rays, num_az)
    want = jax_fan(jnp.asarray(occs), jnp.asarray(origins), jnp.asarray(az),
                   jnp.asarray(dz), jnp.asarray(scale), max_xy_steps=100)
    got = ray_march_vec.dda_raymarch_fan_vec(
        *(torch.from_numpy(a) for a in (occs, origins, az, dz, scale)),
        max_xy_steps=100)
    _assert_same(got, want)
    assert 0 < got[2].sum() < got[2].numel()


def test_fan_empty_grid_and_pack_columns():
    rng = np.random.RandomState(2)
    occ = (rng.rand(2, 7, 5, 16) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        ray_march_vec.pack_columns(torch.from_numpy(occ)).numpy(),
        np.stack([np.asarray(jax_pack(jnp.asarray(g))) for g in occ]))
    occs = torch.zeros(1, 20, 20, 8)
    rays, num_az = _sub_fan(step=60)
    az, dz, scale = (torch.from_numpy(a)
                     for a in fan_parameters(rays, num_az))
    dist, _, hit = ray_march_vec.dda_raymarch_fan_vec(
        occs, torch.tensor([[10.0, 10.0, 4.0]]), az, dz, scale,
        max_xy_steps=60)
    assert not hit.any() and torch.isfinite(dist).all() and (dist >= 0).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    occ = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march.dda_raymarch_cuda(occ, torch.zeros(2, 3),
                                    torch.ones(2, 3), 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march_vec.dda_raymarch_fan_vec_cuda(
            occ[None], torch.zeros(1, 3), torch.ones(2, 2), torch.ones(3),
            torch.ones(3))
    with pytest.raises(ValueError, match="CUDA device"):
        lift_pass2_cuda(torch.zeros(8, 1, 4), torch.zeros(8, 1, 4),
                        torch.ones(4, 1, 4),
                        torch.zeros(8, 1, 8, 8, dtype=torch.bfloat16),
                        torch.zeros(8, 1, 8, 8, dtype=torch.bfloat16), 8, 4)


# ---------------------------------------------------------------------------
# Scalar numpy models of the CUDA kernels' traversal orders
# (occnet_tpu_torch/csrc/ray_march.cu), held bitwise against the JAX
# marchers.  The kernels cannot run here; these models follow their loops
# step by step in float32 (a fused multiply-add as one rounding of the
# float64 value, as the port's plain versions take it).
# ---------------------------------------------------------------------------

F32 = np.float32
BIG = F32(1e30)


def _fma(a, b, c):
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _columns(occ):
    """(X, Y, Z) occupancy -> (X, Y) Z-bit column masks, as each block of
    the kernels packs them."""
    Z = occ.shape[-1]
    return ((occ > 0.5).astype(np.int64) << np.arange(Z)).sum(-1)


def _march_model(cols, shape, o, d, max_steps):
    """dda_kernel's march of one ray, in its two phases: outside, step until
    the ray enters or moves away; inside, test the voxel's bit in the column
    word (reloaded only when x or y changes), then advance one axis and
    check that axis' bound alone.  -> (dist, (x, y, z), hit)."""
    dx, dy, dz = (F32(c) for c in d)
    o = [F32(c) for c in o]
    din = (dx, dy, dz)
    nrm = max(F32(np.sqrt(_fma(dz, dz, _fma(dy, dy, F32(dx * dx))))),
              F32(1e-12))
    u = [c / nrm for c in din]
    v = [int(np.floor(c)) for c in o]
    s = [1 if c >= 0 else -1 for c in u]
    t = [F32(F32(F32(F32(v[a]) + F32(s[a] > 0)) - o[a]) * nrm) / din[a]
         if u[a] != 0 else BIG for a in range(3)]
    dt = [F32(F32(s[a]) * nrm) / din[a] if u[a] != 0 else BIG
          for a in range(3)]
    none = (F32(0), (0, 0, 0)), False

    def axis():
        if t[0] < t[1] and t[0] < t[2]:
            return 0
        return 1 if not t[0] < t[1] and t[1] < t[2] else 2

    step = 0
    while True:                                  # outside the grid
        if step >= max_steps:
            return none
        if all(0 <= v[a] < shape[a] for a in range(3)):
            break
        if any((v[a] < 0 and u[a] < 0) or (v[a] >= shape[a] and u[a] > 0)
               for a in range(3)):
            return none
        a = axis()
        v[a] += s[a]
        t[a] = F32(t[a] + dt[a])
        step += 1
    col = int(cols[v[0], v[1]])
    while True:                                  # inside
        dist = min(min(t[0], t[1]), t[2])
        if (col >> v[2]) & 1:
            return (dist, tuple(v)), True
        step += 1
        if step >= max_steps:
            return (dist, tuple(v)), False
        a = axis()
        v[a] += s[a]
        t[a] = F32(t[a] + dt[a])
        if not 0 <= v[a] < shape[a]:
            v[a] -= s[a]
            return (dist, tuple(v)), False
        if a < 2:
            col = int(cols[v[0], v[1]])


def _dda_model(occ, origins, dirs, max_steps):
    """The raw epilogue: rays in the kernel's grid-stride order, 32 a
    warp."""
    cols = _columns(occ)
    R = len(dirs)
    dist = np.zeros(R, F32)
    coord = np.zeros((R, 3), np.int32)
    hit = np.zeros(R, bool)
    for w0 in range(0, R, 32):
        for r in range(w0, min(w0 + 32, R)):
            (dist[r], coord[r]), hit[r] = _march_model(
                cols, occ.shape, origins[r], dirs[r], max_steps)
    return dist, coord, hit


def _render_rays_model(rot, u, v, C):
    """The render epilogue's rays in its order: 8 x 4 pixel tiles a warp
    (ragged tiles at the edges), each lane's direction u * R[0][j] +
    v * R[1][j] + R[2][j] with one rounding an operation.  -> the (camera,
    row, column) of each ray and its direction."""
    H, W = len(v), len(u)
    pix, dirs = [], []
    for c in range(C):
        for ty in range(-(-H // 4)):
            for tx in range(-(-W // 8)):
                for lane in range(32):
                    px, py = tx * 8 + lane % 8, ty * 4 + lane // 8
                    if px >= W or py >= H:
                        continue
                    Rc = rot[c]
                    pix.append((c, py, px))
                    dirs.append([F32(F32(F32(u[px] * Rc[0, j])
                                         + F32(v[py] * Rc[1, j]))
                                     + Rc[2, j]) for j in range(3)])
    return pix, np.array(dirs, F32)


def test_dda_model_matches_jax_on_tricky_rays():
    """Voxel corners with 45-degree and axis-aligned rays (exact ties),
    origins outside moving away, rays that never enter, and a max_steps cap
    short enough to stop rays mid-grid."""
    rng = np.random.RandomState(4)
    occ = (rng.rand(12, 10, 6) < 0.08).astype(np.float32)
    o, d = _rays(rng, 300, occ.shape)
    for max_steps in (40, 7):
        want = jax_dda(jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d),
                       max_steps=max_steps)
        _assert_same(tuple(torch.from_numpy(a)
                           for a in _dda_model(occ, o, d, max_steps)), want)
    dist, coord, hit = _dda_model(occ, o, d, 7)
    assert 0 < hit.sum() < len(hit) and ((coord == 0).all(1) & ~hit).any()


def test_dda_model_tiled_camera_rays_match_jax():
    """Two cameras of a ring rig at a voxel corner of the grid, a 20 x 10
    image (ragged 8 x 4 tiles): the render epilogue's rays through the
    packed columns give JAX's marcher's results."""
    from occnet_tpu_torch.data import synthetic as syn
    rng = np.random.RandomState(5)
    occ = (rng.rand(16, 16, 6) < 0.06).astype(np.float32)
    occ[:, :, 0] = 1.0
    rig = syn.ring_camera_rig(8, (10, 20))
    tables = syn.scene_tables(rig["R"], rig["t"], rig["K"],
                              syn.class_palette(), (10, 20),
                              (-3.2, -3.2, -0.4, 3.2, 3.2, 2.0), 0.4, "cpu")
    C = 2
    rot = tables.rot.numpy()[[0, 1]]      # 0 and 45 degrees of yaw
    pix, dirs = _render_rays_model(rot, tables.u.numpy(), tables.v.numpy(),
                                   C)
    assert len(pix) == C * 10 * 20
    origin = np.array([8.0, 8.0, 3.0], F32)         # a voxel corner
    origins = np.broadcast_to(origin, dirs.shape).copy()
    want = jax_dda(jnp.asarray(occ), jnp.asarray(origins),
                   jnp.asarray(dirs), max_steps=40)
    got = _dda_model(occ, origins, dirs, 40)
    _assert_same(tuple(torch.from_numpy(a) for a in got), want)
    # the directions are the port's (camera_dirs), pixel for pixel
    for c in range(C):
        rows = [i for i, p in enumerate(pix) if p[0] == c]
        flat = [pix[i][1] * 20 + pix[i][2] for i in rows]
        np.testing.assert_array_equal(
            ray_march.camera_dirs(tables, c).numpy()[flat], dirs[rows])
    assert 0 < got[2].sum() < len(pix)


def _z_time(zb, z0, dz):
    return (F32(zb) - z0) / dz if dz != 0 else BIG


def _subwalk_model(rec, z0, dz, zstep, Z, max_z_sub, tab, zlo):
    """`_z_subwalk` at one crossing, its z-boundary times from the ring's
    table.  -> (hit, hit_s, hit_z, last_ok, last_s, last_z)."""
    _, _, t_in, t_exit, bits = rec
    zi = int(np.floor(_fma(t_in, dz, z0)))
    out = [False, F32(0), 0, False, F32(0), 0]
    for j in range(max_z_sub):
        zj = zi + j * zstep
        if not 0 <= zj < Z:
            continue
        if j > 0 and not (tab[zj + (zstep < 0) - zlo] < t_exit and dz != 0):
            continue
        s_exit = min(tab[zj + (zstep > 0) - zlo], t_exit)
        if (bits >> zj) & 1 and not out[0]:
            out[:3] = [True, s_exit, zj]
        out[3:] = [True, s_exit, zj]
    return out


def _fan_model(occs, origins, az_dirs, pitch_dz, pitch_scale, N, max_z_sub):
    """fan_kernel's traversal: per (grid, origin, azimuth) the xy column
    walk merged 32 crossings at a time and shared by every pitch ring; each
    ring still scanning tests a chunk's crossings with its z-range test
    (z-boundary times from a table built once per origin, no division a
    crossing) and keeps the first hit, else the last visited crossing,
    until it hits or leaves the grid's z-range for good; the warp stops
    when all rings are done or the walk ends.  -> raw (G, T, A, K) dist,
    coord, hit."""
    G, X, Y, Z = occs.shape
    T, A, K = len(origins), len(az_dirs), len(pitch_dz)
    cols = [_columns(o) for o in occs]
    dist = np.zeros((G, T, A, K), F32)
    coord = np.zeros((G, T, A, K, 3), np.int32)
    hit = np.zeros((G, T, A, K), bool)
    zlo = min(0, 2 - max_z_sub)
    zhi = max(Z, Z + max_z_sub - 2)
    dzs = [F32(c) for c in pitch_dz]
    zsteps = [1 if c >= 0 else -1 for c in dzs]
    for t in range(T):
        ox, oy, z0 = (F32(c) for c in origins[t])
        tab = [[_z_time(zb, z0, dzs[k]) for zb in range(zlo, zhi + 1)]
               for k in range(K)]
        for g in range(G):
            for a in range(A):
                d2 = [F32(c) for c in az_dirs[a]]
                st = [1 if c >= 0 else -1 for c in d2]
                v0 = [int(np.floor(ox)), int(np.floor(oy))]
                tmax0 = [(F32(F32(v0[i]) + F32(st[i] > 0)) - (ox, oy)[i])
                         / d2[i] if d2[i] != 0 else BIG for i in range(2)]
                tdelta = [F32(st[i]) / d2[i] if d2[i] != 0 else BIG
                          for i in range(2)]
                done = [False] * K
                vis = [False] * K
                hitf = [False] * K
                rec = [None] * K
                ix = iy = 0
                t_prev = F32(0)
                for n0 in range(0, N, 32):
                    # the chunk's 32 crossings: each of the next 32 x and
                    # y crossings placed in the merge by a binary search
                    # over the other progression (y first on a tie)
                    tX = np.array([_fma(F32(ix + i), tdelta[0], tmax0[0])
                                   for i in range(32)], F32)
                    tY = np.array([_fma(F32(iy + i), tdelta[1], tmax0[1])
                                   for i in range(32)], F32)
                    places, taken_x = {}, 0
                    for i in range(32):
                        ys = int(np.searchsorted(tY, tX[i], "right"))
                        xs = int(np.searchsorted(tX, tY[i], "left"))
                        places[i + ys] = (ix + i, iy + ys, tX[i])
                        places[i + xs] = (ix + xs, iy + i, tY[i])
                        taken_x += i + ys < 32
                    chunk = []
                    for j in range(32):
                        cx, cy, t_exit = places[j]
                        vx, vy = v0[0] + st[0] * cx, v0[1] + st[1] * cy
                        chunk.append((vx, vy, t_prev, t_exit,
                                      0 <= vx < X and 0 <= vy < Y))
                        t_prev = t_exit
                    ix, iy = ix + taken_x, iy + 32 - taken_x
                    cnt = 32
                    for j, (vx, vy, _, _, inside) in enumerate(chunk):
                        away = not inside and (
                            (vx < 0 and st[0] < 0) or (vx >= X and st[0] > 0)
                            or (vy < 0 and st[1] < 0)
                            or (vy >= Y and st[1] > 0))
                        if n0 + j >= N or away:
                            cnt = j
                            break
                    # each ring still scanning tests the chunk's crossings
                    for k in range(K):
                        if done[k]:
                            continue
                        dz, zs = dzs[k], zsteps[k]
                        first_hit = last_visit = None
                        for j, (vx, vy, t_in, t_exit, inside) in \
                                enumerate(chunk[:cnt]):
                            zi = int(np.floor(_fma(t_in, dz, z0)))
                            if (zi >= Z) if zs > 0 else (zi < 0):
                                done[k] = True       # never again
                                break
                            if not inside or ((zi < 1 - max_z_sub) if zs > 0
                                              else (zi > Z + max_z_sub - 2)):
                                continue
                            extra = sum(
                                1 for jj in range(1, max_z_sub)
                                if tab[k][zi + jj * zs + (zs < 0) - zlo]
                                < t_exit and dz != 0)
                            z_far = zi + extra * zs
                            zmin, zmax = min(zi, z_far), max(zi, z_far)
                            if max(zmin, 0) > min(zmax, Z - 1):
                                continue
                            lo = min(max(zmin, 0), Z - 1)
                            hi = min(max(zmax, 0), Z - 1)
                            bits = int(cols[g][vx, vy])
                            last_visit = (vx, vy, t_in, t_exit, bits)
                            if bits & (((1 << (hi - lo + 1)) - 1) << lo):
                                first_hit = last_visit
                                break
                        if first_hit is not None:
                            rec[k] = first_hit
                            vis[k] = hitf[k] = done[k] = True
                        elif last_visit is not None:
                            rec[k] = last_visit
                            vis[k] = True
                    if cnt < 32 or all(done):
                        break
                for k in range(K):
                    s, c = F32(0), (0, 0, 0)
                    if vis[k]:
                        h, hs, hz, lok, ls, lz = _subwalk_model(
                            rec[k], z0, dzs[k], zsteps[k], Z, max_z_sub,
                            tab[k], zlo)
                        if hitf[k] and h:
                            hit[g, t, a, k] = True
                            s, c = hs, (rec[k][0], rec[k][1], hz)
                        elif lok:
                            s, c = ls, (rec[k][0], rec[k][1], lz)
                    dist[g, t, a, k] = F32(s * F32(pitch_scale[k]))
                    coord[g, t, a, k] = c
    return dist, coord, hit


def _az(deg):
    a = np.deg2rad(np.asarray(deg, np.float64))
    return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["lidar_fan", "flat_rings_and_cap"])
def test_fan_model_matches_jax(case):
    """The lidar fan's 39 rings (two a lane for seven lanes) at 45-degree
    and axis-aligned azimuths from voxel corners and from origins outside
    the grid moving away; and rings with dz == 0 (and steep ones) under a
    max_xy_steps cap that ends the walk inside a chunk."""
    rng = np.random.RandomState(6)
    occs = (rng.rand(2, 24, 20, 16) < 0.04).astype(np.float32)
    occs[1, :, :, 0] = 1.0
    # around the corner origin (12, 10): the columns a 45-degree ray
    # crosses for no length when it takes y first on the tie are full, the
    # ones it would cross taking x first are empty
    occs[:, 12, [9, 11], :] = 1.0
    occs[:, [11, 13], 10, :] = 0.0
    az = _az([0, 45, 90, 135, 180, 225, 270, 315, 17, 200])
    origins = np.array([[12.0, 10.0, 4.0], [-3.0, 5.0, 7.7],
                        [30.0, -2.0, 15.5], [5.5, 6.5, 16.0]], np.float32)
    if case == "lidar_fan":
        _, dz, scale = fan_parameters(generate_lidar_rays())
        N = 420
    else:
        dz = np.array([0.0, 0.0, -0.3, 0.25, -2.5, 1e-3, -1e-3],
                      np.float32)
        scale = (1.0 / np.cos(np.arctan(dz))).astype(np.float32)
        N = 37
    want = jax_fan(jnp.asarray(occs), jnp.asarray(origins), jnp.asarray(az),
                   jnp.asarray(dz), jnp.asarray(scale), max_xy_steps=N)
    got = _fan_model(occs, origins, az, dz, scale, N, 4)
    _assert_same(tuple(torch.from_numpy(a) for a in got), want)
    assert 0 < got[2].sum() < got[2].size


def test_fan_tables_built_once_and_equal_to_fan_parameters():
    from occnet_tpu_torch.evaluation import ray_metrics as rm
    rays = generate_lidar_rays()
    rm.FAN_TABLES.clear()
    first = rm.FAN_TABLES(rays, 360, "cpu")
    again = rm.FAN_TABLES(rays.copy(), 360, "cpu")
    assert rm.FAN_TABLES.builds == 1
    for a, b, want in zip(first, again, fan_parameters(rays)):
        assert a is b
        np.testing.assert_array_equal(a.numpy(), want)
    sem = torch.full((20, 20, 8), 16, dtype=torch.int32)
    flow = torch.zeros(20, 20, 8, 2)
    origins = np.zeros((2, 3), np.float32)
    kw = dict(voxel_size=0.8, pc_range=(-8, -8, -1, 8, 8, 5.4))
    for _ in range(2):
        rm.render_pred_gt(sem, flow, sem, flow, rays, origins,
                          np.array([True, False]), **kw)
    assert rm.FAN_TABLES.builds == 1


def test_render_kernels_refuse_cpu_tensors_and_oversized_grids():
    from occnet_tpu_torch.data import synthetic as syn
    rig = syn.ring_camera_rig(2, (8, 16))
    tables = syn.scene_tables(rig["R"], rig["t"], rig["K"],
                              syn.class_palette(), (8, 16),
                              (-8, -8, -1, 8, 8, 5.4), 0.8, "cpu")
    labels = torch.zeros(20, 20, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march.render_views_cuda(labels, tables, 16, 40)
    with pytest.raises(ValueError, match="CUDA device"):
        ray_march_vec.fan_render_cuda(
            [labels.int()], [torch.zeros(20, 20, 8, 2)], torch.zeros(1, 3),
            torch.ones(2, 2), torch.ones(3), torch.ones(3), 0.8, 16)
    # a block holds at most 227 KB of packed columns: 400 x 300 columns of
    # 16 bits take 240,000 bytes
    big = torch.zeros(400, 300, 16, dtype=torch.uint8)
    for call in (lambda: ray_march.render_views_cuda(big, tables, 16, 40),
                 lambda: ray_march.dda_raymarch_cuda(
                     big, torch.zeros(2, 3), torch.ones(2, 3), 8)):
        with pytest.raises(ValueError, match="shared memory"):
            call()
    with pytest.raises(ValueError, match="uint8"):
        ray_march.render_views_cuda(labels.int(), tables, 16, 40)
    assert ray_march.check_packed_grid(200, 200, 16, True, "x") == 82304
    assert ray_march.check_packed_grid(200, 200, 32, False, "x") == 160000
    with pytest.raises(ValueError, match="Z=40"):
        ray_march.check_packed_grid(8, 8, 40, False, "x")
    with pytest.raises(ValueError, match="K <= 64"):
        ray_march_vec.fan_render_cuda(
            [labels.int()], [torch.zeros(20, 20, 8, 2)], torch.zeros(1, 3),
            torch.ones(2, 2), torch.ones(65), torch.ones(65), 0.8, 16)


def test_class_ids_u8_refuses_ids_outside_the_palette():
    from occnet_tpu_torch.data import synthetic as syn
    n_cls = len(syn.class_palette())
    sem, _ = syn.make_scene(0, (20, 20, 8))
    got = syn.class_ids_u8(sem, n_cls)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), sem)
    for bad in (n_cls, 256, -1):
        wrong = sem.copy()
        wrong[3, 4, 5] = bad
        with pytest.raises(ValueError, match=f"\\[0, {n_cls}\\)"):
            syn.class_ids_u8(wrong, n_cls)
