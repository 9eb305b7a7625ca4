"""BEV-query sharding over the model axis on the CPU: the port's sharded
step against its unsharded step and against JAX's `make_train_step`.

In process (no group): the row-range lift and its backward against the
whole lift's rows (and its transposed index's premise on the rows), the
halo'd tap attention and its backward against the unsharded op's rows
(both bitwise), and both against the JAX package's lift and tap.

Two gloo launches under torchrun (`tests/_torch_qshard_worker.py`, one
torch thread a rank, a hard timeout): dp = 1 x mp = 2 and dp = 2 x mp = 2,
each with the dense (`tiny_turbo_occ`) and the gather (`tiny_occ`) encoder
at 64 channels, fp32, a 10 x 10 BEV, 2 layers and 3 cameras:

- with dropout at the config's 0.1 and the grid mask on, the dp = 1 step
  against the port's single-process B = 1 step (a sharded step draws the
  unsharded step's masks), the dp = 2 step against the launch's step with
  the model axis replicated (a single process cannot draw the two data
  ranks' dropout streams);
- with nothing random, against the port's single-process B = 1 / B = 2
  step and against JAX's unsharded `make_train_step` at the same B (the
  function JAX's Q-sharded step computes);
- gather mode with a static top-K below the visible count: the sharded
  certificate equals the unsharded one, exactly;
- the sharded forward with a prev BEV, both modes, and the temporal clip
  step at mp = 2.

And the soak report (`tools.soak_report`) against the JAX package's tool.

The launches start with the module's first test and run while the test
process builds its references."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.ops.planar_lift import lift_and_average as jax_lift
from occnet_tpu.ops.tsa_pallas import tap_attention_xla
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu.training.train import make_train_step as jax_train_step
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.ops import lift_cuda, planar_lift
from occnet_tpu_torch.ops.tsa import tap_attention
from occnet_tpu_torch.parallel.qshard import QShard
from occnet_tpu_torch.training.train import lr_mult
from _torch_threads import one_torch_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _torch_qshard_worker as worker  # noqa: E402
from test_torch_lift import (IMG_HW, PC_RANGE, _feats,  # noqa: E402
                             _ring_cameras)
from test_torch_tap import _case  # noqa: E402

LAUNCH_TIMEOUT_S = 600   # the launches share the CPU with the rest of the suite
# the port's sharded step against its unsharded step: the same fp32
# operations, some sums in another order (tests/test_torch_parallel.py's
# world-2 bounds)
LOSS_RTOL, LEAF_RTOL, UPDATE_L2, STATS_RTOL = 1e-5, 1e-4, 1e-3, 1e-6
# ... but in dense mode the lift returns its feature gradient in bf16, as the
# JAX package does (and as JAX's own Q-sharded step, whose partitioned lift
# sums bf16 partials, does too), so each shard's part is rounded to bf16
# before the parts are summed: the one op that is not the unsharded step's.
# The leaves upstream of the lift (trunk, FPN, shared value projection,
# camera and level embeddings) take that rounding (2^-8 relative, measured
# at most 2.1e-3 of a leaf's max) and are held to 1e-2; every leaf after
# the lift stays at LEAF_RTOL.
LIFT_UPSTREAM = worker.LIFT_UPSTREAM
UPSTREAM_RTOL = 1e-2
# their first AdamW update, g / (|g| + 1e-8) elementwise, flips where a
# gradient element near 0 changes sign: measured 2.5 % in L2, held to 5 %
UPSTREAM_UPDATE_L2 = 5e-2
# against JAX's step: tests/test_torch_train.py's whole-step bounds (and
# tests/test_torch_train_exact.py's L2 bound for the gather trunk)
JAX_LOSS_RTOL, JAX_GRAD_RTOL, TRUNK_L2_RTOL = 1e-3, 5e-2, 0.1


class Launch:
    def __init__(self, tmp, n):
        self.out = str(tmp)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   OCCNET_DIST_TIMEOUT_S="600")
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.n = n
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n),
             os.path.join(HERE, "_torch_qshard_worker.py"), self.out],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._res = None

    def kill(self):
        """End the launch: torchrun stops its ranks on SIGTERM (a SIGKILL
        would leave them holding the output pipe until their collectives
        time out)."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return ""

    def result(self):
        if self._res is None:
            try:
                log = self.proc.communicate(timeout=LAUNCH_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                log = self.kill()
                pytest.fail(f"the {self.n}-rank launch timed out:\n"
                            + log[-3000:])
            assert self.proc.returncode == 0, log[-3000:]
            self._res = [torch.load(os.path.join(self.out, f"rank{r}.pt"),
                                    weights_only=False)
                         for r in range(self.n)]
        return self._res


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    runs = {dp: Launch(tmp_path_factory.mktemp(f"qshard{dp}"), 2 * dp)
            for dp in (1, 2)}
    yield runs
    for run in runs.values():
        run.kill()


# ---------------------------------------------------------------- in process

LIFT_HW, LIFT_BEV, LIFT_Z = IMG_HW, (12, 14), 4
ROW_RANGES = [(0, 6), (6, 12), (3, 8)]


def _lift_inputs():
    return _feats(np.random.RandomState(2)), _ring_cameras(yaw0=0.3)


def _lift(feats, e2i, rows=None):
    fs = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    u, c = planar_lift.lift_and_average(
        fs, torch.from_numpy(e2i), PC_RANGE, LIFT_Z, LIFT_BEV, LIFT_HW,
        rows=rows)
    return fs, u, c


@pytest.mark.usefixtures("launches")
@pytest.mark.parametrize("rows", ROW_RANGES)
def test_row_range_lift_is_the_whole_lifts_rows(rows):
    """The lift of BEV rows [r0, r1) against the whole lift: U_bar and the
    count bitwise the whole lift's queries r0 * bev_w .. r1 * bev_w - 1;
    its feature gradient bitwise the whole lift's gradient for an upstream
    gradient zero outside those rows; each plane's transposed backward
    index (`lift_bwd_index`) bitwise the whole index's plane, its premise
    (one monotone run of pos2 a plane) holding on the rows."""
    feats, e2i = _lift_inputs()
    bw = LIFT_BEV[1]
    q = slice(rows[0] * bw, rows[1] * bw)
    fs, u, c = _lift(feats, e2i)
    fr, ur, cr = _lift(feats, e2i, rows)
    assert ur.shape == (1, 2, LIFT_Z, q.stop - q.start, 16)
    assert torch.equal(ur, u[:, :, :, q]) and torch.equal(cr, c[:, q])
    g = torch.from_numpy(np.random.RandomState(3).randn(
        *u.shape).astype(np.float32)).to(u.dtype)
    g_rows = torch.zeros_like(g)
    g_rows[:, :, :, q] = g[:, :, :, q]
    (u.float() * g_rows.float()).sum().backward()
    (ur.float() * g[:, :, :, q].float()).sum().backward()
    for a, b in zip(fr, fs):
        assert torch.equal(a.grad, b.grad)
    z = torch.from_numpy(planar_lift.z_anchors(PC_RANGE, LIFT_Z))
    H = planar_lift.plane_homographies(torch.from_numpy(e2i), PC_RANGE, z,
                                       LIFT_BEV)
    for f in feats:
        h, w = f.shape[2:4]
        Ml = planar_lift.feature_homographies(H, h, w, LIFT_HW)
        whole = planar_lift.level_geometry(Ml, LIFT_BEV, h, w)
        part = planar_lift.level_geometry(Ml, LIFT_BEV, h, w, rows=rows)
        idx = lift_cuda.lift_bwd_index(*whole[:3], (h, w))
        idx_r = lift_cuda.lift_bwd_index(*part[:3], (h, w))
        assert int(idx_r.excess[0]) == 0
        R = rows[1] - rows[0]
        runs = idx.runs.reshape(1, 3, w + h, LIFT_Z, LIFT_BEV[0], 2)
        assert torch.equal(idx_r.runs.reshape(1, 3, w + h, LIFT_Z, R, 2),
                           runs[:, :, :, :, rows[0]:rows[1]])


def test_row_range_lifts_sum_to_the_whole_gradient():
    """The shards' feature gradients (two row ranges covering the BEV) sum
    to the whole lift's within one bf16 rounding of its max (2^-8): the
    lift returns its feature gradient in bf16, as the JAX package does, so
    each shard's part is rounded before the parts are summed (the one op
    that is not bitwise)."""
    feats, e2i = _lift_inputs()
    fs, u, _ = _lift(feats, e2i)
    g = torch.from_numpy(np.random.RandomState(4).randn(
        *u.shape).astype(np.float32)).to(u.dtype)
    (u.float() * g.float()).sum().backward()
    total = [torch.zeros_like(f.grad, dtype=torch.float32) for f in fs]
    bw = LIFT_BEV[1]
    for rows in ROW_RANGES[:2]:
        q = slice(rows[0] * bw, rows[1] * bw)
        fr, ur, _ = _lift(feats, e2i, rows)
        (ur.float() * g[:, :, :, q].float()).sum().backward()
        for t, f in zip(total, fr):
            t += f.grad.float()
    for t, f in zip(total, fs):
        scale = f.grad.float().abs().max().item()
        assert scale > 0
        assert (t - f.grad.float()).abs().max().item() <= 2 ** -8 * scale


def test_row_range_lift_matches_jax_rows():
    """The row-range lift against JAX's lift (`planar_lift.lift_and_average`)
    on the same rows: the count exactly, U_bar within tests/test_torch_
    lift.py's bf16 bound (0.05)."""
    feats, e2i = _lift_inputs()
    ref_u, ref_c = jax_lift([jnp.asarray(f) for f in feats],
                            jnp.asarray(e2i), PC_RANGE, LIFT_Z, LIFT_BEV,
                            LIFT_HW)
    bw = LIFT_BEV[1]
    for rows in ROW_RANGES:
        q = slice(rows[0] * bw, rows[1] * bw)
        _, ur, cr = _lift(feats, e2i, rows)
        np.testing.assert_array_equal(cr.numpy(), np.asarray(ref_c)[:, q])
        d = np.abs(ur.detach().float().numpy()
                   - np.asarray(ref_u, np.float32)[:, :, :, q])
        assert d.max() < 0.05, d.max()


class _InProcessShard(QShard):
    """A `QShard` whose neighbour rows come from the whole tensors (the
    value grid, the attention and the gradient, told apart by rank), as
    the group's other ranks would send them."""

    def __init__(self, mp, rank, bev_h, bev_w, whole):
        super().__init__(mp, rank, None, bev_h, bev_w)
        object.__setattr__(self, "whole", whole)

    def neighbour_rows(self, x, dim):
        full = self.whole[x.ndim]
        r0, r1 = self.rows
        zero = torch.zeros_like(full.narrow(dim, 0, 1))
        above = full.narrow(dim, r0 - 1, 1) if r0 > 0 else zero
        below = full.narrow(dim, r1, 1) if r1 < self.bev_h else zero
        return above.to(x.dtype), below.to(x.dtype)


def _tap_case(seed=0):
    """tests/test_torch_tap.py's case on an 8 x 9 grid, 4 heads of 16, and
    an output gradient."""
    v, attn = _case(H=8, W=9, D=16, seed=seed)
    g = np.random.RandomState(seed + 100).randn(*v.shape[:1], *v.shape[2:])
    return (torch.from_numpy(v), torch.from_numpy(attn),
            torch.from_numpy(g.astype(np.float32)))


@pytest.mark.parametrize("mp", [2, 4])
def test_halo_tap_is_the_unsharded_taps_rows(mp):
    """The halo'd tap (plain version) of each of mp row blocks against the
    unsharded tap: the output, dvalue and dattn of the block's rows
    bitwise (each rank computes its rows' sums whole, the neighbours' edge
    rows in place of the zero padding)."""
    v, attn, g = _tap_case()
    vf = v.clone().requires_grad_(True)
    af = attn.clone().requires_grad_(True)
    out = tap_attention(vf, af)
    (out * g).sum().backward()
    H, W = v.shape[2], v.shape[3]
    for rank in range(mp):
        shard = _InProcessShard(mp, rank, H, W, {5: v, 6: attn, 4: g})
        r0, r1 = shard.rows
        vl = v[:, :, r0:r1].clone().requires_grad_(True)
        al = attn[:, r0:r1].clone().requires_grad_(True)
        ol = shard.halo_tap(vl, al)
        assert torch.equal(ol, out[:, r0:r1])
        (ol * g[:, r0:r1]).sum().backward()
        assert torch.equal(vl.grad, vf.grad[:, :, r0:r1])
        assert torch.equal(al.grad, af.grad[:, r0:r1])


def test_halo_tap_matches_jax_tap_rows():
    """The halo'd tap's rows against JAX's `tap_attention_xla` on the
    whole grid, within tests/test_torch_tap.py's fp32 bound (1e-5)."""
    v, attn, g = _tap_case(seed=1)
    ref = np.asarray(tap_attention_xla(jnp.asarray(v.numpy()),
                                       jnp.asarray(attn.numpy())))
    H, W = v.shape[2], v.shape[3]
    for rank in range(2):
        shard = _InProcessShard(2, rank, H, W, {5: v, 6: attn, 4: g})
        r0, r1 = shard.rows
        got = shard.halo_tap(v[:, :, r0:r1], attn[:, r0:r1])
        np.testing.assert_allclose(got.numpy(), ref[:, r0:r1], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------- the launches

def _rel_l2(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


@pytest.fixture(scope="module")
def jax_steps(launches):
    """JAX's unsharded `make_train_step` at B = dp for each (dp, mode) of
    the deterministic runs, built while the launches run: {(dp, mode):
    (metrics, gradients)}.  JAX's lift runs at the port's rounding points
    (tests/test_torch_train.py's `jax_lift_at_port_rounding`, applied here
    for the module's fixture)."""
    from occnet_tpu.ops import planar_lift as jax_planar_lift
    lift, warp = (jax_planar_lift.lift_and_average,
                  jax_planar_lift.warp_level_multi_z)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_planar_lift, "warp_level_multi_z", lambda *a, **k:
                   warp(*a, band_dtype=jnp.float32, **k))
        mp.setattr(jax_planar_lift, "lift_and_average", lambda feats, *a, **k:
                   lift([f.astype(jnp.bfloat16).astype(f.dtype)
                         for f in feats], *a, **k))
        for dp in (1, 2):
            for mode in worker.MODES:
                cfg = worker.qshard_cfg(mode, False)
                jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
                    cfg.model, bev_shard_axis=""))
                v = randomize_variables(init_jax_style_variables(
                    cfg, seed=3), seed=4)
                batch = worker.global_batch(cfg, dp)
                batch["voxel_semantics"] = batch["voxel_semantics"].astype(
                    np.int32)
                params = jax.tree_util.tree_map(jnp.asarray, v["params"])
                js = JaxTrainState(
                    step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                       v["batch_stats"]),
                    opt_state=jax_optimizer(jcfg, params).init(params))
                js2, jmet = jax.jit(jax_train_step(
                    jcfg, JaxOccNet(jcfg.model)))(
                    js, {k: jnp.asarray(x) for k, x in batch.items()},
                    jax.random.PRNGKey(0))
                out[dp, mode] = (
                    {k: float(x) for k, x in jmet.items()},
                    from_jax_variables({"params": jax.tree_util.tree_map(
                        lambda mu: np.asarray(mu) / np.float32(0.1),
                        js2.opt_state[1].mu)}))
    return out


@pytest.mark.parametrize("mode", worker.MODES)
@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_step_matches_jax_step(launches, jax_steps, dp, mode):
    """JAX's unsharded `make_train_step` at B = dp on the same weights and
    batch (nothing random, no clipping) against the sharded step: loss
    within 1e-3, every gradient within 5e-2 of its max (JAX's from its
    first Adam moment, mu = 0.1 g), the gather trunk's leaves within 0.1
    in L2 (tests/test_torch_train_exact.py's bounds), frozen leaves
    without gradient."""
    cfg = worker.qshard_cfg(mode, False)
    jmet, jgrads = jax_steps[dp, mode]
    got = _ranks_agree(launches[dp].result(), f"{mode}_det")
    np.testing.assert_allclose(got["metrics"]["loss"], jmet["loss"],
                               rtol=JAX_LOSS_RTOL)
    assert got["metrics"]["cert_overflow"] == jmet["cert_overflow"] == 0
    for n, ref in jgrads.items():
        if lr_mult(n, cfg) == 0.0:
            assert n not in got["grads"] and not ref.any(), n
            continue
        g = got["grads"][n]
        if mode == "gather" and n.startswith("backbone."):
            assert _rel_l2(g, ref) <= TRUNK_L2_RTOL, (n, _rel_l2(g, ref))
        else:
            err = (g - ref).abs().max().item()
            assert err <= JAX_GRAD_RTOL * max(ref.abs().max().item(),
                                              1e-12), (n, err)



def _ranks_agree(ranks, key, part="step"):
    """Every rank's run ``key``: parameters (and buffers) bitwise rank 0's
    and the same metrics; returns rank 0's record."""
    for r in ranks:
        assert r[part][key]["differ"] == 0, key
        assert r[part][key]["metrics"] == ranks[0][part][key]["metrics"]
    return ranks[0][part][key]


def _held(d):
    """A run's `distance` from its reference within the bounds: losses
    LOSS_RTOL, every leaf LEAF_RTOL of its max (the dense lift's upstream
    leaves UPSTREAM_RTOL), the first update UPDATE_L2 in L2 (upstream
    leaves UPSTREAM_UPDATE_L2), BN statistics STATS_RTOL, the same
    certificate and the same leaves with a gradient."""
    for k, e in d["loss"].items():
        assert e <= LOSS_RTOL, (k, e)
    assert d["cert"][0] == d["cert"][1]
    assert d["grad_names"][0] == d["grad_names"][1]
    assert set(d["upstream"]) <= {n for n in d["leaf"]
                                  if n.startswith(LIFT_UPSTREAM)}
    for n, e in d["leaf"].items():
        tol = UPSTREAM_RTOL if n in d["upstream"] else LEAF_RTOL
        assert e <= tol, (n, e)
    assert d["update"] <= UPDATE_L2, d["update"]
    assert d["update_upstream"] <= UPSTREAM_UPDATE_L2, d["update_upstream"]
    assert d["stats"] <= STATS_RTOL, d["stats"]


@pytest.mark.parametrize("mode", worker.MODES)
@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_step_equals_the_unsharded_step(launches, dp, mode):
    """The sharded step (bev_shard_axis = "model", mp = 2) against the
    unsharded step on the same weights and global batch: with dropout and
    grid mask (dp = 1: the unsharded B = 1 step; dp = 2: the launch's
    replicated-model-axis step) and with nothing random (the unsharded
    B = dp step), within `_held`'s bounds.  Ranks bitwise equal; the mesh
    places rank r at (r // 2, r % 2)."""
    ranks = launches[dp].result()
    assert [r["mesh"] for r in ranks] == [
        (dp, 2, r // 2, r % 2) for r in range(2 * dp)]
    drop = _ranks_agree(ranks, f"{mode}_drop")
    det = _ranks_agree(ranks, f"{mode}_det")
    if dp > 1:
        _ranks_agree(ranks, f"{mode}_drop_replicated")
    _held(drop["vs"])
    _held(det["vs"])
    # dropout did reach the step: the deterministic step's loss differs
    assert drop["metrics"]["loss"] != det["metrics"]["loss"]
    assert (mode == "dense") == bool(det["vs"]["upstream"])


def test_sharded_gather_certificate_is_the_unsharded_one(launches):
    """A static top-K below the visible count of two cameras: the sharded
    step's `cert_overflow` equals the unsharded step's, exactly, and is
    nonzero (each shard compacts its own queries, but the overflow is
    taken from the visible counts summed over the model group)."""
    got = _ranks_agree(launches[1].result(), "gather_overflow")
    sharded, unsharded = got["vs"]["cert"]
    assert unsharded > 0 and sharded == unsharded
    assert got["metrics"]["cert_overflow"] == unsharded


@pytest.mark.parametrize("mode", worker.MODES)
def test_sharded_forward_with_prev_bev(launches, mode):
    """The sharded model's BEV with a prev BEV and a shifted TSA reference
    (train mode: grid mask and dropout drawn from one seed) against the
    unsharded model's: the whole BEV on every rank, within 1e-5 of its max
    (the same fp32 operations on a block of rows)."""
    ranks = launches[1].result()
    cfg = worker.qshard_cfg(mode)
    m = cfg.model
    for r in ranks:
        assert r["prev"][mode]["shape"] == (1, m.bev_h * m.bev_w,
                                            m.embed_dims)
    assert ranks[0]["prev"][mode]["err"] <= 1e-5


@pytest.mark.parametrize("mode", worker.MODES)
def test_sharded_temporal_clip_step(launches, mode):
    """The temporal clip step at dp = 1 x mp = 2 (the history frame and the
    supervised frame sharded) against the unsharded clip step, within
    `_held`'s bounds; ranks bitwise equal."""
    got = _ranks_agree(launches[1].result(), mode, "clip")
    _held(got["vs"])


def test_soak_report_matches_the_jax_tool(tmp_path):
    """`tools.soak_report` on a synthetic `metrics.jsonl` (the train CLI's
    events: 12 train logs with a drifting s/it and a certificate, two
    evals with a NaN score, an "hbm" event and an abort) plus three
    ``ckpt_<step>.pt`` files: every key but ``checkpoints`` equals what the
    JAX package's `tools/soak_report.py` (run as a subprocess) writes for
    the same events; ``checkpoints`` are the manager's steps (the JAX tool
    scans for digit-named directories, of which a port run has none)."""
    from occnet_tpu_torch.tools import soak_report
    from occnet_tpu_torch.training.checkpoint import CheckpointManager
    from occnet_tpu_torch.utils.events import JsonlWriter
    work = tmp_path / "soak_turbo"
    rng = np.random.RandomState(0)
    with JsonlWriter(str(work / "metrics.jsonl")) as ev:
        for i in range(12):
            ev.write(i * 10, s_per_it=0.5 + 0.01 * i + rng.rand() * 1e-3,
                     loss=4.0 / (i + 1), grad_norm=1.0,
                     cert_overflow=float(i == 7))
            if i in (5, 11):
                ev.write(i * 10 + 1, tag="eval", RayIoU=0.1 * i,
                         mAVE=float("nan"), OccScore=float("nan"))
        ev.write(120, tag="hbm", peak_bytes_in_use=12_345_678_901,
                 source="torch.cuda.max_memory_allocated")
        ev.write(121, tag="abort", loss=1.0)
    for step in (40, 80, 120):
        (work / f"ckpt_{step}.pt").write_bytes(b"")
    out = tmp_path / "jax.json"
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "soak_report.py"),
                        str(work), "--out", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        want = json.load(f)
    got = soak_report.main([str(work), "--out", str(tmp_path / "t.json")])
    assert got.keys() == want.keys()
    for k in want:
        if k != "checkpoints":
            assert json.dumps(got[k]) == json.dumps(want[k]), k
    assert want["checkpoints"] == []
    mngr = CheckpointManager(str(work))
    assert got["checkpoints"] == mngr.all_steps() == [40, 80, 120]
    mngr.close()
    assert got["aborts"] == 1 and got["cert_overflow_total"] == 1
    with open(tmp_path / "t.json") as f:
        assert json.dumps(json.load(f)) == json.dumps(got)


class _Gathered(Exception):
    pass


def test_eval_hook_merges_the_data_ranks_frames_in_order(monkeypatch):
    """The eval hook's split over dp = 2 x mp = 2 ranks (`training.
    eval_loop.merge_frame_counts` with model rank 0 of each data rank): 5
    frames' counts in blocks of 3 and 2 over the data ranks, each rank's
    tree gathered (`allgather_host`, played here by stacking the four
    ranks' trees), and every rank's accumulator bitwise the single-process
    one (frames added in order, the padding left out)."""
    from occnet_tpu_torch import parallel
    from occnet_tpu_torch.evaluation.ray_metrics import RayMetricAccumulator
    from occnet_tpu_torch.training import eval_loop
    rng = np.random.RandomState(8)
    acc = RayMetricAccumulator()
    frames = [{"gt_cnt": rng.randint(0, 99, acc.gt_cnt.shape),
               "pred_cnt": rng.randint(0, 99, acc.pred_cnt.shape),
               "tp_cnt": rng.randint(0, 99, acc.tp_cnt.shape),
               "ave_sum": rng.rand(*acc.ave_sum.shape) * 1e3,
               "ave_cnt": rng.randint(0, 99, acc.ave_cnt.shape)}
              for _ in range(5)]
    for f in frames:
        acc.update_counts(f)
    per = 3
    kept = [frames[(r // 2) * per:(r // 2 + 1) * per] for r in range(4)]
    trees = []

    def record(tree):
        trees.append(tree)
        raise _Gathered

    def merge(into, k):
        eval_loop.merge_frame_counts(into, k, per, 4, range(0, 4, 2))

    monkeypatch.setattr(parallel, "allgather_host", record)
    for k in kept:
        with pytest.raises(_Gathered):
            merge(RayMetricAccumulator(), k)
    world = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    monkeypatch.setattr(parallel, "allgather_host", lambda tree: world)
    for k in kept:
        got = RayMetricAccumulator()
        merge(got, k)
        assert got.num_samples == 5
        for name in eval_loop.COUNT_KEYS:
            assert np.array_equal(getattr(got, name), getattr(acc, name))
