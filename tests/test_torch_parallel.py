"""Data-parallel training and evaluation of the port over torch.distributed,
on the CPU: ONE 2-rank gloo launch (`tests/_torch_parallel_worker.py`
under torchrun, B = 1 a rank) against the port's single-process B = 2 step
and JAX's `make_train_step` at B = 2 on the same weights and global batch.

- the decoder's BatchNorm3d and the trunk's TrainableBatchNorm on one
  sample a rank: the B = 2 call's output, gradients and running statistics
  (1e-5);
- the world-2 train step with the trunk's BN frozen (the config default)
  and the decoder BN: loss and grad norm within 1e-5 relative of the
  B = 2 step, every leaf's gradient within 1e-4 of its max, the first
  update within 1e-3 in L2, BN statistics within 1e-6, the ranks'
  parameters and buffers bitwise equal;
- with the trunk's BN trainable: the loss within 1e-5, statistics within
  1e-4, every leaf within 0.1 in L2 of the B = 2 step (fp32 does not
  determine a train-mode trunk's gradients at this size more closely, see
  the test); against JAX's B = 2 step within tests/test_torch_train.py's
  whole-step bounds;
- with grid mask and photometric distortion on, each rank's images after
  both are bitwise the B = 2 step's slice;
- the weighted / masked losses on labels whose per-rank weight sums
  differ: the ranks' shares average to the B = 2 loss, and the averaged
  logits gradient is the B = 2 gradient's slice;
- `allgather_host` of int64 beyond 2^31, float64 and bool, exact;
- `CheckpointManager`: rank 0 writes, 3 of 4 checkpoints kept, both ranks
  restore, metadata;
- `tools.test --distributed --eval --format-only` on the one-scene
  miniset (3 frames over 2 ranks of 2: the last shard is one frame short):
  counts bitwise equal to the single-process CLI's, the merged submission
  equal to its submission; with `--video`, rank 1 starts frame 2 on a
  fresh history, and the merged submission holds each frame once, as its
  own rank predicted it.

The launch starts at the first test and runs while the test process builds
its references; it has a hard timeout.  Both run one CPU thread
(`one_torch_thread`): the single-process CLI is compared bitwise with the
ranks, and CPU reductions split by the thread count."""

import dataclasses
import gzip
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu.training.train import make_train_step as jax_train_step
from occnet_tpu_torch import config
from occnet_tpu_torch.config import LossConfig
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.models.head import occ_flow_loss
from occnet_tpu_torch.tools import test as test_cli
from occnet_tpu_torch.training.train import (create_train_state,
                                             make_train_step)
from _torch_threads import one_torch_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _torch_parallel_worker as worker  # noqa: E402
from test_cli import _write_miniset  # noqa: E402
from test_torch_train import (jax_lift_at_port_rounding,  # noqa: E402,F401
                              small_cfg)

LAUNCH_TIMEOUT_S = 600   # the launch shares the CPU with the rest of the suite


class Launch:
    """The running torchrun launch and its inputs; `result()` waits for it
    (killing it past the timeout) and loads both ranks' outputs."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.root = str(tmp / "data")
        cfg = config.apply_overrides(config.tiny_occ(), dict(
            kv.split("=", 1) for kv in worker.CLI_SMALL))
        m = cfg.model
        _write_miniset(self.root, 3, (m.img_h, m.img_w),
                       grid=(m.bev_w, m.bev_h, m.pillar_h))
        self.ckpt = str(tmp / "ckpt.pt")
        torch.save({"step": 0, "model": from_jax_variables(
            randomize_variables(init_jax_style_variables(cfg, seed=0),
                                seed=1))}, self.ckpt)
        self.out = str(tmp / "out")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   OCCNET_DIST_TIMEOUT_S="600")
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2",
             os.path.join(HERE, "_torch_parallel_worker.py"), self.out,
             self.root, self.ckpt],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._res = None

    def result(self):
        if self._res is None:
            try:
                log = self.proc.communicate(timeout=LAUNCH_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                self.proc.kill()
                log = self.proc.communicate()[0]
                pytest.fail("the 2-rank launch timed out:\n" + log[-3000:])
            assert self.proc.returncode == 0, log[-3000:]
            self._res = [torch.load(os.path.join(self.out, f"rank{r}.pt"),
                                    weights_only=False) for r in (0, 1)]
        return self._res


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    run = Launch(tmp_path_factory.mktemp("parallel"))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


def test_worker_configs_are_the_train_tests():
    assert dataclasses.asdict(worker.small_cfg(False, -1)) == \
        dataclasses.asdict(small_cfg(False, -1))
    assert dataclasses.asdict(worker.small_cfg(False, -1, False)) == \
        dataclasses.asdict(small_cfg(False, -1, False))


@pytest.fixture(scope="module")
def single_cli(launch, tmp_path_factory):
    """The single-process test CLI on the launch's miniset and checkpoint:
    (its summary, its submission)."""
    tmp = tmp_path_factory.mktemp("single_cli")
    single = test_cli.main(worker.cli_args(
        launch.root, launch.ckpt, str(tmp / "work"), str(tmp / "sub.gz"),
        "--eval"))
    return single, _load(str(tmp / "sub.gz"))


def _load(path):
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def single_b2():
    """The port's single-process step on the B = 2 global batch for each of
    the worker's STEP_CFGS: {key: (initial state_dict, state after the
    step, metrics)}."""
    runs = {}
    for key, args in worker.STEP_CFGS.items():
        cfg = worker.small_cfg(*args)
        sd = worker.initial_state_dict(cfg)
        state = create_train_state(cfg, sd, "cpu")
        batch = {k: torch.from_numpy(a)
                 for k, a in worker.global_batch(cfg).items()}
        runs[key] = (sd, state, make_train_step(cfg)(state, batch))
    return runs


# the single-process references are built while the launch runs
@pytest.mark.usefixtures("single_cli", "single_b2")
def test_world2_step_matches_jax_b2_step(launch, jax_lift_at_port_rounding):
    """JAX's `make_train_step` on the B = 2 global batch against the world-2
    step, within tests/test_torch_train.py's whole-step bounds: loss 1e-3,
    batch statistics 1e-3, and the gradients of a step with train-mode BN
    in relative L2 to 0.1.  With the trunk's BN in train mode at B = 2,
    fp32 does not determine the head's gradients to 5 % of their maximum
    either (the port's own fp32 and float64 gradients differ by up to
    5.4 % of max|g| on `head.bev_embedding`, measured), so every leaf is
    held in L2, as that test holds the trunk's."""
    cfg = worker.small_cfg(False, -1)
    v = randomize_variables(init_jax_style_variables(cfg, seed=3), seed=4)
    batch = worker.global_batch(cfg)
    batch["voxel_semantics"] = batch["voxel_semantics"].astype(np.int32)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, v["batch_stats"]),
                       opt_state=jax_optimizer(cfg, params).init(params))
    js2, jmet = jax.jit(jax_train_step(cfg, JaxOccNet(cfg.model)))(
        js, {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(0))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / np.float32(0.1), js2.opt_state[1].mu)})
    jstats = from_jax_variables({"params": {},
                                 "batch_stats": js2.batch_stats})
    got = launch.result()[0]["step"]["trainable_bn"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(jmet["loss"]),
                               rtol=1e-3)
    assert got["metrics"]["cert_overflow"] == 0
    assert got["grads"].keys() == jgrads.keys()
    for n, g in got["grads"].items():
        ref = jgrads[n]
        err = (g - ref).norm().item()
        assert err <= 0.1 * ref.norm().item(), (n, err)
    for n, b in got["buffers"].items():
        np.testing.assert_allclose(b.numpy(), jstats[n].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=n)


@pytest.mark.parametrize("name", ["bn3d", "trainable"])
def test_world2_norms_take_global_batch_statistics(launch, name):
    """The decoder's BatchNorm3d and the trunk's TrainableBatchNorm in train
    mode on one sample a rank against the B = 2 call: output, input
    gradient (through the differentiable all-reduce), weight and bias
    gradients summed over the ranks and running statistics, 1e-5."""
    bn, x, g = worker.norm_inputs(name)
    want = worker.norm_step(bn, x, g)
    res = launch.result()
    for r in (0, 1):
        got = res[r]["norms"][name]
        for k in ("y", "dx"):
            torch.testing.assert_close(got[k], want[k][r:r + 1], rtol=1e-5,
                                       atol=1e-5 * want[k].abs().max().item(),
                                       msg=f"{k} rank {r}")
        for k in ("dw", "db", "mean", "var"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, msg=f"{k} rank {r}")


def _rel_max(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _rel_l2(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def _whole(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _world2_and_b2(launch, single_b2, key):
    """(rank 0's world-2 step, the B = 2 step's initial state_dict,
    parameters and metrics) for the config ``key``; the ranks' metrics,
    parameters and buffers bitwise equal."""
    res = launch.result()
    assert res[0]["world"] == 2
    got = res[0]["step"][key]
    assert got["differ"] == res[1]["step"][key]["differ"] == 0
    assert res[1]["step"][key]["metrics"] == got["metrics"]
    sd, state, met = single_b2[key]
    return got, sd, dict(state.model.named_parameters()), \
        dict(state.model.named_buffers()), met


def test_world2_step_equals_single_process_b2_step(launch, single_b2):
    """The world-2 step with the trunk's BN frozen (stage 1 frozen too, as
    the configs train) against the port's single-process B = 2 step: loss
    and grad norm within 1e-5 relative, every leaf's gradient within 1e-4
    of its max |g| (the same leaves get one: the frozen stage none), the
    BN running statistics within 1e-6 of their max.  The first AdamW
    update is held in L2 over all leaves, to 1e-3: an update element is
    g / (|g| + 1e-8), so where |g| is near that eps an absolute gradient
    difference of 1e-9 (1e-6 of the leaf's max) moves it by 10 % of the
    leaf's largest update, and a per-leaf max bound says nothing."""
    got, sd, p0, b0, met = _world2_and_b2(launch, single_b2, "frozen_bn")
    for k in ("loss", "loss_occ", "loss_flow", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], float(met[k]),
                                   rtol=1e-5, err_msg=k)
    assert got["grads"].keys() == {n for n, p in p0.items()
                                   if p.grad is not None}
    assert len(got["grads"]) < len(p0)          # the frozen stage
    for n, g in got["grads"].items():
        assert _rel_max(g, p0[n].grad) <= 1e-4, (n, _rel_max(g, p0[n].grad))
    names = list(got["grads"])
    err = _rel_l2(_whole(got["params"][n] - sd[n] for n in names),
                  _whole(p0[n].detach() - sd[n] for n in names))
    assert err <= 1e-3, err
    for n, b in b0.items():
        if b.is_floating_point():
            assert _rel_max(got["buffers"][n], b) <= 1e-6, n


def test_world2_trainable_bn_step_is_the_b2_step(launch, single_b2):
    """The world-2 step with the trunk's BN trainable (the JAX comparison's
    config) against the port's B = 2 step: loss within 1e-5 relative, BN
    running statistics within 1e-4 of their max, grad norm within 1e-3,
    every leaf within 0.1 in relative L2 (tests/test_torch_train.py's
    bound for train-mode trunks).  Train-mode BN over the deep stages'
    few pixels a sample makes these fp32 gradients ill-conditioned: the
    same global step with the samples swapped, or on B = 1 shapes, moves
    trunk leaves by percents of their max, while with the trunk's BN
    frozen every leaf agrees within the other test's 1e-4."""
    got, sd, p0, b0, met = _world2_and_b2(launch, single_b2,
                                          "trainable_bn")
    for k in ("loss", "loss_occ", "loss_flow"):
        np.testing.assert_allclose(got["metrics"][k], float(met[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               float(met["grad_norm"]), rtol=1e-3)
    assert got["grads"].keys() == {n for n, p in p0.items()
                                   if p.grad is not None}
    for n, g in got["grads"].items():
        assert _rel_l2(g, p0[n].grad) <= 0.1, (n, _rel_l2(g, p0[n].grad))
    for n, b in b0.items():
        if b.is_floating_point():
            assert _rel_max(got["buffers"][n], b) <= 1e-4, n


def test_world2_draws_are_the_b2_draws_slices(launch):
    """Grid mask and photometric distortion on (deterministic=False): each
    rank's backbone input is bitwise the B = 2 step's slice."""
    seen = worker.backbone_input({k: torch.from_numpy(a) for k, a in
                                  worker.images_batch().items()})
    n_cam = worker.small_cfg().model.num_cams
    res = launch.result()
    for r in (0, 1):
        assert torch.equal(res[r]["images"],
                           seen[r * n_cam:(r + 1) * n_cam]), r
    # the distortion and the mask did change the images
    assert not torch.equal(res[0]["images"], res[1]["images"])


@pytest.mark.parametrize("branch", sorted(worker.LOSS_BRANCHES))
def test_world2_loss_normalisers_are_global(launch, branch):
    """The ranks' loss shares average to the B = 2 loss (1e-6 relative) and
    their averaged logits gradients are the B = 2 gradient's slices (1e-6
    of its max), on labels whose per-rank weight sums differ."""
    logits, flow, sem, gt_flow, mask = (torch.from_numpy(np.ascontiguousarray(
        a)) for a in worker.loss_inputs())
    cfg = LossConfig(**worker.LOSS_BRANCHES[branch])
    lg = logits.clone().requires_grad_(True)
    lo, lf = occ_flow_loss(lg, flow, sem, gt_flow, cfg, mask_camera=mask)
    (lo + lf).backward()
    res = launch.result()
    for r in (0, 1):
        got = res[r]["losses"][branch]
        np.testing.assert_allclose(got["loss"].numpy(),
                                   [float(lo), float(lf)], rtol=1e-6)
        scale = lg.grad.abs().max().item()
        assert (got["grad"] - lg.grad[r:r + 1]).abs().max().item() \
            <= 1e-6 * scale, r
    # the per-rank weight sums differ, so a per-rank normaliser would not do
    wts = torch.tensor(cfg.class_weights or [1.0] * 17)[sem.long()]
    if cfg.class_weights:
        sums = wts.reshape(2, -1).sum(1)
        assert abs(sums[0] - sums[1]) > 0.2 * sums.max()


def test_world2_allgather_host_is_exact(launch):
    res = launch.result()
    for r in (0, 1):
        g = res[r]["allgather"]
        np.testing.assert_array_equal(g["i"], np.array(
            [[2 ** 40, -(2 ** 35), 2 ** 62 + 3],
             [2 ** 40 + 1, -(2 ** 35) - 7, 2 ** 62 + 3]], np.int64))
        assert g["i"].dtype == np.int64 and g["f"].dtype == np.float64
        np.testing.assert_array_equal(g["f"], np.array(
            [[1.0 / 3.0, 1e-300], [1.0 / 3.0 + 1, 2e-300]]))
        np.testing.assert_array_equal(g["b"][0], [[True, True],
                                                  [False, True]])


def test_world2_checkpoint_manager(launch):
    """Rank 0 queues every write, rank 1 none; 4 saves keep steps 2-4 and
    link ckpt.pt to the newest; both ranks restore the last state,
    optimizer moments included; the metadata names the world size."""
    res = launch.result()
    m0, m1 = res[0]["manager"], res[1]["manager"]
    assert m0["queued"] == [1, 2, 3, 4] and m1["queued"] == [0, 0, 0, 0]
    for m in (m0, m1):
        assert m["steps"] == [2, 3, 4] and m["link"] == "ckpt_4.pt"
        assert m["restored_step"] == 4 and m["equal"] and m["moments_equal"]
        assert m["config_ok"] and m["env"]["world_size"] == 2
        assert {"time", "hostname", "python", "torch", "cuda",
                "device_kind", "device_count"} <= m["env"].keys()


def _assert_entries_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=f"{what} {k}")


def test_world2_test_cli_equals_single_process(launch, single_cli):
    """`tools.test --distributed --eval --format-only` over 2 ranks (3
    frames: rank 0 takes two, rank 1 one, no padded frame) against the
    single-process CLI: counts bitwise, scores equal, the merged
    submission equal to the single-process one, token for token."""
    single, want = single_cli
    res = launch.result()
    assert single["counts"]["num_samples"] == 3
    for r in (0, 1):
        cli = res[r]["cli"]
        for k, a in single["counts"].items():
            np.testing.assert_array_equal(cli["counts"][k], a, err_msg=k)
        assert cli["scores"] == single["scores"] or all(
            (np.isnan(a) and np.isnan(cli["scores"][k])) or a ==
            cli["scores"][k] for k, a in single["scores"].items())
        assert cli["overflow"] == 0
    assert res[0]["cli"]["tokens"] == single["tokens"][:2]
    assert res[1]["cli"]["tokens"] == single["tokens"][2:]
    got = _load(os.path.join(launch.out, "sub.gz"))
    assert got.keys() == want.keys()
    assert got["results"].keys() == want["results"].keys()
    for tok, entry in want["results"].items():
        _assert_entries_equal(got["results"][tok], entry, tok)
    assert not [p for p in os.listdir(launch.out) if ".part" in p]


def test_world2_video_cli_predicts_each_frame_once(launch, single_cli):
    """`tools.test --distributed --video --format-only` on the one-scene,
    3-frame miniset: rank 0 streams frames 0-1, rank 1 starts frame 2 on a
    fresh history, and no rank predicts a frame twice.  A frame without
    history is the single-frame prediction, so the merged submission holds
    frames 0 and 2 as the single-process CLI's entries (a frame 0 streamed
    again after frame 2, in the same scene, would carry frame 2's history)
    and frame 1, the one frame with history, as another entry."""
    single, frames = single_cli
    res = launch.result()
    toks = single["tokens"]
    assert res[0]["cli"]["video_tokens"] == toks[:2]
    assert res[1]["cli"]["video_tokens"] == toks[2:]
    got = _load(os.path.join(launch.out, "sub_video.gz"))["results"]
    assert sorted(got) == sorted(toks)
    frames = frames["results"]
    _assert_entries_equal(got[toks[0]], frames[toks[0]], toks[0])
    _assert_entries_equal(got[toks[2]], frames[toks[2]], toks[2])
    assert any(not np.array_equal(got[toks[1]][k], a)
               for k, a in frames[toks[1]].items()), \
        "frame 1's entry does not show frame 0's history"
