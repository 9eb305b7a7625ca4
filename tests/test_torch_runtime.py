"""The port's runtime pieces in one process on the CPU, against the JAX
package where it has them: the process-group helpers without a launcher
(no-ops) and at world size 1 (the norms, the loss and a whole train step
bitwise those of no group), the mesh, `grad_checker` against JAX's on the
same zeroed gradients, `JsonlWriter` records against JAX's, the profiler's
Chrome trace with an annotated region and the program's spans, `entry.example_batch` against
`__graft_entry__._example_batch`, the dry run's device choice, and the
checkpoint manager."""

import dataclasses
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from occnet_tpu.training.train import grad_checker as jax_grad_checker
from occnet_tpu.utils.events import JsonlWriter as JaxJsonlWriter
from occnet_tpu_torch import entry, parallel
from occnet_tpu_torch.config import LossConfig
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables)
from occnet_tpu_torch.entry import example_batch
from occnet_tpu_torch.models.head import occ_flow_loss
from occnet_tpu_torch.parallel import multihost
from occnet_tpu_torch.training import checkpoint
from occnet_tpu_torch.training.train import (TrainState, create_train_state,
                                             grad_checker, make_train_step)
from occnet_tpu_torch.utils.events import JsonlWriter
from occnet_tpu_torch.utils.profiling import (annotate, device_sync, span,
                                              trace)
from _torch_threads import one_torch_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import _torch_parallel_worker as worker  # noqa: E402


def test_no_launcher_is_one_process(monkeypatch):
    """Without torchrun's environment `initialize` does nothing and every
    helper is the identity, as the JAX package's are on one process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.initialize() is False
    assert not multihost.is_initialized()
    assert parallel.process_shard() == (0, 1)
    tree = {"a": np.arange(3, dtype=np.int64), "b": [np.ones(2)]}
    out = parallel.allgather_host(tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])
    parallel.barrier("t")
    x = torch.arange(4.0)
    assert multihost.all_reduce_sum(x) is x
    multihost.all_reduce_mean_([x])
    assert torch.equal(x, torch.arange(4.0))
    b = {"img": np.zeros((1, 2)), "n": 3}
    got = parallel.global_batch(b, "cpu")
    assert isinstance(got["img"], torch.Tensor) and got["n"] == 3


def test_mesh_is_the_data_axis():
    """`make_mesh` gives the (data, model) layout: one process is dp = mp =
    1 on the default group; mp > 1 without a process group, or a world
    that is not dp x mp, raises; `check_layout` refuses an unknown
    ``bev_shard_axis`` and, when it shards, a ``bev_h`` that mp does not
    divide (the train step with it); `shard_batch` takes a data rank's
    part."""
    from occnet_tpu_torch.config import tiny_turbo_occ
    from occnet_tpu_torch.parallel.mesh import Mesh, check_layout
    mesh = parallel.make_mesh()
    assert mesh == parallel.make_mesh(dp=1) == Mesh(1, 1, 0, 0)
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(mp=2)
    with pytest.raises(ValueError, match="ranks"):
        parallel.make_mesh(dp=2)
    _init_world1()
    try:
        with pytest.raises(ValueError, match="does not divide"):
            parallel.make_mesh(mp=2)
        with pytest.raises(ValueError, match="ranks"):
            parallel.make_mesh(dp=1, mp=2)
    finally:
        dist.destroy_process_group()
    cfg = tiny_turbo_occ()
    m = cfg.model
    two = Mesh(1, 2, 0, 0)
    assert check_layout(m, two) is False               # replicated model axis
    assert check_layout(dataclasses.replace(m, bev_shard_axis="model"),
                        two) is True
    assert check_layout(dataclasses.replace(m, bev_shard_axis="model"),
                        mesh) is False
    with pytest.raises(ValueError, match="bev_shard_axis"):
        check_layout(dataclasses.replace(m, bev_shard_axis="data"), two)
    with pytest.raises(ValueError, match="bev_h=49"):
        check_layout(dataclasses.replace(m, bev_h=49, bev_shard_axis="model"),
                     two)
    with pytest.raises(ValueError, match="bev_shard_axis"):
        make_train_step(dataclasses.replace(cfg, model=dataclasses.replace(
            m, bev_shard_axis="rows")))
    batch = {"x": np.arange(8).reshape(4, 2), "y": np.arange(4)}
    for r in (0, 1):
        got = parallel.shard_batch(batch, 2, rank=r)
        np.testing.assert_array_equal(got["x"], batch["x"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["y"], batch["y"][2 * r:2 * r + 2])
        got = parallel.shard_batch(batch, Mesh(2, 2, r, 1))
        np.testing.assert_array_equal(got["x"], batch["x"][2 * r:2 * r + 2])
    np.testing.assert_array_equal(parallel.shard_batch(batch, 1)["x"],
                                  batch["x"])
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch({"x": np.arange(3)}, 2, rank=0)


def _init_world1():
    """A one-rank gloo process group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


@pytest.fixture
def world1():
    _init_world1()
    yield
    dist.destroy_process_group()


def _old_bn3d(bn, x):
    """BatchNorm3d's train-mode arithmetic before the process group."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.ndim))
    mean = xf.mean(dim=dims)
    var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    shape = (-1,) + (1,) * (x.ndim - 2)
    return (xf - mean.reshape(shape)) * mul.reshape(shape) + \
        bn.bias.reshape(shape)


def _old_trainable(bn, x):
    """TrainableBatchNorm's train-mode arithmetic before the process
    group."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + bn.eps)
    mul = (bn.weight * inv).to(bn.dtype)
    add = (bn.bias - mean * bn.weight * inv).to(bn.dtype)
    return x * mul[:, None, None] + add[:, None, None]


@pytest.mark.parametrize("group", [False, True])
def test_world1_arithmetic_is_unchanged(group, request):
    """Without a process group and in a one-rank group the two train-mode
    norms are bitwise their single-process arithmetic (outputs and input
    gradients), and `occ_flow_loss`'s weighted / masked branches bitwise
    the plain division."""
    if group:
        request.getfixturevalue("world1")
        assert multihost.is_initialized() and multihost.world_size() == 1
    for name, old in (("bn3d", _old_bn3d), ("trainable", _old_trainable)):
        bn, x, g = worker.norm_inputs(name)
        xa = x.clone().requires_grad_(True)
        xb = x.clone().requires_grad_(True)
        ya, yb = bn(xa, train=True), old(bn, xb)
        assert torch.equal(ya, yb), name
        (ya * g).sum().backward()
        (yb * g).sum().backward()
        assert torch.equal(xa.grad, xb.grad), name
    logits, flow, sem, gt_flow, mask = (torch.from_numpy(
        np.ascontiguousarray(a)) for a in worker.loss_inputs())
    cfg = LossConfig(**worker.LOSS_BRANCHES["masked"])
    lo, lf = occ_flow_loss(logits, flow, sem, gt_flow, cfg, mask_camera=mask)
    w = torch.tensor(cfg.class_weights, dtype=torch.float32)[
        sem.reshape(-1).long()] * \
        mask.reshape(-1)
    ce = -torch.log_softmax(logits.reshape(-1, 17), -1).gather(
        1, sem.reshape(-1, 1).long())[:, 0]
    assert torch.equal(lo, cfg.occ_weight * ((ce * w).sum()
                                             / w.sum().clamp(min=1e-6)))
    assert torch.isfinite(lf)


def test_world1_train_step_is_the_single_process_step():
    """A whole train step (trainable BN, uint8 images, grid mask, dropout)
    in a one-rank group: loss, gradients and parameters bitwise those of
    the same step without a group."""
    cfg = worker.small_cfg(False, -1, deterministic=False)
    sd = worker.initial_state_dict(cfg)
    batch = {k: torch.from_numpy(a[:1].copy()) for k, a in
             worker.global_batch(cfg, seed=2, uint8=True).items()}
    runs = []
    for grouped in (False, True):
        if grouped:
            _init_world1()
        try:
            state = create_train_state(cfg, sd, "cpu")
            met = make_train_step(cfg, seed=3)(state, batch)
            runs.append((state, met))
        finally:
            if grouped:
                dist.destroy_process_group()
    (a, ma), (b, mb) = runs
    for k in ("loss", "grad_norm", "cert_overflow"):
        assert torch.equal(ma[k], mb[k]), k
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        assert (p.grad is None) == (q.grad is None) and (
            p.grad is None or torch.equal(p.grad, q.grad)), n


def test_grad_checker_names_jax_names():
    """Leaves of a JAX gradient tree zeroed, the rest random: JAX's
    `grad_checker` paths and the port's names of the same leaves (each
    JAX leaf marked by a value it alone holds, through the weight bridge),
    plus a port parameter with no gradient at all."""
    cfg = worker.small_cfg()
    v = init_jax_style_variables(cfg, seed=0)
    leaves, treedef = jax.tree_util.tree_flatten(v["params"])
    rng = np.random.RandomState(0)
    dead = {1, 7, 30, len(leaves) - 1}
    grads = [np.zeros_like(x) if i in dead else
             (rng.rand(*x.shape) + 0.5).astype(np.float32)
             for i, x in enumerate(leaves)]
    jax_dead = jax_grad_checker(jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(g) for g in grads]))
    marks = from_jax_variables({"params": jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i + 1, np.float32)
                  for i, x in enumerate(leaves)])})
    port_of = {int(t.reshape(-1)[0]) - 1: n for n, t in marks.items()}
    tg = from_jax_variables({"params": jax.tree_util.tree_unflatten(
        treedef, grads)})
    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    for n, p in state.model.named_parameters():
        p.grad = tg[n].clone()
    assert len(jax_dead) == len(dead)
    assert sorted(grad_checker(state.model)) == sorted(
        port_of[i] for i in dead)
    name = port_of[3]
    dict(state.model.named_parameters())[name].grad = None
    assert name in grad_checker(state.model)


def test_jsonl_writer_records_are_jax_records(tmp_path):
    """The same events through both writers: the same keys in each line and
    the same values (the time stamp given)."""
    events = [dict(step=3, s_per_it=0.25, loss=np.float32(1.5),
                   cert_overflow=0.0),
              dict(step=4, tag="eval", RayIoU=0.75, OccScore=np.nan),
              dict(step=5, tag="abort", cert_overflow=torch.tensor(2.0)),
              dict(step=9, tag="hbm", peak_bytes_in_use=123,
                   source="torch.cuda.max_memory_allocated")]
    lines = {}
    for name, cls in (("port", JsonlWriter), ("jax", JaxJsonlWriter)):
        path = str(tmp_path / name / "metrics.jsonl")
        with cls(path) as w:
            for e in events:
                w.write(t=100.0, **{k: (float(v) if name == "jax" and
                                        isinstance(v, torch.Tensor) else v)
                                    for k, v in e.items()})
        with open(path) as f:
            lines[name] = f.read().splitlines()
    assert len(lines["port"]) == len(events)
    for a, b in zip(lines["port"], lines["jax"]):
        assert a == b
        assert list(json.loads(a))[:3] == ["ts", "step", "tag"]


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    """The Chrome trace holds the annotation and the program's spans as
    ``occ/<name>`` ranges; the spans' summary lies beside it."""
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")):
        with annotate("occnet_region"):
            with span("serve.request"), span("model.trunk"):
                y = x @ x
        device_sync(y)
    files = sorted(os.listdir(tmp_path / "trace"))
    assert len(files) == 2 and files[0].startswith("spans_rank0_")
    assert files[1] == "trace" + files[0][len("spans"):]
    with open(tmp_path / "trace" / files[1]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"occnet_region", "occ/serve.request", "occ/model.trunk"} <= names
    with open(tmp_path / "trace" / files[0]) as f:
        (item,) = json.load(f)
    assert item["root"] == "serve.request"
    assert set(item["spans"]) == {"serve.request", "model.trunk"}
    assert span("serve.request") is span("model.trunk")   # off after it


def test_example_batch_is_the_jax_entry_batch():
    import __graft_entry__
    from occnet_tpu_torch.config import tiny_turbo_occ
    cfg = tiny_turbo_occ()
    for b in (1, 2):
        ours = example_batch(cfg, b)
        theirs = __graft_entry__._example_batch(cfg, b)
        assert ours.keys() == theirs.keys()
        for k, a in theirs.items():
            a = np.asarray(a)
            assert ours[k].dtype == a.dtype and np.array_equal(ours[k], a), k


def test_dryrun_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    """`dryrun_multichip` refuses to start without a card unless the CPU is
    asked for; a rank's steps run on the device it is given (here the CPU,
    one process: no launcher)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
    losses = entry._dryrun_rank("cpu", "gloo")
    assert sorted(losses) == ["tiny_occ", "tiny_turbo_occ"]
    assert all(np.isfinite(v) for v in losses.values())
    assert not multihost.is_initialized()


def test_checkpoint_manager_keeps_three_and_restores(tmp_path):
    """Asynchronous saves of 5 steps: the last 3 kept, `ckpt.pt` linked to
    the newest, the host copy taken at `save` (a later in-place update does
    not reach the file), config and environment metadata, restore of the
    newest and of a given step; a lone `ckpt.pt` still loads."""
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = TrainState(step=0, model=model, optimizer=opt)
    mngr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    assert mngr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mngr.restore(state)
    saved = {}
    for step in range(1, 6):
        with torch.no_grad():
            model.weight.add_(1.0)
        state.step = step
        saved[step] = model.weight.detach().clone()
        mngr.save(step, state, worker.small_cfg())
        with torch.no_grad():
            model.weight.mul_(-1.0)         # after save returned
        saved[step] = (saved[step], model.weight.detach().clone())
    mngr.wait()
    assert mngr.all_steps() == [3, 4, 5]
    assert os.readlink(tmp_path / "ck" / "ckpt.pt") == "ckpt_5.pt"
    ck = torch.load(mngr.path(4), weights_only=True)
    assert torch.equal(ck["model"]["weight"], saved[4][0])
    assert json.loads(ck["config"])["model"]["bev_h"] == 10
    assert ck["env"]["world_size"] == 1 and ck["env"]["device_kind"] == "cpu"
    fresh = torch.nn.Linear(3, 2)
    fstate = TrainState(0, fresh, torch.optim.AdamW(fresh.parameters(),
                                                    lr=0.1))
    mngr.restore(fstate)
    assert fstate.step == 5 and torch.equal(fresh.weight, saved[5][0])
    mngr.restore(fstate, step=3)
    assert fstate.step == 3 and torch.equal(fresh.weight, saved[3][0])
    mngr.close()
    lone = str(tmp_path / "lone.pt")
    checkpoint.save(lone, state, worker.small_cfg())
    checkpoint.restore(lone, fstate)
    assert fstate.step == 5 and torch.equal(fresh.weight, saved[5][1])
