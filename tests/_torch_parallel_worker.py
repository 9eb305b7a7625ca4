"""One rank of the 2-rank gloo launch of tests/test_torch_parallel.py: torch
and the port only (no JAX).  Run by torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/_torch_parallel_worker.py OUT_DIR MINISET_ROOT CKPT

Each rank takes its half (B = 1) of the B = 2 global batches the test
builds the same way, and writes what the test compares to
OUT_DIR/rank<r>.pt:

- ``norms``: the decoder's BatchNorm3d and the trunk's TrainableBatchNorm
  in train mode on the rank's sample: output, gradients, running
  statistics;
- ``step``: the train step of each of `STEP_CFGS` (the trunk's BN frozen
  with stage 1, or trainable; the decoder BN in both): metrics,
  parameters, gradients (rank 0) and buffers after it, and how many leaves
  differ between the ranks;
- ``images``: the backbone's input of a step with grid mask and
  photometric distortion on (the rank's images after both);
- ``losses``: `occ_flow_loss` in its weighted and masked branches on labels
  whose per-rank weight sums differ, the ranks' shares averaged, and the
  rank's logits gradient;
- ``allgather``: `allgather_host` of int64 beyond 2^31, float64 and bool;
- ``manager``: `CheckpointManager` with 4 saves, the steps kept, the
  restores and the metadata;
- ``cli``: the summary of `tools.test --distributed --eval --format-only`
  on the miniset (its counts and scores) under this group, and the tokens
  of a `--distributed --video --format-only` run (submission
  OUT_DIR/sub_video.gz).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from occnet_tpu_torch import parallel
from occnet_tpu_torch.config import LossConfig, apply_overrides, tiny_turbo_occ
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.models.head import occ_flow_loss
from occnet_tpu_torch.models.resnet import TrainableBatchNorm
from occnet_tpu_torch.models.transformer_occ import BatchNorm3d
from occnet_tpu_torch.tools.train import ring_rig
from occnet_tpu_torch.training.checkpoint import CheckpointManager
from occnet_tpu_torch.training.train import (TrainState, create_train_state,
                                             make_train_step)

# the test CLI's config: tiny_occ at tests/test_torch_test_cli.py's size
CLI_SMALL = ["model.img_h=64", "model.img_w=96", "model.embed_dims=32",
             "model.out_dim=8", "model.compute_dtype=float32",
             "model.encoder.num_layers=1", "model.encoder.ffn_dim=64",
             "model.encoder.num_points_in_pillar=4",
             "model.encoder.sca.max_queries_per_cam=2048",
             "eval.max_origins=3"]


def small_cfg(norm_eval=True, frozen_stages=1, deterministic=True):
    """`tests/test_torch_train.small_cfg` (the test holds the two equal)."""
    cfg = tiny_turbo_occ()
    m = cfg.model
    model = dataclasses.replace(
        m, img_h=64, img_w=96, bev_h=10, bev_w=10, pillar_h=4,
        embed_dims=32, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(m.encoder, num_layers=2, ffn_dim=64,
                                    num_points_in_pillar=4),
        backbone=dataclasses.replace(m.backbone, norm_eval=norm_eval,
                                     frozen_stages=frozen_stages))
    cfg = dataclasses.replace(cfg, model=model)
    if deterministic:
        cfg = apply_overrides(cfg, {
            "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
            "model.encoder.tsa.dropout": "0",
            "model.encoder.sca.dropout": "0", "optim.grad_clip_norm": "1e9"})
    return cfg


def global_batch(cfg, seed=0, uint8=False, batch=2):
    """The B = 2 global batch, numpy."""
    m = cfg.model
    rng = np.random.RandomState(seed)
    shape = (batch, m.num_cams, m.img_h, m.img_w, 3)
    img = (rng.randint(0, 256, shape, dtype=np.uint8) if uint8
           else rng.randn(*shape).astype(np.float32))
    return {"img": img, "ego2img": ring_rig(m, batch),
            "voxel_semantics": rng.randint(
                0, 17, (batch, m.bev_w, m.bev_h, m.pillar_h)).astype(
                    np.int64),
            "voxel_flow": rng.randn(batch, m.bev_w, m.bev_h, m.pillar_h,
                                    2).astype(np.float32)}


def initial_state_dict(cfg):
    return from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=3), seed=4))


def loss_inputs():
    """(logits, flow, labels, gt_flow, mask) of a B = 2 batch whose halves
    differ in their class and mask weight sums: sample 0 mostly class 0,
    sample 1 mostly class 16, masks of different density."""
    rng = np.random.RandomState(11)
    logits = rng.randn(2, 5, 4, 3, 17).astype(np.float32) * 2
    flow = rng.randn(2, 5, 4, 3, 2).astype(np.float32)
    sem = rng.randint(0, 17, (2, 5, 4, 3))
    sem[0, :4] = 0
    sem[1, :4] = 16
    gt_flow = rng.randn(2, 5, 4, 3, 2).astype(np.float32)
    mask = np.stack([rng.rand(5, 4, 3) > 0.2,
                     rng.rand(5, 4, 3) > 0.7]).astype(np.float32)
    return logits, flow, sem, gt_flow, mask


LOSS_BRANCHES = {
    "weighted": dict(class_weights=tuple(np.linspace(0.1, 3.0, 17))),
    "masked": dict(use_mask=True, flow_fg_weight=5.0,
                   class_weights=tuple(np.linspace(2.0, 0.2, 17))),
    "fg_flow": dict(flow_fg_weight=50.0),
}


def differing_leaves(tensors):
    """How many of ``tensors`` differ from rank 0's copy."""
    n = 0
    for t in tensors:
        ref = t.clone()
        dist.broadcast(ref, 0)
        n += int(not torch.equal(ref, t))
    return n


def norm_inputs(name):
    """(module, x, upstream gradient g) of a B = 2 batch for the norm
    ``name`` ("bn3d": the decoder's BatchNorm3d on NCDHW, "trainable": the
    trunk's TrainableBatchNorm on NCHW), affine parameters drawn too."""
    rng = np.random.RandomState(21)
    shape = (2, 6, 3, 4, 5) if name == "bn3d" else (2, 6, 7, 5)
    bn = BatchNorm3d(6) if name == "bn3d" else TrainableBatchNorm(6)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
    x = ((rng.randn(*shape) * 2 + 1) * rng.rand(1, 6, *shape[2:]) * 3
         ).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return bn, torch.from_numpy(x), torch.from_numpy(g)


def norm_step(bn, x, g):
    """Output, input / weight / bias gradients of sum(bn(x) * g) and the
    running statistics after it."""
    x = x.clone().requires_grad_(True)
    y = bn(x, train=True)
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def run_norms(rank):
    """Each norm on the rank's sample of `norm_inputs`; the weight and bias
    gradients summed over the ranks (the global loss is the sum of the
    ranks' sums)."""
    out = {}
    for name in ("bn3d", "trainable"):
        bn, x, g = norm_inputs(name)
        r = norm_step(bn, x[rank:rank + 1], g[rank:rank + 1])
        for k in ("dw", "db"):
            parallel.multihost.all_reduce_(r[k])
        out[name] = r
    return out


# the world-2 steps: (norm_eval, frozen_stages) of `small_cfg`
STEP_CFGS = {"frozen_bn": (True, 1), "trainable_bn": (False, -1)}


def run_step(rank, dp, cfg):
    state = create_train_state(cfg, initial_state_dict(cfg), "cpu")
    local = parallel.global_batch(parallel.shard_batch(
        global_batch(cfg), dp), "cpu")
    met = make_train_step(cfg)(state, local)
    params = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "buffers": {n: b.clone() for n, b in
                       state.model.named_buffers()},
           "differ": differing_leaves(list(params.values()) + [
               b for b in state.model.buffers()])}
    if rank == 0:
        out["params"] = params
        out["grads"] = {n: p.grad.clone() for n, p in
                        state.model.named_parameters()
                        if p.grad is not None}
    return out


class _Seen(Exception):
    pass


def backbone_input(batch):
    """The backbone's input in the step (seed 5) of a `small_cfg` with grid
    mask and photometric distortion on: the step's images after both.  The
    step stops there."""
    cfg = small_cfg(norm_eval=False, frozen_stages=-1, deterministic=False)
    state = create_train_state(cfg, initial_state_dict(cfg), "cpu")

    def stop(mod, inp):
        raise _Seen(inp[0].detach().clone())

    state.model.backbone.register_forward_pre_hook(stop)
    try:
        make_train_step(cfg, seed=5)(state, batch)
    except _Seen as seen:
        return seen.args[0]
    raise AssertionError("the backbone did not run")


def images_batch():
    """The B = 2 uint8 global batch of `backbone_input`."""
    return global_batch(small_cfg(deterministic=False), seed=1, uint8=True)


def run_images(rank, dp):
    return backbone_input(parallel.global_batch(parallel.shard_batch(
        images_batch(), dp), "cpu"))


def run_losses(rank):
    logits, flow, sem, gt_flow, mask = (
        torch.from_numpy(np.ascontiguousarray(a[rank:rank + 1]))
        for a in loss_inputs())
    out = {}
    for name, branch in LOSS_BRANCHES.items():
        lg = logits.clone().requires_grad_(True)
        lo, lf = occ_flow_loss(lg, flow, sem, gt_flow, LossConfig(**branch),
                               mask_camera=mask)
        (lo + lf).backward()
        shares = parallel.multihost.all_reduce_(
            torch.stack([lo, lf]).detach()) / 2
        # the data-parallel average of the ranks' gradients
        out[name] = {"loss": shares, "grad": lg.grad / 2}
    return out


def run_allgather(rank):
    tree = {"i": np.array([2 ** 40 + rank, -(2 ** 35) - 7 * rank,
                           2 ** 62 + 3], np.int64),
            "f": np.array([1.0 / 3.0 + rank, 1e-300 * (rank + 1)],
                          np.float64),
            "b": [np.array([rank == 0, True])]}
    return parallel.allgather_host(tree)


def run_manager(rank, out_dir):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    state = TrainState(step=0, model=model, optimizer=opt)
    mngr = CheckpointManager(os.path.join(out_dir, "ckpts"))
    queued = []
    for step in range(1, 5):
        with torch.no_grad():
            model.weight.add_(1.0)
        state.step = step
        mngr.save(step, state, small_cfg())
        queued.append(len(mngr._pending))
    mngr.wait()
    fresh = torch.nn.Linear(4, 3)
    fstate = TrainState(0, fresh, torch.optim.AdamW(fresh.parameters(),
                                                    lr=1e-2))
    mngr.restore(fstate)
    ckpt = torch.load(mngr.path(4), weights_only=True)
    res = {"steps": mngr.all_steps(), "queued": queued,
           "link": os.readlink(os.path.join(mngr.directory, "ckpt.pt")),
           "restored_step": fstate.step,
           "equal": all(torch.equal(a, b) for a, b in zip(
               model.state_dict().values(), fresh.state_dict().values())),
           "moments_equal": all(torch.equal(
               opt.state_dict()["state"][0][k],
               fstate.optimizer.state_dict()["state"][0][k])
               for k in ("exp_avg", "exp_avg_sq")),
           "env": ckpt["env"],
           "config_ok": json.loads(ckpt["config"])["model"]["embed_dims"]
           == 32}
    mngr.close()
    return res


def cli_args(root, ckpt, work, out, *extra):
    """`tools.test` on the miniset at ``root`` with the weights ``ckpt``."""
    return ["--config", "tiny_occ", "--device", "cpu", "--checkpoint", ckpt,
            "--work-dir", work, "--out", out, "--format-only", *extra,
            "--set", f"data.data_root={root}", "data.val_ann=infos_val.pkl",
            *CLI_SMALL]


def run_cli(out_dir, root, ckpt):
    """The CLI with --eval, and a --video run that writes its submission
    only (rank 0 streams frames 0-1, rank 1 frame 2 on a fresh history)."""
    from occnet_tpu_torch.tools import test as test_cli
    work = os.path.join(out_dir, "work")
    summary = test_cli.main(cli_args(
        root, ckpt, work, os.path.join(out_dir, "sub.gz"), "--distributed",
        "--eval"))
    summary["video_tokens"] = test_cli.main(cli_args(
        root, ckpt, work, os.path.join(out_dir, "sub_video.gz"),
        "--distributed", "--video"))["tokens"]
    return summary


def main(out_dir, root, ckpt):
    torch.set_num_threads(1)
    parallel.initialize("gloo")     # timeout: OCCNET_DIST_TIMEOUT_S
    rank, world = parallel.process_shard()
    assert world == 2, world
    dp = parallel.make_mesh()
    res = {"world": world, "norms": run_norms(rank),
           "step": {k: run_step(rank, dp, small_cfg(*v))
                    for k, v in STEP_CFGS.items()},
           "images": run_images(rank, dp), "losses": run_losses(rank),
           "allgather": run_allgather(rank),
           "manager": run_manager(rank, out_dir),
           "cli": run_cli(out_dir, root, ckpt)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    parallel.barrier()
    parallel.multihost.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:4])
