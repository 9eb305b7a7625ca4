"""One rank of the gloo launches of tests/test_torch_qshard.py: torch and the
port only (no JAX).  Run by torchrun with 2 ranks (dp = 1 x mp = 2) or 4
(dp = 2 x mp = 2):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/_torch_qshard_worker.py OUT_DIR

Each rank takes its data rank's part of the global batch (B = 1 a data
rank) and writes to OUT_DIR/rank<r>.pt, for each run of `runs(dp)`, the
step's metrics and how many leaves differ from rank 0's; rank 0 also runs
each run's reference and writes how far the run lies from it
(`distance`), and the deterministic steps' gradients (for the test's
comparison with JAX).  On 2 ranks also the BEV of the sharded forward with
a prev BEV and a temporal clip step, each against rank 0's unsharded
one.  The references run in process on a one-rank layout, which skips
every collective.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from occnet_tpu_torch import parallel
from occnet_tpu_torch.config import apply_overrides, tiny_occ, tiny_turbo_occ
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.parallel.mesh import active
from occnet_tpu_torch.training.train import create_train_state, make_train_step

IMG_HW = (64, 96)
MODES = ("dense", "gather")


def qshard_cfg(mode, dropout=True, axis="model", **sca):
    """``tiny_turbo_occ`` (dense) or ``tiny_occ`` (gather) cut to 2 layers,
    64 channels (the tap kernel's width), a 10 x 10 BEV and 3 cameras, in
    fp32, with ``bev_shard_axis = axis``.  With ``dropout`` the config's
    dropout (0.1) and grid mask stay on; without, nothing in the step is
    random and nothing is clipped (JAX's first Adam moment is 0.1 g)."""
    cfg = tiny_turbo_occ() if mode == "dense" else tiny_occ()
    m = cfg.model
    enc = m.encoder
    model = dataclasses.replace(
        m, img_h=IMG_HW[0], img_w=IMG_HW[1], bev_h=10, bev_w=10, pillar_h=4,
        embed_dims=64, out_dim=8, num_cams=3, compute_dtype="float32",
        bev_shard_axis=axis,
        encoder=dataclasses.replace(
            enc, num_layers=2, ffn_dim=64, num_points_in_pillar=4,
            sca=dataclasses.replace(enc.sca, **sca)))
    cfg = dataclasses.replace(cfg, model=model)
    if not dropout:
        cfg = apply_overrides(cfg, {
            "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
            "model.encoder.tsa.dropout": "0",
            "model.encoder.sca.dropout": "0", "optim.grad_clip_norm": "1e9"})
    return cfg


def rig(m, batch):
    """Outward cameras round the ego, yawed off the field-of-view edges and
    slightly offset, as tests/test_torch_gather.py's ring."""
    h, w = m.img_h, m.img_w
    e = np.tile(np.eye(4, dtype=np.float32), (batch, m.num_cams, 1, 1))
    K = np.array([[48.0, 0, w / 2], [0, 48.0, h / 2], [0, 0, 1]])
    for ci in range(m.num_cams):
        a = 2 * np.pi * ci / m.num_cams + 0.13
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        e[:, ci, :3, :3] = (K @ R).astype(np.float32)
        e[:, ci, :3, 3] = (K @ np.array([0.0, 0.4, 0.3])).astype(np.float32)
    return e


def global_batch(cfg, batch, seed=0):
    """The global batch of ``batch`` samples, numpy (float images)."""
    m = cfg.model
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, m.num_cams, m.img_h, m.img_w,
                             3).astype(np.float32),
            "ego2img": rig(m, batch),
            "voxel_semantics": rng.randint(
                0, 17, (batch, m.bev_w, m.bev_h, m.pillar_h)).astype(
                    np.int64),
            "voxel_flow": rng.randn(batch, m.bev_w, m.bev_h, m.pillar_h,
                                    2).astype(np.float32)}


def initial_state_dict(cfg):
    return from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=3), seed=4))


def runs(dp):
    """{name: (mode, dropout, axis, sca overrides)} of the steps a launch
    takes: at dp = 1 the sharded steps with and without dropout and the
    gather step whose static top-K drops visible queries; at dp = 2 also
    the replicated model axis with dropout (the sharded step's
    reference: a single process cannot draw the data ranks' dropout
    streams)."""
    out = {}
    for mode in MODES:
        out[f"{mode}_drop"] = (mode, True, "model", {})
        out[f"{mode}_det"] = (mode, False, "model", {})
        if dp > 1:
            out[f"{mode}_drop_replicated"] = (mode, True, "", {})
    if dp == 1:
        out["gather_overflow"] = ("gather", False, "model",
                                  {"per_cam_topk": (12, 40, 12)})
    return out


# dense mode: the leaves upstream of the lift, whose gradient takes the
# lift's bf16 feature gradient (tests/test_torch_qshard.py)
LIFT_UPSTREAM = ("backbone.", "neck.", "head.transformer.shared_value_proj.",
                 "head.transformer.level_embeds",
                 "head.transformer.cams_embeds")


def differing_leaves(tensors):
    n = 0
    for t in tensors:
        ref = t.clone()
        dist.broadcast(ref, 0)
        n += int(not torch.equal(ref, t))
    return n


def _rel_max(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _rel_l2(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def _whole(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def distance(mode, sd, got, ref):
    """How far the step ``got`` lies from ``ref`` (each (model, metrics)):
    the losses relative, every leaf's gradient |g - g_ref|max / |g_ref|max
    (and the names that get one on each side), the first update in
    relative L2 over the leaves after the lift and over those upstream of
    it (dense mode), the BN statistics' largest difference relative to
    their max."""
    (gm, gmet), (rm, rmet) = got, ref
    gp, rp = dict(gm.named_parameters()), dict(rm.named_parameters())
    names = sorted(n for n, p in rp.items() if p.grad is not None)
    up = [n for n in names if mode == "dense" and n.startswith(LIFT_UPSTREAM)]
    down = [n for n in names if n not in up]

    def update(ns):
        if not ns:
            return 0.0
        return _rel_l2(_whole(gp[n].detach() - sd[n] for n in ns),
                       _whole(rp[n].detach() - sd[n] for n in ns))

    rb = dict(rm.named_buffers())
    return {
        "loss": {k: abs(float(gmet[k]) - float(rmet[k])) / abs(float(rmet[k]))
                 for k in ("loss", "loss_occ", "loss_flow")},
        "cert": (float(gmet["cert_overflow"]), float(rmet["cert_overflow"])),
        "grad_names": (sorted(n for n, p in gp.items() if p.grad is not None),
                       names),
        "leaf": {n: _rel_max(gp[n].grad, rp[n].grad) for n in names},
        "upstream": up, "update": update(down), "update_upstream": update(up),
        "stats": max((_rel_max(b, rb[n]) for n, b in gm.named_buffers()
                      if b.is_floating_point()), default=0.0)}


def step(cfg, mesh, batch_size):
    """The step of ``cfg`` under ``mesh`` on its data rank's part of the
    global batch of ``batch_size``: (model, metrics)."""
    state = create_train_state(cfg, initial_state_dict(cfg), "cpu")
    local = parallel.global_batch(parallel.shard_batch(
        global_batch(cfg, batch_size), mesh), "cpu")
    met = make_train_step(cfg, mesh=mesh)(state, local)
    return state.model, met


def run_steps(rank, mesh, solo):
    """Each of `runs(dp)` under the mesh; rank 0 compares it with its
    reference: the replicated-model-axis step of the launch for the dp > 1
    dropout steps, else the unsharded step at B = dp in this process
    (``solo``: a one-rank layout).  Rank 0 keeps the deterministic steps'
    gradients for the test's comparison with JAX."""
    out, cache = {}, {}
    for name, (mode, drop, axis, sca) in runs(mesh.dp).items():
        cfg = qshard_cfg(mode, drop, axis, **sca)
        model, met = step(cfg, mesh, mesh.dp)
        rec = {"metrics": {k: float(v) for k, v in met.items()},
               "differ": differing_leaves(
                   [p.detach() for p in model.parameters()]
                   + list(model.buffers()))}
        if name.endswith("_drop_replicated"):
            ref = cache.pop(name[:-len("_replicated")])
            if rank == 0:
                out[name[:-len("_replicated")]]["vs"] = distance(
                    mode, initial_state_dict(cfg), ref, (model, met))
            out[name] = rec
            continue
        if mesh.dp > 1 and drop:
            cache[name] = (model, met)
        elif rank == 0:
            ref = step(cfg, solo, mesh.dp)
            rec["vs"] = distance(mode, initial_state_dict(cfg),
                                 (model, met), ref)
        if rank == 0 and not drop:
            rec["grads"] = {n: p.grad.clone() for n, p in
                            model.named_parameters() if p.grad is not None}
        out[name] = rec
    return out


def prev_inputs(cfg, seed=5):
    """(prev_bev (1, Q, C), shift_ref_2d (1, Q, 1, 2)) drawn from a seed."""
    m = cfg.model
    rng = np.random.RandomState(seed)
    q = m.bev_h * m.bev_w
    prev = rng.randn(1, q, m.embed_dims).astype(np.float32)
    shift = (rng.rand(1, q, 1, 2) * 0.9 + 0.05).astype(np.float32)
    return torch.from_numpy(prev), torch.from_numpy(shift)


def prev_forward(cfg, mesh=None):
    """The BEV (train mode, dropout drawn from seed 9) of the model with a
    prev BEV and a shifted TSA reference, under ``mesh``."""
    from occnet_tpu_torch.models.detector import OccNet
    model = OccNet(cfg.model)
    model.load_state_dict(initial_state_dict(cfg))
    b = global_batch(cfg, 1)
    prev, shift = prev_inputs(cfg)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad(), active(mesh):
        outs = model(torch.from_numpy(b["img"]),
                     torch.from_numpy(b["ego2img"]), prev_bev=prev,
                     shift_ref_2d=shift, only_bev=True, train=True,
                     generator=gen)
    return outs["bev_embed"]


def clip_batch(cfg, seed=6):
    """A 2-frame clip batch of `training.temporal.make_temporal_train_step`
    (float images, the ring rig in both frames)."""
    m = cfg.model
    b = global_batch(cfg, 1, seed)
    rng = np.random.RandomState(seed)
    img = np.stack([b["img"], rng.randn(*b["img"].shape).astype(
        np.float32)], axis=1)
    return {"img": img, "ego2img": np.stack([b["ego2img"]] * 2, axis=1),
            "rot_deg": np.array([[0.0, 3.0]], np.float32),
            "shifts": np.array([[[0.0, 0.0], [0.01, -0.02]]], np.float32),
            "prev_exists": np.array([[False, True]]),
            "shift": np.array([[0.01, -0.02]], np.float32),
            "voxel_semantics": b["voxel_semantics"],
            "voxel_flow": b["voxel_flow"]}


def clip_step(cfg, mesh=None):
    """The temporal clip step's (model, metrics)."""
    from occnet_tpu_torch.training.temporal import make_temporal_train_step
    state = create_train_state(cfg, initial_state_dict(cfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in clip_batch(cfg).items()}
    met = make_temporal_train_step(cfg, mesh=mesh)(state, batch)
    return state.model, met


def main(out_dir):
    torch.set_num_threads(1)
    parallel.initialize("gloo")     # timeout: OCCNET_DIST_TIMEOUT_S
    rank, world = parallel.process_shard()
    mesh = parallel.make_mesh(-1, 2)
    # one-rank layouts (every rank creates every group): rank 0's
    # in-process unsharded references
    solo = parallel.Mesh(1, 1, 0, 0, [dist.new_group([r])
                                      for r in range(world)][rank])
    res = {"world": world, "mesh": (mesh.dp, mesh.mp, mesh.data_rank,
                                    mesh.model_rank),
           "step": run_steps(rank, mesh, solo)}
    if mesh.dp == 1:
        res["prev"], res["clip"] = {}, {}
        for mode in MODES:
            cfg = qshard_cfg(mode)
            got = prev_forward(cfg, mesh)
            res["prev"][mode] = {"shape": tuple(got.shape)}
            cfg = qshard_cfg(mode, False)
            model, met = clip_step(cfg, mesh)
            res["clip"][mode] = {
                "metrics": {k: float(v) for k, v in met.items()},
                "differ": differing_leaves(
                    [p.detach() for p in model.parameters()])}
            if rank == 0:
                want = prev_forward(qshard_cfg(mode), solo)
                res["prev"][mode]["err"] = _rel_max(got, want)
                res["clip"][mode]["vs"] = distance(
                    mode, initial_state_dict(cfg), (model, met),
                    clip_step(cfg, solo))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    parallel.barrier()
    parallel.multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
