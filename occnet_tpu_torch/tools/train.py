"""Training CLI of the port (counterpart of `tools/train.py`).

    python -m occnet_tpu_torch.tools.train --config turbo_occ \
        --set data.data_root=/data/nuscenes/ --eval-interval-epochs 1
    python -m occnet_tpu_torch.tools.train --config turbo_occ \
        --synthetic-data --max-steps 3
    python -m occnet_tpu_torch.tools.train --config tiny_turbo_occ \
        --synthetic-data --max-steps 3 --device cpu
    python -m occnet_tpu_torch.tools.train --config turbo_occ \
        --synthetic-geometric 64 --eval-interval-epochs 1
    python -m occnet_tpu_torch.tools.train --config base_occ \
        --temporal-queue 4 --set data.data_root=/data/nuscenes/

The device is the card unless ``--device cpu`` says otherwise: without a
CUDA device the CLI exits and names that flag.  Config selection and dotted
``--set KEY=VAL`` overrides as in the JAX CLI.  Weights are drawn with the
JAX package's initialisers from ``--seed``; ``--backbone-checkpoint`` loads
a torchvision ResNet state_dict into the backbone
(`utils.torch_convert.load_resnet_into_state_dict`, conv1 flipped to RGB).
``--autoscale-lr`` scales the learning rate by the data-parallel size (the
world size) over the reference's 8 GPUs.  Three data sources:

- by default the nuScenes / OpenOcc train split of ``data.data_root``
  (`data.nuscenes.build_train_dataset`: ``data.train_ann``, plus
  ``data.extra_trainsets`` concatenated), uint8 images distorted,
  normalised and padded on the device; the val split (``data.val_ann``)
  is scored by the eval hook;
- ``--synthetic-data``: one random batch (uint8 images on the ring rig,
  random labels and flow) from ``--seed``, reused every step;
- ``--synthetic-geometric N``: N scenes of the synthetic geometric benchmark
  (`data/synthetic.py`, rendered on the device; train seeds from 1000),
  with uint8 views normalised on the device and the photometric distortion
  off (the task encodes class in colour), and max(8, N // 16) held-out
  scenes (seeds from 0) for the eval hook.

``--temporal-queue N`` (N > 1) trains the temporal path on the data root's
N-frame scene clips (`data.clips.ClipDataset`, each part of a concatenated
train set wrapped on its own): frames 0..N-2 give the history BEV without
gradients, frame N-1 is supervised (`training.temporal.
make_temporal_train_step`, the reference's EpochBasedRunner_video).  The
synthetic sources have no clips and are refused with it; the eval hook stays
single-frame, as in the JAX CLI.

Datasets are shuffled per epoch (epoch = clips or frames // batch steps).
``--eval-interval-epochs K`` scores RayIoU / mAVE / OccScore with
`training.eval_loop.run_evaluation` every K epochs, and
``--eval-dynamic-intervals EPOCH:K,...`` changes K from an epoch on (the
reference's dynamic_intervals).

Logs loss, grad_norm and lr every ``--log-interval`` steps (default every
step) and writes ``metrics.jsonl`` in the JAX package's format
(`utils.events.JsonlWriter`: ``ts``, ``step``, ``tag`` "train", "abort",
"eval" and, at the end on a card, "hbm" with the peak allocated bytes).
Checkpoints go to ``--work-dir`` every ``--ckpt-interval-epochs`` epochs and
at the last step through `training.checkpoint.CheckpointManager`: the last
3 as ``ckpt_<step>.pt``, ``ckpt.pt`` a link to the newest, written on a
background thread; ``--resume`` continues from the newest (or from a lone
``ckpt.pt``).  The exactness certificates (`cert_overflow`) are summed on
the device and checked at every log: a nonzero sum aborts the run.
``--profile N`` traces steps step0+2 .. step0+2+N with `torch.profiler`
into ``<work-dir>/trace`` (a Chrome trace a rank).  Returns the logged
metrics, evaluations included.

``--distributed`` trains data-parallel over the ranks of a launcher
(`torchrun`, `tools/dist_train.sh`; without its environment the run is one
process): each rank holds one device and ``data.batch_size_per_device``
samples, loads its `data.sampler.shuffled_shard_indices` shard of each
epoch, and takes the global step (`training.train` describes how); an
epoch is frames // (world x batch) steps.  ``--dist-backend`` picks NCCL
(the default on the card: one card a rank) or gloo (the CPU, or ranks
sharing a card).  Rank 0 logs, writes the events and the checkpoints;
every rank runs the eval hook, as the JAX CLI does, and rank 0 writes its
scores.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# nuScenes camera images; the configs' 928 x 1600 input is this padded to 32
NUSCENES_HW = (900, 1600)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="occnet_tpu_torch training")
    p.add_argument("--config", default="turbo_occ")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint of "
                        "<work-dir> if there is one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap total steps (smoke runs)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="train on one random batch (no dataset on disk)")
    p.add_argument("--synthetic-geometric", type=int, default=0, metavar="N",
                   help="train on N generated geometric scenes rendered on "
                        "the device (data/synthetic.py); "
                        "--eval-interval-epochs evaluates RayIoU on a "
                        "held-out synthetic val split")
    p.add_argument("--synthetic-render-scale", type=int, default=1,
                   help="ray-cast the synthetic scenes at 1/N resolution "
                        "and pixel-repeat up to the model size")
    p.add_argument("--ckpt-interval-epochs", type=int, default=1,
                   help="checkpoint every N epochs and at the last step "
                        "(the last 3 kept)")
    p.add_argument("--eval-interval-epochs", type=int, default=0,
                   help="run ray-metric evaluation on the val split every N "
                        "epochs (0 = off)")
    p.add_argument("--eval-dynamic-intervals", default="",
                   metavar="EPOCH:N[,EPOCH:N...]",
                   help="change the eval interval once training reaches an "
                        "epoch milestone, e.g. '20:1' = every epoch from "
                        "epoch 20 (the reference's dynamic_intervals)")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="scale optim.lr by data-parallel size / 8, the "
                        "reference's 8-GPU linear-scaling rule")
    p.add_argument("--backbone-checkpoint", default=None,
                   help="torchvision ResNet state_dict (.pth) to initialise "
                        "the backbone (the reference's "
                        "pretrained='torchvision://resnet50')")
    p.add_argument("--temporal-queue", type=int, default=0, metavar="N",
                   help="train the temporal (video) path on N-frame scene "
                        "clips of the data root: frames 0..N-2 give the "
                        "history BEV without gradients, frame N-1 is "
                        "supervised (0 or 1: single-frame training)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the ranks of torchrun's "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT); one process without it")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl with a card, "
                        "gloo without)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps (after a 2-step warm-up) with "
                        "torch.profiler into <work-dir>/trace")
    p.add_argument("--log-interval", type=int, default=1,
                   help="log (and sync) every N steps")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; the CPU only with "
                        "--device cpu)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                   help="dotted config overrides")
    return p.parse_args(argv)


def ring_rig(m, batch_size: int) -> np.ndarray:
    """The ring of `tools/train.make_synthetic_batch`: camera i yawed
    2*pi*i/n, focal img_w/2, principal point at the image centre."""
    ego2img = np.tile(np.eye(4, dtype=np.float32),
                      (batch_size, m.num_cams, 1, 1))
    for ci in range(m.num_cams):
        a = 2 * np.pi * ci / m.num_cams
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        K = np.array([[m.img_w / 2.0, 0, m.img_w / 2],
                      [0, m.img_w / 2.0, m.img_h / 2], [0, 0, 1]])
        ego2img[:, ci, :3, :3] = (K @ R).astype(np.float32)
    return ego2img


def camera_hw(m):
    """Size of the uint8 camera images whose 32-padding is the model input:
    nuScenes 900 x 1600 for the 928 x 1600 configs, else the input size."""
    padded = tuple(-(-s // 32) * 32 for s in NUSCENES_HW)
    return NUSCENES_HW if padded == (m.img_h, m.img_w) else (m.img_h, m.img_w)


def make_synthetic_batch(cfg, batch_size: int, rng: np.random.RandomState
                         ) -> Dict[str, np.ndarray]:
    """Random batch on the ring rig (jax-free port of the JAX CLI's
    `make_synthetic_batch`), with uint8 camera images that the train step
    distorts, normalises and pads on the device."""
    m = cfg.model
    h, w = camera_hw(m)
    img = rng.randint(0, 256, (batch_size, m.num_cams, h, w, 3),
                      dtype=np.uint8)
    sem = rng.randint(0, m.num_classes,
                      size=(batch_size, m.bev_w, m.bev_h, m.pillar_h))
    flow = rng.randn(batch_size, m.bev_w, m.bev_h, m.pillar_h, 2)
    return {"img": img, "ego2img": ring_rig(m, batch_size),
            "voxel_semantics": sem.astype(np.int64),
            "voxel_flow": flow.astype(np.float32)}


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}




def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from occnet_tpu_torch import parallel
    from occnet_tpu_torch.parallel import multihost
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("occnet_tpu_torch.tools.train: no CUDA device is "
                         "available; pass --device cpu to train on the CPU")
    joined = (args.distributed and not multihost.is_initialized()
              and parallel.initialize(args.dist_backend))
    try:
        if args.distributed:
            device = multihost.local_device(device)
        return _train(args, device)
    finally:
        if joined:
            multihost.shutdown()


def _train(args, device: torch.device):
    import contextlib
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.loader import PrefetchLoader
    from occnet_tpu_torch.data.sampler import shuffled_shard_indices
    from occnet_tpu_torch.parallel import process_shard, shard_batch
    from occnet_tpu_torch.parallel.mesh import make_mesh
    from occnet_tpu_torch.parallel.multihost import broadcast_module
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training import checkpoint, eval_loop
    from occnet_tpu_torch.training.temporal import make_temporal_train_step
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    from occnet_tpu_torch.utils.events import JsonlWriter
    from occnet_tpu_torch.utils.profiling import device_sync, trace

    temporal = args.temporal_queue > 1
    if temporal and (args.synthetic_data or args.synthetic_geometric):
        raise SystemExit("occnet_tpu_torch.tools.train: --temporal-queue "
                         "trains on the scene clips of a data root; "
                         "--synthetic-data and --synthetic-geometric make "
                         "single frames with no clips")
    rank, world = process_shard()
    cfg = get_config(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    work_dir = args.work_dir or os.path.join("work_dirs", "torch_" +
                                             args.config)
    os.makedirs(work_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s",
                        force=True)
    log = logging.getLogger("occnet_tpu_torch")
    log.info("device: %s (%s)%s", device, torch.cuda.get_device_name(device)
             if device.type == "cuda" else "host CPU",
             f"; rank 0 of {world}" if world > 1 else "")
    log.info("config: %s", cfg)

    n_dp = make_mesh(cfg.parallel.dp, cfg.parallel.mp)
    batch_size = cfg.data.batch_size_per_device
    global_batch = batch_size * n_dp
    if args.autoscale_lr:
        # linear scaling against the reference's 8-GPU recipe
        # (`tools/train.py:159-161`: lr * n_gpus / 8)
        cfg = apply_overrides(cfg, {"optim.lr": cfg.optim.lr * n_dp / 8.0})
        log.info("autoscale-lr: %.3e (dp=%d)", cfg.optim.lr, n_dp)
    # dynamic eval intervals: sorted (milestone epoch, interval) pairs; the
    # interval in force is that of the last milestone reached
    dyn_eval = sorted((int(e), int(i)) for e, i in (
        kv.split(":") for kv in args.eval_dynamic_intervals.split(",") if kv))

    def eval_interval_at(epoch: int) -> int:
        iv = args.eval_interval_epochs
        for e, i in dyn_eval:
            if epoch + 1 >= e:
                iv = i
        return iv

    wants_eval = bool(args.eval_interval_epochs or dyn_eval)
    dataset = val_dataset = None
    if args.synthetic_geometric:
        from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
        cfg = apply_overrides(cfg, {"data.device_distortion": "false"})
        # disjoint seed ranges: val = seeds [0, n_val), train = [1000, ...)
        dataset = SyntheticOccDataset(
            cfg.data, cfg.model, args.synthetic_geometric, seed=1000,
            render_scale=args.synthetic_render_scale, log=log.info,
            device_normalize=True, device=device)
        if wants_eval:
            val_dataset = SyntheticOccDataset(
                cfg.data, cfg.model, max(8, args.synthetic_geometric // 16),
                seed=0, training=False,
                render_scale=args.synthetic_render_scale,
                device_normalize=True, device=device)
        steps_per_epoch = max(len(dataset) // global_batch, 1)
        cfg = apply_overrides(cfg, {"optim.steps_per_epoch":
                                    str(steps_per_epoch)})
        log.info("synthetic-geometric dataset: %d scenes (%.1f ms a scene "
                 "render), %d steps/epoch", len(dataset),
                 float(np.mean(dataset.render_ms)), steps_per_epoch)
    elif not args.synthetic_data:
        from occnet_tpu_torch.data.nuscenes import (NuSceneOccDataset,
                                                    build_train_dataset)
        dataset = build_train_dataset(cfg.data, training=True)
        if temporal:
            from occnet_tpu_torch.data import ClipDataset, ConcatOccDataset

            def clips(d):
                return ClipDataset(d, args.temporal_queue, cfg.model.pc_range,
                                   (cfg.model.bev_h, cfg.model.bev_w))

            dataset = (ConcatOccDataset([clips(d) for d in dataset.datasets])
                       if isinstance(dataset, ConcatOccDataset)
                       else clips(dataset))
        if wants_eval:
            val_dataset = NuSceneOccDataset(
                cfg.data, os.path.join(cfg.data.data_root, cfg.data.val_ann),
                training=False)
        steps_per_epoch = max(len(dataset) // global_batch, 1)
        cfg = apply_overrides(cfg, {"optim.steps_per_epoch":
                                    str(steps_per_epoch)})
        log.info("dataset: %d %s, %d steps/epoch", len(dataset),
                 f"{args.temporal_queue}-frame clips" if temporal
                 else "frames", steps_per_epoch)
    else:
        # the global batch from the seed; each rank takes its part
        batch = to_device(shard_batch(make_synthetic_batch(
            cfg, global_batch, np.random.RandomState(args.seed)), n_dp),
            device)
    t0 = time.time()
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=args.seed))
    if args.backbone_checkpoint:
        if not cfg.model.backbone.type.startswith("resnet"):
            # as the JAX CLI: a VoVNet checkpoint converts through the
            # library (`utils.torch_convert.load_vovnet_into_state_dict`)
            raise SystemExit(
                f"--backbone-checkpoint takes a torchvision ResNet; for "
                f"{cfg.model.backbone.type!r} convert the checkpoint with "
                f"occnet_tpu_torch.utils.torch_convert."
                f"load_vovnet_into_state_dict")
        from occnet_tpu_torch.utils.torch_convert import (
            load_resnet_into_state_dict)
        ref = torch.load(args.backbone_checkpoint, map_location="cpu",
                         weights_only=True)
        sd = load_resnet_into_state_dict(
            sd, ref.get("state_dict", ref),
            depth=int(cfg.model.backbone.type.replace("resnet", "")))
        log.info("backbone initialised from %s", args.backbone_checkpoint)
    state = create_train_state(cfg, sd, device)
    del sd
    n_params = sum(p.numel() for p in state.model.parameters())
    log.info("model init in %.1fs — %.2fM params", time.time() - t0,
             n_params / 1e6)
    ckpt = checkpoint.CheckpointManager(work_dir)
    lone = os.path.join(work_dir, checkpoint.LATEST)
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.info("resumed from step %d", state.step)
    elif args.resume and os.path.exists(lone):
        checkpoint.restore(lone, state)
        log.info("resumed from step %d (%s)", state.step, lone)
    # every rank starts from rank 0's parameters and statistics
    broadcast_module(state.model)

    step_fn = (make_temporal_train_step if temporal else make_train_step)(
        cfg, seed=args.seed)
    total_steps = cfg.optim.total_epochs * cfg.optim.steps_per_epoch
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    step0 = state.step
    epoch_len = cfg.optim.steps_per_epoch
    profile_start = step0 + 2 if args.profile else None
    trace_dir = os.path.join(work_dir, "trace")
    profiler = contextlib.ExitStack()
    events = (JsonlWriter(os.path.join(work_dir, "metrics.jsonl"))
              if rank == 0 else None)
    history = []
    t_start = time.time()
    loader_iter, loader_epoch = None, -1
    try:
        for step in range(step0, total_steps):
            if step == profile_start:
                device_sync()             # trace only the profiled steps
                profiler.enter_context(trace(trace_dir))
            if profile_start is not None \
                    and step == profile_start + args.profile:
                profiler.close()
                log.info("profiler trace (%d steps) written to %s",
                         args.profile, trace_dir)
            if dataset is not None:
                epoch = step // epoch_len
                if epoch != loader_epoch:
                    # this rank's shard of the epoch's permutation (the
                    # reference's DistributedGroupSampler)
                    order = shuffled_shard_indices(len(dataset), world, rank,
                                                   epoch, cfg.seed)
                    skip = (step % epoch_len) * batch_size
                    loader_iter = iter(PrefetchLoader(
                        dataset, batch_size, order[skip:], seed=cfg.seed,
                        epoch=epoch, num_workers=cfg.data.workers))
                    loader_epoch = epoch
                batch = next(loader_iter)
                batch.pop("tokens")
                batch["voxel_semantics"] = batch["voxel_semantics"].astype(
                    np.int64)
                batch = to_device(batch, device)
            metrics = step_fn(state, batch)
            # the exactness certificates (sca_topk_overflow,
            # dcn_window_overflow) summed on the device, read at every log:
            # a nonzero sum means the static fast paths left the reference
            # semantics and the gradients since then are those of another
            # function, so the run aborts (within --log-interval steps)
            overflow = (metrics["cert_overflow"] if step == step0
                        else overflow + metrics["cert_overflow"])
            if step % args.log_interval == 0 or step == total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["cert_overflow"] = float(overflow)
                if m["cert_overflow"]:
                    if events is not None:
                        events.write(step, tag="abort", **m)
                    raise SystemExit(
                        f"exactness certificate violated at or before step "
                        f"{step}: {int(m['cert_overflow'])} overflowed "
                        f"samples (sca_topk_overflow / dcn_window_overflow); "
                        f"raise model.encoder.sca.max_queries_per_cam or "
                        f"the backbone's DCN window radius, or use gather "
                        f"mode")
                if not (np.isfinite(m["loss"]) and np.isfinite(
                        m["grad_norm"])):
                    raise SystemExit(f"non-finite loss or grad norm at step "
                                     f"{step}: {m}")
                dt = (time.time() - t_start) / (step - step0 + 1)
                log.info("step %d/%d  loss %.4f (occ %.4f flow %.4f) "
                         "gnorm %.2f lr %.2e  %.2fs/it", step, total_steps,
                         m["loss"], m["loss_occ"], m["loss_flow"],
                         m["grad_norm"], m["lr"], dt)
                if events is not None:
                    events.write(step, s_per_it=dt, **m)
                history.append({"step": step, **m})
            if ((step + 1) % (epoch_len * args.ckpt_interval_epochs) == 0
                    or step == total_steps - 1):
                ckpt.save(state.step, state, cfg)
                log.info("checkpoint @ step %d: %s", state.step,
                         ckpt.path(state.step))
            epoch_now = step // epoch_len
            interval = eval_interval_at(epoch_now)
            if (val_dataset is not None and interval
                    and (step + 1) % epoch_len == 0
                    and (epoch_now + 1) % interval == 0):
                scores = eval_loop.run_evaluation(
                    cfg, Predictor.wrap(cfg, state.model), val_dataset,
                    log=log.info)
                if events is not None:
                    events.write(step + 1, tag="eval", **scores)
                history.append({"step": step + 1, "tag": "eval", **scores})
        profiler.close()
        ckpt.close()
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            log.info("peak allocated: %.3f GiB", peak / 2 ** 30)
            if events is not None:
                events.write(total_steps, tag="hbm",
                             peak_bytes_in_use=int(peak),
                             source="torch.cuda.max_memory_allocated")
    finally:
        profiler.close()
        if events is not None:
            events.close()
    log.info("done: %d steps", total_steps - step0)
    return history


if __name__ == "__main__":
    main()
