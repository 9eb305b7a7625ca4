"""Training CLI of the port (counterpart of `tools/train.py`).

    python -m occnet_tpu_torch.tools.train --config turbo_occ \
        --synthetic-data --max-steps 3
    python -m occnet_tpu_torch.tools.train --config tiny_turbo_occ \
        --synthetic-data --max-steps 3 --device cpu
    python -m occnet_tpu_torch.tools.train --config turbo_occ \
        --synthetic-geometric 64 --eval-interval-epochs 1

The device is the card unless ``--device cpu`` says otherwise: without a
CUDA device the CLI exits and names that flag.  Config selection and dotted
``--set KEY=VAL`` overrides as in the JAX CLI.  Weights are random, drawn
with the JAX package's initialisers from ``--seed``.  Two data sources, both
synthetic (no dataset loader is ported):

- ``--synthetic-data``: one random batch (uint8 images on the ring rig,
  random labels and flow) from ``--seed``, reused every step;
- ``--synthetic-geometric N``: N scenes of the synthetic geometric benchmark
  (`data/synthetic.py`, rendered on the device; train seeds from 1000),
  shuffled per epoch (epoch = N // batch steps), with uint8 views
  normalised on the device and the photometric distortion off (the task
  encodes class in colour).  ``--eval-interval-epochs K`` scores RayIoU /
  mAVE / OccScore every K epochs on max(8, N // 16) held-out scenes (seeds
  from 0) with `training.eval_loop.run_evaluation`.

Logs loss, grad_norm and lr every ``--log-interval`` steps (default every
step), writes ``metrics.jsonl`` (evaluations tagged "eval") and a final
checkpoint (``ckpt.pt``) under ``--work-dir``.  Returns the logged metrics,
evaluations included.
"""

from __future__ import annotations

import argparse
import json
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
                   help="continue from <work-dir>/ckpt.pt if it exists")
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
    p.add_argument("--eval-interval-epochs", type=int, default=0,
                   help="run ray-metric evaluation on the val split every N "
                        "epochs (0 = off)")
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
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.loader import PrefetchLoader
    from occnet_tpu_torch.data.sampler import shuffled_shard_indices
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training import checkpoint, eval_loop
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)

    cfg = get_config(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if not (args.synthetic_data or args.synthetic_geometric):
        raise SystemExit("occnet_tpu_torch trains on --synthetic-data or "
                         "--synthetic-geometric N only; the dataset loaders "
                         "are not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("occnet_tpu_torch.tools.train: no CUDA device is "
                         "available; pass --device cpu to train on the CPU")
    work_dir = args.work_dir or os.path.join("work_dirs", "torch_" +
                                             args.config)
    os.makedirs(work_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s",
                        force=True)
    log = logging.getLogger("occnet_tpu_torch")
    log.info("device: %s (%s)", device, torch.cuda.get_device_name(device)
             if device.type == "cuda" else "host CPU")
    log.info("config: %s", cfg)

    batch_size = cfg.data.batch_size_per_device
    dataset = val_dataset = None
    if args.synthetic_geometric:
        from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
        cfg = apply_overrides(cfg, {"data.device_distortion": "false"})
        # disjoint seed ranges: val = seeds [0, n_val), train = [1000, ...)
        dataset = SyntheticOccDataset(
            cfg.data, cfg.model, args.synthetic_geometric, seed=1000,
            render_scale=args.synthetic_render_scale, log=log.info,
            device_normalize=True, device=device)
        if args.eval_interval_epochs:
            val_dataset = SyntheticOccDataset(
                cfg.data, cfg.model, max(8, args.synthetic_geometric // 16),
                seed=0, training=False,
                render_scale=args.synthetic_render_scale,
                device_normalize=True, device=device)
        steps_per_epoch = max(len(dataset) // batch_size, 1)
        cfg = apply_overrides(cfg, {"optim.steps_per_epoch":
                                    str(steps_per_epoch)})
        log.info("synthetic-geometric dataset: %d scenes (%.1f ms a scene "
                 "render), %d steps/epoch", len(dataset),
                 float(np.mean(dataset.render_ms)), steps_per_epoch)
    else:
        batch = to_device(make_synthetic_batch(
            cfg, batch_size, np.random.RandomState(args.seed)), device)
    t0 = time.time()
    state = create_train_state(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=args.seed)), device)
    n_params = sum(p.numel() for p in state.model.parameters())
    log.info("model init in %.1fs — %.2fM params", time.time() - t0,
             n_params / 1e6)
    ckpt_path = os.path.join(work_dir, "ckpt.pt")
    if args.resume and os.path.exists(ckpt_path):
        checkpoint.restore(ckpt_path, state)
        log.info("resumed from step %d", state.step)

    step_fn = make_train_step(cfg, seed=args.seed)
    total_steps = cfg.optim.total_epochs * cfg.optim.steps_per_epoch
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    step0 = state.step
    epoch_len = cfg.optim.steps_per_epoch
    history = []
    t_start = time.time()
    loader_iter, loader_epoch = None, -1
    with open(os.path.join(work_dir, "metrics.jsonl"), "a") as events:
        for step in range(step0, total_steps):
            if dataset is not None:
                epoch = step // epoch_len
                if epoch != loader_epoch:
                    order = shuffled_shard_indices(len(dataset), 1, 0, epoch,
                                                   cfg.seed)
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
            if step % args.log_interval == 0 or step == total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                if not (np.isfinite(m["loss"]) and np.isfinite(
                        m["grad_norm"])):
                    raise SystemExit(f"non-finite loss or grad norm at step "
                                     f"{step}: {m}")
                dt = (time.time() - t_start) / (step - step0 + 1)
                log.info("step %d/%d  loss %.4f (occ %.4f flow %.4f) "
                         "gnorm %.2f lr %.2e  %.2fs/it", step, total_steps,
                         m["loss"], m["loss_occ"], m["loss_flow"],
                         m["grad_norm"], m["lr"], dt)
                events.write(json.dumps({"step": step, "s_per_it": dt, **m})
                             + "\n")
                history.append(m)
            if (val_dataset is not None and (step + 1) % epoch_len == 0
                    and (step // epoch_len + 1) % args.eval_interval_epochs
                    == 0):
                scores = eval_loop.run_evaluation(
                    cfg, Predictor.wrap(cfg, state.model), val_dataset,
                    log=log.info)
                events.write(json.dumps({"step": step + 1, "tag": "eval",
                                         **scores}) + "\n")
                history.append({"step": step + 1, "tag": "eval", **scores})
    checkpoint.save(ckpt_path, state, cfg)
    log.info("checkpoint @ step %d: %s", state.step, ckpt_path)
    if device.type == "cuda":
        log.info("peak allocated: %.3f GiB",
                 torch.cuda.max_memory_allocated(device) / 2 ** 30)
    log.info("done: %d steps", total_steps - step0)
    return history


if __name__ == "__main__":
    main()
