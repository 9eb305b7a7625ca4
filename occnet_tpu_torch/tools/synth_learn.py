"""Learnability run on the synthetic geometric benchmark (counterpart of
`tools/synth_learn.py`): train on generated scenes, then score with the
ray-metric evaluator (RayIoU / mAVE / OccScore) on a held-out synthetic val
split.

    python -m occnet_tpu_torch.tools.synth_learn \\
        --configs synth_tiny_turbo_occ --scenes 256 --steps 500 --batch 2
    python -m occnet_tpu_torch.tools.synth_learn \\
        --configs synth_tiny_turbo_occ --steps 2000 --eval-every 500
    python -m occnet_tpu_torch.tools.synth_learn \\
        --configs synth_tiny_occ --scenes 256 --steps 2000 --batch 2

Both encoders train: the dense (turbo) one and the exact (gather) one,
whose deformable attention runs forward and backward through the MSDA
kernels.  Scenes are rendered on ``--device`` (the card unless ``--device
cpu``); ``--cache-dir`` keeps them on disk between runs.  Writes a JSON
summary to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="occnet_tpu_torch synthetic "
                                            "learnability run")
    p.add_argument("--configs", default="synth_tiny_turbo_occ")
    p.add_argument("--scenes", type=int, default=256)
    p.add_argument("--val-scenes", type=int, default=16)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=0,
                   help="also evaluate mid-training every N steps (0 = only "
                        "at the end)")
    p.add_argument("--out", default="work_dirs/synth_bench_torch.json")
    p.add_argument("--cache-dir", default="",
                   help="scene-render cache directory ('' = none)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; the CPU only with "
                        "--device cpu)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL")
    return p.parse_args(argv)


def run_arm(name, args, train_ds, val_ds, device):
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.loader import PrefetchLoader
    from occnet_tpu_torch.data.sampler import shuffled_shard_indices
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.eval_loop import run_evaluation
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)

    cfg = get_config(name)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    steps_per_epoch = max(len(train_ds) // args.batch, 1)
    # schedule horizon = the actual run length
    epochs = max(-(-args.steps // steps_per_epoch), 1)
    overrides.update({"optim.steps_per_epoch": str(steps_per_epoch),
                      "optim.total_epochs": str(epochs),
                      "data.device_distortion": "false"})
    cfg = apply_overrides(cfg, overrides)

    t0 = time.time()
    state = create_train_state(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=args.seed)), device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[{name}] init {time.time() - t0:.1f}s, {n_params / 1e6:.2f}M "
          "params", flush=True)
    step_fn = make_train_step(cfg, seed=args.seed)

    history = []
    t_start = time.time()
    loader_iter, loader_epoch = None, -1
    overflow_total = 0
    for step in range(args.steps):
        epoch = step // steps_per_epoch
        if epoch != loader_epoch:
            order = shuffled_shard_indices(len(train_ds), 1, 0, epoch,
                                           cfg.seed)
            skip = (step % steps_per_epoch) * args.batch
            loader_iter = iter(PrefetchLoader(
                train_ds, args.batch, order[skip:], seed=cfg.seed,
                epoch=epoch, num_workers=2))
            loader_epoch = epoch
        batch = next(loader_iter)
        batch.pop("tokens")
        batch["voxel_semantics"] = batch["voxel_semantics"].astype(np.int64)
        metrics = step_fn(state, {k: torch.from_numpy(v).to(device)
                                  for k, v in batch.items()})
        if step % args.log_interval == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            overflow_total += int(m["cert_overflow"])
            dt = (time.time() - t_start) / (step + 1)
            print(f"[{name}] step {step}/{args.steps} loss {m['loss']:.4f} "
                  f"(occ {m['loss_occ']:.4f}) gnorm {m['grad_norm']:.2f} "
                  f"{dt:.3f}s/it", flush=True)
            history.append({"step": step, **m})
        if args.eval_every and step and step % args.eval_every == 0:
            scores = run_evaluation(cfg, Predictor.wrap(cfg, state.model),
                                    val_ds, log=lambda *a: None)
            print(f"[{name}] step {step} eval: {scores}", flush=True)
            history.append({"step": step, "eval": scores})
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_eval = time.time()
    pred = Predictor.wrap(cfg, state.model)
    scores = run_evaluation(cfg, pred, val_ds)
    print(f"[{name}] final eval ({time.time() - t_eval:.0f}s): {scores}",
          flush=True)
    # train-split score: separates memorisation from never fitting
    train_scores = run_evaluation(cfg, pred, train_ds,
                                  max_samples=min(16, len(train_ds)),
                                  log=lambda *a: None)
    print(f"[{name}] train-split eval: {train_scores}", flush=True)
    n_cls = int(cfg.model.num_classes)
    for split, ds in (("val", val_ds), ("train", train_ds)):
        s = ds.get_sample(0)
        occ_cls, _ = pred(s["img"][None], s["ego2img"][None])
        pc = np.bincount(occ_cls.cpu().numpy().reshape(-1), minlength=n_cls)
        gc = np.bincount(s["voxel_semantics"].reshape(-1), minlength=n_cls)
        print(f"[{name}] {split} scene 0 voxel counts (pred vs gt): "
              + " ".join(f"c{i}:{pc[i]}/{gc[i]}" for i in range(n_cls)
                         if pc[i] or gc[i]), flush=True)
    return {
        "config": name,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "host CPU"),
        "steps": args.steps,
        "batch": args.batch,
        "train_scenes": len(train_ds),
        "val_scenes": len(val_ds),
        "params_m": n_params / 1e6,
        "final_loss": [h for h in history if "loss" in h][-1]["loss"],
        "s_per_it": (t_eval - t_start) / args.steps,
        "cert_overflow_total": overflow_total,
        "scores": scores,
        "train_scores": train_scores,
        "history": history,
    }


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.data.synthetic import SyntheticOccDataset

    names = args.configs.split(",")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("synth_learn: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    # all arms share geometry, so they share the SAME dataset
    cfg0 = apply_overrides(get_config(names[0]),
                           dict(kv.split("=", 1) for kv in args.set))
    print(f"generating {args.scenes}+{args.val_scenes} scenes...", flush=True)
    t0 = time.time()
    cache = args.cache_dir or None
    kw = dict(cache_dir=cache, device_normalize=True, device=device)
    train_ds = SyntheticOccDataset(cfg0.data, cfg0.model, args.scenes,
                                   seed=1000, training=True,
                                   log=lambda s: print(s, flush=True), **kw)
    val_ds = SyntheticOccDataset(cfg0.data, cfg0.model, args.val_scenes,
                                 seed=0, training=False, **kw)
    print(f"scenes in {time.time() - t0:.0f}s", flush=True)

    results = [run_arm(n, args, train_ds, val_ds, device) for n in names]
    out = {"benchmark": "synthetic-geometric", "scenes": args.scenes,
           "steps": args.steps, "results": results}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n{'config':<26}{'RayIoU':>8}{'@1':>8}{'@2':>8}{'@4':>8}"
          f"{'mAVE':>8}{'OccScore':>9}{'s/step':>9}")
    for r in results:
        s = r["scores"]
        print(f"{r['config']:<26}{s['RayIoU']:>8.3f}{s['RayIoU@1']:>8.3f}"
              f"{s['RayIoU@2']:>8.3f}{s['RayIoU@4']:>8.3f}{s['mAVE']:>8.3f}"
              f"{s['OccScore']:>9.3f}{r['s_per_it']:>9.4f}")
    print(f"written: {args.out}")
    return out


if __name__ == "__main__":
    main()
