"""Entry points of the port (counterpart of `__graft_entry__.py`): the
flagship forward for the speed entry point (`tools/bench.py`) and a
multi-rank dry run of the train step.

    python -m occnet_tpu_torch.entry dryrun 4     # 4 ranks on the card(s)
    python -m occnet_tpu_torch.entry dryrun 4 --device cpu   # gloo, CPU

- `example_batch(cfg, batch_size)`: the JAX package's `_example_batch`, the
  same seeded numpy arrays (float32 images and flow, int32 labels, the ring
  rig);
- `entry(device)`: ``(fn, args)`` with ``fn(*args)`` the `turbo_occ`
  forward (R50 + FPN + planar-lift dense encoder + 200 x 200 x 16 voxel
  decoder, bf16, random JAX-style weights from seed 0) returning the
  occupancy logits, on the card unless ``device`` says otherwise;
- `dryrun_multichip(n, device)`: one train step of a tiny
  `tiny_turbo_occ` at dp = n and one of a tiny `tiny_occ` (the gather
  encoder), each over n ranks launched by torchrun, with a timeout on the
  launch.  The ranks run on the card unless ``device`` is "cpu": NCCL with
  one card a rank when n cards show, else gloo with ranks sharing the
  cards; "cpu" runs gloo ranks on the CPU.  The JAX dry run's dp x mp = 2
  mesh (BEV-query sharding) is not carried: ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600


def example_batch(cfg, batch_size: int = 1) -> Dict[str, np.ndarray]:
    m = cfg.model
    rng = np.random.RandomState(0)
    img = rng.randn(batch_size, m.num_cams, m.img_h, m.img_w, 3).astype(
        np.float32)
    ego2img = np.tile(np.eye(4, dtype=np.float32),
                      (batch_size, m.num_cams, 1, 1))
    for ci in range(m.num_cams):
        a = 2 * np.pi * ci / m.num_cams
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        K = np.array([[m.img_w / 2.0, 0, m.img_w / 2],
                      [0, m.img_w / 2.0, m.img_h / 2], [0, 0, 1]])
        ego2img[:, ci, :3, :3] = (K @ R).astype(np.float32)
    sem = rng.randint(0, m.num_classes,
                      size=(batch_size, m.bev_w, m.bev_h, m.pillar_h))
    flow = rng.randn(batch_size, m.bev_w, m.bev_h, m.pillar_h, 2)
    return {"img": img, "ego2img": ego2img,
            "voxel_semantics": sem.astype(np.int32),
            "voxel_flow": flow.astype(np.float32)}


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(fn, args): the `turbo_occ` inference forward and its inputs on
    ``device`` (see the module doc)."""
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.models.detector import OccNet
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    cfg = turbo_occ()
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(init_jax_style_variables(
        cfg, seed=0)))
    model = model.to(device).eval()
    batch = example_batch(cfg)

    @torch.inference_mode()
    def forward(img, ego2img):
        return model(img, ego2img)["occ"]

    args = tuple(torch.from_numpy(batch[k]).to(device)
                 for k in ("img", "ego2img"))
    return forward, args


def _dryrun_cfg(name: str):
    """``name`` cut to the JAX dry run's tiny per-rank step, at 64 channels
    (the JAX dry run's 16 is below the hand kernels' widths: the tap
    kernel takes multiples of 64)."""
    from occnet_tpu_torch.config import get_config
    cfg = get_config(name)
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, img_h=32, img_w=32, bev_h=6, bev_w=6, pillar_h=2, embed_dims=64,
        out_dim=4, num_cams=2, compute_dtype="float32",
        encoder=dataclasses.replace(m.encoder, num_layers=1, ffn_dim=64,
                                    num_points_in_pillar=2)))


def _dryrun_rank(device: str, backend: str) -> Dict[str, float]:
    """One rank of `dryrun_multichip`: both configs' steps at dp = world on
    the rank's ``device``; returns each config's loss."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.parallel import (global_batch, initialize,
                                           make_mesh, process_shard,
                                           shard_batch)
    from occnet_tpu_torch.parallel.multihost import local_device, shutdown
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    initialize(backend)
    rank, world = process_shard()
    losses = {}
    try:
        dev = local_device(device)
        dp = make_mesh()
        for name in ("tiny_turbo_occ", "tiny_occ"):
            cfg = _dryrun_cfg(name)
            batch = example_batch(cfg, batch_size=dp)
            batch["voxel_semantics"] = batch["voxel_semantics"].astype(
                np.int64)
            state = create_train_state(cfg, from_jax_variables(
                init_jax_style_variables(cfg, seed=0)), dev)
            metrics = make_train_step(cfg)(state, global_batch(
                shard_batch(batch, dp), dev))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise RuntimeError(f"dryrun[{name}] rank {rank}: loss {loss}")
            losses[name] = loss
            if rank == 0:
                print(f"dryrun[{name}] dp={dp} on {dev} "
                      f"({backend if world > 1 else 'one process'}) "
                      f"loss={loss:.4f} OK", flush=True)
    finally:
        shutdown()
    return losses


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Launch `_dryrun_rank` on ``n`` ranks with torchrun, on the card
    unless ``device`` is "cpu" (see the module doc); raises when no card
    shows and the CPU was not asked for, if a rank fails, or if the launch
    outlives DRYRUN_TIMEOUT_S."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device is "
                               "available; pass device='cpu' (--device cpu) "
                               "to run the ranks on the CPU")
        backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
    else:
        backend = "gloo"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "occnet_tpu_torch.entry",
         "dryrun-rank", device, backend], env=env, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT_S)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        raise RuntimeError(f"dryrun over {n} ranks failed (rc "
                           f"{r.returncode}):\n{r.stderr[-8000:]}")
    print(f"dryrun_multichip({n}, {device!r}): OK ({backend})")


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["dryrun-rank"]:
        _dryrun_rank(argv[1], argv[2])
    elif argv[:1] == ["dryrun"]:
        device = "cuda"
        if "--device" in argv:
            i = argv.index("--device")
            device = argv[i + 1]
            del argv[i:i + 2]
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 2, device)
    else:
        sys.exit("usage: python -m occnet_tpu_torch.entry dryrun [N] "
                 "[--device cpu]")
