"""The evaluation path's two renders, split on one card: one full-width
synthetic scene, and an eval run's frames with their render of prediction
and ground truth and their counts.

    python -m occnet_tpu_torch.tools.bench_ray_march [--scenes N]
        [--frames N] [--out FILE]

Eval: a turbo_occ `serve.Predictor` (bf16, random JAX-style weights from
seed 0), warmed by one request, then the train CLI's eval loop
(`training.eval_loop.run_evaluation`) over ``--frames`` synthetic val
frames, the first eval of the process: its wall time on the host clock (its
first frame pays for the first use of the render's and the counts' kernels
in the process), and the loop's own CUDA-event marks around each frame's
forward, its render of prediction + GT (8 padded origins, the 14,040-ray
fan) and its counts.  Then one frame's render (`render_pred_gt`, the GT
copied in from pinned memory as the loop copies it) and its `count_sample`,
each under `torch.profiler`.

Scene: `data.synthetic.SyntheticOccDataset` of turbo_occ (6 x 928 x 1600
views of a 200 x 200 x 16 grid, rendered on the card), ``--scenes`` scenes;
its ``render_ms`` (host clock around the render and the copy of the views to
the host), then one more one-scene dataset under `torch.profiler`.

Each profiled call is reported by `tools.profile_turbo.device_profile`: the
device ms and count of the marcher kernels (`dda_kernel`, `fan_kernel` of
`csrc/ray_march.cu`), of every other kernel, and of the host-to-device and
device-to-host copies, the time the card was busy and the span from the
first start to the last end.  One JSON line.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import torch

GROUPS = {"marcher": ("dda_kernel", "fan_kernel"),
          "copy_htod": ("Memcpy HtoD",), "copy_dtoh": ("Memcpy DtoH",),
          "other_copies": ("Memcpy", "Memset")}


def split(fn) -> Dict[str, object]:
    """`device_profile` of one call of ``fn`` in `GROUPS`, without the
    per-name tables."""
    from occnet_tpu_torch.tools.profile_turbo import device_profile
    out = device_profile(fn, GROUPS)
    out["marcher_names"] = sorted(n[:60] for n in out["by_name"]
                                  if any(m in n for m in GROUPS["marcher"]))
    return {k: v for k, v in out.items() if not k.endswith("by_name")}


def scene_split(n_scenes: int) -> Dict[str, object]:
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
    cfg = turbo_occ()

    def dataset(n, seed):
        return SyntheticOccDataset(cfg.data, cfg.model, n, seed=seed,
                                   training=False, device_normalize=True)

    out = {"render_ms": dataset(n_scenes, 0).render_ms}
    out.update(split(lambda: dataset(1, n_scenes)))
    return out


def eval_split(n_frames: int) -> Dict[str, object]:
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
    from occnet_tpu_torch.evaluation.ego_pose import (extract_ego_origins,
                                                      pad_origins)
    from occnet_tpu_torch.evaluation.ray_metrics import (count_sample,
                                                         generate_lidar_rays,
                                                         render_pred_gt)
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.eval_loop import run_evaluation
    cfg = turbo_occ()
    ds = SyntheticOccDataset(cfg.data, cfg.model, n_frames, seed=1000,
                             training=False, device_normalize=True,
                             render_scale=4)
    model = Predictor(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=0)), "cuda")
    s = ds.get_sample(0)
    occ, flow = model(s["img"][None], s["ego2img"][None])
    torch.cuda.synchronize()
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    t = time.perf_counter()
    run_evaluation(cfg, model, ds, mark=mark, log=lambda *a: None)
    torch.cuda.synchronize()
    out: Dict[str, object] = {"eval_s": time.perf_counter() - t}
    frames = [marks[i:i + 4] for i in range(0, len(marks), 4)]
    for i, key in enumerate(("forward_ms", "render_ms", "counts_ms")):
        out[key] = [f[i].elapsed_time(f[i + 1]) for f in frames]
    dev = torch.device("cuda")
    padded, valid = pad_origins(dict(extract_ego_origins(ds.infos))[
        s["token"]], cfg.eval.max_origins)
    gt = [torch.from_numpy(s[k]).pin_memory()
          for k in ("voxel_semantics", "voxel_flow")]
    rays = generate_lidar_rays()

    def render():
        return render_pred_gt(
            occ[0], flow[0], *(g.to(dev, non_blocking=True) for g in gt),
            rays, padded, valid,
            voxel_size=cfg.eval.voxel_size,
            pc_range=tuple(cfg.eval.pc_range))

    out["render"] = split(render)
    pred, gtr = render()
    out["counts"] = split(lambda: count_sample(pred, gtr))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenes", type=int, default=3)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", help="also write the JSON line here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_ray_march: needs a CUDA device")
    import occnet_tpu_torch
    from occnet_tpu_torch.ops import _build
    _build.library()
    # the eval first: its wall time is that of the process' first eval,
    # before any profiler session
    res = {"package": occnet_tpu_torch.__file__,
           "eval": eval_split(args.frames),
           "scene": scene_split(args.scenes),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip()}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
