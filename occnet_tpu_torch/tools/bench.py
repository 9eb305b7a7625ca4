"""Speed entry point of the port (counterpart of `bench.py`): 6-camera
occupancy inference frames a second on one card, the `turbo_occ` forward
of `entry.entry()` (bf16, batch 1, 6 x 928 x 1600 float images, random
weights).

    python -m occnet_tpu_torch.tools.bench

Three warm-up calls (the first builds the CUDA kernels), then
``BENCH_ITERS`` (default 10) calls timed on the host clock between two
`torch.cuda.synchronize()`.  Prints ONE JSON line with `bench.py`'s keys
("metric", "value", "unit", "vs_baseline") plus "device" and
"power_limit", the card's name and power limit as `nvidia-smi` reports
them (a card set below its maximum runs slower under load).

``vs_baseline`` is bench.py's normalisation: frames/s over twice
A100_EST_FPS, BEVFormer's 3.0 frames/s on an A100 on this task (SparseOcc,
arXiv 2312.17118, Tab. 3; see BASELINE.md), so 1.0 is the 2x target.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

A100_EST_FPS = 3.0
TARGET_MULT = 2.0
WARMUP = 3


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown, unknown"


def main() -> dict:
    from occnet_tpu_torch.entry import entry
    if not torch.cuda.is_available():
        raise SystemExit("occnet_tpu_torch.tools.bench: no CUDA device is "
                         "available (the bench runs on the card only)")
    fn, args = entry("cuda")
    for _ in range(WARMUP):
        out = fn(*args)
    torch.cuda.synchronize()
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    fps = args[0].shape[0] / dt
    name, _, limit = nvidia_smi().partition(", ")
    res = {"metric": "6-cam occ inference frames/sec/chip "
                     "(OccNet turbo, bf16)",
           "value": round(fps, 3), "unit": "frames/s",
           "vs_baseline": round(fps / (TARGET_MULT * A100_EST_FPS), 3),
           "device": name, "power_limit": limit,
           "iters": iters, "ms_per_frame": round(dt * 1e3, 3),
           "out_shape": list(out.shape)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
