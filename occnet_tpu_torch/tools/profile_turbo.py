"""Device time of one full-width turbo_occ request and one train step under
`torch.profiler`, on one card.

    python -m occnet_tpu_torch.tools.profile_turbo [--out FILE]

Serving: `serve.Predictor` on turbo_occ (bf16, random JAX-style weights
from seed 0), 6 uint8 900 x 1600 images on the ring rig of the train CLI,
two warm-up requests, then one profiled request.  Training: the train CLI's
step (`training.train.make_train_step`) on one synthetic batch at B = 1,
two warm-up steps, then one profiled step.  For each it prints the summed
time of the device's kernels and copies, the time the card was busy (the
union of their intervals), the span from the first start to the last end,
and the summed time of the lift (`lift_level_kernel`) and tap-attention
(`tap_kernel`) forward kernels, as one JSON line (`device_profile` also
sums the MSDA and DCN sampling backward kernels, for the exact and
R101-DCN train steps of chip_smoke.py).

It uses only the package's public entry points, so it also measures another
checkout of the package: run this file by its path with that checkout's
root first on ``PYTHONPATH``.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

KERNELS = {"lift": "lift_level_kernel", "tap": "tap_kernel<",
           "msda_bwd": "msda_bwd_kernel",
           "dcn_bwd": "deform_sample_bwd_"}


def device_profile(fn: Callable[[], object],
                   groups: Optional[Dict[str, Sequence[str]]] = None
                   ) -> Dict[str, object]:
    """ms of device activity in one call of ``fn`` (see the module doc),
    plus ``by_name`` / ``n_by_name``: the ms and count of each kernel or
    copy name.  ``groups`` (name -> substrings of event names) adds
    ``{group}_ms`` and ``{group}_n`` for the events whose name holds one of
    the group's substrings, the first group matching taking each event, and
    ``other_ms`` / ``other_n`` for the events no group takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    out = {"kernel_ms": sum(s1 - s0 for s0, s1 in spans) / 1e3,
           "busy_ms": busy / 1e3, "span_ms": (end - spans[0][0]) / 1e3}
    for key, name in KERNELS.items():
        out[f"{key}_ms"] = sum(e.time_range.end - e.time_range.start
                               for e in events if name in e.name) / 1e3
    by_name: Dict[str, float] = {}
    n_by_name: Dict[str, int] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
        n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
    out["by_name"] = by_name
    out["n_by_name"] = n_by_name
    if groups is not None:
        taken = {g: [0.0, 0] for g in [*groups, "other"]}
        for name, ms in by_name.items():
            g = next((g for g, subs in groups.items()
                      if any(sub in name for sub in subs)), "other")
            taken[g][0] += ms
            taken[g][1] += n_by_name[name]
        for g, (ms, n) in taken.items():
            out[f"{g}_ms"] = ms
            out[f"{g}_n"] = n
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the JSON line here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_turbo: needs a CUDA device")
    import occnet_tpu_torch
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.tools.train import (make_synthetic_batch, ring_rig,
                                              to_device)
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = turbo_occ()
    m = cfg.model
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    pred = Predictor(cfg, sd, "cuda")
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3), dtype=np.uint8)
    e2i = ring_rig(m, 1)
    for _ in range(2):
        pred(imgs, e2i)
    request = device_profile(lambda: pred(imgs, e2i))
    del pred
    torch.cuda.empty_cache()
    state = create_train_state(cfg, sd, "cuda")
    batch = to_device(make_synthetic_batch(cfg, 1, np.random.RandomState(0)),
                      "cuda")
    step_fn = make_train_step(cfg, seed=0)
    for _ in range(2):
        step_fn(state, batch)
    step = device_profile(lambda: step_fn(state, batch))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"package": occnet_tpu_torch.__file__, "card": card,
           "request": request, "train_step": step}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
