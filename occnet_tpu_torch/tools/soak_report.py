"""Distill a training run's `metrics.jsonl` into a soak report (counterpart
of `tools/soak_report.py`, the same keys).

    python -m occnet_tpu_torch.tools.soak_report work_dirs/soak_turbo \
        --out SOAK_torch.json [--config turbo_occ]

It reads ``<work_dir>/metrics.jsonl`` (`utils.events.JsonlWriter`'s
stream, written by `tools.train`) and the run's checkpoints, and writes
one JSON summary: step-time drift (the mean s/it of the first and the last
quarter of the logged steps, the first 3 logs left out as warm-up), the
first and last loss, the eval hook's scores, ``cert_overflow_total``, the
checkpoint steps, the peak device memory of the "hbm" event and the
number of aborts.  The checkpoints are the steps
`training.checkpoint.CheckpointManager` keeps in the work directory
(``ckpt_<step>.pt``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def soak_report(work_dir: str, config: Optional[str] = None) -> dict:
    """The report of the run in ``work_dir`` (see the module doc)."""
    from occnet_tpu_torch.training.checkpoint import CheckpointManager
    path = os.path.join(work_dir, "metrics.jsonl")
    with open(path) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    train = [e for e in events if e.get("tag") == "train"]
    evals = [e for e in events if e.get("tag") == "eval"]
    hbm = [e for e in events if e.get("tag") == "hbm"]
    aborts = [e for e in events if e.get("tag") == "abort"]
    if not train:
        raise ValueError(f"no train events in {path}")
    sit = [e["s_per_it"] for e in train if "s_per_it" in e][3:]
    q = max(len(sit) // 4, 1)
    first, last = sit[:q], sit[-q:]

    def mean(xs):
        return sum(xs) / len(xs)

    mngr = CheckpointManager(work_dir)
    steps = mngr.all_steps()
    mngr.close()
    return {
        "config": config or os.path.basename(os.path.normpath(work_dir)),
        "steps_logged": len(train),
        "first_step": train[0]["step"],
        "last_step": train[-1]["step"],
        "loss_first": train[0].get("loss"),
        "loss_last": train[-1].get("loss"),
        "s_per_it_early": round(mean(first), 4),
        "s_per_it_late": round(mean(last), 4),
        "s_per_it_drift_pct": round(
            100.0 * (mean(last) - mean(first)) / mean(first), 2),
        "cert_overflow_total": int(sum(
            e.get("cert_overflow", 0) for e in train)),
        "evals": [{"step": e["step"],
                   **{k: v for k, v in e.items()
                      if k not in ("step", "tag", "wall_time")}}
                  for e in evals],
        "checkpoints": steps,
        "peak_hbm_gib": (round(hbm[-1]["peak_bytes_in_use"] / 2 ** 30, 2)
                         if hbm else None),
        "aborts": len(aborts),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("work_dir")
    p.add_argument("--out", default="SOAK_torch.json")
    p.add_argument("--config", default=None,
                   help="config name to record (else the work dir's name)")
    args = p.parse_args(argv)
    try:
        report = soak_report(args.work_dir, args.config)
    except ValueError as e:
        sys.exit(str(e))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print(f"written: {args.out}")
    return report


if __name__ == "__main__":
    main()
