"""Readings that the correctness limits are set from, for one cell, in one
process:

    python3 -m occbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2 --out <file.json>

For each of ``--seeds`` a run of the cell with a short window (the
program's numbers: the lower readings), and for each of
``--control-seeds`` the control's numbers (the float32 reference against
itself computed in fp8, the precision below the configuration's bf16; for
a train cell also the reference fed half of each batch).  Prints and
writes every reading; the limits in `occbench/limits/<cell>.json` lie
between the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from occbench import harness
from occbench.reference.occnet import fp8
from occbench.run import Context


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("occbench.calibrate needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"cell": cell["name"], "card": harness.power_limit(),
           "program": [], "control": []}
    for seed in seeds:
        ctx = Context(torch, cell, seed, args.seconds, False,
                      t0=time.perf_counter())
        driver = harness.load_module("drivers", ctx.traffic["driver"])
        res = driver.run(ctx)
        row = {"seed": seed, "failed": res["failed"], **res["numbers"]}
        out["program"].append(row)
        print(json.dumps(row), flush=True)
        del res
        ctx.free()
    for seed in controls:
        ctx = Context(torch, cell, seed, args.seconds, False,
                      t0=time.perf_counter())
        driver = harness.load_module("drivers", ctx.traffic["driver"])
        row = {"seed": seed, **driver.control_readings(ctx, fp8)}
        out["control"].append(row)
        print(json.dumps(row), flush=True)
        ctx.free()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
