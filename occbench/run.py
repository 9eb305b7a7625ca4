"""Run one cell of the benchmark once.

    python3 -m occbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (a
traced run also profiles a short sub-window).  Every run checks what the
timed path produced against the plain reference and prints each compared
number beside its limit, as the last lines of standard error and under
``checks`` at the end of the result line, the last line of standard
output.  Without a CUDA device, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from occbench import harness  # noqa: E402


class Context:
    """What a driver needs of a run: the seed, window and trace flag, the
    cell's configuration (file and program object) and traffic, the device
    and the run's start time."""

    def __init__(self, torch, cell: Dict, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 cfg_file: Optional[Dict] = None,
                 traffic: Optional[Dict] = None, t0: float = T0):
        self.torch, self.cell, self.device = torch, cell, device
        self.seed, self.seconds, self.trace, self.t0 = (int(seed),
                                                        float(seconds),
                                                        bool(trace), t0)
        self.cfg_file = cfg_file or harness.config_file(cell["config"])
        self.cfg = harness.program_config(self.cfg_file)
        self.traffic = traffic or harness.traffic_file(cell["traffic"])
        self.wrap_step = lambda step: step        # tests plant faults here

    @property
    def cuda(self) -> bool:
        return self.device != "cpu"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def device_info(self) -> Dict:
        if self.cuda:
            return harness.device_info(self.torch, self.cell["chips"])
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 without TF32 for the reference."""
        torch = self.torch
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32,
               torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old[0]
            torch.backends.cudnn.allow_tf32 = old[1]
            torch.set_float32_matmul_precision(old[2])


def execute(ctx: Context, bench: Dict, limits: Dict[str, float]) -> Dict:
    """Run the cell's driver and assemble the result line's object."""
    driver = harness.load_module("drivers", ctx.traffic["driver"])
    res = driver.run(ctx)
    name = ctx.cell["name"]
    checks = harness.judge(res["numbers"], limits)
    correct = harness.passed(checks) and res["failed"] == 0
    metrics = {}
    if not ctx.trace:
        for m in harness.end_to_end_for(bench, name):
            v = (res["setup_s"] if m["name"] == "setup_s"
                 else res["e2e"][m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in harness.per_layer_for(bench, name):
            v = harness.load_module("metrics", m["name"]).read(res["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(res["device"])
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    tr = res["record"].get("trace")
    if ctx.trace and tr:
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    out["_errors"] = res.get("errors", [])
    out["_numbers"] = res["numbers"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    limits = harness.limits_file(cell["name"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"occbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    ctx = Context(torch, cell, args.seed, args.seconds, bool(args.trace))
    out = execute(ctx, bench, limits)
    bad = harness.forbidden_modules()
    if bad:
        print(f"occbench: the run loaded {bad}, which the benchmark must "
              f"not load", file=sys.stderr)
        return 3
    errors, numbers = out.pop("_errors"), out.pop("_numbers")
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'OVER'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
