"""The program's own spans and counters in one traced run of a cell.

    python3 -m occbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout.  It runs the cell as ``python3 -m occbench.run
... --trace 1`` does, with the program's spans
(`occnet_tpu_torch.utils.profiling.spans`) on from the start of the
cell's `occbench/drivers/` run, so that set-up is covered too, and prints
that run's result line, the last line of standard output, with one key
more: ``spans``, the readings below.  Its profiled sub-window keeps the
program's ``occ/<name>`` ranges out of the host operations that name the
idle gaps, so the line's ``breakdown`` is built as in a plain traced run,
and names the same gaps once more by the innermost ``occ/`` range
(``outside``: none).

Readings (`readings`): medians over the window's requests or steps of a
span's time in an item, on the device's clock (the host's without a card)
unless named host; None where the run recorded no such span.

- serve: ``input_ms`` (``serve.input``), ``geometry_ms``
  (``encoder.geometry``), ``sca_select_ms`` (``sca.select``),
  ``decode_ms`` (``model.decode``), ``readback_ms`` (``serve.readback``,
  host), ``launch_ms`` (``serve.request`` less its read-back, host),
  ``sca_fill`` (100 x ``sca.visible`` / ``sca.slots`` over the window);
- train: ``trunk_fwd_ms`` (``model.trunk``), ``encoder_fwd_ms``
  (``model.encoder``), ``trunk_bwd_ms`` (``train.backward.trunk``),
  ``clip_ms`` (``train.clip``);
- both: ``program_idle_ms`` (idle of the profiled sub-window inside any
  ``occ/`` range, a request or step), ``idle_ms`` (all its idle, a request
  or step), ``idle_by_span_ms`` (that idle by innermost range, a request or
  step), ``model_init_s`` (``setup.model``, host), ``kernel_load_s``
  (``setup.kernels``, host; in the first request or step when the first
  kernel call loads the library), ``kernels_built`` (the counter),
  ``span_ms`` (every span's median).

Exits with 2 without a CUDA device, or when the program records no spans.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional, Sequence  # noqa: E402
from unittest import mock  # noqa: E402

from occbench import harness, run, trace  # noqa: E402

PREFIX = "occ/"
ROOT = {"serve": "serve.request", "train": "train.step"}
MEDIANS = {"serve": {"input_ms": "serve.input",
                     "geometry_ms": "encoder.geometry",
                     "sca_select_ms": "sca.select",
                     "decode_ms": "model.decode"},
           "train": {"trunk_fwd_ms": "model.trunk",
                     "encoder_fwd_ms": "model.encoder",
                     "trunk_bwd_ms": "train.backward.trunk",
                     "clip_ms": "train.clip"}}


def reduce(device: Sequence[trace.Interval], host: Sequence[trace.Interval],
           occ: Sequence[trace.Interval], window) -> Dict:
    """`trace.reduce` of the timeline without the program's ranges
    ``occ``, and ``idle_by_span``: the same idle gaps named by the
    innermost range at each gap's middle (the span's name, or
    ``outside``), all of them, largest first."""
    out = trace.reduce(device, host, window)
    named = trace.reduce(device, occ, window, top=len(occ) + 1)["idle_gaps"]
    out["idle_by_span"] = [["outside" if k == "host_idle"
                            else k[len(PREFIX):], v] for k, v in named]
    return out


def profile(fn: Callable[[], None]) -> Dict:
    """`trace.profile` with the program's ``occ/`` ranges kept apart
    (`reduce`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            fn()
    device, host, occ, window = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            device.append((name, s, t))
        elif name == trace.WINDOW:
            window = (s, t)
        elif name.startswith(PREFIX):
            occ.append((name, s, t))
        else:
            host.append((name, s, t))
    ranges = {h[0] for h in host} | {h[0] for h in occ} | {trace.WINDOW}
    device = [d for d in device if d[0] not in ranges]
    if window is None or not device:
        raise RuntimeError("the profiler recorded no window or no device "
                           "operation")
    return reduce(device, host, occ, window)


def _ms(row: Dict) -> float:
    return row["host_ms"] if row["device_ms"] is None else row["device_ms"]


def _median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def readings(items: List[Dict], record: Dict, first: int, n: int
             ) -> Dict:
    """The readings (module doc) from the program's summary ``items``
    (`Recorder.summary`) and the run's ``record``: the window is the
    ``n`` items of the cell's root after the ``first`` of set-up."""
    kind = record["kind"]
    window = [it for it in items if it["root"] == ROOT[kind]][first:first + n]
    names = sorted({k for it in window for k in it["spans"]})
    span_ms = {k: _median([_ms(it["spans"][k]) for it in window
                           if k in it["spans"]]) for k in names}
    out = {k: span_ms.get(s) for k, s in MEDIANS[kind].items()}
    if kind == "serve":
        back = [it["spans"]["serve.readback"]["host_ms"] for it in window
                if "serve.readback" in it["spans"]]
        out["readback_ms"] = _median(back)
        out["launch_ms"] = _median([
            it["spans"][ROOT[kind]]["host_ms"]
            - it["spans"].get("serve.readback", {}).get("host_ms", 0.0)
            for it in window])
        slots = sum(it["counters"].get("sca.slots", 0) for it in window)
        out["sca_fill"] = (100.0 * sum(it["counters"].get("sca.visible", 0)
                                       for it in window) / slots
                           if slots else None)
    tr = record.get("trace")
    k = record.get("trace_items")
    if tr and "idle_by_span" in tr:
        out["program_idle_ms"] = 1e3 * sum(
            v for name, v in tr["idle_by_span"] if name != "outside") / k
        out["idle_ms"] = 1e3 * (tr["window_s"] - tr["busy_s"]) / k
        out["idle_by_span_ms"] = [[name, 1e3 * v / k]
                                  for name, v in tr["idle_by_span"]]
    else:
        out["program_idle_ms"] = out["idle_ms"] = None
        out["idle_by_span_ms"] = []

    def setup_s(name: str) -> Optional[float]:
        # in any item: the library loads at the first kernel call, inside
        # the first request or step when nothing loaded it before
        xs = [it["spans"][name]["host_ms"] for it in items
              if name in it["spans"]]
        return 1e-3 * sum(xs) if xs else None

    out["model_init_s"] = setup_s("setup.model")
    out["kernel_load_s"] = setup_s("setup.kernels")
    built = [it["counters"]["kernels.built"] for it in items
             if "kernels.built" in it["counters"]]
    out["kernels_built"] = sum(built) if built else None
    out["window_items"] = len(window)
    out["span_ms"] = span_ms
    return out


def execute(ctx: run.Context, bench: Dict, limits: Dict[str, float]
            ) -> Dict:
    """`run.execute` with the program's spans on over the cell's run and
    the profile of `profile`; the result holds ``spans``, the
    `readings`."""
    from occnet_tpu_torch.utils import profiling
    box = {}
    load = harness.load_module

    def load_module(kind: str, name: str):
        mod = load(kind, name)
        if kind == "drivers":
            drive = mod.run

            def run_with_spans(ctx):
                with profiling.spans() as rec:
                    res = drive(ctx)
                box["res"], box["items"] = res, rec.summary()
                return res

            mod.run = run_with_spans
        return mod

    with mock.patch.object(harness, "load_module", load_module), \
            mock.patch.object(trace, "profile", profile):
        out = run.execute(ctx, bench, limits)
    res, T = box["res"], ctx.traffic
    first = T["warmup"] if res["record"]["kind"] == "serve" \
        else T["checked_steps"]
    out["spans"] = readings(box["items"], res["record"], first,
                            res["attempted"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    limits = harness.limits_file(cell["name"])
    import torch
    from occnet_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        print("occbench.spans: the program records no spans",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"occbench.spans: {args.workload} needs {cell['chips']} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    ctx = run.Context(torch, cell, args.seed, args.seconds, True, t0=T0)
    out = execute(ctx, bench, limits)
    bad = harness.forbidden_modules()
    if bad:
        print(f"occbench.spans: the run loaded {bad}, which the benchmark "
              f"must not load", file=sys.stderr)
        return 3
    errors, numbers = out.pop("_errors"), out.pop("_numbers")
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
