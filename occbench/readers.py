"""Helpers of the per-layer metric readers in `occbench/metrics/`: each
reader is ``read(record) -> number or None`` over a run's record (its
kind, window, request or step times, CUDA-event spans, the reduced trace
of the profiled sub-window and the kernel calls recorded after it)."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Tuple

from occbench import trace, yardstick


def median_span(record: Dict, kind: str, span: str) -> Optional[float]:
    xs = record.get("spans_ms", {}).get(span) if record["kind"] == kind \
        else None
    return statistics.median(xs) if xs else None


def roofline(record: Dict, kind: str, kernel: str, calls: str,
             cost: Callable[[Dict], Tuple[float, float]]) -> Optional[float]:
    """The kernel's least time over its device time in the profiled
    sub-window, in %: the least time of the calls recorded after it,
    scaled from the recorded items to the traced ones; None where the
    kernel did not run or no call was recorded."""
    if record["kind"] != kind or "trace" not in record:
        return None
    spent, _ = trace.kernel_seconds(record["trace"], kernel)
    recorded = record["calls"].get(calls, [])
    if spent <= 0 or not recorded:
        return None
    least = sum(yardstick.least_time_s(*cost(c))[0] for c in recorded)
    least *= record["trace_items"] / record["calls_items"]
    return 100.0 * least / spent


def idle_share(record: Dict, kind: str) -> Optional[float]:
    tr = record.get("trace") if record["kind"] == kind else None
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(record: Dict, kind: str) -> Optional[float]:
    if record["kind"] != kind:
        return None
    return yardstick.mfu_percent(record["flops_per_item"], record["items"],
                                 record["window_s"])


def lift_cost(c: Dict) -> Tuple[float, float]:
    return yardstick.lift_level_cost(c["B"], c["A"], c["h"], c["w"], c["C"],
                                     c["ZR"], c["M"], c["Q"], c["live"],
                                     c["feat_bytes"], c["out_bytes"])


def lift_bwd_cost(c: Dict) -> Tuple[float, float]:
    return yardstick.lift_bwd_level_cost(c["B"], c["A"], c["h"], c["w"],
                                         c["C"], c["ZR"], c["M"], c["Q"],
                                         c["live"], c["g_bytes"],
                                         c["dfeat_bytes"])


def tap_cost(c: Dict) -> Tuple[float, float]:
    return yardstick.tap_cost(c["B"], c["nq"], c["H"], c["W"], c["C"],
                              c["heads"], c["taps"], c["v_bytes"],
                              c["attn_bytes"], c["out_bytes"])
