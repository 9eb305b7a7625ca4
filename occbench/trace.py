"""The traced sub-window: `torch.profiler` over a few requests or steps,
reduced in memory to device time by operation name, the device's busy
time (the union of its operation intervals), and the idle gaps named by
what the host was doing in each.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "occbench.window"
Interval = Tuple[str, float, float]      # (name, start s, end s)


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, sorted and merged."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def short(name: str, n: int = 120) -> str:
    """A device operation's name for the breakdown: without a leading
    "void " and namespaces that every ATen kernel carries, cut to ``n``
    characters."""
    name = name[5:] if name.startswith("void ") else name
    for ns in ("at::native::", "(anonymous namespace)::", "c10::"):
        name = name.replace(ns, "")
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce(device: Sequence[Interval], host: Sequence[Interval],
           window: Tuple[float, float], top: int = 10) -> Dict:
    """Reduce a timeline: ``device`` and ``host`` operations as (name,
    start, end) in seconds on one clock, ``window`` the traced span.
    Returns busy_s (union of device intervals inside the window),
    window_s, ops {name: device seconds}, launches {name: count},
    device_ops and idle_gaps (the ``top`` largest, [name, seconds]); an
    idle gap is named by the innermost host operation running at its
    middle, or "host_idle"."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in device
               if e > w0 and s < w1]
    busy = union(clipped)
    ops: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for name, s, e in device:
        ops[name] += e - s
        launches[name] += 1
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, innermost(host, [0.5 * (a + b)
                                                  for a, b in gaps])):
        named[name] += b - a
    return {"busy_s": sum(e - s for s, e in busy), "window_s": w1 - w0,
            "ops": dict(ops), "launches": dict(launches),
            "device_ops": sorted(([short(k), v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in named.items()),
                                key=lambda kv: -kv[1])[:top]}


def innermost(host: Sequence[Interval], points: Sequence[float]
              ) -> List[str]:
    """For each of the ascending ``points``, the name of the host operation
    that contains it and started last (the innermost on its thread), or
    "host_idle": one sweep with a heap of the operations started so far,
    latest start on top, dropping those that ended before the point."""
    ops = sorted((h for h in host if h[0] != WINDOW), key=lambda h: h[1])
    heap: List[Tuple[float, float, str]] = []
    out, i = [], 0
    for p in points:
        while i < len(ops) and ops[i][1] <= p:
            heapq.heappush(heap, (-ops[i][1], ops[i][2], ops[i][0]))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host_idle")
    return out


def kernel_seconds(reduced: Dict, pattern: str) -> Tuple[float, int]:
    """(device seconds, launches) of the operations whose name matches
    the regular expression ``pattern`` as a whole word."""
    rx = re.compile(rf"(?<![A-Za-z0-9_]){pattern}(?![A-Za-z0-9_])")
    t = n = 0
    for name, s in reduced["ops"].items():
        if rx.search(name):
            t += s
            n += reduced["launches"][name]
    return t, n


def profile(fn: Callable[[], None]) -> Dict:
    """Run ``fn`` (which ends in a device synchronise) under
    `torch.profiler` with CPU and CUDA activities and reduce its trace
    (the profiler's raw events, without building its event tree)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            device.append((name, s, t))
        elif name == WINDOW:
            window = (s, t)
        else:
            host.append((name, s, t))
    # a host range (record_function, an optimizer's step) also shows as a
    # device annotation of the same name: it is no operation on the card
    ranges = {h[0] for h in host} | {WINDOW}
    device = [d for d in device if d[0] not in ranges]
    if window is None or not device:
        raise RuntimeError("the profiler recorded no window or no device "
                           "operation")
    return reduce(device, host, window)
