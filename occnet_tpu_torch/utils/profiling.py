"""Tracing and profiling helpers (counterpart of `occnet_tpu/utils/
profiling.py`): the reference's `run_time` rolling-latency decorator
(`models/utils/bricks.py:7-19`, which synchronises the card and prints
means) and its commented-out profiler hook, here on `torch.profiler`.

- `device_sync(x)`: wait for the card that holds a tensor of ``x``;
- `run_time(name)`: decorator printing each call's latency and the mean;
- `trace(log_dir)`: `torch.profiler` over the CPU and, when a card is
  visible, CUDA activity, written as a Chrome trace
  (``trace_rank<r>_<time>.json``) into ``log_dir``; open it in Perfetto or
  chrome://tracing;
- `annotate(name)`: a named region of the trace (`record_function`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

import torch

from occnet_tpu_torch.parallel.multihost import process_shard

_STATS: Dict[str, list] = defaultdict(list)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None) -> None:
    """Wait for the device work queued before this call: the card of the
    first tensor in ``x`` (a tensor, or dicts / lists of them), the current
    card when ``x`` is None; nothing for CPU tensors."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    elif t is None and torch.cuda.is_available():
        torch.cuda.synchronize()


def run_time(name: str) -> Callable:
    """Decorator printing a rolling mean latency for the wrapped function
    (the reference's `run_time`), synchronising on the output."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            device_sync(out)
            dt = time.perf_counter() - t0
            _STATS[name].append(dt)
            vals = _STATS[name]
            print(f"[run_time] {name}: {dt * 1e3:.1f} ms (mean "
                  f"{sum(vals) / len(vals) * 1e3:.1f} ms, n={len(vals)})")
            return out
        return wrapped
    return deco


def reset_run_time_stats():
    _STATS.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` over the block, a Chrome trace written to
    ``log_dir`` at its end (see the module doc)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        device_sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_rank{process_shard()[0]}_{int(time.time())}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
