"""Tracing and profiling of the port: the program's spans and counters, and
`torch.profiler` traces (the counterpart of `occnet_tpu/utils/
profiling.py`, whose `run_time` decorator has no caller here).

- `span(name)`, `count(name, value)`, `grad_span(module, name)`,
  `spans()`: the spans and counters the program records where its work
  happens (below);
- `trace(log_dir)`: `torch.profiler` over the CPU and, when a card is
  visible, CUDA activity, with the spans on, written as a Chrome trace
  (``trace_rank<r>_<time>.json``) into ``log_dir``, beside the spans'
  summary (``spans_rank<r>_<time>.json``); open the trace in Perfetto or
  chrome://tracing;
- `annotate(name)`: a named region of the trace (`record_function`);
- `device_sync(x)`: wait for the card that holds a tensor of ``x``.

Spans are off by default.  `span` then tests one module flag and returns a
shared no-op context, and `count` returns at once: nothing is recorded or
allocated and no CUDA call is made.  Inside ``with spans() as rec`` (and
inside `trace`) each span records its name, its host start and end
(`time.perf_counter_ns`), a pair of CUDA events when a card is visible
(drawn from the recorder's pool, recorded on the stream that was current
when the item's root opened), its parent (the span open around it on the
same thread) and its item.  A span without a parent is a root and opens a new
item: ``serve.request`` a request, ``train.step`` a train step; the spans
and counts inside it share its item.  While a profiler runs, each span
also opens the range ``occ/<name>``, so that in a profiled window the
spans lie on the device operations' clock.  `count` adds an int or a
tensor (summed on its own device, without a host sync; the sums are read
once, by `Recorder.summary`) to the counter of the innermost open span's
item.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Union

import torch

from occnet_tpu_torch.parallel.multihost import process_shard


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


class _Off:
    """The shared span of recording off: enters, exits and stops as
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def stop(self) -> None:
        pass


_OFF = _Off()


class Span:
    """One recorded span: ``name``, ``item``, ``parent`` (a Span or None),
    host ``t0`` / ``t1`` in ns, and, once its CUDA events are read (after
    its item, or by `Recorder.summary`), ``device_ms`` (None without a
    card)."""
    __slots__ = ("name", "item", "parent", "t0", "t1", "device_ms", "_rec",
                 "_events", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self.name = rec, name
        self.parent: Optional[Span] = None
        self.item = 0
        self.t0 = self.t1 = 0
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        if self.parent is None:
            self.item = rec._new_item()
            rec._root_stream()
        else:
            self.item = self.parent.item
        stack.append(self)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function("occ/" + self.name)
            self._range.__enter__()
        self._events = rec._event_pair()
        if self._events:
            self._events[0].record(rec._stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._events:
            self._events[1].record(self._rec._stream)
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec._stack().pop()
        self._rec._closed(self)
        return False


class _GradSpan(Span):
    """A span that opens when the gradient reaches the outputs of a module
    (the last of them to get it, from a tensor hook on autograd's thread)
    and closes at `stop`; its parent is the span open around `stop`.  It
    opens no profiler range: a range cannot start on one thread and end on
    another."""
    __slots__ = ("_hook",)

    def __init__(self, rec: "Recorder", name: str, module: torch.nn.Module):
        super().__init__(rec, name)
        self._hook = module.register_forward_hook(self._watch)

    def _watch(self, module, args, out) -> None:
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(self._open)

    def _open(self, grad) -> None:
        if self._events is None:
            self._events = self._rec._event_pair()
        if self._events:
            self._events[0].record(self._rec._stream)
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._hook.remove()
        if not self.t0:
            return                      # no gradient reached the module
        self.t1 = time.perf_counter_ns()
        if self._events:
            self._events[1].record(self._rec._stream)
        stack = self._rec._stack()
        self.parent = stack[-1] if stack else None
        self.item = self.parent.item if self.parent else self._rec._new_item()
        self._rec._closed(self)


class Recorder:
    """The spans and counts of one `spans()` block (module doc)."""

    def __init__(self):
        self.records: List[Span] = []
        self.counters: Dict[tuple, List[Union[int, torch.Tensor]]] = {}
        self._items = 0
        self._local = threading.local()
        self._cuda = torch.cuda.is_available()
        self._pool: List[torch.cuda.Event] = []
        self._unread: Deque[Span] = collections.deque()
        self._stream = None             # the current root's stream

    def _root_stream(self) -> None:
        """Take the current stream at a root's start: the item's spans
        record their events on it (`torch.cuda.current_stream` costs more
        than the record itself)."""
        if self._cuda:
            self._stream = torch.cuda.current_stream()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_item(self) -> int:
        self._items += 1
        return self._items

    def _event_pair(self):
        if not self._cuda:
            return None
        if len(self._pool) >= 2:
            return self._pool.pop(), self._pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _closed(self, s: Span) -> None:
        self.records.append(s)
        if s._events:
            self._unread.append(s)
        if s.parent is None:
            self._reap()

    def _reap(self) -> None:
        """Read the spans of finished items.  The unread spans lie in the
        order they closed, an item's root last, so an item is finished
        once its root's end event is; the item of the root that has just
        closed is left for later."""
        unread = self._unread
        while unread:
            n = next((i for i, s in enumerate(unread) if s.parent is None),
                     len(unread) - 1)
            if n == len(unread) - 1 or not unread[n]._events[1].query():
                return
            for _ in range(n + 1):
                self._read(unread.popleft())

    def _read(self, s: Span) -> None:
        e0, e1 = s._events
        s.device_ms = e0.elapsed_time(e1)
        s._events = None
        self._pool += (e0, e1)

    def count(self, name: str, value: Union[int, torch.Tensor]) -> None:
        stack = self._stack()
        key = (stack[-1].item if stack else 0, name)
        if isinstance(value, torch.Tensor):
            value = value.detach().sum()
        self.counters.setdefault(key, []).append(value)

    def _read_events(self) -> None:
        """The device ms of the spans not read yet (one synchronise for
        all)."""
        if not self._unread:
            return
        torch.cuda.synchronize()
        while self._unread:
            self._read(self._unread.popleft())

    def _read_counters(self) -> Dict[tuple, float]:
        """Each counter's total as a float: the tensor values of each
        device read in one copy."""
        out = {k: float(sum(v for v in vs if not isinstance(v, torch.Tensor)))
               for k, vs in self.counters.items()}
        by_device: Dict[torch.device, list] = {}
        for k, vs in self.counters.items():
            for v in vs:
                if isinstance(v, torch.Tensor):
                    by_device.setdefault(v.device, []).append((k, v))
        for kv in by_device.values():
            vals = torch.stack([v.double() for _, v in kv]).tolist()
            for (k, _), x in zip(kv, vals):
                out[k] += x
        return out

    def summary(self) -> List[Dict]:
        """Per item, in order: ``{"item", "root", "spans": {name:
        {"n", "host_ms", "device_ms", "self_ms"}}, "counters": {name:
        value}}``.  A name's times are summed over its spans in the item;
        ``device_ms`` is None without a card; ``self_ms`` is the span's
        time (on the device clock when there is one, else the host's) less
        its child spans'.  Item 0 holds counts made outside any span."""
        self._read_events()

        def ms(s: Span) -> float:
            return s.host_ms if s.device_ms is None else s.device_ms

        child_ms: Dict[int, float] = {}
        for s in self.records:
            if s.parent is not None:
                child_ms[id(s.parent)] = child_ms.get(id(s.parent), 0.0) \
                    + ms(s)
        items: Dict[int, Dict] = {}

        def item(i: int, root: Optional[str]) -> Dict:
            if i not in items:
                items[i] = {"item": i, "root": root, "spans": {},
                            "counters": {}}
            return items[i]

        for s in self.records:
            it = item(s.item, None)
            if s.parent is None:
                it["root"] = s.name
            row = it["spans"].setdefault(s.name, {
                "n": 0, "host_ms": 0.0, "device_ms": None, "self_ms": 0.0})
            row["n"] += 1
            row["host_ms"] += s.host_ms
            if s.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
            row["self_ms"] += ms(s) - child_ms.get(id(s), 0.0)
        for (i, name), v in self._read_counters().items():
            item(i, None)["counters"][name] = v
        return [items[i] for i in sorted(items)]


_rec: Optional[Recorder] = None        # the innermost `spans()` block's


def span(name: str):
    """The span ``name`` as a context manager (module doc)."""
    if _rec is None:
        return _OFF
    return Span(_rec, name)


def grad_span(module: torch.nn.Module, name: str):
    """A span ``name`` from the moment the backward's gradient reaches the
    outputs of ``module`` (registered on its next forward) until the
    returned object's ``stop()``.  Off: a no-op with ``stop()``."""
    if _rec is None:
        return _OFF
    return _GradSpan(_rec, name, module)


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (an int, or a tensor: its sum) to the counter ``name``
    of the current item; nothing when spans are off."""
    if _rec is not None:
        _rec.count(name, value)


@contextlib.contextmanager
def spans() -> Iterator[Recorder]:
    """Record spans and counts for the block; yields its `Recorder`."""
    global _rec
    outer, _rec = _rec, Recorder()
    try:
        yield _rec
    finally:
        _rec = outer


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` over the block with the spans on, a Chrome trace
    and the spans' summary written to ``log_dir`` at its end (see the
    module doc)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with spans() as rec, profile(activities=activities) as prof:
        yield prof
        device_sync()
    stem = f"rank{process_shard()[0]}_{int(time.time())}.json"
    prof.export_chrome_trace(os.path.join(log_dir, "trace_" + stem))
    with open(os.path.join(log_dir, "spans_" + stem), "w") as f:
        json.dump(rec.summary(), f)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
