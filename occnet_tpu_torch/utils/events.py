"""Structured experiment-metric event stream (counterpart of `occnet_tpu/
utils/events.py`, the same record format): one JSON object per logging
event appended to `<work_dir>/metrics.jsonl` with the keys ``ts`` (Unix
time), ``step``, ``tag`` ("train", "eval", "abort", "hbm") and the event's
scalars, flushed at each event so a killed run keeps every logged step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JsonlWriter:
    """Append-only JSONL metric writer, flushed per event."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, tag: str = "train",
              t: Optional[float] = None, **scalars):
        rec = {"ts": time.time() if t is None else t, "step": int(step),
               "tag": tag}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
