"""Tiny CPU versions of the benchmark's cells for the tests: the program's
tiny configurations of the same encoders, small frames and short mixes."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from occbench import harness
from occbench.run import Context

TINY = {"turbo_occ": "tiny_turbo_occ", "base_occ": "tiny_occ"}


def config_file(cell_config: str, **model) -> dict:
    from occnet_tpu_torch import config
    d = json.loads(json.dumps(dataclasses.asdict(
        config.get_config(TINY[cell_config]))))
    d["model"].update(model)
    return {"name": TINY[cell_config], "reference": "occnet",
            "flow_classes": 8, "config": d}


def context(cell_name: str, seed: int = 12345678901, trace: bool = False,
            **model) -> Context:
    cell = harness.cell(harness.benchmark(), cell_name)
    cf = config_file(cell["config"], **model)
    tr = harness.traffic_file(cell["traffic"])
    m = cf["config"]["model"]
    tr["frame_hw"] = [m["img_h"] - 10, m["img_w"]]
    if tr["driver"] == "serve":
        tr.update(ring=2, warmup=1, sampled=1, sample_from=2, traced=1)
    else:
        tr.update(batch=2, ring=3, checked_steps=2, traced=1)
    return Context(torch, cell, seed, 0.5, trace, "cpu", cf, tr,
                   time.perf_counter())
