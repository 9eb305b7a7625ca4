"""What every cell shares: finding a cell's configuration, traffic mix,
driver, limits and per-layer metric readers by name, the device's
description, and the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.  The
configuration is `occbench/configs/<name>.json`, the traffic mix
`occbench/traffic/<name>.json`, and the traffic file names its driver,
`occbench/drivers/<driver>.py`, and the correctness limits of the cell
are `occbench/limits/<cell>.json`.  A per-layer metric is read by
`occbench/metrics/<metric name>.py`, whose ``read(record)`` returns a
number or None.  A new cell, mix or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import typing
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "occbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "occnet_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Dict:
    return load_json(HERE, "configs", name + ".json")


def traffic_file(name: str) -> Dict:
    return load_json(HERE, "traffic", name + ".json")


def limits_file(cell_name: str) -> Dict[str, float]:
    return load_json(HERE, "limits", cell_name + ".json")


def load_module(kind: str, name: str):
    """occbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"occbench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def from_dict(cls, data: Any):
    """A (nested, frozen) dataclass of type ``cls`` from its dict; lists
    become tuples."""
    if dataclasses.is_dataclass(cls):
        hints = typing.get_type_hints(cls)
        return cls(**{k: from_dict(hints[k], v) for k, v in data.items()})
    if isinstance(data, list):
        return tuple(from_dict(None, v) for v in data)
    return data


def program_config(cfg_file: Dict):
    """The program's configuration object of a configuration file, checked
    to hold exactly the file's values."""
    from occnet_tpu_torch.config import OccNetConfig
    cfg = from_dict(OccNetConfig, cfg_file["config"])
    if json.loads(json.dumps(dataclasses.asdict(cfg))) != cfg_file["config"]:
        raise ValueError(f"{cfg_file['name']}: the file does not round-trip "
                         f"through the program's configuration")
    return cfg


def per_layer_for(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics a cell reports."""
    moves = {m["name"] for m in bench["end_to_end"]
             if cell_name in m.get("workloads", [cell_name])}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in moves]


def end_to_end_for(bench: Dict, cell_name: str) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``occnet_tpu_torch`` is not ``occnet_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every compared number."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
