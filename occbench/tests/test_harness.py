"""The harness finds configurations, traffic mixes, drivers, limits and
metric readers by name, and BENCHMARK.json keeps to its contract."""

import dataclasses
import json
import os
import re
import shutil

import pytest

from occbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "occbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "serve_burst.json").write_text(json.dumps(
        {"driver": "serve", "ring": 2}))
    cfg = json.loads((root / "configs" / "turbo_occ.json").read_text())
    cfg["name"] = "turbo_occ_copy"
    (root / "configs" / "turbo_occ_copy.json").write_text(json.dumps(cfg))
    (root / "metrics" / "requests.serve.py").write_text(
        "def read(record):\n    return float(record['items'])\n")
    (root / "limits" / "turbo_occ_copy.serve_burst.json").write_text(
        json.dumps({"occ_gap": 0.5}))
    monkeypatch.setattr(harness, "HERE", str(root))
    assert harness.traffic_file("serve_burst")["ring"] == 2
    assert harness.config_file("turbo_occ_copy")["name"] == "turbo_occ_copy"
    assert harness.load_module("metrics", "requests.serve").read(
        {"items": 7}) == 7.0
    assert harness.limits_file("turbo_occ_copy.serve_burst") == {
        "occ_gap": 0.5}
    assert hasattr(harness.load_module("drivers", "serve"), "run")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "missing.serve")


def test_metrics_are_chosen_by_workloads_and_moves():
    bench = {"end_to_end": [
        {"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "x", "moves": "rate"},
                      {"name": "y", "moves": "rate", "workloads": ["b"]},
                      {"name": "z", "moves": "setup_s"}]}
    assert [m["name"] for m in harness.per_layer_for(bench, "a")] == [
        "x", "z"]
    assert [m["name"] for m in harness.per_layer_for(bench, "b")] == ["z"]
    assert [m["name"] for m in harness.end_to_end_for(bench, "b")] == [
        "setup_s"]


def test_checks_and_forbidden_names(monkeypatch):
    checks = harness.judge({"a": 0.1, "b": 2.0, "extra": 9}, {"a": 0.2,
                                                               "b": 1.0})
    assert checks == {"a": {"value": 0.1, "limit": 0.2},
                      "b": {"value": 2.0, "limit": 1.0}}
    assert not harness.passed(checks)
    with pytest.raises(KeyError):
        harness.judge({}, {"a": 1.0})
    import sys
    fake = dict(sys.modules)
    fake.update({"occnet_tpu_torch.serve": None, "occnet_tpux": None})
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["occnet_tpu.config"] = None
    assert harness.forbidden_modules() == ["occnet_tpu"]


@pytest.mark.parametrize("name", ["turbo_occ", "base_occ"])
def test_config_files_are_the_programs_named_configs(name):
    from occnet_tpu_torch.config import get_config
    f = harness.config_file(name)
    cfg = harness.program_config(f)
    assert cfg == get_config(f["port_config"])
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == f["config"]


def test_benchmark_keeps_to_its_contract():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and len(json.dumps(b)) < 65536
    root = harness.ROOT
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(root, c["file"]))
        assert c["file"].startswith("occbench/")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        tr = harness.traffic_file(w["traffic"])
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           tr["driver"] + ".py"))
        assert harness.limits_file(w["name"])
        reports = [m["name"] for m in harness.end_to_end_for(b, w["name"])]
        assert "setup_s" in reports and len(reports) >= 2
        assert harness.per_layer_for(b, w["name"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
