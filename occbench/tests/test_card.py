"""On a CUDA device: one short run of each cell through the benchmark's
command, its result line and its check."""

import json
import os
import subprocess

import pytest

from occbench import harness


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    b = harness.benchmark()
    cmd = b["command"] + ["--workload", cell, "--seed", "3000000019",
                          "--seconds", "3", "--trace", "0"]
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-4000:]
    assert set(res["metrics"]) == {
        m["name"] for m in harness.end_to_end_for(b, cell)}
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
