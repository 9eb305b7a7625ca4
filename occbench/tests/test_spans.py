"""The reader of the program's spans (`occbench.spans`): its trace reduction
on a hand-made timeline, and its readings on tiny CPU runs of each cell."""

import pytest

from occbench import harness, spans, trace
from occbench.tests import tiny


def test_program_ranges_leave_the_breakdown_as_it_was():
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0),
              ("k3", 9.5, 10.5)]
    host = [("outer", 0.0, 10.0), ("cudaLaunchKernel", 3.5, 4.5),
            (trace.WINDOW, 0.0, 10.0)]
    occ = [("occ/serve.request", 0.5, 8.0), ("occ/model.trunk", 2.5, 4.5),
           ("occ/model.decode", 5.5, 6.5)]
    window = (0.0, 10.0)
    plain = trace.reduce(device, host, window)
    out = spans.reduce(device, host, occ, window)
    by_span = dict(out.pop("idle_by_span"))
    assert out == plain
    # gaps [0, 1] (middle 0.5: the request's start), [3, 5] (4: the
    # trunk), [6, 9.5] (7.75: the request)
    assert by_span == {"serve.request": pytest.approx(4.5),
                       "model.trunk": pytest.approx(2.0)}
    # a gap whose middle lies outside every range is "outside"; the names
    # add up to all the idle, those inside the ranges to the idle in them
    out = spans.reduce(device, host, occ[1:], window)
    by_span = dict(out["idle_by_span"])
    assert by_span == {"model.trunk": pytest.approx(2.0),
                       "outside": pytest.approx(4.5)}
    assert sum(by_span.values()) == pytest.approx(out["window_s"]
                                                  - out["busy_s"])


def summary_item(i, root, spans_ms, counters=None):
    return {"item": i, "root": root, "counters": counters or {},
            "spans": {k: {"n": 1, "host_ms": h, "device_ms": d,
                          "self_ms": 0.0} for k, (h, d) in spans_ms.items()}}


def test_readings_take_the_window_and_the_setup_apart():
    items = [summary_item(1, "setup.model", {"setup.model": (500.0, None)})]
    for i in range(6):                       # 2 warm-up, 3 window, 1 traced
        items.append(summary_item(
            2 + i, "serve.request",
            {"serve.request": (40.0 + i, 45.0 + i), "serve.input": (1, 2 + i),
             "sca.select": (1, 5.0), "serve.readback": (2.0 + i, None)},
            {"sca.visible": 6.0, "sca.slots": 8.0}))
    # the first request's first kernel call loads the library
    items[1]["spans"]["setup.kernels"] = {"n": 1, "host_ms": 30.0,
                                          "device_ms": None, "self_ms": 30.0}
    items[1]["counters"]["kernels.built"] = 0.0
    record = {"kind": "serve", "trace_items": 2,
              "trace": {"window_s": 0.1, "busy_s": 0.07,
                        "idle_by_span": [["sca.select", 0.02],
                                         ["outside", 0.01]]}}
    r = spans.readings(items, record, 2, 3)
    assert r["window_items"] == 3
    assert r["input_ms"] == 5.0 and r["sca_select_ms"] == 5.0
    assert r["geometry_ms"] is None and r["decode_ms"] is None
    assert r["readback_ms"] == 5.0 and r["launch_ms"] == 38.0
    assert r["sca_fill"] == 75.0
    assert r["program_idle_ms"] == pytest.approx(10.0)
    assert r["idle_ms"] == pytest.approx(15.0)
    assert r["model_init_s"] == 0.5 and r["kernel_load_s"] == 0.03
    assert r["kernels_built"] == 0.0
    assert r["span_ms"]["serve.request"] == 48.0


@pytest.mark.parametrize("cell", ["turbo_occ.serve", "base_occ.serve",
                                  "base_occ.train", "turbo_occ.train"])
def test_readings_of_a_tiny_cpu_run(cell):
    """Each reading is a number where the cell's program records its span
    and None where it does not: the gather encoder's `sca.select`, read-back
    and fill are `base_occ`'s alone; the CPU loads no kernel library, and
    an untraced run has no profile."""
    ctx = tiny.context(cell, compute_dtype="float32", img_h=96, img_w=128)
    out = spans.execute(ctx, harness.benchmark(), harness.limits_file(cell))
    assert out["correct"] and out["failed"] == 0
    r = out["spans"]
    assert r["window_items"] == out["attempted"]
    gather = cell.startswith("base_occ")
    if cell.endswith(".serve"):
        numbers = ["input_ms", "geometry_ms", "decode_ms", "launch_ms"]
        if gather:
            numbers += ["sca_select_ms", "readback_ms", "sca_fill"]
        else:
            for k in ("sca_select_ms", "readback_ms", "sca_fill"):
                assert r[k] is None, k
    else:
        numbers = ["trunk_fwd_ms", "encoder_fwd_ms", "trunk_bwd_ms",
                   "clip_ms"]
    numbers.append("model_init_s")
    for k in numbers:
        assert isinstance(r[k], float) and r[k] > 0, k
    if gather and cell.endswith(".serve"):
        assert 0 < r["sca_fill"] <= 100
    for k in ("kernel_load_s", "kernels_built", "program_idle_ms"):
        assert r[k] is None, k
