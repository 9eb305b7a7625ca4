"""The trace reduction on a hand-made timeline."""

import pytest

from occbench import readers, trace


def test_reduce_busy_idle_and_gap_names():
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0),
              ("k3", 9.5, 10.5)]
    host = [("outer", 0.0, 10.0), ("cudaLaunchKernel", 3.5, 4.5),
            (trace.WINDOW, 0.0, 10.0)]
    r = trace.reduce(device, host, (0.0, 10.0))
    # busy: [1, 3] + [5, 6] + [9.5, 10] inside the window
    assert r["busy_s"] == pytest.approx(3.5)
    assert r["window_s"] == 10.0
    assert r["ops"] == {"k1": 2.0, "k2": 1.5, "k3": 1.0}
    assert r["launches"] == {"k1": 2, "k2": 1, "k3": 1}
    gaps = dict(r["idle_gaps"])
    # gaps [0, 1], [3, 5], [6, 9.5]: the middle of [3, 5] is 4, inside the
    # launch; the others only inside "outer"
    assert gaps == {"outer": pytest.approx(4.5),
                    "cudaLaunchKernel": pytest.approx(2.0)}
    assert r["device_ops"][0] == ["k1", 2.0]
    rec = {"kind": "train", "trace": r}
    assert readers.idle_share(rec, "train") == pytest.approx(65.0)
    assert trace.kernel_seconds(r, "k1") == (2.0, 2)
    assert trace.kernel_seconds(r, "k") == (0, 0)


def test_gap_without_host_activity_and_long_names():
    r = trace.reduce([("a", 2.0, 3.0)], [], (0.0, 4.0))
    assert dict(r["idle_gaps"]) == {"host_idle": 3.0}
    assert trace.short("void " + "x" * 200) == "x" * 117 + "..."


def test_roofline_scales_recorded_calls_to_traced_items():
    r = trace.reduce([("void tap_kernel<float>(int)", 0.0, 1.0)], [],
                     (0.0, 1.0))
    call = dict(B=1, nq=2, H=2, W=2, C=8, heads=2, taps=9, v_bytes=2,
                attn_bytes=2, out_bytes=4)
    rec = {"kind": "serve", "trace": r, "trace_items": 4, "calls_items": 2,
           "calls": {"tap": [call]}}
    want = 100 * 2 * 544 / 3.35e12
    assert readers.roofline(rec, "serve", "tap_kernel", "tap",
                            readers.tap_cost) == pytest.approx(want)
    assert readers.roofline(rec, "serve", "msda_kernel", "msda",
                            readers.tap_cost) is None


def test_innermost_sweep_matches_a_direct_search():
    import random
    r = random.Random(5)
    host = []
    for i in range(300):
        a = r.uniform(0, 100)
        host.append((f"op{i}", a, a + r.expovariate(0.2)))
    points = sorted(r.uniform(0, 110) for _ in range(200))
    want = []
    for p in points:
        inside = [h for h in host if h[1] <= p <= h[2]]
        want.append(max(inside, key=lambda h: h[1])[0] if inside
                    else "host_idle")
    assert trace.innermost(host, points) == want
