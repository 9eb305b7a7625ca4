"""Served frames: a closed loop of one client with a batch of 1, requests
back to back, each handed to `Predictor.__call__` as a uint8 host frame in
pinned memory and done when its outputs (classes and flow) are complete on
the device.

Traffic file keys: ``ring`` (distinct frames, made from the seed before the
window), ``warmup`` (requests of set-up), ``sampled`` (requests whose
outputs are checked, drawn from the seed among the first ``sample_from``;
the last request of the window is checked too), ``traced`` (requests
under the profiler in a traced run).

The check: the reference (plain float32) reads each checked request's
frame, and two numbers are compared with the cell's limits:
``occ_gap``, the widest gap by which the reference's logit of a served
class lies below the reference's best logit of that voxel, over the
standard deviation of the reference's logits; and ``flow_err``, the L2
distance of the served flow from the reference's over the reference's
L2 norm.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List

import numpy as np

from occbench import inputs, program, trace, yardstick


def setup(ctx) -> Dict:
    """Model, weights, frames and rig of the run, on ctx.device."""
    torch, cfg, T = ctx.torch, ctx.cfg, ctx.traffic
    m, dev = cfg.model, ctx.device
    model = program.build_model(cfg, dev)
    spec = program.weight_spec(model)
    weights = inputs.make_weights(spec, ctx.seed, dev)
    model.load_state_dict(weights)
    gen = inputs.generator(ctx.seed, 2, dev)
    h, w = T["frame_hw"]
    frames = []
    for _ in range(T["ring"]):
        f = inputs.images(gen, 1, m.num_cams, h, w, dev)
        host = torch.empty(f.shape, dtype=torch.uint8,
                           pin_memory=dev != "cpu")
        frames.append(host.copy_(f))
    e2i = torch.from_numpy(inputs.ring_rig(m.num_cams, m.img_h, m.img_w, 1))
    if dev != "cpu":
        e2i = e2i.pin_memory()
    weights = {k: v.to("cpu") for k, v in weights.items()}
    return {"pred": program.predictor(cfg, model), "frames": frames,
            "e2i": e2i, "weights": weights, "spec": spec}


def checked_indices(seed: int, T: Dict) -> List[int]:
    rng = np.random.default_rng(int(seed) % 2 ** 63 + 3)
    return sorted(int(i) for i in rng.choice(T["sample_from"], T["sampled"],
                                             replace=False))


def run(ctx) -> Dict:
    T = ctx.traffic
    s = setup(ctx)
    pred, frames, e2i = s["pred"], s["frames"], s["e2i"]
    sync = ctx.sync
    ring = len(frames)

    def request(i):
        out = pred(frames[i % ring], e2i)
        sync()
        return out

    sync()
    ctx.reset_peak()
    for i in range(T["warmup"]):
        request(i)
    setup_s = time.perf_counter() - ctx.t0

    hooks = Spans(ctx, pred.model) if ctx.trace else None
    keep = set(checked_indices(ctx.seed, T))
    kept, lat, failed, errors = {}, [], 0, []
    n = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if hooks:
            hooks.begin()
        try:
            out = request(n)
        except RuntimeError as e:         # a certificate the program raised
            failed += 1
            errors.append(str(e))
            out = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if out is not None and (n in keep):
            kept[n] = out
        last = (n, out)
        n += 1
        if t1 - t_start >= ctx.seconds or failed > 10:
            break
    window_s = t1 - t_start
    if last[1] is not None:
        kept[last[0]] = last[1]
    record = {"kind": "serve", "latency_ms": [x * 1e3 for x in lat],
              "items": n, "window_s": window_s,
              "flops_per_item": yardstick.model_flops(ctx.cfg_file["config"][
                  "model"], 1, False)}
    peak = ctx.device_info()              # the window's, before any trace
    if hooks:
        record["spans_ms"] = hooks.finish()
        record.update(traced(ctx, request, T))
    del request, pred, s["pred"]
    ctx.free()
    numbers = compare(ctx, s, kept)
    return {"setup_s": setup_s, "window_s": window_s, "attempted": n,
            "failed": failed, "errors": errors[:3], "device": peak,
            "numbers": numbers, "record": record,
            "e2e": {"latency_ms_p95": yardstick.percentile(
                        record["latency_ms"], 95),
                    "frames_per_s": n / window_s,
                    "peak_gib": peak["memory_peak_bytes"] / 2 ** 30}}


class Spans:
    """CUDA events at the trunk's (backbone + neck) and the encoder's
    (`TransformerOcc.get_bev_features`: the lift or the pyramid, and the
    encoder layers) bounds of every request of the window."""

    def __init__(self, ctx, model):
        self.torch, self.rows, self.cur = ctx.torch, [], None
        ev = self.event
        model.backbone.register_forward_pre_hook(
            lambda *_: self.cur.__setitem__("trunk0", ev()))
        model.neck.register_forward_hook(
            lambda *_: self.cur.__setitem__("trunk1", ev()))
        tr = model.head.transformer
        orig = tr.get_bev_features

        def bev(*a, **k):
            self.cur["encoder0"] = ev()
            out = orig(*a, **k)
            self.cur["encoder1"] = ev()
            return out

        tr.get_bev_features = bev

    def event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(self):
        self.cur = {}
        self.rows.append(self.cur)

    def finish(self) -> Dict[str, List[float]]:
        self.torch.cuda.synchronize()
        out = {"trunk": [], "encoder": []}
        for r in self.rows:
            for k in out:
                if k + "0" in r and k + "1" in r:
                    out[k].append(r[k + "0"].elapsed_time(r[k + "1"]))
        self.rows = []
        return out


def traced(ctx, request, T) -> Dict:
    """The profiled sub-window (``traced`` requests from frame 0) and, after
    it, the same requests again with their kernel calls recorded."""
    k = T["traced"]

    def go():
        for i in range(k):
            request(i)

    rec = {"trace": trace.profile(go), "trace_items": k}
    calls: Dict[str, list] = {}
    with program.recording_calls(calls):
        go()
    rec["calls"], rec["calls_items"] = calls, k
    return rec


def reference_outputs(ctx, s, frame_ids, quant=None) -> Dict[int, tuple]:
    """{frame: (logits, flow)} of the float32 reference (or the given
    quantizer's) on the run's frames."""
    occnet = importlib.import_module("occbench.reference."
                                     + ctx.cfg_file["reference"])
    torch = ctx.torch
    with ctx.reference_precision():
        P = {k: v.to(ctx.device) for k, v in s["weights"].items()}
        net = occnet.Net(P, ctx.cfg_file["config"]["model"], quant)
        out = {}
        with torch.no_grad():
            for f in frame_ids:
                img = occnet.normalize(s["frames"][f].to(ctx.device),
                                       ctx.cfg_file["config"]["data"])
                out[f] = net.forward(img, s["e2i"].to(ctx.device))
        return out


def gaps(ref_logits, ref_flow, cls, flow) -> Dict[str, float]:
    """occ_gap and flow_err of served classes ``cls`` and ``flow`` against
    the reference's logits and flow."""
    r = ref_logits.float()
    best = r.max(dim=-1).values
    got = r.gather(-1, cls.long()[..., None])[..., 0]
    gap = float((best - got).max() / r.std())
    fe = float((flow.float() - ref_flow.float()).norm()
               / ref_flow.float().norm().clamp(min=1e-30))
    return {"occ_gap": gap, "flow_err": fe}


def compare(ctx, s, kept: Dict[int, tuple]) -> Dict[str, float]:
    """The worst of each number over the checked requests (none checked:
    every request failed, and the numbers read as far off)."""
    if not kept:
        return {"occ_gap": 1e9, "flow_err": 1e9, "checked": 0}
    ring = len(s["frames"])
    refs = reference_outputs(ctx, s, sorted({i % ring for i in kept}))
    worst: Dict[str, float] = {}
    for i, (cls, flow) in kept.items():
        logits, rflow = refs[i % ring]
        for k, v in gaps(logits, rflow, cls, flow).items():
            worst[k] = max(worst.get(k, 0.0), v)
    worst["checked"] = len(kept)
    return worst


def control(ctx, s, frame_ids, quant) -> Dict[str, float]:
    """The numbers of the reference computed through ``quant`` put in the
    program's place, against the float32 reference."""
    ref = reference_outputs(ctx, s, frame_ids)
    low = reference_outputs(ctx, s, frame_ids, quant)
    worst: Dict[str, float] = {}
    for f in frame_ids:
        logits, flow = ref[f]
        for k, v in gaps(logits, flow, low[f][0].argmax(-1),
                         low[f][1]).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control_readings(ctx, quant) -> Dict[str, Dict[str, float]]:
    """The control's numbers on the frames a run checks as many of: the
    reference computed through ``quant`` in the program's place."""
    s = setup(ctx)
    del s["pred"]
    ctx.free()
    ids = list(range(min(ctx.traffic["sampled"] + 1, len(s["frames"]))))
    return {"control": control(ctx, s, ids, quant)}
