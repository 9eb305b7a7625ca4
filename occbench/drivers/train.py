"""Training steps queued back to back: `make_train_step`'s step on a ring of
batches made on the device from the seed.

Set-up builds one train state (model and AdamW) and drives it through the
first ``checked_steps`` steps on distinct batches; those steps are the
warm-up, and the same state goes on into the window.  In the window the
host queues each step without waiting for it, and waits only for the step
``depth`` places back, so the card sets the pace; the window ends at a
synchronise after the last step, and that wait counts.

Traffic file keys: ``batch`` (samples a step), ``ring`` (distinct
batches), ``checked_steps``, ``depth``, ``traced`` (steps under the
profiler in a traced run).

The check follows the checked steps with the float32 reference from the
same weights, batches and seed, and compares three numbers with the
cell's limits: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the worst leaf's gap between the norms of the first
gradient as the optimizer got it (the program's read from AdamW's first
moment after one step) over the larger of the reference's norm of that
leaf and of the median leaf; ``update_gap``, the same of each leaf's
change over the checked steps.  Leaves whose first reference gradient is
under a thousandth of the median leaf's are left out of both.
"""

from __future__ import annotations

import collections
import statistics
import importlib
import time
from typing import Dict, List

from occbench import inputs, program, trace, yardstick

ADAM_B1 = 0.9
MIN_LEAF = 1e-3


def batches(ctx, n: int) -> List[Dict]:
    torch, m, T = ctx.torch, ctx.cfg.model, ctx.traffic
    dev = ctx.device
    gen = inputs.generator(ctx.seed, 3, dev)
    h, w = T["frame_hw"]
    e2i = torch.from_numpy(inputs.ring_rig(m.num_cams, m.img_h, m.img_w,
                                           T["batch"])).to(dev)
    out = []
    for _ in range(n):
        b = {"img": inputs.images(gen, T["batch"], m.num_cams, h, w, dev),
             "ego2img": e2i}
        b.update(inputs.labels(gen, T["batch"], ctx.cfg.data.occ_size,
                               m.num_classes, ctx.cfg_file["flow_classes"],
                               dev))
        out.append(b)
    return out


def run(ctx) -> Dict:
    torch, T, cfg = ctx.torch, ctx.traffic, ctx.cfg
    dev = ctx.device
    model = program.build_model(cfg, dev)
    spec = program.weight_spec(model)
    weights = inputs.make_weights(spec, ctx.seed, dev)
    model.load_state_dict(weights)
    ring = batches(ctx, T["ring"])
    state = program.train_state(cfg, model)
    step = ctx.wrap_step(program.train_step(cfg, ctx.seed))
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = [(names[id(p)], p) for g in state.optimizer.param_groups
              for p in g["params"]]
    ctx.sync()
    ctx.reset_peak()

    losses, first = [], None
    for i in range(T["checked_steps"]):
        met = step(state, ring[i % len(ring)])
        losses.append(met["loss"].detach())
        if i == 0:
            st = state.optimizer.state
            first = torch.stack([torch.linalg.vector_norm(
                st[p]["exp_avg"].float()) / (1.0 - ADAM_B1)
                for _, p in leaves])
    delta = torch.stack([torch.linalg.vector_norm(
        p.detach().float() - weights[n]) for n, p in leaves])
    checked = {"loss": [float(x) for x in losses],
               "grad": dict(zip([n for n, _ in leaves], first.tolist())),
               "delta": dict(zip([n for n, _ in leaves], delta.tolist()))}
    weights = {k: v.to("cpu") for k, v in weights.items()}
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    marks = Marks(ctx) if ctx.trace else None
    cert = torch.zeros((), dtype=torch.int64, device=dev)
    pending = collections.deque()
    n, k0 = 0, T["checked_steps"]
    t_start = time.perf_counter()
    while True:
        if marks:
            marks.begin()
        met = step(state, ring[(k0 + n) % len(ring)],
                   marks.mark if marks else None)
        cert = cert + met["cert_overflow"]
        if dev != "cpu":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > T["depth"]:
                pending.popleft().synchronize()
        n += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    last_loss = float(met["loss"])
    record = {"kind": "train", "items": n, "window_s": window_s,
              "flops_per_item": yardstick.model_flops(
                  ctx.cfg_file["config"]["model"], T["batch"], True)}
    peak = ctx.device_info()              # the window's, before any trace
    if marks:
        record["spans_ms"] = marks.finish()
        record.update(traced(ctx, step, state, ring, T))
    cert = int(cert)
    del step, state, model, leaves, names, met
    ctx.free()
    numbers = compare(ctx, weights, spec, ring[:T["checked_steps"]],
                      checked)
    ok = cert == 0 and last_loss == last_loss
    errors = [] if ok else [f"cert_overflow {cert}, last loss {last_loss}"]
    return {"setup_s": setup_s, "window_s": window_s, "attempted": n,
            "failed": 0 if ok else 1, "errors": errors, "device": peak,
            "numbers": numbers, "record": record,
            "e2e": {"train_samples_per_s": n * T["batch"] / window_s,
                    "peak_gib": peak["memory_peak_bytes"] / 2 ** 30}}


class Marks:
    """CUDA events before each step and at its mark("forward" /
    "backward" / "optimizer") callbacks."""

    def __init__(self, ctx):
        self.torch, self.rows = ctx.torch, []

    def event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(self):
        self.rows.append({"start": self.event()})

    def mark(self, name):
        self.rows[-1][name] = self.event()

    def finish(self) -> Dict[str, List[float]]:
        self.torch.cuda.synchronize()
        out = {"fwd": [], "bwd": [], "opt": []}
        for r in self.rows:
            if {"start", "forward", "backward", "optimizer"} <= set(r):
                out["fwd"].append(r["start"].elapsed_time(r["forward"]))
                out["bwd"].append(r["forward"].elapsed_time(r["backward"]))
                out["opt"].append(r["backward"].elapsed_time(r["optimizer"]))
        self.rows = []
        return out


def traced(ctx, step, state, ring, T) -> Dict:
    """The profiled sub-window (``traced`` steps queued back to back) and
    one more step with its kernel calls recorded."""
    torch, k = ctx.torch, T["traced"]

    def go():
        for i in range(k):
            step(state, ring[i % len(ring)])
        torch.cuda.synchronize()

    rec = {"trace": trace.profile(go), "trace_items": k}
    calls: Dict[str, list] = {}
    with program.recording_calls(calls):
        step(state, ring[0])
        torch.cuda.synchronize()
    rec["calls"], rec["calls_items"] = calls, 1
    return rec


def reference(ctx, weights, spec, checked_batches, quant=None, keep=None):
    occnet = importlib.import_module("occbench.reference."
                                     + ctx.cfg_file["reference"])
    with ctx.reference_precision():
        P = {k: v.to(ctx.device) for k, v in weights.items()}
        return occnet.train_steps(P, [n for n, _, p in spec if p],
                                  ctx.cfg_file["config"], ctx.seed,
                                  checked_batches, quant, keep)


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap, grad_gap and update_gap of ``got`` against ``ref`` (each
    {"loss": [...], "grad": {leaf: norm}, "delta": {leaf: norm}})."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    kept = [n for n, g in ref["grad"].items() if g >= MIN_LEAF * med_g]
    med_d = statistics.median(ref["delta"][n] for n in kept)

    def worst(key, med):
        return max(abs(got[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in kept)

    return {"loss_gap": loss_gap, "grad_gap": worst("grad", med_g),
            "update_gap": worst("delta", med_d), "leaves": len(kept),
            "left_out": len(ref["grad"]) - len(kept)}


def compare(ctx, weights, spec, checked_batches, checked) -> Dict[str, float]:
    ref = reference(ctx, weights, spec, checked_batches)
    return gaps(checked, ref)


def control_readings(ctx, quant) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference computed through ``quant`` (the
    control) and of the reference fed half of each batch (a fault: the
    mean taken over the rest), each against the float32 reference."""
    T = ctx.traffic
    model = program.build_model(ctx.cfg, ctx.device)
    spec = program.weight_spec(model)
    weights = inputs.make_weights(spec, ctx.seed, ctx.device)
    del model
    ring = batches(ctx, T["checked_steps"])
    ref = reference(ctx, weights, spec, ring)
    return {"control": gaps(reference(ctx, weights, spec, ring, quant), ref),
            "half_batch": gaps(reference(ctx, weights, spec, ring,
                                         keep=T["batch"] // 2), ref)}
