"""The port's spans and counters (`occnet_tpu_torch.utils.profiling`) on the
CPU with small configurations: off, a request and a train step record
nothing and answer bit for bit as with the spans on; on, a served request
of each encoder and a train step of each give the span tree the program
promises (items, parents, self times), the gather encoder's counters and
its certificate read-back; a counter fed tensors reads no value before
the summary; the set-up spans; and a benchmark run without tracing records
no span."""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from occnet_tpu_torch import geometry
from occnet_tpu_torch.config import tiny_occ, tiny_turbo_occ
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.ops import _build
from occnet_tpu_torch.serve import Predictor
from occnet_tpu_torch.tools.train import ring_rig
from occnet_tpu_torch.training.train import (TrainState, make_optimizer,
                                             make_train_step)
from occnet_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: E402,F401

IMG_HW = (96, 128)
FRAME_HW = (90, 128)                  # padded to IMG_HW by the normaliser


def small_cfg(mode: str, k: int = 0):
    """tiny_turbo_occ ("dense") or tiny_occ ("gather", static top-K ``k``
    a camera) cut to 2 layers, 64 channels, a 10 x 10 BEV, fp32."""
    cfg = tiny_turbo_occ() if mode == "dense" else tiny_occ()
    enc = cfg.model.encoder
    model = dataclasses.replace(
        cfg.model, img_h=IMG_HW[0], img_w=IMG_HW[1], bev_h=10, bev_w=10,
        pillar_h=4, embed_dims=64, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(
            enc, num_layers=2, ffn_dim=64, num_points_in_pillar=4,
            sca=dataclasses.replace(enc.sca, max_queries_per_cam=k)))
    return dataclasses.replace(cfg, model=model)


def served(mode: str):
    """(predictor, frame, ego2img) of a small model; the gather model has
    a static top-K sized for the rig (certificate 0)."""
    cfg = small_cfg(mode)
    e2i = ring_rig(cfg.model, 1)
    if mode == "gather":
        cfg = small_cfg(mode, geometry.calibration_topk(cfg.model, e2i,
                                                        multiple=8))
    torch.manual_seed(0)
    pred = Predictor.wrap(cfg, OccNet(cfg.model).eval())
    frame = np.random.RandomState(1).randint(0, 256, (1, 6, *FRAME_HW, 3),
                                             dtype=np.uint8)
    return pred, frame, e2i


def train_setup(mode: str):
    cfg = small_cfg(mode)
    m = cfg.model
    e2i = ring_rig(m, 1)
    if mode == "gather":
        cfg = small_cfg(mode, geometry.calibration_topk(m, e2i, multiple=8))
        m = cfg.model
    rng = np.random.RandomState(2)
    batch = {
        "img": torch.from_numpy(rng.randint(
            0, 256, (1, m.num_cams, *FRAME_HW, 3), dtype=np.uint8)),
        "ego2img": torch.from_numpy(e2i),
        "voxel_semantics": torch.from_numpy(rng.randint(
            0, 17, (1, m.bev_w, m.bev_h, m.pillar_h))),
        "voxel_flow": torch.from_numpy(rng.randn(
            1, m.bev_w, m.bev_h, m.pillar_h, 2).astype(np.float32))}
    torch.manual_seed(0)
    return cfg, OccNet(m), batch


def state_of(cfg, model):
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


@contextlib.contextmanager
def nothing_recorded(monkeypatch):
    """Fails any span made or count taken inside the block."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span or a count was recorded with spans off")
    with monkeypatch.context() as m:
        m.setattr(profiling, "Span", refuse)
        m.setattr(profiling, "_GradSpan", refuse)
        m.setattr(profiling.Recorder, "count", refuse)
        yield


def by_name(rec):
    out = {}
    for s in rec.records:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_spans_off_record_nothing_and_serve_the_same(mode, monkeypatch):
    pred, frame, e2i = served(mode)
    with nothing_recorded(monkeypatch):
        off = pred(frame, e2i, with_logits=True)
    with profiling.spans() as rec:
        on = pred(frame, e2i, with_logits=True)
    assert rec.records
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_spans_off_record_nothing_and_train_the_same(monkeypatch):
    cfg, model, batch = train_setup("dense")
    twin = copy.deepcopy(model)
    step = make_train_step(cfg, seed=3)
    states = [state_of(cfg, model), state_of(cfg, twin)]
    with nothing_recorded(monkeypatch):
        off = step(states[0], batch)
    with profiling.spans() as rec:
        on = step(states[1], batch)
    assert rec.records
    for k in ("loss", "grad_norm", "cert_overflow"):
        assert torch.equal(off[k], on[k]), k
    for (n, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_a_request_gives_the_span_tree(mode):
    pred, frame, e2i = served(mode)
    with profiling.spans() as rec:
        pred(frame, e2i)
    spans = by_name(rec)
    parent = {"serve.request": None, "serve.input": "serve.request",
              "model.trunk": "serve.request",
              "model.encoder": "serve.request",
              "encoder.geometry": "model.encoder",
              "model.decode": "serve.request"}
    if mode == "gather":
        parent.update({"sca.select": "model.encoder",
                       "serve.readback": "serve.request"})
    assert set(spans) == set(parent)
    for name, ss in spans.items():
        for s in ss:
            assert (s.parent.name if s.parent else None) == parent[name]
            assert s.item == 1
            assert s.t0 <= s.t1
            if s.parent:
                assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1
    layers = pred.cfg.model.encoder.num_layers
    if mode == "gather":
        # a layer: the visibility counts, then for its one K the top-K
        # and gathers before MSDA and the scatter-add after it
        assert len(spans["sca.select"]) == 3 * layers
    (item,) = rec.summary()
    assert item["item"] == 1 and item["root"] == "serve.request"
    for name, row in item["spans"].items():
        assert row["device_ms"] is None                # no card here
        assert 0 <= row["self_ms"] <= row["host_ms"] + 1e-9, name
    top = item["spans"]["serve.request"]
    children = sum(item["spans"][n]["host_ms"] for n, p in parent.items()
                   if p == "serve.request")
    assert top["self_ms"] == pytest.approx(top["host_ms"] - children)
    if mode == "dense":
        assert item["counters"] == {}
        return
    # the counters: the visible (query, camera) pairs the certificate
    # counts, and B x cameras x K MSDA slots, each over the layers
    tr = pred.model.head.transformer
    m = pred.cfg.model
    *_, bev_mask, _, _ = tr.encoder.gather_geometry(
        1, torch.from_numpy(e2i), ())
    visible = int(bev_mask.any(dim=-1).sum())
    k = m.encoder.sca.max_queries_per_cam
    assert item["counters"] == {"sca.visible": layers * visible,
                                "sca.slots": layers * 6 * k}
    assert 0 < visible <= 6 * k


@pytest.mark.parametrize("mode", ["dense", "gather"])
def test_a_train_step_gives_its_phases_and_marks(mode):
    cfg, model, batch = train_setup(mode)
    step = make_train_step(cfg, seed=3)
    state = state_of(cfg, model)
    marks = []
    with profiling.spans() as rec:
        step(state, batch, marks.append)
        step(state, batch)
    assert marks == ["forward", "backward", "optimizer"]
    spans = by_name(rec)
    parent = {"train.step": None, "train.forward": "train.step",
              "train.backward": "train.step",
              "train.optimizer": "train.step",
              "train.clip": "train.optimizer",
              "train.backward.trunk": "train.backward",
              "model.trunk": "train.forward",
              "model.encoder": "train.forward",
              "encoder.geometry": "model.encoder",
              "model.decode": "train.forward"}
    if mode == "gather":
        parent["sca.select"] = "model.encoder"
    assert set(spans) == set(parent)
    for name, ss in spans.items():
        assert {s.item for s in ss} == {1, 2}, name
        for s in ss:
            assert (s.parent.name if s.parent else None) == parent[name]
            if s.parent:
                assert s.parent.item == s.item
                assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1, name
    items = rec.summary()
    assert [it["root"] for it in items] == ["train.step"] * 2
    for it in items:
        for name, row in it["spans"].items():
            assert 0 <= row["self_ms"] <= row["host_ms"] + 1e-9, name


def test_a_counter_fed_tensors_reads_nothing_before_the_summary():
    """A meta tensor has no values: any read of a counter's value before
    `summary` (a host sync on a card) would raise here."""
    with profiling.spans() as rec:
        with profiling.span("serve.request"):
            for _ in range(3):
                profiling.count("sca.visible",
                                torch.ones(4, 5, dtype=torch.bool,
                                           device="meta"))
            profiling.count("sca.slots", 7)
        with profiling.span("serve.request"):
            profiling.count("sca.slots", 7)
    assert set(rec.counters) == {(1, "sca.visible"), (1, "sca.slots"),
                                 (2, "sca.slots")}
    assert [v.device.type for v in rec.counters[(1, "sca.visible")]] == [
        "meta"] * 3
    with pytest.raises((RuntimeError, NotImplementedError)):
        rec.summary()


def test_counters_sum_on_their_device_and_read_once():
    with profiling.spans() as rec:
        with profiling.span("serve.request"):
            profiling.count("sca.visible", torch.tensor([[True, False],
                                                         [True, True]]))
            profiling.count("sca.visible", torch.tensor(2))
            profiling.count("sca.slots", 6)
        profiling.count("kernels.built", 0)
    items = {it["item"]: it for it in rec.summary()}
    assert items[1]["counters"] == {"sca.visible": 5.0, "sca.slots": 6.0}
    assert items[0] == {"item": 0, "root": None, "spans": {},
                        "counters": {"kernels.built": 0.0}}
    assert profiling.span("x") is profiling.span("y")      # off again


class FakeEvent:
    """A CUDA event on a card whose clock is ``FakeEvent.done``: an event
    recorded at or before it has completed."""
    made, done, now = 0, 0, 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        assert stream == "root stream"
        FakeEvent.now += 1
        self.at = FakeEvent.now

    def query(self):
        return self.at <= FakeEvent.done

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before it completed"
        return float(end.at - self.at)


@pytest.mark.parametrize("card_keeps_up", [True, False])
def test_span_events_are_reused_once_their_item_is_done(card_keeps_up,
                                                        monkeypatch):
    """With the card keeping up, a root's close reads the earlier items'
    events and returns them to the pool, so 40 requests of 4 spans use
    the events of two requests; with the card behind, nothing is read
    before the summary, which synchronises once."""
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(FakeEvent, "done", 0)
    monkeypatch.setattr(FakeEvent, "now", 0)
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "root stream")
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: (syncs.append(1),
                                 setattr(FakeEvent, "done", FakeEvent.now)))
    with profiling.spans() as rec:
        rec._cuda = True
        for _ in range(40):
            with profiling.span("serve.request"):
                with profiling.span("serve.input"):
                    pass
                with profiling.span("model.trunk"):
                    with profiling.span("model.encoder"):
                        pass
            if card_keeps_up:
                FakeEvent.done = FakeEvent.now
        read_early = sum(s.device_ms is not None for s in rec.records)
    items = rec.summary()
    if card_keeps_up:
        assert FakeEvent.made == 2 * 4 * 2
        assert read_early == 4 * 39                 # all but the last item
    else:
        assert FakeEvent.made == 2 * 4 * 40
        assert read_early == 0
    assert syncs == [1]
    assert len(items) == 40 and not rec._unread
    for it in items:
        sp = it["spans"]
        # a request records 8 events in turn: request 1, input 2-3,
        # trunk 4, encoder 5-6, trunk 7, request 8
        assert [sp[n]["device_ms"] for n in ("serve.request", "serve.input",
                                             "model.trunk", "model.encoder")
                ] == [7.0, 1.0, 3.0, 1.0]
        assert sp["serve.request"]["self_ms"] == 3.0


def test_setup_spans_time_the_model_and_the_kernel_library(
        monkeypatch, tmp_path):
    loaded = []
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_compile",
                        lambda so, srcs: open(so, "w").close())
    monkeypatch.setattr(_build.ctypes, "CDLL", loaded.append)
    with profiling.spans() as rec:
        OccNet(small_cfg("dense").model)
        _build.library()                       # compiles: the first run
        _build._lib = None
        _build.library()                       # loads: a warm checkout
    assert len(loaded) == 2
    items = rec.summary()
    assert [(it["root"], it["counters"]) for it in items] == [
        ("setup.model", {}), ("setup.kernels", {"kernels.built": 1.0}),
        ("setup.kernels", {"kernels.built": 0.0})]
    assert all(it["spans"][it["root"]]["host_ms"] > 0 for it in items)


@pytest.mark.parametrize("cell", ["turbo_occ.serve", "turbo_occ.train"])
def test_a_benchmark_run_without_tracing_records_no_span(cell, monkeypatch):
    from occbench import harness
    from occbench.run import execute
    from occbench.tests import tiny
    ctx = tiny.context(cell, compute_dtype="float32", img_h=IMG_HW[0],
                       img_w=IMG_HW[1])
    with nothing_recorded(monkeypatch):
        out = execute(ctx, harness.benchmark(), harness.limits_file(cell))
    assert out["attempted"] > 0 and out["failed"] == 0
    assert profiling._rec is None
