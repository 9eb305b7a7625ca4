"""A run with the timed path broken underneath comes out not correct, and
the control (the reference computed in fp8, below the configuration's
bf16) fails the cell's limits: at a tiny size on the CPU, past the
harness's look for a card, with the cells' own limits.  The runs here
compute in float32, so that the sound run's numbers stay far inside the
limits set for bf16 at full size."""

import pytest
import torch

from occbench import harness
from occbench.reference.occnet import fp8
from occbench.run import execute
from occbench.tests import tiny


def run(cell, **faults):
    ctx = tiny.context(cell, compute_dtype="float32")
    if "step" in faults:
        ctx.wrap_step = faults["step"]
    return execute(ctx, harness.benchmark(), harness.limits_file(cell))


def unchanged(step):
    """A step that returns its state unchanged."""
    def go(state, batch, mark=None):
        keep = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, batch, mark)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), keep):
                p.copy_(k)
        return out
    return go


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def go(state, batch, mark=None):
        n = batch["img"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()}, mark)
    return go


@pytest.mark.parametrize("cell", ["turbo_occ.serve", "base_occ.serve"])
def test_serve_sound_and_altered_answer(cell, monkeypatch):
    assert run(cell)["correct"]
    from occnet_tpu_torch import serve as served
    orig = served.get_occ

    def altered(outs):
        cls, flow = orig(outs)
        cls = cls.clone()
        flat = cls.view(-1)
        flat[::97] = (flat[::97] + 1) % outs["occ"].shape[-1]
        return cls, flow

    monkeypatch.setattr(served, "get_occ", altered)
    out = run(cell)
    assert not out["correct"]
    assert out["checks"]["occ_gap"]["value"] > \
        out["checks"]["occ_gap"]["limit"]


@pytest.mark.parametrize("cell", ["base_occ.train", "turbo_occ.train"])
@pytest.mark.parametrize("fault", [None, unchanged, half_batch])
def test_train_sound_and_faults(cell, fault):
    out = run(cell) if fault is None else run(cell, step=fault)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("cell", ["turbo_occ.serve", "base_occ.serve",
                                  "base_occ.train", "turbo_occ.train"])
def test_control_fails_the_limits(cell):
    ctx = tiny.context(cell)
    driver = harness.load_module("drivers", ctx.traffic["driver"])
    limits = harness.limits_file(cell)
    for name, numbers in driver.control_readings(ctx, fp8).items():
        assert any(numbers[k] > v for k, v in limits.items()), (name,
                                                                 numbers)
