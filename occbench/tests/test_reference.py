"""The frozen reference against the program at a tiny size on the CPU,
both in float32: served outputs, the gather encoder through the program's
static top-K, the lift alone, and the first train steps."""

import pytest
import torch

from occbench import inputs
from occbench.drivers import serve, train
from occbench.reference import geometry, occnet
from occbench.tests import tiny


@pytest.mark.parametrize("cell,model,flow_tol", [
    # the program's lift reads bf16 features even in float32
    ("turbo_occ.serve", {}, 5e-3),
    ("base_occ.serve", {}, 1e-5),
    # K = 1024 of Q = 2500: the program's top-K path, the reference's
    # exact per-camera selection
    ("base_occ.serve", {"encoder": "topk"}, 1e-5),
])
def test_served_outputs_match_in_float32(cell, model, flow_tol):
    ctx = tiny.context(cell)
    m = ctx.cfg_file["config"]["model"]
    m["compute_dtype"] = "float32"
    if model.get("encoder") == "topk":
        m["encoder"]["sca"]["max_queries_per_cam"] = 1024
    ctx = tiny.Context(torch, ctx.cell, ctx.seed, 0.5, False, "cpu",
                       ctx.cfg_file, ctx.traffic, ctx.t0)
    res = serve.run(ctx)
    assert res["failed"] == 0 and res["numbers"]["checked"] >= 1
    assert res["numbers"]["flow_err"] < flow_tol
    assert res["numbers"]["occ_gap"] < 10 * flow_tol


def test_reference_lift_matches_the_programs():
    from occnet_tpu_torch.ops.planar_lift import lift_and_average
    m = tiny.config_file("turbo_occ")["config"]["model"]
    g = torch.Generator().manual_seed(3)
    levels = [(32, 56), (16, 28)]
    feats = [torch.randn(1, 6, h, w, 16, generator=g).bfloat16().float()
             for h, w in levels]
    e2i = torch.from_numpy(inputs.ring_rig(6, m["img_h"], m["img_w"], 1))
    want, count = lift_and_average(
        feats, e2i, m["pc_range"], m["encoder"]["num_points_in_pillar"],
        (m["bev_h"], m["bev_w"]), (m["img_h"], m["img_w"]),
        out_dtype=torch.float32)
    net = occnet.Net({}, m)
    got = net.lift(feats, e2i)
    _, ref_count = geometry.lift_geometry(
        e2i, m["pc_range"], m["encoder"]["num_points_in_pillar"],
        (m["bev_h"], m["bev_w"]), (m["img_h"], m["img_w"]), levels)
    assert torch.equal(ref_count, count)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("cell,tol", [("base_occ.train", 5e-3),
                                      ("turbo_occ.train", 2e-2)])
def test_train_steps_match_in_float32(cell, tol):
    ctx = tiny.context(cell)
    ctx.cfg_file["config"]["model"]["compute_dtype"] = "float32"
    ctx = tiny.Context(torch, ctx.cell, ctx.seed, 0.5, False, "cpu",
                       ctx.cfg_file, ctx.traffic, ctx.t0)
    res = train.run(ctx)
    n = res["numbers"]
    assert res["failed"] == 0
    assert n["loss_gap"] < tol / 50
    assert n["grad_gap"] < tol and n["update_gap"] < tol
    assert n["leaves"] > 100
