"""The yardstick's arithmetic on hand-made inputs: least times, kernel
bytes and operations, touched MSDA rows, the model's operations against
PyTorch's own count, the percentile and the window rate."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from occbench import inputs, readers, yardstick
from occbench.reference import occnet
from occbench.tests import tiny


def test_least_time_picks_the_slower_unit():
    t, by = yardstick.least_time_s(3.35e12, 0.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = yardstick.least_time_s(1.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_lift_and_tap_costs_by_hand():
    # feat 48 + pos1 40 + pos2 40 + steep 2 + inv 20 + out 80 bytes
    assert yardstick.lift_level_cost(1, 1, 2, 3, 4, 2, 5, 5, 7) == (230.0,
                                                                    224.0)
    # g 80 + pos1 40 + pos2 40 + steep 2 + inv 20 + dfeat 48 bytes
    assert yardstick.lift_bwd_level_cost(1, 1, 2, 3, 4, 2, 5, 5, 7) == (
        230.0, 224.0)
    # v 128 + attn 288 + out 128 bytes; 4 cells x 8 ch x 2 slots x 9 taps x 2
    assert yardstick.tap_cost(1, 2, 2, 2, 8, 2, 9) == (544.0, 1152.0)


def test_msda_touched_rows_and_corners():
    loc = torch.tensor([0.5, 0.5]).reshape(1, 1, 1, 1, 1, 2)
    assert yardstick.msda_touched((1, 4, 1, 8), [(2, 2)], loc) == (4, 4)
    # a corner row shared by two samples is one row; far samples touch none
    loc = torch.tensor([[0.5, 0.5], [0.6, 0.6], [9.0, 9.0]]).reshape(
        1, 1, 1, 1, 3, 2)
    rows, corners = yardstick.msda_touched((1, 4, 1, 8), [(2, 2)], loc)
    assert (rows, corners) == (4, 8)
    c = {"value_shape": (1, 4, 1, 8), "value_bytes": 2, "rows": 4,
         "corners": 8, "Q": 1, "loc_bytes": 24, "attn_bytes": 12}
    assert yardstick.msda_cost(c) == (4 * 8 * 2 + 24 + 12 + 8 * 2, 128.0)
    assert yardstick.msda_bwd_cost(c)[0] == 4 * 16 + 36 + 16 + 64 + 36


def test_model_flops_match_pytorch_count_of_the_reference():
    cf = tiny.config_file("turbo_occ")
    m = cf["config"]["model"]
    from occbench import program
    from occnet_tpu_torch.config import get_config
    model = program.build_model(get_config("tiny_turbo_occ"), "cpu")
    P = inputs.make_weights(program.weight_spec(model), 5, "cpu")
    net = occnet.Net(P, m)
    img = torch.zeros(1, m["num_cams"], m["img_h"], m["img_w"], 3)
    e2i = torch.from_numpy(inputs.ring_rig(m["num_cams"], m["img_h"],
                                           m["img_w"], 1))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net.forward(img, e2i)
    # the reference's tap attention is an einsum that PyTorch counts; the
    # program runs it on the CUDA cores and model_flops leaves it out
    enc = m["encoder"]
    taps = (2 * m["bev_h"] * m["bev_w"] * m["embed_dims"]
            * enc["tsa"]["num_bev_queue"] * 9 * enc["num_layers"])
    assert yardstick.model_flops(m, 1, False) == pytest.approx(
        fc.get_total_flops() - taps, rel=1e-9)
    # training: the trainable layers three times, the frozen stem and stage
    # once, the trainable convs reading the frozen stage twice
    fwd, train = yardstick.model_flops(m, 2, False), \
        yardstick.model_flops(m, 2, True)
    assert 2.0 * fwd < train < 3.0 * fwd


def test_mfu_percentile_and_window_rate():
    assert yardstick.mfu_percent(989e12, 2, 4.0) == pytest.approx(50.0)
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == 95
    assert yardstick.percentile([4, 1, 3, 2], 50) == 2
    assert yardstick.percentile([7.0], 95) == 7.0
    rec = {"kind": "serve", "flops_per_item": 989e12, "items": 3,
           "window_s": 6.0}
    assert readers.mfu(rec, "serve") == pytest.approx(50.0)
    assert readers.mfu(rec, "train") is None


def test_serve_metrics_cover_every_request_of_the_window():
    ctx = tiny.context("turbo_occ.serve")
    ctx.seconds = 1.0
    from occbench.drivers import serve
    res = serve.run(ctx)
    lat = res["record"]["latency_ms"]
    assert len(lat) == res["attempted"] >= 1
    assert res["e2e"]["latency_ms_p95"] == yardstick.percentile(lat, 95)
    assert res["e2e"]["frames_per_s"] == pytest.approx(
        res["attempted"] / res["window_s"])
    assert res["window_s"] >= 1.0
