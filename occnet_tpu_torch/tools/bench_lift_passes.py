"""Per-pass microbenchmark of the lift at level-0 base scale on the card
(counterpart of `tools/bench_lift_passes.py`).

    python -m occnet_tpu_torch.tools.bench_lift_passes

Shapes of the JAX tool: A = 6 cameras, a 116 x 200 x 256 feature level,
Z = 8 anchors over a 200 x 200 BEV grid, so ZR = 1600 rows, padded to
ZR_pad = 1664, w_pad = 200, h_pad = 120; random bf16 tmp slabs, random
order-A positions and every order-B position dead (-2).  The fused lift's
positions are random too, but sorted along each plane's BEV row: the
geometry makes them monotone there, and the backward kernel's index rests on
that.  Cases:

- ``pass2``: pass-2 from the tmp slabs (`ops/lift_pass2.py`, the
  counterpart of Pallas kernel #7, `lift_pallas._pass2`);
- ``lift fwd``: the port's fused lift level (`ops/lift_cuda.lift_level`),
  which replaces the JAX tool's pass1A + pass1B + pass2 cases;
- ``lift bwd``: its transpose (`lift_level_bwd`), which replaces pass2b +
  pass1Ab.

Prints one line per case (mean ms of 10 launches after one warm-up, CUDA
events) with the card's name; ``main`` returns {case: ms}.  Runs on the card
only.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

A, H, W, C = 6, 116, 200, 256
Z, BEV_H, BEV_W = 8, 200, 200
ZR, M = Z * BEV_H, BEV_W
ZR_PAD, W_PAD, H_PAD = 1664, 200, 120     # ZR to 128, w and h to 8


def pass2_inputs(device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX tool's pass-2 inputs: pos2A U(0, w), pos2B all -2,
    inv_count 1, tmp slabs N(0, 1) in bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "pos2A": torch.rand(ZR_PAD, A, M, generator=g, device=device) * W,
        "pos2B": torch.full((ZR_PAD, A, M), -2.0, device=device),
        "inv_count": torch.ones(BEV_H, 1, M, device=device),
        "tmpA": torch.randn(ZR_PAD, A, W_PAD, C, generator=g,
                            device=device).to(torch.bfloat16),
        "tmpB": torch.randn(ZR_PAD, A, H_PAD, C, generator=g,
                            device=device).to(torch.bfloat16),
    }


def lift_inputs(device, seed: int = 1) -> Dict[str, torch.Tensor]:
    """Level-0 inputs of the fused lift, B = 1: random features, order-A
    positions U(0, w) along (sorted along each BEV row, as the geometry
    orders them) and U(0, h) across every line."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "feat": torch.randn(1, A, H, W, C, generator=g,
                            device=device).to(torch.bfloat16),
        "pos1": torch.rand(1, A, ZR, W + H, generator=g, device=device) * H,
        "pos2": torch.sort(torch.rand(1, A, ZR, M, generator=g,
                                      device=device) * W, dim=-1)[0],
        "steep": torch.zeros(1, A, ZR, dtype=torch.bool, device=device),
        "inv_count": torch.ones(1, BEV_H * M, device=device),
        "g": torch.randn(1, ZR, M, C, generator=g,
                         device=device).to(torch.bfloat16),
    }


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    from occnet_tpu_torch.ops.lift_cuda import lift_level, lift_level_bwd
    from occnet_tpu_torch.ops.lift_pass2 import lift_pass2
    if not torch.cuda.is_available():
        raise SystemExit("bench_lift_passes: no CUDA device is available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    p2 = pass2_inputs(dev)
    lv = lift_inputs(dev)
    out = torch.empty(1, ZR, M, C, dtype=torch.bfloat16, device=dev)
    cases = [
        ("pass2", lambda: lift_pass2(p2["pos2A"], p2["pos2B"],
                                     p2["inv_count"], p2["tmpA"], p2["tmpB"],
                                     ZR, BEV_H)),
        ("lift fwd", lambda: lift_level(lv["feat"], lv["pos1"], lv["pos2"],
                                        lv["steep"], lv["inv_count"], out)),
        ("lift bwd", lambda: lift_level_bwd(lv["g"], lv["pos1"], lv["pos2"],
                                            lv["steep"], lv["inv_count"],
                                            (H, W))),
    ]
    times = {}
    for case, fn in cases:
        times[case] = time_ms(fn)
        print(f"{case:8s}: {times[case]:8.4f} ms  ({name})", flush=True)
    return times


if __name__ == "__main__":
    main()
