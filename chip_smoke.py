#!/usr/bin/env python3
"""Smoke test of occnet_tpu_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):
  1. device   torch/CUDA versions, the card's name and power limit; TF32 off
  2. build    nvcc builds the CUDA kernels from occnet_tpu_torch/csrc
  3. kernels  lift and tap kernels vs their plain PyTorch versions on the
              card, at the main-path shapes of turbo_occ (and B=2 lift)
  4. parity   one random-weight small config (tiny_turbo_occ, fp32) on the
              card (kernels) and on the CPU (plain versions): same logits
  5. serve    Predictor on turbo_occ (bf16, full width) answers 3 requests of
              6 uint8 900x1600 images; launch counts prove both kernels ran
The last lines are the kernels JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.  Needs no network and no JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

LIFT_TOL = 0.05          # bf16 bound between two lift forms (JAX tests)
TAP_TOL = 2e-2           # rtol = atol of tests/test_tsa_pallas.py
LOGIT_ATOL = 5e-2        # cross-implementation bound of the model tests
REQUESTS = 3


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps launches (CUDA events)."""
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


def in_turns(torch, kernel, plain, reps):
    """plain, kernel, kernel, plain on one card; returns (kernel, plain) ms."""
    p1 = cuda_ms(torch, plain, reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, reps)
    log(f"    times ms: plain {p1:.4f}, kernel {k1:.4f}, kernel {k2:.4f}, "
        f"plain {p2:.4f}")
    return (k1 + k2) / 2, (p1 + p2) / 2


def ring_rig(m, batch):
    """The ring of `__graft_entry__._example_batch`: cam i yawed 2*pi*i/n,
    focal img_w/2, principal point at the image centre."""
    ego2img = np.tile(np.eye(4, dtype=np.float32), (batch, m.num_cams, 1, 1))
    for ci in range(m.num_cams):
        a = 2 * np.pi * ci / m.num_cams
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        K = np.array([[m.img_w / 2.0, 0, m.img_w / 2],
                      [0, m.img_w / 2.0, m.img_h / 2], [0, 0, 1]])
        ego2img[:, ci, :3, :3] = (K @ R).astype(np.float32)
    return ego2img


def phase_kernels(torch, cfg, results):
    from occnet_tpu_torch.ops import planar_lift, tsa
    from occnet_tpu_torch.ops.lift_cuda import lift_level_cuda, \
        lift_level_plain
    m = cfg.model
    dev = torch.device("cuda")
    C = m.embed_dims
    levels = [(116, 200), (58, 100), (29, 50), (15, 25)]
    gen = torch.Generator(device=dev).manual_seed(0)
    bev_hw, img_hw = (m.bev_h, m.bev_w), (m.img_h, m.img_w)
    Z = m.encoder.num_points_in_pillar

    for B in (1, 2):
        feats = [torch.randn(B, m.num_cams, h, w, C, generator=gen,
                             device=dev).to(torch.bfloat16)
                 for h, w in levels]
        e2i = torch.from_numpy(ring_rig(m, B)).to(dev)
        uk, ck = planar_lift.lift_and_average(
            feats, e2i, m.pc_range, Z, bev_hw, img_hw, impl="cuda")
        up, cp = planar_lift.lift_and_average(
            feats, e2i, m.pc_range, Z, bev_hw, img_hw, impl="plain")
        torch.cuda.synchronize()
        if not torch.equal(ck, cp):
            raise RuntimeError("lift: count differs between kernel and plain")
        err = (uk.float() - up.float()).abs().max().item()
        fin = torch.isfinite(uk.float()).all().item()
        log(f"  lift B={B} U_bar {tuple(uk.shape)}: max|kernel-plain| = "
            f"{err:.6f} (tol {LIFT_TOL}), finite={fin}, count range "
            f"[{ck.min().item():.0f}, {ck.max().item():.0f}]")
        if not (err <= LIFT_TOL and fin):
            raise RuntimeError(f"lift kernel disagrees with plain: {err}")
        results["lift"]["max_abs_err"] = max(
            err, results["lift"].get("max_abs_err", 0.0))
        if B == 1:
            # the level kernels alone, on precomputed geometry
            z = torch.from_numpy(planar_lift.z_anchors(m.pc_range, Z)).to(dev)
            H = planar_lift.plane_homographies(e2i, m.pc_range, z, bev_hw)
            args = []
            for f in feats:
                Ml = planar_lift.feature_homographies(H, f.shape[2],
                                                      f.shape[3], img_hw)
                p1, p2, st, _ = planar_lift.level_geometry(
                    Ml, bev_hw, f.shape[2], f.shape[3])
                args.append((f, p1, p2, st))
            inv = (1.0 / ck).contiguous()
            out = torch.empty_like(uk)

            def run(fn):
                def go():
                    for lvl, (f, p1, p2, st) in enumerate(args):
                        fn(f, p1, p2, st, inv, out[:, lvl].view(
                            B, Z * m.bev_h, m.bev_w, C))
                return go

            k, p = in_turns(torch, run(lift_level_cuda),
                            run(lift_level_plain), 5)
            results["lift"].update(ms=k, plain_ms=p)
            full = cuda_ms(torch, lambda: planar_lift.lift_and_average(
                feats, e2i, m.pc_range, Z, bev_hw, img_hw, impl="cuda"), 5)
            log(f"  lift 4 levels B=1: kernel {k:.4f} ms, plain {p:.4f} ms; "
                f"with fp32 geometry {full:.4f} ms; "
                f"U_bar {uk.numel() * 2 / 1e6:.1f} MB bf16 "
                f"-> {uk.numel() * 2 / k / 1e9:.3f} TB/s write")
        del uk, up, feats

    heads = m.encoder.tsa.num_heads
    nq = m.encoder.tsa.num_bev_queue
    v = torch.randn(1, nq, m.bev_h, m.bev_w, C, generator=gen, device=dev
                    ).to(torch.bfloat16)
    logits = torch.randn(1, m.bev_h, m.bev_w, nq, len(tsa.TSA_TAPS), heads,
                         generator=gen, device=dev)
    attn = torch.softmax(logits, dim=4).to(torch.bfloat16)
    ok_ = tsa.tap_attention_cuda(v, attn)
    op = tsa.tap_attention_plain(v, attn)
    torch.cuda.synchronize()
    err = (ok_ - op).abs().max().item()
    bound = (TAP_TOL + TAP_TOL * op.abs()).sub((ok_ - op).abs()).min().item()
    log(f"  tap {tuple(v.shape)} bf16: max|kernel-plain| = {err:.3e} "
        f"(rtol=atol={TAP_TOL}), finite={torch.isfinite(ok_).all().item()}")
    if not (bound >= 0 and torch.isfinite(ok_).all().item()):
        raise RuntimeError(f"tap kernel disagrees with plain: {err}")
    k, p = in_turns(torch, lambda: tsa.tap_attention_cuda(v, attn),
                    lambda: tsa.tap_attention_plain(v, attn), 20)
    nbytes = v.numel() * 2 + attn.numel() * 2 + ok_.numel() * 4
    log(f"  tap: kernel {k:.4f} ms, plain {p:.4f} ms; "
        f"{nbytes / 1e6:.1f} MB moved -> {nbytes / k / 1e9:.3f} TB/s")
    results["tap"] = {"max_abs_err": err, "ms": k, "plain_ms": p}


def phase_parity(torch, full_cfg):
    from occnet_tpu.config import tiny_turbo_occ
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.serve import Predictor
    cfg = tiny_turbo_occ()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    m = cfg.model
    sd = from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=1), seed=2))
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (1, m.num_cams, m.img_h, m.img_w, 3),
                       dtype=np.uint8)
    e2i = ring_rig(m, 1)
    # the lift geometry is fp32 op for op: bitwise equal on card and CPU
    # (the ring rig puts BEV cells exactly on the cameras' FOV edges)
    from occnet_tpu_torch.ops import planar_lift
    for mc in (m, full_cfg.model):
        z = torch.from_numpy(planar_lift.z_anchors(
            mc.pc_range, mc.encoder.num_points_in_pillar))
        h, w = mc.img_h // 8, mc.img_w // 8
        geo = []
        for dev in ("cuda", "cpu"):
            H = planar_lift.plane_homographies(
                torch.from_numpy(ring_rig(mc, 1)).to(dev), mc.pc_range,
                z.to(dev), (mc.bev_h, mc.bev_w))
            Ml = planar_lift.feature_homographies(H, h, w,
                                                  (mc.img_h, mc.img_w))
            geo.append([t.cpu() for t in planar_lift.level_geometry(
                Ml, (mc.bev_h, mc.bev_w), h, w)])
        same = [torch.equal(a, b) for a, b in zip(*geo)]
        log(f"  lift geometry {mc.bev_h}x{mc.bev_w} level 0, card vs CPU "
            f"bitwise equal (pos1, pos2, steep, valid): {same}")
        if not all(same):
            raise RuntimeError("lift geometry differs between card and CPU")
    _, _, lg = Predictor(cfg, sd, "cuda")(imgs, e2i, with_logits=True)
    _, _, lc = Predictor(cfg, sd, "cpu")(imgs, e2i, with_logits=True)
    lg = lg.float().cpu()
    err = (lg - lc).abs().max().item()
    agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
    log(f"  tiny_turbo_occ fp32 {tuple(lg.shape)}: max|card-cpu| logits = "
        f"{err:.3e} (atol {LOGIT_ATOL}), argmax agreement {agree:.5f}, "
        f"|logits| max {lc.abs().max().item():.3f}")
    if not (err <= LOGIT_ATOL and agree >= 0.99
            and torch.isfinite(lg).all().item()):
        raise RuntimeError("card and CPU disagree on the small config")


def phase_serve(torch, cfg, results):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    m = cfg.model
    t0 = time.perf_counter()
    pred = Predictor(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=0)), "cuda")
    log(f"  Predictor(turbo_occ, bf16) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(7)
    e2i = ring_rig(m, 1)
    reqs = [rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3),
                        dtype=np.uint8) for _ in range(REQUESTS + 1)]
    pred(reqs[0], e2i)                       # warm-up (cuDNN autotune etc.)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LIFT.launches = TAP.launches = 0
    lat = []
    for imgs in reqs[1:]:
        t = time.perf_counter()
        occ, flow, logits = pred(imgs, e2i, with_logits=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        if tuple(occ.shape) != (1, m.bev_w, m.bev_h, m.pillar_h) or \
                tuple(flow.shape) != (1, m.bev_w, m.bev_h, m.pillar_h, 2):
            raise RuntimeError(f"bad output shapes {occ.shape} {flow.shape}")
        if not (torch.isfinite(logits).all() and torch.isfinite(flow).all()):
            raise RuntimeError("non-finite logits or flow")
    launches = {"lift": LIFT.launches, "tap": TAP.launches}
    want = {"lift": m.num_feature_levels * REQUESTS,
            "tap": m.encoder.num_layers * REQUESTS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {REQUESTS} requests: latency ms {[round(x, 3) for x in lat]}, "
        f"mean {sum(lat) / len(lat):.3f}; peak allocated {peak:.3f} GiB; "
        f"launches {launches} (expected {want}); card {nvidia_smi()}")
    log(f"  occ classes used {int(occ.unique().numel())}, logits range "
        f"[{logits.min().item():.3f}, {logits.max().item():.3f}]")
    if launches != want:
        raise RuntimeError(f"kernel launch counts {launches} != {want}")
    for k in launches:
        results[k]["launches"] = launches[k]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from occnet_tpu.config import turbo_occ
    from occnet_tpu_torch.ops import _build

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; nvidia-smi: {smi}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    _build.library()
    log(f"[2 build] kernels built/loaded in {_build.build_seconds:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())

    cfg = turbo_occ()
    results = {"lift": {}, "tap": {}}
    log("[3 kernels] kernel vs plain at main-path shapes")
    phase_kernels(torch, cfg, results)
    log("[4 parity] same weights, card vs CPU (tiny_turbo_occ, fp32)")
    phase_parity(torch, cfg)
    log("[5 serve] turbo_occ full width, bf16")
    phase_serve(torch, cfg, results)

    kernels = [
        dict(name="lift", route="cuda",
             source="occnet_tpu_torch/csrc/lift.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:101,176,443",
             **results["lift"]),
        dict(name="tap", route="cuda",
             source="occnet_tpu_torch/csrc/tap.cu",
             replaces="occnet_tpu/ops/tsa_pallas.py:88",
             **results["tap"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
