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
  6. kernels (backward)  lift_bwd and tap_bwd kernels vs their plain versions
              at the main-path shapes (lift at B=1 and B=2, the B=2 result
              against two B=1 calls, the adjoint identity)
  7. train parity  one train step of tiny_turbo_occ in fp32 on the card and
              on the CPU, same weights and batch: same loss and gradients
  8. train    turbo_occ full width, bf16, B=1, config defaults (grid mask,
              photometric distortion, dropout): 1 warm-up + 3 timed steps
              through the CLI's train step; frozen stages bitwise unchanged,
              every other leaf moved, 4 launches of each kernel per step
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
# lift_bwd: both forms round an fp32 sum to bf16; the kernel's atomics add in
# a run-dependent order, so the two may be one bf16 step apart (2^-7 of the
# larger magnitude) plus fp32 ordering noise on cancelling sums
LIFT_BWD_RTOL = 2.0 ** -7
LIFT_BWD_ATOL = 2.0 ** -12   # x max|plain| of the level
ADJOINT_RTOL = 1e-5      # fp32 inner products <lift f, g> vs <f, lift^T g>
GRAD_RTOL = 5e-2         # per leaf, x max|g|: the lift's bf16 rounding bound
REQUESTS = 3
TRAIN_STEPS = 3


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


def ring_rig(m, batch, yaw_step=0.0):
    """The ring of `__graft_entry__._example_batch`: cam i yawed 2*pi*i/n
    (plus yaw_step * b for batch element b), focal img_w/2, principal point
    at the image centre."""
    ego2img = np.tile(np.eye(4, dtype=np.float32), (batch, m.num_cams, 1, 1))
    for b in range(batch):
        for ci in range(m.num_cams):
            a = 2 * np.pi * ci / m.num_cams + yaw_step * b
            R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                          [np.sin(a), np.cos(a), 0.0]])
            K = np.array([[m.img_w / 2.0, 0, m.img_w / 2],
                          [0, m.img_w / 2.0, m.img_h / 2], [0, 0, 1]])
            ego2img[b, ci, :3, :3] = (K @ R).astype(np.float32)
    return ego2img


def bf16_step_apart(torch, a, b):
    """Number of elements of a and b (fp32 views of bf16 results) further
    apart than the lift_bwd bound."""
    bound = (LIFT_BWD_RTOL * torch.maximum(a.abs(), b.abs())
             + LIFT_BWD_ATOL * b.abs().max())
    return ((a - b).abs() > bound).sum().item()


def lift_geometry(torch, m, e2i, levels):
    """Per level (pos1, pos2, steep) and the level-0 inv_count of the lift
    at the model's BEV grid, for the feature sizes ``levels``."""
    from occnet_tpu_torch.ops import planar_lift
    Z = m.encoder.num_points_in_pillar
    bev_hw, img_hw = (m.bev_h, m.bev_w), (m.img_h, m.img_w)
    z = torch.from_numpy(planar_lift.z_anchors(m.pc_range, Z)).to(e2i.device)
    H = planar_lift.plane_homographies(e2i, m.pc_range, z, bev_hw)
    geo, inv = [], None
    for h, w in levels:
        Ml = planar_lift.feature_homographies(H, h, w, img_hw)
        p1, p2, st, valid = planar_lift.level_geometry(Ml, bev_hw, h, w)
        if inv is None:
            count = valid.any(dim=2).sum(dim=1).float().clamp(min=1.0)
            inv = (1.0 / count).reshape(e2i.shape[0], -1).contiguous()
        geo.append((p1, p2, st))
    return geo, inv


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


def phase_kernels_bwd(torch, cfg, results):
    from occnet_tpu_torch.ops import tsa
    from occnet_tpu_torch.ops.lift_cuda import (lift_level_bwd_cuda,
                                                lift_level_bwd_plain,
                                                lift_level_cuda)
    m = cfg.model
    dev = torch.device("cuda")
    C = m.embed_dims
    levels = [(116, 200), (58, 100), (29, 50), (15, 25)]
    ZR = m.encoder.num_points_in_pillar * m.bev_h
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for B in (1, 2):
        e2i = torch.from_numpy(ring_rig(m, B, yaw_step=0.1)).to(dev)
        geo, inv = lift_geometry(torch, m, e2i, levels)
        gs = [torch.randn(B, ZR, m.bev_w, C, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in levels]
        out[B] = (e2i, geo, inv, gs)
        worst = 0.0
        for (h, w), (p1, p2, st), g in zip(levels, geo, gs):
            dk = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w)).float()
            dp = lift_level_bwd_plain(g, p1, p2, st, inv, (h, w)).float()
            bad = bf16_step_apart(torch, dk, dp)
            err = (dk - dp).abs().max().item()
            worst = max(worst, err)
            log(f"  lift_bwd B={B} level {h}x{w}: max|kernel-plain| = "
                f"{err:.6f}, |plain| max {dp.abs().max().item():.3f}, "
                f"{bad} elements beyond one bf16 step, "
                f"finite={torch.isfinite(dk).all().item()}")
            if bad or not torch.isfinite(dk).all().item():
                raise RuntimeError("lift_bwd kernel disagrees with plain")
        results["lift_bwd"]["max_abs_err"] = max(
            worst, results["lift_bwd"].get("max_abs_err", 0.0))

    # B=2 against two B=1 calls on the same samples (the r5 hazard)
    e2i, geo, inv, gs = out[2]
    for b in (0, 1):
        geo1, inv1 = lift_geometry(torch, m, e2i[b:b + 1].contiguous(),
                                   levels)
        for (h, w), (p1, p2, st), g, (q1, q2, qt) in zip(levels, geo, gs,
                                                          geo1):
            d2 = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w)).float()[b]
            d1 = lift_level_bwd_cuda(g[b:b + 1].contiguous(), q1, q2, qt,
                                     inv1, (h, w)).float()[0]
            bad = bf16_step_apart(torch, d2, d1)
            if bad:
                raise RuntimeError(f"lift_bwd B=2 sample {b} level {h}x{w} "
                                   f"differs from its B=1 call ({bad})")
    log("  lift_bwd B=2 == two B=1 calls, every level (within one bf16 "
        "step)")

    # adjoint identity <lift(f), g> = <f, lift^T(g)>, fp32 output both ways
    e2i, geo, inv, gs = out[1]
    for (h, w), (p1, p2, st), g in zip(levels, geo, gs):
        f = torch.randn(1, m.num_cams, h, w, C, generator=gen, device=dev
                        ).to(torch.bfloat16)
        u = torch.empty(1, ZR, m.bev_w, C, device=dev)
        lift_level_cuda(f, p1, p2, st, inv, u)
        gf = g.float()
        df = lift_level_bwd_cuda(gf, p1, p2, st, inv, (h, w),
                                 out_dtype=torch.float32)
        lhs = (u.double() * gf.double()).sum().item()
        rhs = (f.double() * df.double()).sum().item()
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        log(f"  adjoint level {h}x{w}: <lift f, g> = {lhs:.6e}, "
            f"<f, lift^T g> = {rhs:.6e}, rel {rel:.2e} (tol {ADJOINT_RTOL})")
        if not rel <= ADJOINT_RTOL:
            raise RuntimeError("lift_bwd kernel is not the forward's adjoint")

    def run(fn):
        def go():
            for (h, w), (p1, p2, st), g in zip(levels, geo, gs):
                fn(g, p1, p2, st, inv, (h, w))
        return go

    k, p = in_turns(torch, run(lift_level_bwd_cuda),
                    run(lift_level_bwd_plain), 3)
    results["lift_bwd"].update(ms=k, plain_ms=p)
    log(f"  lift_bwd 4 levels B=1: kernel {k:.4f} ms, plain {p:.4f} ms")

    heads = m.encoder.tsa.num_heads
    nq = m.encoder.tsa.num_bev_queue
    v = torch.randn(1, nq, m.bev_h, m.bev_w, C, generator=gen, device=dev
                    ).to(torch.bfloat16)
    logits = torch.randn(1, m.bev_h, m.bev_w, nq, len(tsa.TSA_TAPS), heads,
                         generator=gen, device=dev)
    attn = torch.softmax(logits, dim=4).to(torch.bfloat16)
    g = torch.randn(1, m.bev_h, m.bev_w, C, generator=gen, device=dev)
    dvk, dak = tsa.tap_attention_bwd_cuda(v, attn, g)
    dvp, dap = tsa.tap_attention_bwd_plain(v, attn, g)
    torch.cuda.synchronize()
    errs = []
    for name, a, b in (("dv", dvk, dvp), ("dattn", dak, dap)):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        bound = (TAP_TOL + TAP_TOL * b.abs()).sub((a - b).abs()).min().item()
        log(f"  tap_bwd {name} {tuple(a.shape)} bf16: max|kernel-plain| = "
            f"{err:.3e} (rtol=atol={TAP_TOL}), |plain| max "
            f"{b.abs().max().item():.3f}, finite="
            f"{torch.isfinite(a).all().item()}")
        if not (bound >= 0 and torch.isfinite(a).all().item()):
            raise RuntimeError(f"tap_bwd kernel disagrees with plain ({name})")
        errs.append(err)
    k, p = in_turns(torch, lambda: tsa.tap_attention_bwd_cuda(v, attn, g),
                    lambda: tsa.tap_attention_bwd_plain(v, attn, g), 10)
    nbytes = 2 * (v.numel() * 2 + attn.numel() * 2) + g.numel() * 4
    log(f"  tap_bwd: kernel {k:.4f} ms, plain {p:.4f} ms; {nbytes / 1e6:.1f} "
        f"MB moved -> {nbytes / k / 1e9:.3f} TB/s")
    results["tap_bwd"] = {"max_abs_err": max(errs), "ms": k, "plain_ms": p}


def small_train_cfg():
    """tiny_turbo_occ in fp32 with nothing random in the step (dropout 0,
    grid mask off, float images) and no clipping, so card and CPU take the
    same step and p.grad holds the raw gradients."""
    from occnet_tpu.config import apply_overrides, tiny_turbo_occ
    return apply_overrides(tiny_turbo_occ(), {
        "model.compute_dtype": "float32", "model.use_grid_mask": "false",
        "model.encoder.ffn_dropout": "0", "model.encoder.tsa.dropout": "0",
        "model.encoder.sca.dropout": "0", "optim.grad_clip_norm": "1e9"})


def phase_train_parity(torch):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.tools.train import make_synthetic_batch, to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    cfg = small_train_cfg()
    m = cfg.model
    sd = from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=1), seed=2))
    batch = make_synthetic_batch(cfg, 1, np.random.RandomState(4))
    batch["img"] = np.random.RandomState(5).randn(
        1, m.num_cams, m.img_h, m.img_w, 3).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(cfg, sd, dev)
        metrics = make_train_step(cfg)(state, to_device(batch, dev))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in state.model.named_parameters()
                 if p.grad is not None}
        stats = {n: b.detach().cpu() for n, b in state.model.named_buffers()}
        runs[dev] = (float(metrics["loss"]), grads, stats)
    (lg, gg, sg), (lc, gc, sc) = runs["cuda"], runs["cpu"]
    if gg.keys() != gc.keys():
        raise RuntimeError("card and CPU differ in which leaves get grads")
    worst, worst_name = 0.0, ""
    for n in gc:
        scale = max(gc[n].abs().max().item(), 1e-12)
        rel = (gg[n] - gc[n]).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, n
    stat_err = max((sg[n] - sc[n]).abs().max().item() for n in sc)
    log(f"  tiny_turbo_occ fp32 train step: loss card {lg:.6f} cpu {lc:.6f}; "
        f"{len(gc)} gradient leaves, worst max|card-cpu|/max|g| = "
        f"{worst:.3e} ({worst_name}; tol {GRAD_RTOL}); BN statistics "
        f"max|card-cpu| {stat_err:.3e}")
    if not (abs(lg - lc) <= 1e-3 * abs(lc) and worst <= GRAD_RTOL
            and stat_err <= 1e-3 and np.isfinite(lg)):
        raise RuntimeError("card and CPU train steps disagree")


def phase_train(torch, cfg, results):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    from occnet_tpu_torch.tools.train import make_synthetic_batch, to_device
    from occnet_tpu_torch.training.train import (create_train_state, lr_mult,
                                                 make_train_step)
    m = cfg.model
    t0 = time.perf_counter()
    state = create_train_state(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=0)), "cuda")
    batch = to_device(make_synthetic_batch(cfg, 1, np.random.RandomState(0)),
                      "cuda")
    step_fn = make_train_step(cfg, seed=0)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    log(f"  turbo_occ train state ready in {time.perf_counter() - t0:.1f} s; "
        f"images {tuple(batch['img'].shape)} uint8")
    metrics = step_fn(state, batch)                  # warm-up
    torch.cuda.synchronize()
    log(f"  warm-up step: loss {float(metrics['loss']):.4f}")
    torch.cuda.reset_peak_memory_stats()
    kernels = {"lift": LIFT, "lift_bwd": LIFT_BWD, "tap": TAP,
               "tap_bwd": TAP_BWD}
    for k in kernels.values():
        k.launches = 0
    host, phases = [], []
    for _ in range(TRAIN_STEPS):
        ev = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        t = time.perf_counter()
        ev["start"].record()
        metrics = step_fn(state, batch, mark)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        phases.append({
            "forward": ev["start"].elapsed_time(ev["forward"]),
            "backward": ev["forward"].elapsed_time(ev["backward"]),
            "optimizer": ev["backward"].elapsed_time(ev["optimizer"])})
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"  step {state.step - 1}: loss {vals['loss']:.4f} (occ "
            f"{vals['loss_occ']:.4f} flow {vals['loss_flow']:.4f}) gnorm "
            f"{vals['grad_norm']:.3f} lr {vals['lr']:.3e}; host "
            f"{host[-1]:.3f} ms; device forward {phases[-1]['forward']:.3f}"
            f" / backward {phases[-1]['backward']:.3f} / optimizer "
            f"{phases[-1]['optimizer']:.3f} ms")
        if not (np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])):
            raise RuntimeError(f"non-finite loss or grad norm: {vals}")
    launches = {k: v.launches for k, v in kernels.items()}
    want = {"lift": m.num_feature_levels * TRAIN_STEPS,
            "lift_bwd": m.num_feature_levels * TRAIN_STEPS,
            "tap": m.encoder.num_layers * TRAIN_STEPS,
            "tap_bwd": m.encoder.num_layers * TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean = {k: sum(p[k] for p in phases) / TRAIN_STEPS for k in phases[0]}
    log(f"  {TRAIN_STEPS} train steps: host ms {[round(x, 3) for x in host]},"
        f" mean {sum(host) / len(host):.3f}; device mean forward "
        f"{mean['forward']:.3f} / backward {mean['backward']:.3f} / "
        f"optimizer {mean['optimizer']:.3f} ms; peak allocated {peak:.3f} "
        f"GiB; launches {launches} (expected {want}); card {nvidia_smi()}")
    if launches != want:
        raise RuntimeError(f"train launch counts {launches} != {want}")
    frozen = moved = 0
    for n, p in state.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if lr_mult(n, cfg) == 0.0:
            frozen += 1
            if not same:
                raise RuntimeError(f"frozen parameter {n} changed")
        elif same:
            raise RuntimeError(f"trained parameter {n} did not move")
        else:
            moved += 1
    log(f"  {frozen} frozen leaves (stem, layer1_*) bitwise unchanged; "
        f"{moved} trained leaves all moved")
    for k in ("lift_bwd", "tap_bwd"):
        results[k]["launches"] = launches[k]


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
    torch.cuda.empty_cache()
    results.update(lift_bwd={}, tap_bwd={})
    log("[6 kernels (backward)] kernel vs plain at main-path shapes")
    phase_kernels_bwd(torch, cfg, results)
    log("[7 train parity] same weights and batch, card vs CPU "
        "(tiny_turbo_occ, fp32)")
    phase_train_parity(torch)
    log("[8 train] turbo_occ full width, bf16, B=1, config defaults")
    phase_train(torch, cfg, results)

    kernels = [
        dict(name="lift", route="cuda",
             source="occnet_tpu_torch/csrc/lift.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:101,176,443",
             **results["lift"]),
        dict(name="tap", route="cuda",
             source="occnet_tpu_torch/csrc/tap.cu",
             replaces="occnet_tpu/ops/tsa_pallas.py:88",
             **results["tap"]),
        dict(name="lift_bwd", route="cuda",
             source="occnet_tpu_torch/csrc/lift_bwd.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:270,493",
             **results["lift_bwd"]),
        dict(name="tap_bwd", route="cuda",
             source="occnet_tpu_torch/csrc/tap_bwd.cu",
             replaces="occnet_tpu/ops/tsa_pallas.py:155",
             **results["tap_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
