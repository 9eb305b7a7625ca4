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
  9. kernels (msda)  the deformable-attention kernel vs its plain version at
              base_occ's SCA shape (6 cameras x 12288 queries, 4 levels) and
              TSA shape (2 x 40000 queries, 1 level), bf16 and f32 values
 10. exact parity  the pillar projection at full width and at tiny_occ's
              size, card vs CPU bitwise (bev_mask and ref_cam); tiny_occ in
              fp32 with static top-K SCA on the card and on the CPU: same
              logits, same sca_topk_overflow
 11. serve exact  Predictor on base_occ (bf16, full width, gather encoder)
              answers 3 requests; 24 msda launches, certificate 0; then one
              request split by CUDA events and one under torch.profiler
 12. kernels (dcn)  the DCNv2 sampling kernel vs its plain version at the
              four DCN shapes of R101-DCN (B = 6; stride 1 and 2; bf16 and
              f32), offsets N(0, 2^2) px with 1 % at +/-30 px; the window
              certificate at R = 3 card vs CPU; times and the bound
 13. dcn parity  tiny R101-DCN in fp32 with window DCN, dense and gather
              encoders, on the card and on the CPU: same logits, same
              certificates, 26 deform_sample launches
 14. serve turbo_r101_dcn_occ  full width, bf16 (window DCN, dense
              encoder), conv_offset drawn from a seed and calibrated to
              |offset| <= 2.5 px: every layer's needed_radius, 3 requests
              with 26 deform_sample + 4 lift + 4 tap launches each and
              dcn_window_overflow 0; one request split by CUDA events
 15. serve r101_dcn_occ  the same with gather DCN and the exact encoder:
              26 deform_sample + 8 msda launches a request,
              sca_topk_overflow 0
 16. kernels (eval)  pass-2 from a tmp slab (Pallas #7) vs its plain
              version at the bench tool's shapes (one bf16 step), with a
              dense-hat bmm as the library yardstick; the per-ray DDA on
              one full-width synthetic scene (6 x 928 x 1600 rays, 420
              steps) and the fan DDA at the eval shape (2 grids x 8 origins
              x 360 x 39 rays, 200 x 200 x 16) vs their plain versions
              (coords and hits bitwise); then the bench tool's entry
 17. eval parity  synth_tiny_turbo_occ in fp32, card vs CPU: rendered
              views (share of differing pixels <= 1e-3), GT-vs-GT RayIoU 1,
              metric counts of the same grids bitwise, a random-weight
              model's argmax agreement (>= 99 %) and run_evaluation scores
 18. eval turbo_occ  the train CLI in process: 4 full-width bf16 steps on
              4 synthetic scenes rendered on the card, then run_evaluation
              on 8 val scenes (finite RayIoU); GT-vs-GT RayIoU 1 on a val
              frame, 6 DDA launches a scene, 4 lift + 4 tap + 1 fan
              launches a frame, a per-frame split by CUDA events
The last lines are the kernels JSON (each kernel with its bound_ms: the
larger of its compulsory bytes over 3.35 TB/s and its fp32 operations over
67 TFLOP/s), the nvidia-smi line and {"ok": true, "device": {...}}.  Needs
no network and no JAX.
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
MSDA_BF16_TOL = 2e-2     # bf16 values: one bf16 step (the tap bound)
MSDA_F32_ATOL, MSDA_F32_RTOL = 2e-5, 1e-5   # tests/test_msda.py:192
HBM_TBS = 3.35           # H100 SXM device-memory peak, TB/s
FP32_TFLOPS = 67.0       # H100 SXM fp32 peak outside the tensor cores
# deform_sample: kernel and plain version take the same fp32 operations in
# the same order, so f32 results are expected bitwise; the bound allows
# summation noise at 1e-6 of the largest input
DCN_F32_RTOL = 1e-6
DCN_RADIUS = 3           # the served window radius of turbo_r101_dcn_occ
DCN_MAX_PX = 2.5         # largest |offset| after calibration: floor in [-3, 2]
# the marchers: kernel and plain version take the same fp32 operations, so
# distances are expected bitwise; the bound allows 1e-6 relative
DIST_RTOL = 1e-6
PIXEL_MISMATCH = 1e-3    # rendered views, card vs CPU (exp may differ an ulp)
# a DDA step and a fan-column crossing cost a handful of fp32 operations
# (compares, a multiply-add, a division per z test)
DDA_OPS_PER_STEP = 5
FAN_OPS_PER_CROSSING = 15
REQUESTS = 3
TRAIN_STEPS = 3


def log(*a):
    print(*a, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_time(nb: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nb`` bytes (each input read once, each output written
    once) and do ``flops`` fp32 operations on the CUDA cores: the larger of
    bytes over 3.35 TB/s and operations over 67 TFLOP/s."""
    t_bytes = nb / (HBM_TBS * 1e12) * 1e3
    t_ops = flops / (FP32_TFLOPS * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            # each visible (camera, cell) pair: 2x2 corners, mul + add per
            # channel
            flops = sum((p2 > -2).sum().item() for _, _, p2, _ in args) \
                * C * 8
            b_ms, by = least_time(sum(nbytes(*a) for a in args)
                                  + nbytes(inv, uk), flops)
            results["lift"].update(ms=k, plain_ms=p, bound_ms=b_ms,
                                   bound_by=by, library_ms=None)
            log(f"  lift bound {b_ms:.4f} ms ({by}); kernel at "
                f"{b_ms / k:.1%} of it")
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
    nb = nbytes(v, attn, ok_)
    # 2 queue slots x 9 taps, mul + add per output element
    b_ms, by = least_time(nb, ok_.numel() * nq * len(tsa.TSA_TAPS) * 2)
    log(f"  tap: kernel {k:.4f} ms, plain {p:.4f} ms; "
        f"{nb / 1e6:.1f} MB moved -> {nb / k / 1e9:.3f} TB/s; bound "
        f"{b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it")
    results["tap"] = {"max_abs_err": err, "ms": k, "plain_ms": p,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def phase_parity(torch, full_cfg):
    from occnet_tpu_torch.config import tiny_turbo_occ
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
    B1 = 1
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
    # reads g and the geometry, writes one bf16 feature gradient per level;
    # the forward's operations, transposed
    nb = sum(nbytes(g, p1, p2, st) + B1 * m.num_cams * h * w * C * 2
             for (h, w), (p1, p2, st), g in zip(levels, geo, gs)) \
        + nbytes(inv)
    flops = sum((p2 > -2).sum().item() for _, p2, _ in geo) * C * 8
    b_ms, by = least_time(nb, flops)
    results["lift_bwd"].update(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=by,
                               library_ms=None)
    log(f"  lift_bwd 4 levels B=1: kernel {k:.4f} ms, plain {p:.4f} ms; "
        f"bound {b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it")

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
    nb = nbytes(v, attn, g, dvk, dak)
    # dv: each output-gradient element scatters to 2 x 9 taps; dattn: the
    # same products summed over channels (mul + add each)
    b_ms, by = least_time(nb, g.numel() * nq * len(tsa.TSA_TAPS) * 4)
    log(f"  tap_bwd: kernel {k:.4f} ms, plain {p:.4f} ms; {nb / 1e6:.1f} "
        f"MB moved -> {nb / k / 1e9:.3f} TB/s; bound {b_ms:.4f} ms ({by}), "
        f"kernel at {b_ms / k:.1%} of it")
    results["tap_bwd"] = {"max_abs_err": max(errs), "ms": k, "plain_ms": p,
                          "bound_ms": b_ms, "bound_by": by,
                          "library_ms": None}


def small_train_cfg():
    """tiny_turbo_occ in fp32 with nothing random in the step (dropout 0,
    grid mask off, float images) and no clipping, so card and CPU take the
    same step and p.grad holds the raw gradients."""
    from occnet_tpu_torch.config import apply_overrides, tiny_turbo_occ
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


def phase_msda_kernels(torch, cfg, results):
    from occnet_tpu_torch.ops import msda
    m = cfg.model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    sca, tsa = m.encoder.sca, m.encoder.tsa
    D = m.embed_dims // sca.num_heads
    cases = [("SCA", m.num_cams, sca.max_queries_per_cam, sca.num_heads,
              [(116, 200), (58, 100), (29, 50), (15, 25)], sca.num_points),
             ("TSA", tsa.num_bev_queue, m.bev_h * m.bev_w, tsa.num_heads,
              [(m.bev_h, m.bev_w)], tsa.num_points)]
    ms = plain_ms = worst = bound_ms = 0.0
    bound_by = set()
    for name, N, Q, H, shapes, P in cases:
        L, V = len(shapes), sum(h * w for h, w in shapes)
        v32 = torch.randn(N, V, H, D, generator=gen, device=dev)
        loc = torch.rand(N, Q, H, L, P, 2, generator=gen, device=dev
                         ) * 1.4 - 0.2
        attn = torch.softmax(torch.randn(N, Q, H, L * P, generator=gen,
                                         device=dev), -1
                             ).reshape(N, Q, H, L, P).contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            v = v32.to(dtype)
            got = msda.msda_cuda(v, shapes, loc, attn).float()
            want = msda.msda_plain(v, shapes, loc, attn).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if dtype == torch.bfloat16:
                bound = MSDA_BF16_TOL + MSDA_BF16_TOL * want.abs()
            else:
                bound = MSDA_F32_ATOL + MSDA_F32_RTOL * want.abs()
            ok = bool((diff <= bound).all()) \
                and bool(torch.isfinite(got).all())
            err = diff.max().item()
            log(f"  msda {name} value {tuple(v.shape)} {dtype}, Q={Q}, "
                f"L={L}, P={P}: max|kernel-plain| = {err:.3e}, |plain| max "
                f"{want.abs().max().item():.3f}, within bound: {ok}")
            if not ok:
                raise RuntimeError(f"msda kernel disagrees with plain "
                                   f"({name}, {dtype}): {err}")
            worst = max(worst, err)
            k, p = in_turns(torch, lambda: msda.msda_cuda(v, shapes, loc,
                                                          attn),
                            lambda: msda.msda_plain(v, shapes, loc, attn), 5)
            nb = nbytes(v, loc, attn) + got.numel() * v.element_size()
            # every sample: 2x2 corners, mul + add per channel (an upper
            # bound: out-of-level samples are skipped)
            b_ms, by = least_time(nb, N * Q * H * D * L * P * 4 * 2)
            log(f"  msda {name} {dtype}: kernel {k:.4f} ms, plain {p:.4f} "
                f"ms; compulsory {nb / 1e6:.1f} MB -> "
                f"{nb / k / 1e9:.3f} TB/s "
                f"({nb / k / 1e9 / HBM_TBS:.1%} of {HBM_TBS} TB/s); bound "
                f"{b_ms:.4f} ms ({by})")
            if dtype == torch.bfloat16:
                ms, plain_ms = ms + k, plain_ms + p
                bound_ms += b_ms
                bound_by.add(by)
    log(f"  msda per encoder layer (1 TSA + 1 SCA call, bf16): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["msda"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": "+".join(
                           sorted(bound_by)), "library_ms": None}


def exact_cfg(name, **sca):
    """A named gather-mode config in fp32 or bf16 with SCA overrides."""
    from occnet_tpu_torch.config import base_occ, tiny_occ
    cfg = {"base_occ": base_occ, "tiny_occ": tiny_occ}[name]()
    m = cfg.model
    enc = dataclasses.replace(m.encoder, sca=dataclasses.replace(
        m.encoder.sca, **sca))
    return dataclasses.replace(cfg, model=dataclasses.replace(m, encoder=enc))


def phase_exact_parity(torch):
    from occnet_tpu_torch import geometry
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.serve import Predictor
    # the pillar projection is fp32 op for op: bitwise equal on card and CPU
    # (the ring rig's 90-degree cameras put BEV cells exactly on their edges)
    for name in ("base_occ", "tiny_occ"):
        mc = exact_cfg(name).model
        ref3d = geometry.bev_reference_points_3d(
            mc.bev_h, mc.bev_w, mc.pc_range[5] - mc.pc_range[2],
            mc.encoder.num_points_in_pillar)
        e2i = torch.from_numpy(ring_rig(mc, 1))
        (rg, mg), (rc, mcpu) = [geometry.project_bev_points_to_cameras(
            ref3d, mc.pc_range, e2i.to(dev), (mc.img_h, mc.img_w))
            for dev in ("cuda", "cpu")]
        same_mask = torch.equal(mg.cpu(), mcpu)
        same_ref = torch.equal(rg.cpu(), rc)
        vis = mcpu.any(-1).sum(-1)[:, 0].tolist()
        log(f"  {name} pillar projection {tuple(mcpu.shape)}, card vs CPU "
            f"bitwise equal: bev_mask {same_mask}, ref_cam {same_ref} (max "
            f"|diff| {(rg.cpu() - rc).abs().max().item():.3e}); visible "
            f"queries per camera {vis}")
        if not same_mask:
            raise RuntimeError(f"{name}: bev_mask differs between card and "
                               f"CPU")
    m0 = exact_cfg("tiny_occ").model
    e2i = ring_rig(m0, 1)
    k = geometry.calibration_topk(m0, e2i)
    cfg = exact_cfg("tiny_occ", max_queries_per_cam=k)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    m = cfg.model
    sd = from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=1), seed=2))
    imgs = np.random.RandomState(3).randint(
        0, 256, (1, m.num_cams, m.img_h, m.img_w, 3), dtype=np.uint8)
    MSDA.launches = 0
    pg, pc = Predictor(cfg, sd, "cuda"), Predictor(cfg, sd, "cpu")
    _, _, lg = pg(imgs, e2i, with_logits=True)
    launches = MSDA.launches
    _, _, lc = pc(imgs, e2i, with_logits=True)
    lg = lg.float().cpu()
    err = (lg - lc).abs().max().item()
    agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
    log(f"  tiny_occ fp32, static top-K K={k} of {m.bev_h * m.bev_w} "
        f"queries: {tuple(lg.shape)} max|card-cpu| logits = {err:.3e} (atol "
        f"{LOGIT_ATOL}), argmax agreement {agree:.5f}, |logits| max "
        f"{lc.abs().max().item():.3f}; sca_topk_overflow card "
        f"{pg.sca_topk_overflow} cpu {pc.sca_topk_overflow}; msda launches "
        f"on the card {launches}")
    if not (err <= LOGIT_ATOL and agree >= 0.99
            and torch.isfinite(lg).all().item()
            and pg.sca_topk_overflow == pc.sca_topk_overflow == 0
            and launches == 2 * m.encoder.num_layers):
        raise RuntimeError("card and CPU disagree on tiny_occ")


def request_split(torch, pred, imgs, e2i):
    """One request with CUDA events recorded by module hooks; returns the
    intervals between consecutive marks, summed over the encoder layers,
    in order of first appearance."""
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    model = pred.model
    tr = model.head.transformer
    watch = [("trunk", model.backbone), ("fpn", model.neck),
             ("encoder", tr.encoder), ("decoder0", tr.decoder0),
             ("decoder1", tr.decoder1), ("heads", tr.predicter),
             ("flow_head", tr.flow_predicter)]
    for lid in range(tr.encoder.num_layers):
        layer = getattr(tr.encoder, f"layer{lid}")
        watch += [("TSA", layer.self_attn), ("SCA", layer.cross_attn),
                  ("SCA.msda_module", layer.cross_attn.deformable_attention),
                  ("SCA.output_proj", layer.cross_attn.output_proj),
                  ("FFN", layer.ffn)]
    hooks = []
    for name, mod in watch:
        hooks.append(mod.register_forward_pre_hook(
            lambda *_, n=name: mark(n + ">")))
        hooks.append(mod.register_forward_hook(
            lambda *_, n=name: mark(n + "<")))
    try:
        torch.cuda.synchronize()
        mark("request>")
        pred(imgs, e2i)
        mark("request<")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    split = {}
    for (a, ea), (b, eb) in zip(marks, marks[1:]):
        key = f"{a} -> {b}"
        split[key] = split.get(key, 0.0) + ea.elapsed_time(eb)
    return split, marks[0][1].elapsed_time(marks[-1][1])


def phase_serve_exact(torch, results):
    from occnet_tpu_torch import geometry
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.serve import Predictor
    cfg = exact_cfg("base_occ")
    m = cfg.model
    e2i = ring_rig(m, 1)
    need = geometry.calibration_topk(m, e2i, margin=1.0, multiple=1)
    t0 = time.perf_counter()
    pred = Predictor(cfg, from_jax_variables(
        init_jax_style_variables(cfg, seed=0)), "cuda")
    ks = pred.model.head.transformer.encoder.layer0.cross_attn.topk_sizes(
        m.bev_h * m.bev_w)
    groups = len(set(ks)) or 1
    log(f"  Predictor(base_occ, bf16, gather) ready in "
        f"{time.perf_counter() - t0:.1f} s; top-K per camera {ks}, the "
        f"ring rig's worst camera sees {need} queries")
    rng = np.random.RandomState(8)
    reqs = [rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3),
                        dtype=np.uint8) for _ in range(REQUESTS + 2)]
    pred(reqs[0], e2i)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MSDA.launches = 0
    lat = []
    for imgs in reqs[1:REQUESTS + 1]:
        t = time.perf_counter()
        occ, flow, logits = pred(imgs, e2i, with_logits=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        if tuple(occ.shape) != (1, m.bev_w, m.bev_h, m.pillar_h) or \
                tuple(flow.shape) != (1, m.bev_w, m.bev_h, m.pillar_h, 2):
            raise RuntimeError(f"bad output shapes {occ.shape} {flow.shape}")
        if not (torch.isfinite(logits).all() and torch.isfinite(flow).all()):
            raise RuntimeError("non-finite logits or flow")
        if pred.sca_topk_overflow != 0:
            raise RuntimeError(f"sca_topk_overflow {pred.sca_topk_overflow}")
    launches = MSDA.launches
    want = REQUESTS * m.encoder.num_layers * (1 + groups)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {REQUESTS} requests: latency ms {[round(x, 3) for x in lat]}, "
        f"mean {sum(lat) / len(lat):.3f}; peak allocated {peak:.3f} GiB; "
        f"sca_topk_overflow {pred.sca_topk_overflow}; msda launches "
        f"{launches} (expected {want}); card {nvidia_smi()}")
    log(f"  occ classes used {int(occ.unique().numel())}, logits range "
        f"[{logits.min().item():.3f}, {logits.max().item():.3f}]")
    if launches != want:
        raise RuntimeError(f"msda launch count {launches} != {want}")
    results["msda"]["launches"] = launches

    split, total = request_split(torch, pred, reqs[-1], e2i)
    log(f"  one request split by CUDA events (module hooks), total "
        f"{total:.3f} ms; intervals summed over the "
        f"{m.encoder.num_layers} layers:")
    for key, val in split.items():
        log(f"    {val:9.3f} ms  {key}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred(reqs[-1], e2i)
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t and e.key not in dev_ms and not e.key.startswith("aten::") \
                and not e.key.startswith("cuda"):
            dev_ms[e.key] = t / 1e3
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]
    msda_ms = sum(v for k, v in dev_ms.items() if "msda_kernel" in k)
    log(f"  profiler, one request: device kernels total "
        f"{sum(dev_ms.values()):.3f} ms, msda_kernel {msda_ms:.3f} ms; top:")
    for k, v in top:
        log(f"    {v:9.3f} ms  {k[:100]}")


# the DCN layers of R101-DCN at full width (B = 6 cameras): name, input
# (h, w, C), stride, launches per request
DCN_SHAPES = [("layer3_0", 116, 200, 256, 2, 1),
              ("layer3_1..22", 58, 100, 256, 1, 22),
              ("layer4_0", 58, 100, 512, 2, 1),
              ("layer4_1..2", 29, 50, 512, 1, 2)]


def phase_dcn_kernels(torch, results):
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops.dcn_window import window_overflow
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B = 6
    per_req = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    worst = 0.0
    for name, h, w, C, stride, count in DCN_SHAPES:
        ho, wo = dc.out_size(h, w, stride)
        x32 = torch.randn(B, h, w, C, generator=gen, device=dev)
        # offsets N(0, 2^2) px with about 1 % at +/-30 px, mask U(0, 1)
        off = torch.randn(B, ho, wo, 9, 2, generator=gen, device=dev) * 2.0
        far = torch.rand(B, ho, wo, 9, 2, generator=gen, device=dev) < 0.01
        off = torch.where(far, torch.sign(off) * 30.0, off).contiguous()
        mask = torch.rand(B, ho, wo, 9, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            got = dc.deform_sample_cuda(x, off, mask, stride)
            want = dc.deform_sample_plain(x, off, mask, stride)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, want)
            if dtype == torch.bfloat16:
                bad = bf16_step_apart(torch, got.float(), want.float())
                tol = "one bf16 step"
            else:
                bad = int(err > DCN_F32_RTOL * x.abs().max().item())
                tol = f"{DCN_F32_RTOL} x max|x|"
            fin = torch.isfinite(got.float()).all().item()
            log(f"  dcn {name} x {tuple(x.shape)} {dtype} stride {stride} -> "
                f"cols {tuple(got.shape)}: max|kernel-plain| = {err:.3e} "
                f"(tol {tol}), bitwise equal {same}, finite {fin}")
            if bad or not fin:
                raise RuntimeError(f"dcn kernel disagrees with plain ({name}, "
                                   f"{dtype}): {err}")
            worst = max(worst, err)
            k, p = in_turns(torch, lambda: dc.deform_sample_cuda(
                x, off, mask, stride), lambda: dc.deform_sample_plain(
                x, off, mask, stride), 5)
            # each sample: 4 corner weights (3 multiplies each) and, per
            # channel, 4 multiply-adds
            b_ms, by = least_time(nbytes(x, off, mask, got),
                                  got.numel() * 8 + off.numel() // 2 * 12)
            log(f"  dcn {name} {dtype}: kernel {k:.4f} ms, plain {p:.4f} ms; "
                f"bound {b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it "
                f"({nbytes(x, off, mask, got) / k / 1e9:.3f} TB/s)")
            if dtype == torch.bfloat16:
                per_req["ms"] += k * count
                per_req["plain_ms"] += p * count
                per_req["bound_ms"] += b_ms * count
            del got, want
        if stride == 1:
            cg = int(window_overflow(off, ho, wo, DCN_RADIUS))
            cc = int(window_overflow(off.cpu(), ho, wo, DCN_RADIUS))
            log(f"  dcn {name} window certificate at R={DCN_RADIUS}: card "
                f"{cg}, CPU {cc}")
            if cg != cc:
                raise RuntimeError("dcn certificate differs card vs CPU")
        del x32, off, mask
    log(f"  dcn per request (26 launches, bf16): kernel "
        f"{per_req['ms']:.4f} ms, plain {per_req['plain_ms']:.4f} ms, bound "
        f"{per_req['bound_ms']:.4f} ms (bytes); kernel at "
        f"{per_req['bound_ms'] / per_req['ms']:.1%} of it")
    results["dcn"] = {"max_abs_err": worst, **per_req, "bound_by": "bytes",
                      "library_ms": None}


def dcn_cfg(name, tiny=False, fp32=False):
    """A named R101-DCN config; ``tiny`` puts its backbone on tiny_turbo_occ
    (dense encoder) or tiny_occ (gather encoder, top-K sized for the ring
    rig), ``fp32`` computes in float32."""
    from occnet_tpu_torch import geometry
    from occnet_tpu_torch.config import get_config
    cfg = get_config(name)
    if tiny:
        base = get_config("tiny_turbo_occ" if cfg.model.encoder.mode ==
                          "dense" else "tiny_occ")
        m = dataclasses.replace(base.model, backbone=cfg.model.backbone)
        if m.encoder.mode == "gather":
            k = geometry.calibration_topk(m, ring_rig(m, 1))
            m = dataclasses.replace(m, encoder=dataclasses.replace(
                m.encoder, sca=dataclasses.replace(
                    m.encoder.sca, max_queries_per_cam=k)))
        cfg = dataclasses.replace(base, model=m)
    if fp32:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32"))
    return cfg


def dcn_weights(torch, cfg, device, imgs, e2i, seed, randomize=False):
    """The JAX-style init of ``cfg`` (every leaf random-filled with
    ``randomize``), every DCN layer's conv_offset kernel drawn from
    ``seed`` (the init's zero kernel would sample only integer positions),
    then calibrated on these images so that no layer's |offset| exceeds
    DCN_MAX_PX: within the R = 3 window, fractions and both signs
    exercised.  Returns the model's state_dict (on the CPU)."""
    from occnet_tpu_torch.convert import (calibrate_dcn_offsets,
                                          from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.data.pipeline import make_device_normalizer
    from occnet_tpu_torch.models.detector import OccNet
    v = init_jax_style_variables(cfg, seed=0)
    if randomize:
        v = randomize_variables(v, seed=2)
    rng = np.random.RandomState(seed)
    for blk in v["params"]["backbone"].values():
        co = blk.get("conv2", {}).get("conv_offset")
        if co is not None:
            co["kernel"] = rng.randn(*co["kernel"].shape).astype(np.float32)
    model = OccNet(cfg.model).to(device).eval()
    model.load_state_dict(from_jax_variables(v))
    x = make_device_normalizer(cfg.data)(torch.from_numpy(imgs).to(device))
    calibrate_dcn_offsets(model, x, torch.from_numpy(e2i).to(device),
                          DCN_MAX_PX)
    return {k: t.cpu() for k, t in model.state_dict().items()}


def dcn_radii(torch, pred, imgs, e2i):
    """needed_radius of every DCN layer on one request (forward pre-hooks
    recompute each layer's offsets; not timed)."""
    from occnet_tpu_torch.ops.dcn_window import needed_radius
    from occnet_tpu_torch.ops.deform_conv import ModulatedDeformConv
    radii, spread, hooks = {}, {}, []

    def probe(name, mod, inputs):
        off, _ = mod.offset_and_mask(inputs[0])
        radii[name] = int(needed_radius(off, *inputs[0].shape[2:]))
        spread[name] = (off.abs().mean().item(), off.abs().max().item())

    for name, mod in pred.model.backbone.named_modules():
        if isinstance(mod, ModulatedDeformConv):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, i, n=name.split(".")[0]: probe(n, m, i)))
    try:
        pred(imgs, e2i)
    finally:
        for h in hooks:
            h.remove()
    return radii, spread


def phase_dcn_parity(torch):
    from occnet_tpu_torch.ops.deform_conv import DEFORM
    from occnet_tpu_torch.serve import Predictor
    for name in ("turbo_r101_dcn_occ", "r101_dcn_occ"):
        cfg = dcn_cfg(name, tiny=True, fp32=True)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=dataclasses.replace(
                cfg.model.backbone, dcn_mode="window")))
        m = cfg.model
        e2i = ring_rig(m, 1)
        imgs = np.random.RandomState(9).randint(
            0, 256, (1, m.num_cams, m.img_h, m.img_w, 3), dtype=np.uint8)
        sd = dcn_weights(torch, cfg, "cpu", imgs, e2i, seed=3,
                         randomize=True)
        pg, pc = Predictor(cfg, sd, "cuda"), Predictor(cfg, sd, "cpu")
        DEFORM.launches = 0
        _, _, lg = pg(imgs, e2i, with_logits=True)
        launches = DEFORM.launches
        _, _, lc = pc(imgs, e2i, with_logits=True)
        lg = lg.float().cpu()
        err = (lg - lc).abs().max().item()
        agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
        log(f"  tiny {m.backbone.type} DCN {m.backbone.dcn_mode} + "
            f"{m.encoder.mode} encoder, fp32 {tuple(lg.shape)}: "
            f"max|card-cpu| logits = {err:.3e} (atol {LOGIT_ATOL}), argmax "
            f"agreement {agree:.5f}, |logits| max {lc.abs().max().item():.3f};"
            f" dcn_window_overflow card {pg.dcn_window_overflow} cpu "
            f"{pc.dcn_window_overflow}; sca_topk_overflow card "
            f"{pg.sca_topk_overflow} cpu {pc.sca_topk_overflow}; "
            f"deform_sample launches on the card {launches}")
        if not (err <= LOGIT_ATOL and agree >= 0.99
                and torch.isfinite(lg).all().item()
                and pg.dcn_window_overflow == pc.dcn_window_overflow == 0
                and pg.sca_topk_overflow == pc.sca_topk_overflow
                and launches == 26):
            raise RuntimeError(f"card and CPU disagree on tiny {name}")


def dcn_split(torch, pred, imgs, e2i):
    """One request with CUDA events at the trunk's bounds, each DCN layer's
    bounds, and around its sampling kernel and certificate: returns ms of
    (request, trunk, DCN offset conv, DCN sampling, DCN matmul, DCN
    certificate)."""
    from occnet_tpu_torch.ops import deform_conv as dc
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def wrap(fn, label):
        def go(*a, **k):
            mark(label + ">")
            out = fn(*a, **k)
            mark(label + "<")
            return out
        return go

    saved = dc.deform_sample, dc.window_overflow
    dc.deform_sample = wrap(dc.deform_sample, "sample")
    dc.window_overflow = wrap(dc.window_overflow, "cert")
    hooks = [pred.model.backbone.register_forward_pre_hook(
        lambda *_: mark("trunk>")),
        pred.model.backbone.register_forward_hook(lambda *_: mark("trunk<"))]
    for mod in pred.model.backbone.modules():
        if isinstance(mod, dc.ModulatedDeformConv):
            hooks.append(mod.register_forward_pre_hook(
                lambda *_: mark("dcn>")))
            hooks.append(mod.register_forward_hook(lambda *_: mark("dcn<")))
    try:
        torch.cuda.synchronize()
        mark("request>")
        pred(imgs, e2i)
        mark("request<")
        torch.cuda.synchronize()
    finally:
        dc.deform_sample, dc.window_overflow = saved
        for h in hooks:
            h.remove()
    t = {"offset conv": 0.0, "sampling": 0.0, "matmul": 0.0,
         "certificate": 0.0}
    key = {("dcn>", "sample>"): "offset conv", ("sample>", "sample<"):
           "sampling", ("sample<", "cert>"): "matmul", ("sample<", "dcn<"):
           "matmul", ("cert>", "cert<"): "certificate"}
    for (a, ea), (b, eb) in zip(marks, marks[1:]):
        if (a, b) in key:
            t[key[(a, b)]] += ea.elapsed_time(eb)
    ev = dict((label, e) for label, e in marks)
    return (ev["request>"].elapsed_time(ev["request<"]),
            ev["trunk>"].elapsed_time(ev["trunk<"]), t)


def phase_serve_dcn(torch, name, results):
    from occnet_tpu_torch.ops.deform_conv import DEFORM
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    cfg = dcn_cfg(name)
    m = cfg.model
    e2i = ring_rig(m, 1)
    rng = np.random.RandomState(10)
    reqs = [rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3),
                        dtype=np.uint8) for _ in range(REQUESTS + 2)]
    t0 = time.perf_counter()
    sd = dcn_weights(torch, cfg, "cuda", reqs[0], e2i, seed=11)
    pred = Predictor(cfg, sd, "cuda")
    del sd
    log(f"  Predictor({name}, bf16, {m.backbone.type}, DCN "
        f"{m.backbone.dcn_mode}, {m.encoder.mode} encoder) ready in "
        f"{time.perf_counter() - t0:.1f} s (conv_offset calibrated to "
        f"|offset| <= {DCN_MAX_PX} px on the first request)")
    radii, spread = dcn_radii(torch, pred, reqs[1], e2i)
    log(f"  needed_radius per DCN layer: {radii}")
    log("  mean / max |offset| px per DCN layer: " + ", ".join(
        f"{k} {a:.2f}/{b:.2f}" for k, (a, b) in spread.items()))
    if max(radii.values()) > DCN_RADIUS:
        raise RuntimeError(f"needed radius above {DCN_RADIUS}: {radii}")
    pred(reqs[0], e2i)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense = m.encoder.mode == "dense"
    kernels = {"dcn": DEFORM, **({"lift": LIFT, "tap": TAP} if dense
                                 else {"msda": MSDA})}
    if dense:
        want = {"dcn": 26, "lift": m.num_feature_levels,
                "tap": m.encoder.num_layers}
    else:
        ks = pred.model.head.transformer.encoder.layer0.cross_attn \
            .topk_sizes(m.bev_h * m.bev_w)
        want = {"dcn": 26, "msda": m.encoder.num_layers * (
            1 + (len(set(ks)) or 1))}
    lat, total = [], {k: 0 for k in kernels}
    for imgs in reqs[1:REQUESTS + 1]:
        for k in kernels.values():
            k.launches = 0
        t = time.perf_counter()
        occ, flow, logits = pred(imgs, e2i, with_logits=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        launches = {n: k.launches for n, k in kernels.items()}
        for n in launches:
            total[n] += launches[n]
        if launches != want:
            raise RuntimeError(f"launch counts {launches} != {want}")
        if tuple(occ.shape) != (1, m.bev_w, m.bev_h, m.pillar_h) or \
                tuple(flow.shape) != (1, m.bev_w, m.bev_h, m.pillar_h, 2):
            raise RuntimeError(f"bad output shapes {occ.shape} {flow.shape}")
        if not (torch.isfinite(logits).all() and torch.isfinite(flow).all()):
            raise RuntimeError("non-finite logits or flow")
        certs = (pred.dcn_window_overflow, pred.sca_topk_overflow)
        if certs != ((0, None) if dense else (None, 0)):
            raise RuntimeError(f"certificates (dcn, sca) {certs}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {REQUESTS} requests: latency ms {[round(x, 3) for x in lat]}, "
        f"mean {sum(lat) / len(lat):.3f}; peak allocated {peak:.3f} GiB; "
        f"launches per request {want}, in all {total}; "
        f"dcn_window_overflow {pred.dcn_window_overflow}, sca_topk_overflow "
        f"{pred.sca_topk_overflow}; card {nvidia_smi()}")
    log(f"  occ classes used {int(occ.unique().numel())}, logits range "
        f"[{logits.min().item():.3f}, {logits.max().item():.3f}]")
    req, trunk, t = dcn_split(torch, pred, reqs[-1], e2i)
    dcn = sum(t.values())
    log(f"  one request split by CUDA events: total {req:.3f} ms; trunk "
        f"{trunk:.3f} ms, of it the 26 DCN layers {dcn:.3f} ms (offset conv "
        f"{t['offset conv']:.3f}, sampling kernel {t['sampling']:.3f}, "
        f"matmul {t['matmul']:.3f}, certificate {t['certificate']:.3f}) and "
        f"the rest of the trunk {trunk - dcn:.3f}; the rest of the request "
        f"{req - trunk:.3f} ms")
    return total["dcn"]


def compare_marches(torch, name, got, want):
    """coords and hits bitwise, dist to DIST_RTOL; returns max |d dist|."""
    (dk, ck, hk), (dp, cp, hp) = got, want
    torch.cuda.synchronize()
    err = (dk - dp).abs().max().item()
    rel = ((dk - dp).abs() / dp.abs().clamp(min=1e-6)).max().item()
    same = torch.equal(ck, cp) and torch.equal(hk, hp)
    log(f"  {name}: coords and hits bitwise equal {same}; dist max |d| "
        f"{err:.3e}, max rel {rel:.3e} (tol {DIST_RTOL}), bitwise "
        f"{torch.equal(dk, dp)}; hits {int(hk.sum())} of {hk.numel()}")
    if not (same and rel <= DIST_RTOL):
        raise RuntimeError(f"{name} kernel disagrees with its plain version")
    return err


def phase_eval_kernels(torch, cfg, results):
    from occnet_tpu_torch.data import synthetic as syn
    from occnet_tpu_torch.evaluation.ray_metrics import (fan_parameters,
                                                         generate_lidar_rays)
    from occnet_tpu_torch.ops import lift_pass2 as lp
    from occnet_tpu_torch.ops import ray_march as rm
    from occnet_tpu_torch.ops import ray_march_vec as rv
    from occnet_tpu_torch.tools import bench_lift_passes as blp
    dev = torch.device("cuda")

    # pass-2 from a tmp slab (Pallas #7) at the bench tool's shapes
    p = blp.pass2_inputs(dev)
    args = (p["pos2A"], p["pos2B"], p["inv_count"], p["tmpA"], p["tmpB"],
            blp.ZR, blp.BEV_H)
    ko = lp.lift_pass2_cuda(*args).float()
    po = lp.lift_pass2_plain(*args).float()
    torch.cuda.synchronize()
    bad = bf16_step_apart(torch, ko, po)
    err = (ko - po).abs().max().item()
    log(f"  lift_pass2 tmpA {tuple(p['tmpA'].shape)} tmpB "
        f"{tuple(p['tmpB'].shape)} -> {tuple(ko.shape)} bf16: "
        f"max|kernel-plain| = {err:.3e}, bitwise {torch.equal(ko, po)}, "
        f"{bad} elements beyond one bf16 step, finite "
        f"{torch.isfinite(ko).all().item()}")
    if bad or not torch.isfinite(ko).all().item():
        raise RuntimeError("lift_pass2 kernel disagrees with plain")
    k, pl = in_turns(torch, lambda: lp.lift_pass2_cuda(*args),
                     lambda: lp.lift_pass2_plain(*args), 3)
    # compulsory bytes: the tmp rows a nonzero weight reaches, pos2 of the
    # real rows, inv_count and the output; 2 operations per tap and channel
    taps = rows = 0
    C = p["tmpA"].shape[3]
    for pos, K in ((p["pos2A"], blp.W_PAD), (p["pos2B"], blp.H_PAD)):
        pos = pos[:blp.ZR]
        k0 = torch.floor(pos).long()
        hit = torch.zeros(blp.ZR, blp.A, K, dtype=torch.bool, device=dev)
        for dk in (0, 1):
            kk = k0 + dk
            live = (kk >= 0) & (kk < K) & (lp._hat_bf16(pos, kk) != 0)
            taps += int(live.sum())
            zr, a, m = torch.nonzero(live, as_tuple=True)
            hit[zr, a, kk[zr, a, m]] = True
        rows += int(hit.sum())
    nb = rows * C * 2 + 2 * blp.ZR * blp.A * blp.M * 4 \
        + nbytes(p["inv_count"]) + ko.numel() * 2
    b_ms, by = least_time(nb, taps * C * 2)
    # the TPU kernel's contraction as one library call: the dense bf16 hat
    # weights (A * (w + h), M) of every zr against the tmp slab
    hats = []
    for pos, K in ((p["pos2A"], blp.W_PAD), (p["pos2B"], blp.H_PAD)):
        kk = torch.arange(K, device=dev, dtype=torch.float32)
        w = (1.0 - (pos[:blp.ZR, :, :, None] - kk).abs()).clamp(min=0.0)
        hats.append(w.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(
            blp.ZR, blp.M, -1))
        del w
    W_all = torch.cat(hats, dim=2)
    del hats
    T_all = torch.cat([p["tmpA"][:blp.ZR].reshape(blp.ZR, -1, C),
                       p["tmpB"][:blp.ZR].reshape(blp.ZR, -1, C)], dim=1)
    dense = (torch.bmm(W_all, T_all).float()
             * p["inv_count"][:, 0].repeat(blp.Z, 1)[..., None])
    dense_bad = bf16_step_apart(torch, ko, dense.to(torch.bfloat16).float())
    lib = cuda_ms(torch, lambda: torch.bmm(W_all, T_all), 3)
    log(f"  lift_pass2: kernel {k:.4f} ms, plain {pl:.4f} ms, library "
        f"bmm {tuple(W_all.shape)} x {tuple(T_all.shape)} {lib:.4f} ms; "
        f"dense form vs kernel: {dense_bad} elements beyond one bf16 step; "
        f"{rows} tmp rows reached, {nb / 1e6:.1f} MB compulsory -> bound "
        f"{b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it")
    if dense_bad:
        raise RuntimeError("lift_pass2 kernel disagrees with the dense form")
    results["lift_pass2"] = {"max_abs_err": err, "ms": k, "plain_ms": pl,
                             "bound_ms": b_ms, "bound_by": by,
                             "library_ms": lib}
    del W_all, T_all, dense, ko, po, p, args
    torch.cuda.empty_cache()

    # per-ray DDA: one full-width synthetic scene through the ring rig
    m = cfg.model
    occ_size = tuple(cfg.data.occ_size)
    sem, _ = syn.make_scene(0, occ_size)
    rig = syn.ring_camera_rig(m.num_cams, (m.img_h, m.img_w))
    vs = (m.pc_range[3] - m.pc_range[0]) / occ_size[0]
    dirs, o_vox = syn.camera_rays(rig["R"], rig["t"], rig["K"],
                                  (m.img_h, m.img_w), m.pc_range, vs, dev)
    occ = torch.from_numpy(sem != syn.FREE_ID).to(dev)
    steps = sum(occ_size) + 4
    R = dirs.shape[1]
    origins = [torch.from_numpy(o).to(dev)[None].expand(R, 3) for o in o_vox]

    def scene(fn):
        return lambda: [fn(occ, o, d, steps) for o, d in zip(origins, dirs)]

    got, want = scene(rm.dda_raymarch_cuda)(), scene(rm.dda_raymarch_plain)()
    err = max(compare_marches(torch, f"dda camera {c}", g, w)
              for c, (g, w) in enumerate(zip(got, want)))
    k, pl = in_turns(torch, scene(rm.dda_raymarch_cuda),
                     scene(rm.dda_raymarch_plain), 1)
    # steps this run's rays take: the voxels between start and end, + 1
    n_steps = sum(int(((c - torch.floor(o).int()).abs().sum(1) + 1).sum())
                  for (_, c, _), o in zip(got, origins))
    nb = nbytes(dirs) + occ.numel() + R * m.num_cams * (4 + 12 + 1)
    b_ms, by = least_time(nb, n_steps * DDA_OPS_PER_STEP)
    log(f"  dda scene {m.num_cams} x {m.img_h} x {m.img_w} rays, grid "
        f"{occ_size}, {steps} steps: kernel {k:.4f} ms, plain {pl:.4f} ms; "
        f"{n_steps / (R * m.num_cams):.1f} steps a ray; bound {b_ms:.4f} ms "
        f"({by}), kernel at {b_ms / k:.1%} of it")
    results["ray_march_dda"] = {"max_abs_err": err, "ms": k, "plain_ms": pl,
                                "bound_ms": b_ms, "bound_by": by,
                                "library_ms": None}
    del got, want, dirs, origins
    torch.cuda.empty_cache()

    # fan DDA at the eval shape: prediction and GT grids, 8 origins
    rng = np.random.RandomState(12)
    gt, _ = syn.make_scene(1, occ_size)
    pred = gt.copy()
    flip = rng.rand(*occ_size) < 0.01
    pred[flip] = rng.randint(0, syn.FREE_ID + 1, int(flip.sum()))
    occs = torch.from_numpy(np.stack([pred, gt]) != syn.FREE_ID).to(dev)
    o_m = np.concatenate([rng.uniform(-30, 30, (8, 2)),
                          rng.uniform(0.5, 2.5, (8, 1))], 1).astype(
        np.float32)
    o_vox = (o_m - np.asarray(m.pc_range[:3], np.float32)) / np.float32(vs)
    fan = [torch.from_numpy(a).to(dev)
           for a in fan_parameters(generate_lidar_rays())]
    fargs = (occs, torch.from_numpy(o_vox).to(dev), *fan)
    got = rv.dda_raymarch_fan_vec_cuda(*fargs)
    want = rv.dda_raymarch_fan_vec_plain(*fargs)
    err = compare_marches(torch, f"fan {tuple(got[0].shape)}", got, want)
    k, pl = in_turns(torch, lambda: rv.dda_raymarch_fan_vec_cuda(*fargs),
                     lambda: rv.dda_raymarch_fan_vec_plain(*fargs), 5)
    v0 = torch.floor(fargs[1][:, :2]).int()[None, :, None, None]
    crossings = int(((got[1][..., :2] - v0).abs().sum(-1) + 1).sum())
    nb = nbytes(fargs[1], *fan) + occs.shape[0] * occ_size[0] \
        * occ_size[1] * 4 + got[0].numel() * (4 + 12 + 1)
    b_ms, by = least_time(nb, crossings * FAN_OPS_PER_CROSSING)
    log(f"  fan: kernel {k:.4f} ms, plain {pl:.4f} ms; "
        f"{crossings / got[0].numel():.1f} crossings a ray; bound "
        f"{b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it")
    results["ray_march_fan"] = {"max_abs_err": err, "ms": k, "plain_ms": pl,
                                "bound_ms": b_ms, "bound_by": by,
                                "library_ms": None}

    # the bench tool, the path that runs #7
    lp.LIFT_PASS2.launches = 0
    times = blp.main([])
    results["lift_pass2"]["launches"] = lp.LIFT_PASS2.launches
    log(f"  bench_lift_passes: {times}; lift_pass2 launches "
        f"{lp.LIFT_PASS2.launches}")
    if not lp.LIFT_PASS2.launches:
        raise RuntimeError("the bench tool did not launch lift_pass2")
    torch.cuda.empty_cache()


def synth_tiny_fp32():
    from occnet_tpu_torch.config import synth_tiny_turbo_occ
    cfg = synth_tiny_turbo_occ()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))


def gt_ray_iou(torch, cfg, sample, device):
    """RayIoU of a frame's ground truth against itself on ``device``."""
    from occnet_tpu_torch.evaluation.ego_pose import pad_origins
    from occnet_tpu_torch.evaluation.ray_metrics import (
        RayMetricAccumulator, generate_lidar_rays, occ_score_from_metrics,
        render_pred_gt)
    sem = torch.from_numpy(sample["voxel_semantics"]).to(device)
    flow = torch.from_numpy(sample["voxel_flow"]).to(device)
    padded, valid = pad_origins(np.zeros((1, 3), np.float32),
                                cfg.eval.max_origins)
    acc = RayMetricAccumulator()
    acc.update(*render_pred_gt(sem, flow, sem, flow, generate_lidar_rays(),
                               padded, valid, voxel_size=cfg.eval.voxel_size,
                               pc_range=tuple(cfg.eval.pc_range)))
    return occ_score_from_metrics(acc.finalize())["RayIoU"]


def phase_eval_parity(torch):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
    from occnet_tpu_torch.evaluation.ego_pose import pad_origins
    from occnet_tpu_torch.evaluation.ray_metrics import (count_sample,
                                                         generate_lidar_rays,
                                                         render_pred_gt)
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.eval_loop import run_evaluation
    cfg = synth_tiny_fp32()
    m = cfg.model
    ds = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        ds[dev] = SyntheticOccDataset(cfg.data, m, 2, seed=0, training=False,
                                      device_normalize=True, device=dev)
        log(f"  {dev}: 2 scenes rendered in {time.perf_counter() - t:.2f} s")
    diff = np.mean([(a[0] != b[0]).any(-1).mean() for a, b in
                    zip(ds["cuda"].samples, ds["cpu"].samples)])
    log(f"  synth_tiny views {ds['cpu'].samples[0][0].shape}: share of "
        f"pixels differing card vs CPU {diff:.3e} (tol {PIXEL_MISMATCH})")
    if diff > PIXEL_MISMATCH:
        raise RuntimeError("rendered views differ between card and CPU")
    s = ds["cpu"].get_sample(0)
    ious = {dev: gt_ray_iou(torch, cfg, s, dev) for dev in ("cuda", "cpu")}
    log(f"  GT-vs-GT RayIoU {ious}")
    if ious != {"cuda": 1.0, "cpu": 1.0}:
        raise RuntimeError("GT-vs-GT RayIoU is not 1")
    # counts of the same (pred, gt) grids on both devices
    rng = np.random.RandomState(13)
    gt = s["voxel_semantics"]
    pred = gt.copy()
    flip = rng.rand(*gt.shape) < 0.05
    pred[flip] = rng.randint(0, 17, int(flip.sum()))
    fpred = rng.randn(*s["voxel_flow"].shape).astype(np.float32)
    padded, valid = pad_origins(np.array([[0.0, 0, 0], [3, -2, 0.5]],
                                         np.float32), cfg.eval.max_origins)
    counts = {}
    for dev in ("cuda", "cpu"):
        def t_(a):
            return torch.from_numpy(a).to(dev)
        pr, g = render_pred_gt(t_(pred), t_(fpred), t_(gt),
                               t_(s["voxel_flow"]), generate_lidar_rays(),
                               padded, valid, voxel_size=cfg.eval.voxel_size,
                               pc_range=tuple(cfg.eval.pc_range))
        counts[dev] = {k: v.cpu() for k, v in count_sample(pr, g).items()}
    same = {k: torch.equal(counts["cuda"][k], counts["cpu"][k])
            for k in counts["cpu"]}
    ave = (counts["cuda"]["ave_sum"] - counts["cpu"]["ave_sum"]).abs().max()
    log(f"  metric counts card vs CPU bitwise: {same}; ave_sum max|d| "
        f"{ave.item():.3e}")
    if not all(v for k, v in same.items() if k != "ave_sum") \
            or ave.item() > 1e-5 * counts["cpu"]["ave_sum"].abs().max():
        raise RuntimeError("metric counts differ between card and CPU")
    # the random-weight model, end to end on each device
    sd = from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=1), seed=2))
    preds = {dev: Predictor(cfg, sd, dev) for dev in ("cuda", "cpu")}
    agree = np.mean([
        (preds["cuda"](x["img"][None], x["ego2img"][None])[0].cpu()
         == preds["cpu"](x["img"][None], x["ego2img"][None])[0]).float()
        .mean().item() for x in map(ds["cpu"].get_sample, range(2))])
    scores = {dev: run_evaluation(cfg, preds[dev], ds[dev],
                                  log=lambda *a: None)
              for dev in ("cuda", "cpu")}
    d_iou = abs(scores["cuda"]["RayIoU"] - scores["cpu"]["RayIoU"])
    log(f"  random-weight synth_tiny_turbo_occ fp32: argmax agreement "
        f"{agree:.5f}; run_evaluation card {scores['cuda']}, CPU "
        f"{scores['cpu']}; |d RayIoU| {d_iou:.3e}")
    if agree < 0.99 or not np.isfinite(scores["cuda"]["RayIoU"]):
        raise RuntimeError("card and CPU evaluations disagree")


def phase_eval_turbo(torch, results):
    import shutil
    import tempfile
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.data.synthetic import SyntheticOccDataset
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.ray_march import DDA
    from occnet_tpu_torch.ops.ray_march_vec import FAN
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.tools import train as cli
    from occnet_tpu_torch.training import eval_loop
    cfg = turbo_occ()
    DDA.launches = 0
    ds = SyntheticOccDataset(cfg.data, cfg.model, 2, seed=0, training=False,
                             device_normalize=True)
    per_scene = DDA.launches / len(ds)
    iou = gt_ray_iou(torch, cfg, ds.get_sample(0), "cuda")
    log(f"  2 val scenes at {cfg.model.img_h} x {cfg.model.img_w} x "
        f"{cfg.model.num_cams}, grid {tuple(cfg.data.occ_size)}: render ms "
        f"{[round(x, 3) for x in ds.render_ms]} (the first builds nothing: "
        f"the library is loaded), {per_scene:.0f} DDA launches a scene; "
        f"GT-vs-GT RayIoU {iou}")
    if per_scene != cfg.model.num_cams or iou != 1.0:
        raise RuntimeError("val scene rendering or GT-vs-GT RayIoU wrong")
    del ds

    kernels = {"lift": LIFT, "tap": TAP, "fan": FAN}
    frames = []
    orig = eval_loop.run_evaluation

    def traced(*a, **kw):
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev, {k: v.launches
                                     for k, v in kernels.items()}))

        scores = orig(*a, mark=mark, **kw)
        torch.cuda.synchronize()
        for i in range(0, len(marks), 4):
            (_, e0, l0), (_, e1, _), (_, e2, _), (_, e3, l3) = marks[i:i + 4]
            frames.append({"forward": e0.elapsed_time(e1),
                           "render": e1.elapsed_time(e2),
                           "counts": e2.elapsed_time(e3),
                           "launches": {k: l3[k] - l0[k] for k in l0}})
        return scores

    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    DDA.launches = FAN.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eval_loop.run_evaluation = traced
    t = time.perf_counter()
    try:
        history = cli.main(["--config", "turbo_occ", "--synthetic-geometric",
                            "4", "--synthetic-render-scale", "1",
                            "--eval-interval-epochs", "1", "--max-steps", "4",
                            "--work-dir", work])
    finally:
        eval_loop.run_evaluation = orig
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    evals = [h for h in history if h.get("tag") == "eval"]
    steps = [h for h in history if "loss" in h]
    want = {"lift": cfg.model.num_feature_levels,
            "tap": cfg.model.encoder.num_layers, "fan": 1}
    mean = {k: float(np.mean([f[k] for f in frames]))
            for k in ("forward", "render", "counts")}
    log(f"  train CLI: {len(steps)} steps, losses "
        f"{[round(h['loss'], 4) for h in steps]}; {wall:.1f} s in all; "
        f"peak allocated {peak:.3f} GiB; DDA launches {DDA.launches} "
        f"(12 scenes), fan launches {FAN.launches}; card {nvidia_smi()}")
    log(f"  eval of {len(frames)} frames: scores {evals}")
    log(f"  per frame (CUDA events), mean ms: forward {mean['forward']:.3f}, "
        f"render pred+gt {mean['render']:.3f}, counts {mean['counts']:.3f}; "
        f"per frame: " + "; ".join(
            f"{f['forward']:.2f}/{f['render']:.3f}/{f['counts']:.3f}"
            for f in frames))
    log(f"  launches per frame {[f['launches'] for f in frames]} (expected "
        f"{want})")
    if len(steps) != 4 or len(evals) != 1 or len(frames) != 8 \
            or not np.isfinite(evals[0]["RayIoU"]):
        raise RuntimeError(f"train CLI eval run incomplete: {history}")
    if any(f["launches"] != want for f in frames):
        raise RuntimeError("eval launch counts per frame are wrong")
    results["ray_march_dda"]["launches"] = DDA.launches
    results["ray_march_fan"]["launches"] = FAN.launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from occnet_tpu_torch.config import turbo_occ
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
    torch.cuda.empty_cache()
    log("[9 kernels (msda)] kernel vs plain at base_occ's SCA and TSA shapes")
    phase_msda_kernels(torch, exact_cfg("base_occ"), results)
    log("[10 exact parity] pillar projection card vs CPU bitwise; tiny_occ "
        "fp32, static top-K, card vs CPU")
    phase_exact_parity(torch)
    log("[11 serve exact] base_occ full width, bf16, gather encoder")
    phase_serve_exact(torch, results)
    torch.cuda.empty_cache()
    log("[12 kernels (dcn)] DCNv2 sampling kernel vs plain at R101-DCN's "
        "four DCN shapes, bf16 and f32")
    phase_dcn_kernels(torch, results)
    torch.cuda.empty_cache()
    log("[13 dcn parity] tiny R101-DCN, fp32, window DCN, dense and gather "
        "encoders, card vs CPU")
    phase_dcn_parity(torch)
    log("[14 serve turbo_r101_dcn_occ] full width, bf16, window DCN, dense "
        "encoder")
    results["dcn"]["launches"] = phase_serve_dcn(
        torch, "turbo_r101_dcn_occ", results)
    torch.cuda.empty_cache()
    log("[15 serve r101_dcn_occ] full width, bf16, gather DCN, exact "
        "encoder")
    phase_serve_dcn(torch, "r101_dcn_occ", results)
    torch.cuda.empty_cache()
    log("[16 kernels (eval)] pass-2 from a tmp slab (Pallas #7) at the bench "
        "tool's shapes; the per-ray and fan DDA at full width")
    phase_eval_kernels(torch, cfg, results)
    log("[17 eval parity] synth_tiny_turbo_occ fp32, card vs CPU: views, "
        "metric counts, run_evaluation")
    phase_eval_parity(torch)
    torch.cuda.empty_cache()
    log("[18 eval turbo_occ] train CLI: 4 steps on 4 synthetic scenes, "
        "run_evaluation on 8 val scenes")
    phase_eval_turbo(torch, results)

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
        dict(name="msda", route="cuda",
             source="occnet_tpu_torch/csrc/msda.cu",
             replaces="occnet_tpu/ops/msda_pallas.py:78,120,156",
             **results["msda"]),
        dict(name="dcn", route="cuda",
             source="occnet_tpu_torch/csrc/deform_conv.cu",
             replaces="occnet_tpu/ops/dcn_window.py:133,174",
             **results["dcn"]),
        dict(name="lift_pass2", route="cuda",
             source="occnet_tpu_torch/csrc/lift_pass2.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:385",
             **results["lift_pass2"]),
        dict(name="ray_march_dda", route="cuda",
             source="occnet_tpu_torch/csrc/ray_march.cu",
             replaces="occnet_tpu/ops/ray_march.py:31",
             **results["ray_march_dda"]),
        dict(name="ray_march_fan", route="cuda",
             source="occnet_tpu_torch/csrc/ray_march.cu",
             replaces="occnet_tpu/ops/ray_march_vec.py:121",
             **results["ray_march_fan"]),
    ]
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    for k in kernels:
        if not keys <= k.keys():
            raise RuntimeError(f"kernel {k['name']} lacks {keys - k.keys()}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
