#!/usr/bin/env python3
"""Smoke test of occnet_tpu_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):
  1. device   torch/CUDA versions, the card's name and power limit; TF32 off
  2. build    nvcc builds the CUDA kernels from occnet_tpu_torch/csrc
  3. kernels  lift and tap kernels vs their plain PyTorch versions on the
              card, at the main-path shapes of turbo_occ: the lift bitwise
              equal to its plain version at all 4 levels at B=1 and B=2, on
              a rig whose cameras overlap (cells seen by 3-4 cameras), with
              fp32 output at tiny_turbo_occ's size, and on edge positions
              (dead, integral, k = -1 and k = n - 1 taps, both pass
              orders); two launches and B=2 against two B=1 launches
              bitwise; each level timed against its bound.  The tap kernel
              within TAP_TOL at (1, 2, 200, 200, 256) bf16 and at (2, 2, 9,
              13, 128) bf16 and fp32, two launches and B=2 against two B=1
              launches bitwise
  4. parity   one random-weight small config (tiny_turbo_occ, fp32) on the
              card (kernels) and on the CPU (plain versions): same logits
  5. serve    Predictor on turbo_occ (bf16, full width) answers 3 requests of
              6 uint8 900x1600 images; launch counts prove both kernels ran;
              one more request under torch.profiler and one split by CUDA
              events (trunk, FPN, lift geometry, lift kernels, encoder
              without its tap kernels, tap kernels, decoder, heads)
  6. kernels (backward)  lift_bwd and tap_bwd kernels vs their plain versions
              at the main-path shapes (lift at B=1 and B=2, every level
              within one bf16 step, two launches bitwise equal, the B=2
              result against two B=1 calls, the adjoint identity on three
              draws a level (the gap over sum|u g|), and at
              16 z-anchors, where a line's planes take two tiles); the
              lift_bwd index kernel bitwise equal to its plain version at
              every level, and timed; tap_bwd within TAP_TOL, two launches
              bitwise equal, B=2 bitwise equal to two B=1 calls
  7. train parity  one train step of tiny_turbo_occ in fp32 on the card and
              on the CPU, same weights and batch: same loss and gradients
  8. train    turbo_occ full width, bf16, B=1, config defaults (grid mask,
              photometric distortion, dropout): 1 warm-up + 3 timed steps
              through the CLI's train step; frozen stages bitwise unchanged,
              every other leaf moved, 4 launches of each kernel per step;
              one more step under torch.profiler (device time summed and
              the card's busy time)
  9. kernels (msda)  the deformable-attention kernel vs its plain version at
              base_occ's SCA shape (6 cameras x 12288 queries, 4 levels) and
              TSA shape (2 x 40000 queries, 1 level), bf16 and f32 values,
              uniform random locations: within the bounds, f32 bitwise
              equal, the B=2 result bitwise equal to two B=1 calls
 10. exact parity  the pillar projection at full width and at tiny_occ's
              size, card vs CPU bitwise (bev_mask and ref_cam); tiny_occ in
              fp32 with static top-K SCA on the card and on the CPU: same
              logits, same sca_topk_overflow
 11. serve exact  Predictor on base_occ (bf16, full width, gather encoder)
              answers 3 requests; 24 msda launches, certificate 0; the
              msda kernel timed on the first encoder layer's TSA and SCA
              inputs captured from a request (real locations); then one
              request split by CUDA events and one under torch.profiler
 12. kernels (dcn)  at the four DCN shapes of R101-DCN (B = 6; stride 1
              and 2), offsets N(0, 2^2) px with 1 % at +/-30 px: the
              sampling kernel vs its plain version (bf16 and f32, bitwise);
              the fused DCN kernel (bf16) vs deform_conv_plain within one
              bf16 step or 2^-12 sum|cols W|, its window certificate at
              R = 3 equal to window_overflow card and CPU, two launches
              bitwise equal, B = 6 bitwise equal to six B = 1 calls; the
              fused kernel timed in turns against the sampling kernel +
              torch.matmul and against torch.matmul alone; the bounds
 13. dcn parity  tiny R101-DCN in fp32 with window DCN, dense and gather
              encoders, on the card and on the CPU: same logits, same
              certificates, 26 deform_sample launches (the fp32 path)
 14. serve turbo_r101_dcn_occ  full width, bf16 (window DCN, dense
              encoder), conv_offset drawn from a seed and calibrated to
              |offset| <= 2.5 px: every layer's needed_radius, 3 requests
              with 26 deform_conv + 0 deform_sample + 4 lift + 4 tap
              launches each, no window_overflow call and
              dcn_window_overflow 0, host clock beside CUDA events; the
              logits against the same request on the two-step route
              (sampling kernel + torch.matmul + window_overflow); one
              request under torch.profiler; one request split by CUDA
              events on each route
 15. serve r101_dcn_occ  the same with gather DCN and the exact encoder:
              26 deform_conv + 8 msda launches a request,
              sca_topk_overflow 0
 16. kernels (eval)  pass-2 from a tmp slab (Pallas #7) vs its plain
              version at the bench tool's shapes (one bf16 step), with a
              dense-hat bmm as the library yardstick; the scene render
              kernel (dda_kernel's render epilogue: one launch for a
              full-width synthetic scene, 6 x 928 x 1600 views of a
              200 x 200 x 16 grid, 420 steps) vs render_views_plain (share
              of differing pixels <= PIXEL_MISMATCH, bitwise expected; two
              launches bitwise) and its raw epilogue on the same rays
              (coords and hits bitwise); the eval render kernel
              (fan_kernel's render epilogue at the eval shape: prediction
              int64 / bf16 and GT int32 / fp32, 8 origins x 360 x 39 rays)
              vs fan_render_plain (label and flow bitwise, dist within
              DIST_RTOL; two launches bitwise; G = 2 equal to two G = 1
              calls) and its raw epilogue (coords and hits bitwise); each
              epilogue timed against a bound from its own traffic (the
              render: scene tables and grid in, views out; the fan render:
              origins and tables in, dist / label / flow out; the raw
              ones: rays in, dist / coord / hit out) and this run's steps;
              then the bench tool's entry
 17. eval parity  synth_tiny_turbo_occ in fp32, card vs CPU: rendered
              views (share of differing pixels <= 1e-3), GT-vs-GT RayIoU 1,
              metric counts of the same grids bitwise, a random-weight
              model's argmax agreement (>= 99 %) and run_evaluation scores
 18. eval turbo_occ  the train CLI in process: 4 full-width bf16 steps on
              4 synthetic scenes rendered on the card, then run_evaluation
              on 8 val scenes (finite RayIoU); GT-vs-GT RayIoU 1 on a val
              frame, 1 render launch a scene (no raw DDA launch), 4 lift +
              4 tap + 1 fan render launches a frame, the fan tables built
              once in the run, a per-frame split by CUDA events
 19. kernels (msda backward)  occ_msda_bwd vs msda_backward_plain at
              base_occ's SCA and TSA shapes, bf16 and f32, locations in
              [-0.2, 1.2]: every gradient within BWD_F32_TOL / BWD_BF16_TOL
              of max|plain| (fp32 atomics: dvalue is not bitwise
              reproducible), dloc and dattn bitwise over two launches and
              at B=2 against two B=1 calls (dvalue within the tolerance);
              timed against the plain version and the bound, and in bf16
              each SCA level alone (the per-level split); the hot-row case
              (every sample of camera 0, head 0 inside rows 5-8 of level 3)
 20. kernels (dcn backward)  occ_deform_sample_bwd vs
              deform_sample_backward_plain at the four DCN shapes (stride 1
              and the stride-2 stage entries): bf16 and f32 at phase 12's
              offsets, bf16 at calibrated offsets (|offset| <=
              DCN_TRAIN_MAX_PX); the same checks (doffset, dmask), a
              need_dx=False launch skipping dx alone; the share of
              samples the kernel scatters; timed per shape
 21. train parity (exact, DCN)  one fp32 train step card vs CPU on the
              small gather config (static top-K) and the small R50-DCN
              config (window DCN + dense, gather DCN + gather): loss 1e-3
              relative, gradients 5e-2 x max|g| per leaf (the gather
              config's trunk in L2), certificates 0; the backward kernels
              launched once a layer
 22-24. train base_occ, turbo_r101_dcn_occ, r101_dcn_occ  full width,
              bf16, B=1, config defaults: 1 warm-up + 2 timed steps through
              the CLI's train step (R101-DCN: trunk FrozenBN statistics and
              DCN offsets calibrated on the batch, |offset| <= 1.5 px, no
              grid mask or photometric distortion): finite
              loss, cert_overflow 0, host ms, CUDA-event forward / backward
              / optimizer split, peak allocated, launches per step (8 msda
              and 8 msda_bwd; 26 fused DCN, 26 sampling for the backward's
              columns and 26 dcn_bwd), one more step under torch.profiler
              with the backward kernels' device ms; then the backward
              kernels on that profiled step's own inputs (base_occ: the
              first encoder layer's SCA, level by level too, and TSA;
              R101-DCN: layer3_1 with its scattered share), held and
              timed as in 19 / 20
 25. data base_occ  a 4-frame, 2-scene nuScenes-layout data root (the
              six committed 900 x 1600 JPEGs of
              occnet_tpu_torch/data/fixtures/, the ring rig, labels.npz with
              ~1 % occupied voxels and flow, infos pkls): the port's JPEG
              decoder gives the fixtures' tf.io.decode_jpeg digests; a
              reference BEVFormerOcc .pth fabricated from the port's init
              converts back to it bit for bit; the test CLI (--torch-
              checkpoint --eval --format-only) on base_occ: auto top-K per
              camera, certificate 0, msda 4 layers x (1 + K groups) and the
              fan render kernel twice a frame (eval + submission), finite
              RayIoU and point clouds (mAVE / OccScore are NaN when no
              flow-class ray is a true positive, the reference's
              semantics), a per-frame split (host load, forward, render,
              counts); then ray_casting + metric: GT vs GT RayIoU and
              OccScore 1, the metric CLI equal to score_submissions, the
              CLI's submission equal to ray_casting's point clouds
 26. data turbo_r101_dcn_occ  the test CLI with the window-DCN radius
              probe on weights calibrated on the first frame: the probed
              per-layer radii equal each layer's needed_radius computed
              apart (0 off the window kernel), certificate 0 on every
              frame, 26 fused DCN + 4 lift + 4 tap launches a request (the
              probe is one more), one fan render a frame
 27. data train  the train CLI on the data root: turbo_occ, full width,
              B = 1, 2 steps with a torchvision-layout ResNet-50
              (--backbone-checkpoint; conv1 kept bit for bit, frozen) and
              the eval hook on 2 val frames: finite losses, lift / tap
              forward and backward launches, the checkpoint written and one
              more step resumed from it
 28. temporal parity  the nearest rotation's source indices at 200 x 200
              on 254 angles (cos / sin taken on each device) card vs CPU,
              equal except within ROT_TIE_PX of a .5 tie; tiny_turbo_occ
              and tiny_occ (static top-K) in fp32 card vs CPU: a 2-scene x
              3-frame stream through StreamingInferenceState (yaw and
              translation a frame; history BEV and logits within
              LOGIT_ATOL, certificates 0) and one clip train step (T = 3,
              one padded frame; phase 7 / 21's bounds)
 29. temporal serve  turbo_occ and base_occ (bf16, full width) stream 2
              scenes x TEMPORAL_FRAMES uint8 900 x 1600 frames: 4 lift + 4
              tap or 8 msda launches a frame (the single-frame counts),
              certificates 0, each scene's first frame equal to a
              single-frame request and the later ones not; host ms a
              frame, the align / forward split by CUDA events, the
              single-frame latency of the same frames in turns (stream,
              single, single, stream), peak memory
 30. temporal train  clip steps through the train CLI's temporal step,
              full width, bf16, B = 1 (turbo_occ T = 2 and 4, base_occ
              T = 2): 1 warm-up + 2 timed steps, finite losses,
              certificates 0, launches a step (4T lift + 4T tap and 4
              lift_bwd + 4 tap_bwd; 8T msda + 8 msda_bwd), host ms, the
              history / forward / backward / optimizer split by CUDA
              events, peak memory
 31. temporal data root  on phase 25's data root: the test CLI with
              --video --eval --format-only on base_occ (auto top-K,
              certificate 0, msda and fan render launches as phase 25,
              history engaged on each scene's second frame, finite scores,
              GT vs GT RayIoU 1); the train CLI with --temporal-queue 2 on
              turbo_occ for 2 steps (lift / tap launches for both clip
              frames, the backward's for the last) and one step resumed
 32. bench    `python -m occnet_tpu_torch.tools.bench` in its own process:
              its JSON line (bench.py's keys, the card's name and power
              limit) and frames/s of the turbo_occ forward
 33. data-parallel steps  over torchrun, full width, B = 1 a rank,
              dropout 0 (grid mask and distortion on): turbo_occ at NCCL
              world 1 bitwise equal to the in-process step; turbo_occ and
              base_occ at gloo world 2, both ranks on the one card, the
              ranks' leaves bitwise equal, turbo_occ against the
              in-process B = 2 step (loss and BN statistics 1e-3, the
              gradients within twice what swapping the B = 2 batch's
              samples moves them); NCCL at world 2 where two cards show;
              for each rank the timed step's host ms, its CUDA-event split
              (forward, backward, gradient all-reduce, optimizer), peak
              memory and hand-kernel launches
 34. dist_train  occnet_tpu_torch/tools/dist_train.sh at world 1 (NCCL)
              on phase 25's data root (a one-frame train split: a
              checkpoint every step), --profile 2, 4 steps: 3 checkpoints
              kept with their metadata, metrics.jsonl in the JAX format
              with its "hbm" event, the trace naming the lift, tap,
              lift_bwd and tap_bwd kernels and holding the spans'
              occ/ ranges, their summary beside it; --resume from the step-2
              checkpoint equal to the uninterrupted run
 35. dist_test  occnet_tpu_torch/tools/dist_test.sh at world 2 (gloo, one
              card) with phase 34's checkpoint, --eval --format-only on the
              4 val frames: scores and merged submission equal to the
              single-process test CLI's
 36. vovnet parity  every VoVNet preset (models/vovnet.py), fp32, random
              weights, at an odd 67 x 93 input (the ceil-mode pools hang off
              the edge), card (cuDNN) vs CPU within MODULE_RTOL
 37. vovnet  base_occ with backbone.type = vovnet, V-99-eSE, full width,
              bf16: REQUESTS served requests (certificate 0, 8 msda launches
              each, latency, peak), then 1 warm-up + FULL_TRAIN_STEPS train
              steps through the CLI's step (finite losses, 8 msda + 8
              msda_bwd launches a step, the frozen stem and stage 2 moved by
              AdamW's decay alone, every other leaf moved, peak)
 38. detection kernels  msda.cu / msda_bwd.cu at the detection decoder's
              shape (value (1, 200 x 200, 8, 32), Q = 900, L = 1, P = 4),
              point and box references with samples off the map, bf16 and
              f32, against msda_plain / msda_backward_plain, timed against
              bounds that count the value rows the samples touch
 39. detection  PerceptionTransformer fp32 card vs CPU at the CPU tests'
              sizes, with and without can-bus and a prev BEV; then at
              base_occ's widths in bf16 (R50 + FPN features of 6 x 928 x
              1600 images, 200 x 200 BEV, 4 encoder layers, 900 queries, 6
              decoder layers) with can-bus and a prev BEV ->
              decode_layer_boxes -> nms_free_decode: REQUESTS requests,
              certificate 0, 8 + 6 msda launches each, a CUDA-event split
 40. renders  render_sample (the dda kernel's raw epilogue, one launch) and
              render_sample_fast (the fan kernel's render epilogue, one
              launch) at 200 x 200 x 16 along the 14,040-ray fan from 2
              origins, against their CPU plain versions and render_pred_gt;
              the expected depth and its gradient card vs CPU; each timed
              over 20 launches or calls, the expected depth also profiled
 41. model axis  turbo_occ and base_occ train steps (full width, bf16,
              B = 1, dropout and grid mask on) at dp = 1 x mp = 2 with the
              BEV queries sharded, two gloo ranks on the one card under
              torchrun, against the in-process unsharded step: loss and BN
              statistics within QSHARD_RTOL, every leaf within GRAD_RTOL,
              the ranks bitwise equal, the
              unsharded step's launches a rank, certificates 0; each rank's
              step split (the halo / gather collectives apart) and peak
              beside the unsharded step's.  Then the lift (rows of a half),
              tap and tap_bwd (a half plus its halo, H = 102) and MSDA /
              msda_bwd (Q = 20,000 over the whole value) against their
              plain versions
 42. soak     the turbo_occ train CLI (SOAK_STEPS steps on SOAK_SCENES
              synthetic scenes, an eval and a checkpoint each epoch) and
              tools.soak_report over its work directory: the JAX tool's
              keys, the manager's checkpoints, a finite peak, no abort
 43. lift geometry  the geometry kernel (csrc/lift_geometry.cu) bitwise
              equal to its plain version on the card (pos1, pos2, steep of
              every level, count, inv_count): the ring rig (cells exactly on
              the cameras' field-of-view edges) at tiny_turbo_occ's and
              turbo_occ's widths, B = 1 and B = 4, BEV rows [0, 100) and
              [100, 200), the overlapping rig and three random rigs; kernel,
              plain version and bound timed in turns at B = 1 and B = 4; one
              full-width lift_and_average under
              torch.cuda.set_sync_debug_mode("error") (the plain geometry
              shown to synchronise), and its counter in the spans
The last lines are the kernels JSON (each kernel with its bound_ms: the
largest of its compulsory bytes over 3.35 TB/s, its fp32 operations over
67 TFLOP/s and, for the fused DCN, its bf16 tensor-core operations over
989 TFLOP/s), the nvidia-smi line and {"ok": true, "device": {...}}.
Needs no network and no JAX.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

TAP_TOL = 2e-2           # rtol = atol of tests/test_tsa_pallas.py
LOGIT_ATOL = 5e-2        # cross-implementation bound of the model tests
# lift_bwd: both forms round an fp32 sum to bf16; the kernel adds in another
# order than the plain version, so the two may be one bf16 step apart (2^-7
# of the larger magnitude) plus fp32 ordering noise on cancelling sums
LIFT_BWD_RTOL = 2.0 ** -7
LIFT_BWD_ATOL = 2.0 ** -12   # x max|plain| of the level
ADJOINT_RTOL = 1e-5      # fp32 inner products <lift f, g> vs <f, lift^T g>
ADJOINT_DRAWS = 3        # draws of (f, g) a level for the adjoint identity
GRAD_RTOL = 5e-2         # per leaf, x max|g|: the lift's bf16 rounding bound
# the small gather config's trunk gradients are not determined by fp32:
# card and CPU differ by up to 6.3 % of max|g| on a trunk leaf (1.9 % in L2)
# while the FPN and every leaf after it agree to 1e-5 (phase 21 held per
# leaf), so its trunk leaves are held in relative L2, as
# tests/test_torch_train.py holds train-mode trunks
TRUNK_L2_RTOL = 0.1
MSDA_BF16_TOL = 2e-2     # bf16 values: one bf16 step (the tap bound)
MSDA_F32_ATOL, MSDA_F32_RTOL = 2e-5, 1e-5   # tests/test_msda.py:192
HBM_TBS = 3.35           # H100 SXM device-memory peak, TB/s
FP32_TFLOPS = 67.0       # H100 SXM fp32 peak outside the tensor cores
BF16_TC_TFLOPS = 989.0   # H100 SXM dense bf16 tensor-core peak
# deform_sample: kernel and plain version take the same fp32 operations in
# the same order, so f32 results are expected bitwise; the bound allows
# summation noise at 1e-6 of the largest input
DCN_F32_RTOL = 1e-6
DCN_RADIUS = 3           # the served window radius of turbo_r101_dcn_occ
# the fused DCN kernel against its plain version: both round an fp32 sum of
# the same bf16 columns x weight products to bf16, but the tensor cores add
# in another order than an fp32 matmul, so the two may be one bf16 step
# apart, plus fp32 ordering noise where the row cancels (x sum_k |cols W|)
DCN_CONV_RTOL = 2.0 ** -7
DCN_CONV_ATOL = 2.0 ** -12
# whole bf16 R101-DCN requests, fused DCN against the two-step route
# (sampling kernel + torch.matmul): argmax agreement on the voxels whose top
# two logits are not tied in bf16 (a tie flips under any one-step change:
# the two-step route and the plain product of the same columns agree on
# 98.9 % of all voxels of turbo_r101_dcn_occ), and on all voxels no further
# below the two-step / plain agreement than this slack
ARGMAX_AGREE = 0.99
ARGMAX_FLOOR_SLACK = 5e-3
DCN_MAX_PX = 2.5         # largest |offset| after calibration: floor in [-3, 2]
# train steps move the weights (Adam's first steps move each by about the
# learning rate), so their offsets are calibrated with more margin
DCN_TRAIN_MAX_PX = 1.5
# the backward kernels against their plain versions, per gradient, x the
# plain gradient's largest magnitude: dvalue / dx are fp32 atomic sums in an
# order that changes from launch to launch (not bitwise reproducible), and
# in bf16 they are rounded once to bf16 (2^-8 relative) from bf16 inputs
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2e-2
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
FULL_TRAIN_STEPS = 2     # timed steps of each exact / R101-DCN config


def log(*a):
    print(*a, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_time(nb: float, flops: float, bf16_tc_flops: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nb`` bytes (each input read once, each output written
    once), do ``flops`` fp32 operations on the CUDA cores and
    ``bf16_tc_flops`` bf16 operations on the tensor cores: the largest of
    bytes over 3.35 TB/s, fp32 operations over 67 TFLOP/s and tensor-core
    operations over 989 TFLOP/s."""
    t_bytes = nb / (HBM_TBS * 1e12) * 1e3
    t_ops = flops / (FP32_TFLOPS * 1e12) * 1e3
    t_tc = bf16_tc_flops / (BF16_TC_TFLOPS * 1e12) * 1e3
    if t_tc > max(t_bytes, t_ops):
        return t_tc, "operations (tensor cores)"
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


def ring_rig(m, batch, yaw_step=0.0, spacing=None):
    """The ring of `__graft_entry__._example_batch`: cam i yawed 2*pi*i/n
    (plus yaw_step * b for batch element b), focal img_w/2, principal point
    at the image centre.  ``spacing`` (rad) yaws cam i by spacing * i
    instead: at pi/6 the six 90-degree fields of view overlap, and BEV
    cells ahead of the middle cameras are seen by 3-4 of them (the ring's
    by 1-2)."""
    ego2img = np.tile(np.eye(4, dtype=np.float32), (batch, m.num_cams, 1, 1))
    step = 2 * np.pi / m.num_cams if spacing is None else spacing
    for b in range(batch):
        for ci in range(m.num_cams):
            a = step * ci + yaw_step * b
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


def lift_geometry(m, e2i, levels, rows=None):
    """Per level (pos1, pos2, steep) and the level-0 inv_count of the lift
    at the model's BEV grid (its rows ``rows`` = (r0, r1) alone when
    given), for the feature sizes ``levels``: the plain version."""
    from occnet_tpu_torch.ops import planar_lift
    geo, _, inv = planar_lift.lift_geometry_plain(
        e2i, m.pc_range, m.encoder.num_points_in_pillar, (m.bev_h, m.bev_w),
        (m.img_h, m.img_w), levels, rows)
    return geo, inv


def lift_bitwise(torch, m, feats, e2i, label, out_dtype=None):
    """The lift of ``feats`` through the kernel and through the plain
    version on the card: count and U_bar must be bitwise equal.  Returns
    the kernel's (U_bar, count)."""
    from occnet_tpu_torch.ops import planar_lift
    dt = out_dtype or torch.bfloat16
    args = (feats, e2i, m.pc_range, m.encoder.num_points_in_pillar,
            (m.bev_h, m.bev_w), (m.img_h, m.img_w))
    uk, ck = planar_lift.lift_and_average(*args, out_dtype=dt, impl="cuda")
    up, cp = planar_lift.lift_and_average(*args, out_dtype=dt, impl="plain")
    torch.cuda.synchronize()
    same = torch.equal(uk, up)
    fin = torch.isfinite(uk.float()).all().item()
    diff = (uk.float() - up.float()).abs().max().item()
    log(f"  lift {label} U_bar {tuple(uk.shape)} {dt}: bitwise equal to the "
        f"plain version {same} (max|diff| {diff:.3e}), finite={fin}, count "
        f"range [{ck.min().item():.0f}, {ck.max().item():.0f}]")
    if not (torch.equal(ck, cp) and same and fin):
        raise RuntimeError(f"lift kernel differs from plain ({label})")
    return uk, ck


def edge_positions(torch, gen, B, A, ZR, M, h, w):
    """Lift positions that probe the sampler's edges rather than a camera
    geometry: uniform over (-1.5, n + 0.5) of each axis extent n with a
    fifth made integral, band-limited to (-1, n) as `level_geometry` does
    (the rest dead, -2), a fifth more dead, and a random pass order a
    plane.  Returns (pos1, pos2, steep)."""
    dev = gen.device

    def draw(n):
        def u():
            return torch.rand(n.shape, generator=gen, device=dev)
        p = u() * (n + 2.0) - 1.5
        p = torch.where(u() < 0.2, p.round(), p)
        dead = (u() < 0.2) | (p <= -1.0) | (p >= n)
        return torch.where(dead, torch.full_like(p, -2.0), p)

    steep = torch.rand(B, A, ZR, generator=gen, device=dev) < 0.5
    n2 = torch.where(steep, float(h), float(w))[..., None].expand(
        B, A, ZR, M)
    n1 = torch.cat([torch.full((w,), float(h), device=dev),
                    torch.full((h,), float(w), device=dev)]).expand(
        B, A, ZR, w + h)
    return draw(n1).contiguous(), draw(n2).contiguous(), steep


def random_rig(m, batch, seed):
    """A random rig: each camera yawed anywhere, pitched and rolled up to
    0.1 rad, placed up to 2 m off the ego origin, focal 0.4-0.8 img_w,
    principal point up to 5 % off the image centre."""
    rng = np.random.RandomState(seed)
    ego2img = np.tile(np.eye(4, dtype=np.float32), (batch, m.num_cams, 1, 1))
    for b in range(batch):
        for ci in range(m.num_cams):
            yaw = rng.uniform(0, 2 * np.pi)
            pitch, roll = rng.uniform(-0.1, 0.1, 2)
            cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), \
                np.sin(pitch)
            # ego (x fwd, y left, z up) -> camera (x right, y down, z fwd)
            R = np.array([[sy, -cy, 0], [0, 0, -1], [cy, sy, 0.0]])
            R = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]) @ R
            R = np.array([[np.cos(roll), -np.sin(roll), 0],
                          [np.sin(roll), np.cos(roll), 0], [0, 0, 1]]) @ R
            t = -R @ np.array([*rng.uniform(-2, 2, 2), 1.5])
            f = rng.uniform(0.4, 0.8) * m.img_w
            K = np.array([[f, 0, m.img_w * rng.uniform(0.45, 0.55)],
                          [0, f, m.img_h * rng.uniform(0.45, 0.55)],
                          [0, 0, 1]])
            ego2img[b, ci, :3, :3] = (K @ R).astype(np.float32)
            ego2img[b, ci, :3, 3] = (K @ t).astype(np.float32)
    return ego2img


def feature_levels(m):
    """The (h, w) of the four FPN levels at the model's padded image."""
    return [(-(-m.img_h // s), -(-m.img_w // s)) for s in (8, 16, 32, 64)]


def phase_lift_geometry(torch, results):
    from occnet_tpu_torch.config import tiny_turbo_occ, turbo_occ
    from occnet_tpu_torch.ops import planar_lift
    from occnet_tpu_torch.ops.planar_lift import (GEOMETRY,
                                                  lift_geometry_cuda,
                                                  lift_geometry_plain)
    from occnet_tpu_torch.utils.profiling import span, spans
    dev = torch.device("cuda")
    fm, tm = turbo_occ().model, tiny_turbo_occ().model

    def geo_args(m):
        return (m.pc_range, m.encoder.num_points_in_pillar,
                (m.bev_h, m.bev_w), (m.img_h, m.img_w), feature_levels(m))

    def differing(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return int((a != b).sum())

    def held(label, m, e2i, rows=None):
        e = torch.from_numpy(e2i).to(dev)
        gk, ck, ik = lift_geometry_cuda(e, *geo_args(m), rows)
        gp, cp, ip = lift_geometry_plain(e, *geo_args(m), rows)
        torch.cuda.synchronize()
        named = [(f"level {lvl} {name}", a, b)
                 for lvl, (lk, lp) in enumerate(zip(gk, gp))
                 for name, a, b in zip(("pos1", "pos2", "steep"), lk, lp)]
        named += [("count", ck, cp), ("inv_count", ik, ip)]
        bad = {n: k for n, a, b in named if (k := differing(a, b))}
        live = (gk[0][1] > -2).float().mean().item()
        log(f"  {label}: B={e.shape[0]}, rows {rows or (0, m.bev_h)}, "
            f"level-0 pos2 {tuple(gk[0][1].shape)} {live:.1%} live, count "
            f"[{ck.min().item():.0f}, {ck.max().item():.0f}]: bitwise equal "
            f"to the plain version in all {len(named)} outputs "
            f"{not bad}")
        if bad:
            raise RuntimeError(f"lift geometry kernel differs from plain "
                               f"({label}): differing elements {bad}")
        return ck

    held("tiny_turbo_occ ring", tm, ring_rig(tm, 1))
    held("tiny_turbo_occ ring, yawed 0.1 a sample", tm, ring_rig(tm, 4, 0.1))
    held("turbo_occ ring", fm, ring_rig(fm, 1))
    held("turbo_occ ring, yawed 0.1 a sample", fm, ring_rig(fm, 4, 0.1))
    for rows in ((0, 100), (100, 200)):
        held("turbo_occ ring", fm, ring_rig(fm, 1), rows)
        held("turbo_occ ring, yawed 0.1 a sample", fm, ring_rig(fm, 4, 0.1),
             rows)
    if held("turbo_occ overlapping cameras", fm,
            ring_rig(fm, 1, spacing=np.pi / 6)).max().item() < 3:
        raise RuntimeError("the overlapping rig sees no cell with 3 cameras")
    for seed in range(3):
        held(f"turbo_occ random rig {seed}", fm, random_rig(fm, 2, seed))

    # time, B = 1 and B = 4: each call's device time by the profiler (the
    # wrapper's host work, ~0.1 ms, paces back-to-back calls, so CUDA
    # events over them time the host), and the calls in turns
    from occnet_tpu_torch.tools.profile_turbo import device_profile
    reps = 10
    for B in (1, 4):
        e = torch.from_numpy(ring_rig(fm, B, 0.1)).to(dev)
        geo, ck, ik = lift_geometry_cuda(e, *geo_args(fm))
        nb = nbytes(e, ck, ik, *[t for g in geo for t in g])
        # a pos2 element: 12 roundings and 2 divisions; a pos1 tap: 2
        flops = sum(14 * p2.numel() + 2 * p1.numel() for p1, p2, _ in geo)
        b_ms, by = least_time(nb, flops)

        def kernel():
            for _ in range(reps):
                lift_geometry_cuda(e, *geo_args(fm))

        prof = device_profile(kernel, {"geometry": ["lift_geometry_kernel"]})
        if prof["geometry_n"] != reps:
            raise RuntimeError(f"profiled {prof['geometry_n']} geometry "
                               f"kernels of {reps} calls")
        k = prof["geometry_ms"] / reps
        plain = device_profile(lambda: lift_geometry_plain(e, *geo_args(fm)))
        wall_k, wall_p = in_turns(
            torch, lambda: lift_geometry_cuda(e, *geo_args(fm)),
            lambda: lift_geometry_plain(e, *geo_args(fm)), reps)
        ops = sum(plain["n_by_name"].values())
        log(f"  lift geometry B={B}: kernel {k:.4f} ms on the card (1 "
            f"launch); plain {plain['busy_ms']:.4f} ms busy in a "
            f"{plain['span_ms']:.4f} ms span ({ops} device operations); a "
            f"call back to back {wall_k:.4f} / "
            f"{wall_p:.4f} ms; {nb / 1e6:.1f} MB written; bound {b_ms:.4f} ms "
            f"({by}), kernel at {b_ms / k:.1%} of it")
        key = "" if B == 1 else "_b4"
        results["lift_geometry"].update({
            f"ms{key}": k, f"plain_ms{key}": plain["busy_ms"],
            f"call_ms{key}": wall_k, f"plain_call_ms{key}": wall_p,
            f"bound_ms{key}": b_ms})
    results["lift_geometry"].update(bound_by=by, library_ms=None,
                                    max_abs_err=0.0)

    # one full-width lift: no synchronising call on the kernel path; the
    # plain geometry synchronises at its z-anchor upload
    Z = fm.encoder.num_points_in_pillar
    feats = [torch.randn(1, fm.num_cams, h, w, fm.embed_dims,
                         device=dev).to(torch.bfloat16)
             for h, w in feature_levels(fm)]
    e = torch.from_numpy(ring_rig(fm, 1)).to(dev)
    lift = (feats, e, fm.pc_range, Z, (fm.bev_h, fm.bev_w),
            (fm.img_h, fm.img_w))
    planar_lift.lift_and_average(*lift)
    torch.cuda.synchronize()
    GEOMETRY.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        planar_lift.lift_and_average(*lift)
        try:
            planar_lift.lift_and_average(*lift, impl="plain")
            plain = "raised nothing"
        except RuntimeError as err:
            plain = f"raised: {str(err).splitlines()[0]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = GEOMETRY.launches
    with spans() as rec:
        with span("smoke.lift"):
            planar_lift.lift_and_average(*lift)
    counted = sum(it["counters"].get("lift.geometry_kernel", 0)
                  for it in rec.summary())
    log(f"  full-width lift_and_average under sync debug mode \"error\": "
        f"the kernel path raised nothing ({launched} geometry launch); the "
        f"plain path {plain}; counter lift.geometry_kernel {counted:.0f} in "
        f"one traced call")
    if launched != 1 or counted != 1:
        raise RuntimeError("the lift did not go through the geometry kernel "
                           "once")


def phase_kernels(torch, cfg, results):
    from occnet_tpu_torch.config import tiny_turbo_occ
    from occnet_tpu_torch.ops import planar_lift, tsa
    from occnet_tpu_torch.ops.lift_cuda import lift_level_cuda, \
        lift_level_plain
    m = cfg.model
    dev = torch.device("cuda")
    C = m.embed_dims
    levels = [(116, 200), (58, 100), (29, 50), (15, 25)]
    gen = torch.Generator(device=dev).manual_seed(0)
    Z = m.encoder.num_points_in_pillar
    ZR = Z * m.bev_h

    def draw_feats(mc, B, lv):
        return [torch.randn(B, mc.num_cams, h, w, mc.embed_dims,
                            generator=gen, device=dev).to(torch.bfloat16)
                for h, w in lv]

    # bitwise against the plain version: B = 1 (twice: two launches agree),
    # B = 2 against two B = 1 launches, and the overlapping-camera rig
    feats = draw_feats(m, 2, levels)
    e2i = torch.from_numpy(ring_rig(m, 2, yaw_step=0.1)).to(dev)
    u2, _ = lift_bitwise(torch, m, feats, e2i, "B=2 (ring, yawed 0.1 a "
                         "sample)")
    for b in range(2):
        one = [f[b:b + 1].contiguous() for f in feats]
        u1, _ = lift_bitwise(torch, m, one, e2i[b:b + 1], f"B=1 sample {b}")
        again, _ = lift_bitwise(torch, m, one, e2i[b:b + 1],
                                f"B=1 sample {b}, second launch")
        if not (torch.equal(u1, again) and torch.equal(u1[0], u2[b])):
            raise RuntimeError("lift: launches or batch splits differ")
    log("  lift: two launches bitwise equal; B=2 bitwise equal to two B=1 "
        "launches")
    del u2, u1, again
    e2o = torch.from_numpy(ring_rig(m, 1, spacing=np.pi / 6)).to(dev)
    _, co = lift_bitwise(torch, m, [f[:1].contiguous() for f in feats], e2o,
                         "overlapping cameras (6 yawed pi/6 apart)")
    if co.max().item() < 3:
        raise RuntimeError("the overlapping rig sees no cell with 3 cameras")
    # the fp32 output at tiny_turbo_occ's size (C = 128, Z = 4, 50 x 50)
    tm = tiny_turbo_occ().model
    tl = [(-(-tm.img_h // s), -(-tm.img_w // s)) for s in (8, 16, 32, 64)]
    lift_bitwise(torch, tm, draw_feats(tm, 2, tl),
                 torch.from_numpy(ring_rig(tm, 2, 0.1)).to(dev),
                 "tiny_turbo_occ B=2", out_dtype=torch.float32)
    # edge positions (k = -1, k = n - 1, integral taps, both pass orders)
    for lvl in (0, 3):
        h, w = levels[lvl]
        p1, p2, st = edge_positions(torch, gen, 2, m.num_cams, ZR, m.bev_w,
                                    h, w)
        f = draw_feats(m, 2, [(h, w)])[0]
        inv = 1.0 / torch.randint(1, 7, (2, m.bev_h * m.bev_w), generator=gen,
                                  device=dev).float()
        for dt in (torch.bfloat16, torch.float32):
            ok_ = torch.empty(2, ZR, m.bev_w, C, dtype=dt, device=dev)
            op = torch.empty_like(ok_)
            lift_level_cuda(f, p1, p2, st, inv, ok_)
            lift_level_plain(f, p1, p2, st, inv, op)
            torch.cuda.synchronize()
            if not torch.equal(ok_, op):
                raise RuntimeError(f"lift kernel differs from plain on edge "
                                   f"positions, level {lvl}, {dt}")
        log(f"  lift edge positions level {lvl} ({h}x{w}), B=2, "
            f"{(p2 > -2).float().mean().item():.1%} of pos2 live: bf16 and "
            f"fp32 outputs bitwise equal to the plain version")
    results["lift"]["max_abs_err"] = 0.0
    del feats

    # time: the four level kernels on precomputed geometry, B = 1
    f1 = draw_feats(m, 1, levels)
    e2i = torch.from_numpy(ring_rig(m, 1)).to(dev)
    geo, inv = lift_geometry(m, e2i, levels)
    args = [(f, *g) for f, g in zip(f1, geo)]
    out = torch.empty(1, len(levels), ZR, m.bev_w, C, dtype=torch.bfloat16,
                      device=dev)

    def run(fn, lvls=range(len(levels))):
        def go():
            for lvl in lvls:
                fn(*args[lvl], inv, out[:, lvl])
        return go

    def bound(lvl):
        f, p1, p2, st = args[lvl]
        # each live (camera, cell) pair: 2x2 taps, mul + add per channel
        flops = (p2 > -2).sum().item() * C * 8
        return least_time(nbytes(f, p1, p2, st, inv, out[:, lvl]), flops)

    for lvl, (h, w) in enumerate(levels):
        k = cuda_ms(torch, run(lift_level_cuda, [lvl]), 20)
        b_ms, by = bound(lvl)
        log(f"  lift level {lvl} ({h}x{w}): kernel {k:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it")
    k, p = in_turns(torch, run(lift_level_cuda), run(lift_level_plain), 5)
    flops = sum((a[2] > -2).sum().item() for a in args) * C * 8
    b_ms, by = least_time(sum(nbytes(*a) for a in args) + nbytes(inv, out),
                          flops)
    results["lift"].update(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=by,
                           library_ms=None)
    full = cuda_ms(torch, lambda: planar_lift.lift_and_average(
        f1, e2i, m.pc_range, Z, (m.bev_h, m.bev_w), (m.img_h, m.img_w),
        impl="cuda"), 5)
    log(f"  lift 4 levels B=1: kernel {k:.4f} ms, plain {p:.4f} ms; bound "
        f"{b_ms:.4f} ms ({by}), kernel at {b_ms / k:.1%} of it; with fp32 "
        f"geometry {full:.4f} ms; U_bar {out.numel() * 2 / 1e6:.1f} MB bf16 "
        f"-> {out.numel() * 2 / k / 1e9:.3f} TB/s write")
    del f1, out, args, geo

    # tap attention: the main-path shape and an odd one (H, W not multiples
    # of the 8 x 8 tile, B = 2, C = 128), within TAP_TOL of the plain
    # version; two launches and B = 2 against two B = 1 launches bitwise
    def tap_case(shape, heads, dtype):
        B, nq, H, W, _ = shape
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        logits = torch.randn(B, H, W, nq, len(tsa.TSA_TAPS), heads,
                             generator=gen, device=dev)
        return v, torch.softmax(logits, dim=4).to(dtype)

    def tap_check(v, attn):
        ok_ = tsa.tap_attention_cuda(v, attn)
        again = tsa.tap_attention_cuda(v, attn)
        op = tsa.tap_attention_plain(v, attn)
        split = torch.cat([tsa.tap_attention_cuda(v[b:b + 1].contiguous(),
                                                  attn[b:b + 1].contiguous())
                           for b in range(v.shape[0])])
        torch.cuda.synchronize()
        err = (ok_ - op).abs().max().item()
        slack = (TAP_TOL + TAP_TOL * op.abs() - (ok_ - op).abs()).min().item()
        fin = torch.isfinite(ok_).all().item()
        same = torch.equal(ok_, again) and torch.equal(ok_, split)
        log(f"  tap {tuple(v.shape)} {attn.shape[-1]} heads {v.dtype}: "
            f"max|kernel-plain| = {err:.3e} (rtol=atol={TAP_TOL}), "
            f"finite={fin}; two launches and the batch split bitwise equal "
            f"{same}")
        if not (slack >= 0 and fin and same):
            raise RuntimeError(f"tap kernel disagrees with plain: {err}")
        return ok_, err

    heads = m.encoder.tsa.num_heads
    nq = m.encoder.tsa.num_bev_queue
    err = 0.0
    for shape, hd, dt in (((2, 2, 9, 13, 128), 8, torch.bfloat16),
                          ((2, 2, 9, 13, 128), 8, torch.float32),
                          ((1, nq, m.bev_h, m.bev_w, C), heads,
                           torch.bfloat16)):
        v, attn = tap_case(shape, hd, dt)
        ok_, e = tap_check(v, attn)
        err = max(err, e)
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
    from occnet_tpu_torch.ops.lift_cuda import (lift_bwd_index,
                                                lift_bwd_index_plain,
                                                lift_level_bwd_cuda,
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
        geo, inv = lift_geometry(m, e2i, levels)
        gs = [torch.randn(B, ZR, m.bev_w, C, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in levels]
        idx = [lift_bwd_index(p1, p2, st, hw)
               for (p1, p2, st), hw in zip(geo, levels)]
        for (p1, p2, st), hw, ix in zip(geo, levels, idx):
            ix.check()
            runs, excess = lift_bwd_index_plain(p1, p2, st, hw)
            if not (torch.equal(ix.runs, runs) and int(excess) == 0):
                raise RuntimeError(f"lift_bwd index kernel differs from its "
                                   f"plain version at level {hw}")
        log(f"  lift_bwd index B={B}: every level bitwise equal to the plain "
            f"version, premise holds (0 excess pairs)")
        out[B] = (e2i, geo, inv, gs, idx)
        worst = 0.0
        for (h, w), (p1, p2, st), g, ix in zip(levels, geo, gs, idx):
            dk = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w), index=ix)
            dk2 = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w), index=ix)
            dp = lift_level_bwd_plain(g, p1, p2, st, inv, (h, w)).float()
            same = torch.equal(dk, dk2)
            dk = dk.float()
            bad = bf16_step_apart(torch, dk, dp)
            err = (dk - dp).abs().max().item()
            worst = max(worst, err)
            runs = int((ix.runs[..., 0] != 0).sum())
            log(f"  lift_bwd B={B} level {h}x{w}: {runs} (line, plane) runs;"
                f" max|kernel-plain| = "
                f"{err:.6f}, |plain| max {dp.abs().max().item():.3f}, "
                f"{bad} elements beyond one bf16 step, "
                f"finite={torch.isfinite(dk).all().item()}, two launches "
                f"bitwise equal {same}")
            if bad or not torch.isfinite(dk).all().item():
                raise RuntimeError("lift_bwd kernel disagrees with plain")
            if not same:
                raise RuntimeError("lift_bwd kernel is not deterministic")
        results["lift_bwd"]["max_abs_err"] = max(
            worst, results["lift_bwd"].get("max_abs_err", 0.0))

    # B=2 against two B=1 calls on the same samples (the r5 hazard)
    e2i, geo, inv, gs, idx = out[2]
    for b in (0, 1):
        geo1, inv1 = lift_geometry(m, e2i[b:b + 1].contiguous(), levels)
        for (h, w), (p1, p2, st), g, ix, (q1, q2, qt) in zip(
                levels, geo, gs, idx, geo1):
            d2 = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w),
                                     index=ix).float()[b]
            d1 = lift_level_bwd_cuda(g[b:b + 1].contiguous(), q1, q2, qt,
                                     inv1, (h, w)).float()[0]
            bad = bf16_step_apart(torch, d2, d1)
            if bad:
                raise RuntimeError(f"lift_bwd B=2 sample {b} level {h}x{w} "
                                   f"differs from its B=1 call ({bad})")
    log("  lift_bwd B=2 == two B=1 calls, every level (within one bf16 "
        "step)")

    # 16 z-anchors: ZR = 3200 planes, more than the kernel sorts at once, so
    # each line is walked in two tiles carried in the fp32 scratch
    m16 = dataclasses.replace(m, encoder=dataclasses.replace(
        m.encoder, num_points_in_pillar=16))
    tiles = [(29, 50), (15, 25)]
    geo16, inv16 = lift_geometry(m16, out[1][0], tiles)
    gen16 = torch.Generator(device=dev).manual_seed(16)
    for (h, w), (p1, p2, st) in zip(tiles, geo16):
        g = torch.randn(1, p2.shape[2], m.bev_w, C, generator=gen16,
                        device=dev).to(torch.bfloat16)
        for dt in (torch.bfloat16, torch.float32):
            dk = lift_level_bwd_cuda(g, p1, p2, st, inv16, (h, w),
                                     out_dtype=dt)
            same = torch.equal(dk, lift_level_bwd_cuda(
                g, p1, p2, st, inv16, (h, w), out_dtype=dt))
            dp = lift_level_bwd_plain(g, p1, p2, st, inv16, (h, w),
                                      out_dtype=dt).float()
            bad = bf16_step_apart(torch, dk.float(), dp)
            log(f"  lift_bwd ZR={p2.shape[2]} level {h}x{w} {dt}: "
                f"{bad} elements beyond one bf16 step, two launches "
                f"bitwise equal {same}")
            if bad or not same:
                raise RuntimeError("lift_bwd kernel fails over two tiles")

    # adjoint identity <lift(f), g> = <f, lift^T(g)>, fp32 output both ways,
    # on ADJOINT_DRAWS draws of (f, g) a level; the gap is taken relative to
    # sum|u * g|, since the inner product itself cancels and may be near 0
    e2i, geo, inv, gs, idx = out[1]
    B1 = 1
    for (h, w), (p1, p2, st), ix in zip(levels, geo, idx):
        for _ in range(ADJOINT_DRAWS):
            f = torch.randn(1, m.num_cams, h, w, C, generator=gen, device=dev
                            ).to(torch.bfloat16)
            gf = torch.randn(1, ZR, m.bev_w, C, generator=gen, device=dev
                             ).to(torch.bfloat16).float()
            u = torch.empty(1, ZR, m.bev_w, C, device=dev)
            lift_level_cuda(f, p1, p2, st, inv, u)
            df = lift_level_bwd_cuda(gf, p1, p2, st, inv, (h, w),
                                     out_dtype=torch.float32, index=ix)
            ug = u.double() * gf.double()
            lhs = ug.sum().item()
            rhs = (f.double() * df.double()).sum().item()
            rel = abs(lhs - rhs) / max(ug.abs().sum().item(), 1e-30)
            log(f"  adjoint level {h}x{w}: <lift f, g> = {lhs:.6e}, "
                f"<f, lift^T g> = {rhs:.6e}, |gap| / sum|u g| = {rel:.2e} "
                f"(tol {ADJOINT_RTOL})")
            if not rel <= ADJOINT_RTOL:
                raise RuntimeError("lift_bwd kernel is not the forward's "
                                   "adjoint")

    def run(fn):
        def go():
            for (h, w), (p1, p2, st), g, ix in zip(levels, geo, gs, idx):
                fn(g, p1, p2, st, inv, (h, w), index=ix)
        return go

    def plain(g, p1, p2, st, inv, hw, index):
        return lift_level_bwd_plain(g, p1, p2, st, inv, hw)

    k, p = in_turns(torch, run(lift_level_bwd_cuda), run(plain), 3)
    per_level = [cuda_ms(torch, lambda: lift_level_bwd_cuda(
        g, p1, p2, st, inv, hw, index=ix), 3)
        for hw, (p1, p2, st), g, ix in zip(levels, geo, gs, idx)]
    log(f"  lift_bwd kernel per level ms: "
        f"{[round(t, 4) for t in per_level]}")

    def run_index(fn):
        def go():
            for (p1, p2, st), hw in zip(geo, levels):
                fn(p1, p2, st, hw)
        return go

    ik, ip = in_turns(torch, run_index(lift_bwd_index),
                      run_index(lift_bwd_index_plain), 3)
    # reads the geometry, writes the runs (8 bytes a line and plane); a
    # compare and two min / max a live (cell, tap) pair
    ib_ms, iby = least_time(
        sum(nbytes(p1, p2, st, ix.runs) for (p1, p2, st), ix
            in zip(geo, idx)),
        sum(4 * (p2 > -1).sum().item() for _, p2, _ in geo))
    results["lift_bwd_index"].update(
        max_abs_err=0.0, ms=ik, plain_ms=ip, bound_ms=ib_ms, bound_by=iby,
        library_ms=None)
    log(f"  lift_bwd index 4 levels B=1: kernel {ik:.4f} ms, plain "
        f"{ip:.4f} ms; bound {ib_ms:.4f} ms ({iby}), kernel at "
        f"{ib_ms / ik:.1%} of it")
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

    phase_tap_bwd(torch, m, gen, results)


def phase_tap_bwd(torch, m, gen, results):
    """The tap-attention backward kernel at the main-path shape (B = 1,
    bf16 v and attn, fp32 g) against its plain version within TAP_TOL, two
    launches bitwise equal, B = 2 bitwise equal to two B = 1 calls; timed in
    turns."""
    from occnet_tpu_torch.ops import tsa
    dev = torch.device("cuda")
    C = m.embed_dims
    heads = m.encoder.tsa.num_heads
    nq = m.encoder.tsa.num_bev_queue

    def draw(B):
        v = torch.randn(B, nq, m.bev_h, m.bev_w, C, generator=gen,
                        device=dev).to(torch.bfloat16)
        logits = torch.randn(B, m.bev_h, m.bev_w, nq, len(tsa.TSA_TAPS),
                             heads, generator=gen, device=dev)
        attn = torch.softmax(logits, dim=4).to(torch.bfloat16)
        g = torch.randn(B, m.bev_h, m.bev_w, C, generator=gen, device=dev)
        return v, attn, g

    v, attn, g = draw(1)
    dvk, dak = tsa.tap_attention_bwd_cuda(v, attn, g)
    dvk2, dak2 = tsa.tap_attention_bwd_cuda(v, attn, g)
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
    same = torch.equal(dvk, dvk2) and torch.equal(dak, dak2)
    v2, attn2, g2 = draw(2)
    dv2, da2 = tsa.tap_attention_bwd_cuda(v2, attn2, g2)
    split = True
    for b in (0, 1):
        dv1, da1 = tsa.tap_attention_bwd_cuda(
            v2[b:b + 1].contiguous(), attn2[b:b + 1].contiguous(),
            g2[b:b + 1].contiguous())
        split &= torch.equal(dv2[b:b + 1], dv1) and torch.equal(
            da2[b:b + 1], da1)
    log(f"  tap_bwd two launches bitwise equal {same}; B=2 bitwise equal to "
        f"two B=1 calls {split}")
    if not (same and split):
        raise RuntimeError("tap_bwd kernel is not deterministic per sample")
    del v2, attn2, g2, dv2, da2, dv1, da1
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
    from occnet_tpu_torch.tools.train import make_synthetic_batch
    cfg = small_train_cfg()
    m = cfg.model
    sd = from_jax_variables(randomize_variables(
        init_jax_style_variables(cfg, seed=1), seed=2))
    batch = make_synthetic_batch(cfg, 1, np.random.RandomState(4))
    batch["img"] = np.random.RandomState(5).randn(
        1, m.num_cams, m.img_h, m.img_w, 3).astype(np.float32)
    train_step_parity(torch, "tiny_turbo_occ", cfg, sd, batch)


def phase_train(torch, cfg, results):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD, LIFT_BWD_INDEX
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    from occnet_tpu_torch.tools.profile_turbo import device_profile
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
    kernels = {"lift": LIFT, "lift_bwd": LIFT_BWD,
               "lift_bwd_index": LIFT_BWD_INDEX, "tap": TAP,
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
            "lift_bwd_index": m.num_feature_levels * TRAIN_STEPS,
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
    prof = device_profile(lambda: step_fn(state, batch))
    log(f"  one more step under torch.profiler: device kernels and copies "
        f"{prof['kernel_ms']:.3f} ms summed, card busy {prof['busy_ms']:.3f} "
        f"ms of a {prof['span_ms']:.3f} ms span")
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
    for k in ("lift_bwd", "lift_bwd_index", "tap_bwd"):
        results[k]["launches"] = launches[k]


def phase_serve(torch, cfg, results):
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.planar_lift import GEOMETRY
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.tools.profile_turbo import device_profile
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
    LIFT.launches = TAP.launches = GEOMETRY.launches = 0
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
    launches = {"lift": LIFT.launches, "tap": TAP.launches,
                "lift_geometry": GEOMETRY.launches}
    want = {"lift": m.num_feature_levels * REQUESTS,
            "tap": m.encoder.num_layers * REQUESTS,
            "lift_geometry": REQUESTS}
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
    prof = device_profile(lambda: pred(reqs[-1], e2i))
    log(f"  one more request under torch.profiler: device kernels and copies "
        f"{prof['kernel_ms']:.3f} ms summed, card busy {prof['busy_ms']:.3f} "
        f"ms of a {prof['span_ms']:.3f} ms span")
    total, split = turbo_split(torch, pred, reqs[-1], e2i)
    log(f"  one request split by CUDA events: total {total:.3f} ms; "
        + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; the rest (normalise, H2D, embeds, get_occ) "
        f"{total - sum(split.values()):.3f} ms")


def turbo_split(torch, pred, imgs, e2i):
    """One dense-encoder request with CUDA events at module bounds and
    around the lift and the tap kernels: returns (total ms, {stage: ms})
    for trunk, FPN, lift geometry (everything of `lift_and_average` but
    the level kernels), lift kernels, encoder without its tap kernels, tap
    kernels, decoder (Conv3d stack) and heads."""
    from occnet_tpu_torch.models import dense_attention, transformer_occ
    from occnet_tpu_torch.ops import planar_lift
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

    model = pred.model
    tr = model.head.transformer
    watch = [("trunk", model.backbone), ("fpn", model.neck),
             ("encoder", tr.encoder), ("decoder", tr.decoder0),
             ("decoder", tr.decoder1), ("heads", tr.predicter),
             ("heads", tr.flow_predicter)]
    hooks = []
    for name, mod in watch:
        hooks.append(mod.register_forward_pre_hook(
            lambda *_, n=name: mark(n + ">")))
        hooks.append(mod.register_forward_hook(
            lambda *_, n=name: mark(n + "<")))
    try:
        with patched(transformer_occ, "lift_and_average",
                     wrap(transformer_occ.lift_and_average, "lift")), \
                patched(planar_lift, "lift_level",
                        wrap(planar_lift.lift_level, "kernels")), \
                patched(dense_attention, "tap_attention",
                        wrap(dense_attention.tap_attention, "tap")):
            torch.cuda.synchronize()
            mark("request>")
            pred(imgs, e2i)
            mark("request<")
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    spans, opened = {}, {}
    for label, ev in marks:
        name, end = label[:-1], label[-1] == "<"
        if end:
            spans[name] = spans.get(name, 0.0) + \
                opened.pop(name).elapsed_time(ev)
        else:
            opened[name] = ev
    split = {"trunk": spans["trunk"], "FPN": spans["fpn"],
             "lift geometry": spans["lift"] - spans["kernels"],
             "lift kernels": spans["kernels"],
             "encoder without tap": spans["encoder"] - spans["tap"],
             "tap kernels": spans["tap"], "decoder": spans["decoder"],
             "heads": spans["heads"]}
    return spans["request"], split


def msda_touched(torch, v, shapes, loc):
    """(bytes, corners) an MSDA call needs of value on this run's locations:
    the D channels of each distinct (batch, head, row) that some sample's
    bilinear corner touches inside its level, at most all of value, and the
    number of in-level corners."""
    from occnet_tpu_torch.ops.msda import _level_corners
    N, V, H, D = v.shape
    dev = loc.device
    base = (torch.arange(N, device=dev)[:, None, None, None] * H
            + torch.arange(H, device=dev)[None, None, :, None]) * V
    keys, corners, start = [], 0, 0
    for lvl, (h, w) in enumerate(shapes):
        _, _, cs = _level_corners(loc[:, :, :, lvl].float(), h, w)
        for valid, row in cs:
            keys.append((base + start + row)[valid])
            corners += int(valid.sum())
        start += h * w
    rows = torch.unique(torch.cat(keys)).numel()
    return rows * D * v.element_size(), corners


def msda_bound(torch, v, shapes, loc, attn):
    """(bound_ms, bound_by) of one MSDA call: the value rows its samples
    touch (`msda_touched`), loc and attn read once, its output written
    once; a multiply and an add a channel for each in-level corner."""
    N, Q, H = loc.shape[:3]
    D = v.shape[3]
    touched, corners = msda_touched(torch, v, shapes, loc)
    return least_time(touched + nbytes(loc, attn)
                      + N * Q * H * D * v.element_size(), corners * D * 2)


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
            got = msda.msda_cuda(v, shapes, loc, attn)
            want = msda.msda_plain(v, shapes, loc, attn)
            # B = 2 against two B = 1 calls on the same samples
            halves = torch.cat([msda.msda_cuda(v[i:i + 1].contiguous(),
                                               shapes,
                                               loc[i:i + 1].contiguous(),
                                               attn[i:i + 1].contiguous())
                                for i in range(2)])
            torch.cuda.synchronize()
            same_b1 = torch.equal(got[:2], halves)
            bitwise = torch.equal(got, want)
            got, want = got.float(), want.float()
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
                f"{want.abs().max().item():.3f}, within bound: {ok}, bitwise "
                f"equal {bitwise}; B=2 == two B=1 calls bitwise {same_b1}")
            if not ok:
                raise RuntimeError(f"msda kernel disagrees with plain "
                                   f"({name}, {dtype}): {err}")
            if not same_b1:
                raise RuntimeError(f"msda B=2 differs from two B=1 calls "
                                   f"({name}, {dtype})")
            if dtype == torch.float32 and not bitwise:
                raise RuntimeError(f"msda f32 is not bitwise equal to the "
                                   f"plain version ({name})")
            worst = max(worst, err)
            k, p = in_turns(torch, lambda: msda.msda_cuda(v, shapes, loc,
                                                          attn),
                            lambda: msda.msda_plain(v, shapes, loc, attn), 5)
            b_ms, by = msda_bound(torch, v, shapes, loc, attn)
            nb = (msda_touched(torch, v, shapes, loc)[0] + nbytes(loc, attn)
                  + got.numel() * v.element_size())
            log(f"  msda {name} {dtype}: kernel {k:.4f} ms, plain {p:.4f} "
                f"ms; compulsory {nb / 1e6:.1f} MB -> "
                f"{nb / k / 1e9:.3f} TB/s "
                f"({nb / k / 1e9 / HBM_TBS:.1%} of {HBM_TBS} TB/s); bound "
                f"{b_ms:.4f} ms ({by})")
            if dtype == torch.bfloat16:
                ms, plain_ms = ms + k, plain_ms + p
                bound_ms += b_ms
                bound_by.add(by)
    log(f"  msda per encoder layer (1 TSA + 1 SCA call, bf16, uniform "
        f"locations): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["msda"] = {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "+".join(sorted(bound_by)),
        "library_ms": None}


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


def msda_real(torch, pred, imgs, e2i, results):
    """The MSDA kernel on the inputs of a real request: the first encoder
    layer's TSA and SCA calls of one base_occ request are captured (value,
    loc, attn as the model makes them), then held to the plain version and
    timed."""
    from occnet_tpu_torch.models import attention
    from occnet_tpu_torch.ops import msda
    calls = []
    orig = attention.multi_scale_deformable_attention

    def capture(value, shapes, loc, attn):
        if len(calls) < 2:
            calls.append((value.clone(), list(shapes), loc.clone(),
                          attn.clone()))
        return orig(value, shapes, loc, attn)

    attention.multi_scale_deformable_attention = capture
    try:
        pred(imgs, e2i)
    finally:
        attention.multi_scale_deformable_attention = orig
    ms = bound_ms = 0.0
    for (v, shapes, loc, attn), name in zip(calls, ("TSA", "SCA")):
        got = msda.msda_cuda(v, shapes, loc, attn).float()
        want = msda.msda_plain(v, shapes, loc, attn).float()
        diff = (got - want).abs()
        ok = bool((diff <= MSDA_BF16_TOL + MSDA_BF16_TOL * want.abs()).all())
        inside = ((loc >= 0) & (loc <= 1)).all(-1).float().mean().item()
        log(f"  msda on a real request, layer 0 {name}: value "
            f"{tuple(v.shape)} {v.dtype}, loc {tuple(loc.shape)}, "
            f"{inside:.1%} of samples inside their level; max|kernel-plain|"
            f" = {diff.max().item():.3e}, within bound: {ok}")
        if not ok:
            raise RuntimeError(f"msda kernel disagrees with plain on a real "
                               f"request ({name})")
        k, _ = in_turns(torch, lambda: msda.msda_cuda(v, shapes, loc, attn),
                        lambda: msda.msda_plain(v, shapes, loc, attn), 5)
        b_ms, _ = msda_bound(torch, v, shapes, loc, attn)
        log(f"  msda real {name}: kernel {k:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_ms / k:.1%})")
        ms += k
        bound_ms += b_ms
    log(f"  msda per encoder layer on a real request: kernel {ms:.4f} ms")
    results["msda"].update(ms_real=ms, bound_ms_real=bound_ms)


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
    msda_real(torch, pred, reqs[-1], e2i, results)

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
# base_occ's SCA pyramid (h, w) for 900 x 1600 images, strides 8 to 64
SCA_LEVELS = [(116, 200), (58, 100), (29, 50), (15, 25)]


def phase_dcn_kernels(torch, results):
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops.dcn_window import window_overflow
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B = 6
    per_req = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    conv = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "pair_ms": 0.0,
            "matmul_ms": 0.0, "bytes_ms": 0.0}
    worst = conv_worst = 0.0
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
        x = x32.to(torch.bfloat16)
        del x32
        conv_worst = max(conv_worst, dcn_conv_checks(
            torch, dc, name, x, off, mask, stride, count, gen, conv))
        del x, off, mask
    log(f"  dcn sampling per request (26 launches, bf16): kernel "
        f"{per_req['ms']:.4f} ms, plain {per_req['plain_ms']:.4f} ms, bound "
        f"{per_req['bound_ms']:.4f} ms (bytes); kernel at "
        f"{per_req['bound_ms'] / per_req['ms']:.1%} of it")
    log(f"  fused dcn per request (26 launches, bf16): kernel "
        f"{conv['ms']:.4f} ms against sampling kernel + torch.matmul "
        f"{conv['pair_ms']:.4f} ms and torch.matmul of the same columns "
        f"alone {conv['matmul_ms']:.4f} ms; plain {conv['plain_ms']:.4f} "
        f"ms; bound {conv['bound_ms']:.4f} ms (operations (tensor cores); "
        f"bytes {conv['bytes_ms']:.4f}), kernel at "
        f"{conv['bound_ms'] / conv['ms']:.1%} of it; card {nvidia_smi()}")
    results["dcn"] = {"max_abs_err": worst, **per_req, "bound_by": "bytes",
                      "library_ms": None}
    results["dcn_conv"] = {
        "max_abs_err": conv_worst, "ms": conv["ms"],
        "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
        "bound_by": "operations (tensor cores)", "library_ms": None,
        "pair_ms": conv["pair_ms"], "matmul_ms": conv["matmul_ms"]}


def dcn_conv_checks(torch, dc, name, x, off, mask, stride, count, gen,
                    totals):
    """The fused DCN kernel on one DCN shape (bf16 x, a random (9C, C)
    weight): against `deform_conv_plain` on the card within DCN_CONV_RTOL
    of |y| plus DCN_CONV_ATOL x sum_k |cols W|; the window certificate at
    DCN_RADIUS (stride 1) equal to `window_overflow` card and CPU; two
    launches bitwise equal, and B = 6 bitwise equal to six B = 1 calls.
    Then timed in turns against the sampling kernel + torch.matmul and
    against the torch.matmul of the same columns alone; per-request sums
    (``count`` layers of this shape) added to ``totals``.  Returns
    max|kernel - plain|."""
    from occnet_tpu_torch.ops.dcn_window import window_overflow
    B, h, w, C = x.shape
    ho, wo = off.shape[1:3]
    wmat = (torch.randn(9 * C, C, generator=gen, device=x.device)
            / (9 * C) ** 0.5).to(torch.bfloat16)
    radius = DCN_RADIUS if stride == 1 else None
    y, cnt = dc.deform_conv_cuda(x, off, mask, wmat, stride, radius)
    y2, cnt2 = dc.deform_conv_cuda(x, off, mask, wmat, stride, radius)
    want, wcnt = dc.deform_conv_plain(x, off, mask, wmat, stride, radius)
    cols = dc.deform_sample_cuda(x, off, mask, stride)
    mag = torch.matmul(cols.float().abs(), wmat.float().abs()).view(
        B, ho, wo, C)
    yf, wf = y.float(), want.float()
    diff = (yf - wf).abs()
    bad = int((diff > DCN_CONV_RTOL * torch.maximum(yf.abs(), wf.abs())
               + DCN_CONV_ATOL * mag).sum())
    err = diff.max().item()
    fin = torch.isfinite(yf).all().item()
    same = torch.equal(y, y2) and (cnt is None or torch.equal(cnt, cnt2))
    ys, cs = [], 0
    for b in range(B):
        yb, cb = dc.deform_conv_cuda(x[b:b + 1].contiguous(),
                                     off[b:b + 1].contiguous(),
                                     mask[b:b + 1].contiguous(), wmat, stride,
                                     radius)
        ys.append(yb)
        cs += 0 if cb is None else int(cb)
    split = torch.equal(torch.cat(ys), y)
    counts = None
    if radius is not None:
        counts = (int(cnt), int(wcnt), int(window_overflow(
            off.cpu(), ho, wo, radius)), cs)
        split &= cs == counts[0]
    log(f"  fused dcn {name} y {tuple(y.shape)} bf16: max|kernel-plain| = "
        f"{err:.3e} ({bad} elements beyond {DCN_CONV_RTOL:.3g} |y| + "
        f"{DCN_CONV_ATOL:.3g} sum|cols W|), finite {fin}; certificate at "
        f"R={DCN_RADIUS} (kernel, card, CPU, six B=1 calls) {counts}; two "
        f"launches bitwise equal {same}; B=6 bitwise equal to six B=1 calls "
        f"{split}")
    if bad or not fin:
        raise RuntimeError(f"fused dcn kernel disagrees with plain ({name})")
    if counts is not None and len(set(counts)) != 1:
        raise RuntimeError(f"fused dcn certificate disagrees ({name})")
    if not (same and split):
        raise RuntimeError(f"fused dcn kernel is not deterministic ({name})")

    def pair():
        torch.matmul(dc.deform_sample_cuda(x, off, mask, stride), wmat)

    slot = None if radius is None else torch.zeros(
        1, dtype=torch.int32, device=x.device)

    def fused():
        dc.deform_conv_cuda(x, off, mask, wmat, stride, radius, slot)

    def matmul():
        torch.matmul(cols, wmat)

    p1 = cuda_ms(torch, pair, 5)
    k1 = cuda_ms(torch, fused, 5)
    m1 = cuda_ms(torch, matmul, 5)
    m2 = cuda_ms(torch, matmul, 5)
    k2 = cuda_ms(torch, fused, 5)
    p2 = cuda_ms(torch, pair, 5)
    pl = cuda_ms(torch, lambda: dc.deform_conv_plain(
        x, off, mask, wmat, stride), 1)
    k, pr, mm = (k1 + k2) / 2, (p1 + p2) / 2, (m1 + m2) / 2
    flops = 2.0 * cols.shape[0] * cols.shape[1] * cols.shape[2] * C
    b_ms, by = least_time(nbytes(x, off, mask, wmat, y), 0.0, flops)
    bytes_ms = least_time(nbytes(x, off, mask, wmat, y), 0.0)[0]
    log(f"    times ms: pair {p1:.4f}, fused {k1:.4f}, matmul {m1:.4f}, "
        f"matmul {m2:.4f}, fused {k2:.4f}, pair {p2:.4f}; plain {pl:.4f}; "
        f"{flops / 1e9:.2f} GFLOP, bound {b_ms:.4f} ms ({by}), fused at "
        f"{b_ms / k:.1%} of it ({flops / k / 1e9:.1f} TFLOP/s)")
    for key, t in (("ms", k), ("pair_ms", pr), ("matmul_ms", mm),
                   ("plain_ms", pl), ("bound_ms", b_ms),
                   ("bytes_ms", bytes_ms)):
        totals[key] += t * count
    return err


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


@contextlib.contextmanager
def frozen_bn_calibrated(torch, model):
    """Inside the block, every forward of ``model`` sets each FrozenBatchNorm's
    running statistics, in place and in forward order, to the batch
    statistics of its input: a random trunk's activations then have a
    pretrained trunk's unit scale.  (The JAX-style init's identity
    statistics let them grow with depth, and Adam's first steps, which move
    every weight by about the learning rate whatever its gradient, then move
    a DCN layer's offsets by pixels.)  Run the DCN offset calibration in the
    same forward, so that each layer is calibrated on inputs the layers
    before it already produce calibrated."""
    from occnet_tpu_torch.models.resnet import FrozenBatchNorm

    def set_stats(mod, inputs):
        xf = inputs[0].float()
        mod.running_mean.copy_(xf.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(xf.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if type(m) is FrozenBatchNorm]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def dcn_weights(torch, cfg, device, imgs, e2i, seed, randomize=False,
                max_px=DCN_MAX_PX, normalise_bn=False):
    """The JAX-style init of ``cfg`` (every leaf random-filled with
    ``randomize``), every DCN layer's conv_offset kernel drawn from
    ``seed`` (the init's zero kernel would sample only integer positions),
    then calibrated on these images (uint8, or float already normalised) so
    that no layer's |offset| exceeds ``max_px``: within the R = 3 window,
    fractions and both signs exercised; with ``normalise_bn`` the trunk's
    FrozenBN statistics are set from the images in the same forward
    (`frozen_bn_calibrated`).  Returns the model's state_dict (on the
    CPU)."""
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
    e2i = torch.from_numpy(e2i).to(device)
    with (frozen_bn_calibrated(torch, model) if normalise_bn
          else contextlib.nullcontext()):
        calibrate_dcn_offsets(model, x, e2i, max_px)
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
    """Returns the sampling kernel's launches over the two card requests
    (its main path since the bf16 layers run the fused kernel)."""
    from occnet_tpu_torch.ops.deform_conv import DEFORM, DEFORM_CONV
    from occnet_tpu_torch.serve import Predictor
    total = 0
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
        DEFORM.launches = DEFORM_CONV.launches = 0
        _, _, lg = pg(imgs, e2i, with_logits=True)
        launches, fused = DEFORM.launches, DEFORM_CONV.launches
        total += launches
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
            f"deform_sample / deform_conv launches on the card {launches} /"
            f" {fused}")
        if not (err <= LOGIT_ATOL and agree >= 0.99
                and torch.isfinite(lg).all().item()
                and pg.dcn_window_overflow == pc.dcn_window_overflow == 0
                and pg.sca_topk_overflow == pc.sca_topk_overflow
                and launches == 26 and fused == 0):
            raise RuntimeError(f"card and CPU disagree on tiny {name}")
    return total


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def plain_route(x, offset, mask, wmat, stride=1, radius=None, count=None):
    """A DCN layer as `deform_conv_plain` on the card (the fp32 product of
    the same columns, rounded once): the reference that bounds how far two
    valid bf16 routes drift apart through the trunk."""
    from occnet_tpu_torch.ops import deform_conv as dc
    y, over = dc.deform_conv_plain(x, offset, mask, wmat, stride, radius)
    return y, dc._added(over, count)


def argmax_agreement(torch, a, b, where=None):
    """Share of voxels (of ``where``) whose class argmax agrees."""
    same = a.float().argmax(-1) == b.float().argmax(-1)
    return (same if where is None else same[where]).float().mean().item()


def dcn_split(torch, pred, imgs, e2i):
    """One request with CUDA events at the trunk's bounds, each DCN layer's
    bounds, and around its kernels and certificate: returns ms of
    (request, trunk, {offset conv, fused DCN, sampling, matmul,
    certificate}).  The fused kernel counts the certificate itself, so
    there "certificate" is only the gap from its end to the layer's; on the
    two-step route it is `window_overflow` and the count's add."""
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

    hooks = [pred.model.backbone.register_forward_pre_hook(
        lambda *_: mark("trunk>")),
        pred.model.backbone.register_forward_hook(lambda *_: mark("trunk<"))]
    for mod in pred.model.backbone.modules():
        if isinstance(mod, dc.ModulatedDeformConv):
            hooks.append(mod.register_forward_pre_hook(
                lambda *_: mark("dcn>")))
            hooks.append(mod.register_forward_hook(lambda *_: mark("dcn<")))
    try:
        with patched(dc, "deform_conv_cuda", wrap(dc.deform_conv_cuda,
                                                  "conv")), \
                patched(dc, "deform_sample_cuda",
                        wrap(dc.deform_sample_cuda, "sample")), \
                patched(dc, "window_overflow", wrap(dc.window_overflow,
                                                    "cert")):
            torch.cuda.synchronize()
            mark("request>")
            pred(imgs, e2i)
            mark("request<")
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    t = {"offset conv": 0.0, "fused DCN": 0.0, "sampling": 0.0,
         "matmul": 0.0, "certificate": 0.0}
    key = {("dcn>", "conv>"): "offset conv", ("dcn>", "sample>"):
           "offset conv", ("conv>", "conv<"): "fused DCN",
           ("sample>", "sample<"): "sampling", ("sample<", "cert>"):
           "matmul", ("sample<", "dcn<"): "matmul", ("cert>", "cert<"):
           "certificate", ("cert<", "dcn<"): "certificate",
           ("conv<", "dcn<"): "certificate"}
    for (a, ea), (b, eb) in zip(marks, marks[1:]):
        if (a, b) in key:
            t[key[(a, b)]] += ea.elapsed_time(eb)
    ev = dict((label, e) for label, e in marks)
    return (ev["request>"].elapsed_time(ev["request<"]),
            ev["trunk>"].elapsed_time(ev["trunk<"]), t)


def log_split(label, split):
    req, trunk, t = split
    dcn = sum(t.values())
    log(f"  {label}, one request split by CUDA events: total {req:.3f} ms; "
        f"trunk {trunk:.3f} ms, of it the 26 DCN layers {dcn:.3f} ms (offset"
        f" conv {t['offset conv']:.3f}, fused DCN {t['fused DCN']:.3f}, "
        f"sampling kernel {t['sampling']:.3f}, matmul {t['matmul']:.3f}, "
        f"certificate {t['certificate']:.3f}) and the rest of the trunk "
        f"{trunk - dcn:.3f}; the rest of the request {req - trunk:.3f} ms")


def phase_serve_dcn(torch, name, results):
    """Returns the fused DCN kernel's launches over the timed requests."""
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.tools.profile_turbo import device_profile
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
    kernels = {"dcn_conv": dc.DEFORM_CONV, "dcn_sample": dc.DEFORM,
               **({"lift": LIFT, "tap": TAP} if dense else {"msda": MSDA})}
    if dense:
        want = {"dcn_conv": 26, "dcn_sample": 0, "lift": m.num_feature_levels,
                "tap": m.encoder.num_layers}
    else:
        ks = pred.model.head.transformer.encoder.layer0.cross_attn \
            .topk_sizes(m.bev_h * m.bev_w)
        want = {"dcn_conv": 26, "dcn_sample": 0, "msda": m.encoder.num_layers
                * (1 + (len(set(ks)) or 1))}
    cert_calls = [0]
    window_overflow = dc.window_overflow

    def counted(*a, **k):
        cert_calls[0] += 1
        return window_overflow(*a, **k)

    lat, ev_ms, total = [], [], {k: 0 for k in kernels}
    with patched(dc, "window_overflow", counted):
        for imgs in reqs[1:REQUESTS + 1]:
            for k in kernels.values():
                k.launches = 0
            cert_calls[0] = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            occ, flow, logits = pred(imgs, e2i, with_logits=True)
            end.record()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            ev_ms.append(start.elapsed_time(end))
            launches = {n: k.launches for n, k in kernels.items()}
            for n in launches:
                total[n] += launches[n]
            if launches != want or cert_calls[0]:
                raise RuntimeError(f"launch counts {launches} != {want}, or "
                                   f"{cert_calls[0]} window_overflow calls")
            if tuple(occ.shape) != (1, m.bev_w, m.bev_h, m.pillar_h) or \
                    tuple(flow.shape) != (1, m.bev_w, m.bev_h, m.pillar_h,
                                          2):
                raise RuntimeError(f"bad output shapes {occ.shape} "
                                   f"{flow.shape}")
            if not (torch.isfinite(logits).all()
                    and torch.isfinite(flow).all()):
                raise RuntimeError("non-finite logits or flow")
            certs = (pred.dcn_window_overflow, pred.sca_topk_overflow)
            if certs != ((0, None) if dense else (None, 0)):
                raise RuntimeError(f"certificates (dcn, sca) {certs}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {REQUESTS} requests: latency ms (host clock) "
        f"{[round(x, 3) for x in lat]}, mean {sum(lat) / len(lat):.3f}; "
        f"CUDA events on the stream from before the upload to after the "
        f"answer {[round(x, 3) for x in ev_ms]}; peak allocated "
        f"{peak:.3f} GiB; launches per request {want}, in all {total}; "
        f"window_overflow calls 0; dcn_window_overflow "
        f"{pred.dcn_window_overflow}, sca_topk_overflow "
        f"{pred.sca_topk_overflow}; card {nvidia_smi()}")
    log(f"  occ classes used {int(occ.unique().numel())}, logits range "
        f"[{logits.min().item():.3f}, {logits.max().item():.3f}]")
    # the last timed request again on the two-step route and on the plain
    # product (the fp32 matmul of the same columns, rounded once)
    with patched(dc, "deform_conv", dc.deform_conv_pair):
        _, _, old = pred(reqs[REQUESTS], e2i, with_logits=True)
    if pred.dcn_window_overflow not in (None, 0):
        raise RuntimeError("two-step route: nonzero DCN certificate")
    with patched(dc, "deform_conv", plain_route):
        _, _, ref = pred(reqs[REQUESTS], e2i, with_logits=True)
    err = (logits.float() - old.float()).abs().max().item()
    agree = argmax_agreement(torch, logits, old)
    floor = argmax_agreement(torch, old, ref)
    top2 = old.float().topk(2, -1).values
    untied = top2[..., 0] > top2[..., 1]
    agree_untied = argmax_agreement(torch, logits, old, untied)
    log(f"  the same request with every DCN layer on the two-step route "
        f"(sampling kernel + torch.matmul + window_overflow): max|logits "
        f"fused - two-step| = {err:.3e} (atol {LOGIT_ATOL}); argmax "
        f"agreement {agree:.5f} of all voxels, {agree_untied:.5f} of the "
        f"{untied.float().mean().item():.4f} whose two-step top two logits "
        f"are not tied in bf16 (ARGMAX_AGREE); the two-step route against "
        f"the plain product, the bf16 noise floor: {floor:.5f} of all "
        f"voxels")
    if not (err <= LOGIT_ATOL and agree_untied >= ARGMAX_AGREE
            and agree >= floor - ARGMAX_FLOOR_SLACK):
        raise RuntimeError("fused DCN request disagrees with the two-step "
                           "route")
    prof = device_profile(lambda: pred(reqs[-1], e2i))
    log(f"  one more request under torch.profiler: device kernels and "
        f"copies {prof['kernel_ms']:.3f} ms summed, card busy "
        f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span")
    log_split("fused DCN", dcn_split(torch, pred, reqs[-1], e2i))
    with patched(dc, "deform_conv", dc.deform_conv_pair):
        log_split("two-step route", dcn_split(torch, pred, reqs[-1], e2i))
    return total["dcn_conv"]


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
    from occnet_tpu_torch.evaluation.ray_metrics import (FAN_TABLES,
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

    # per-ray DDA: one full-width synthetic scene through the ring rig,
    # the render epilogue (the scene's views, one launch) and the raw one
    # (dist, coord, hit of the same rays, one launch)
    m = cfg.model
    occ_size = tuple(cfg.data.occ_size)
    hw = (m.img_h, m.img_w)
    sem, _ = syn.make_scene(0, occ_size)
    rig = syn.ring_camera_rig(m.num_cams, hw)
    vs = (m.pc_range[3] - m.pc_range[0]) / occ_size[0]
    steps = sum(occ_size) + 4
    tables = syn.scene_tables(rig["R"], rig["t"], rig["K"],
                              syn.class_palette(), hw, m.pc_range, vs, dev)
    labels = syn.class_ids_u8(sem, len(syn.class_palette())).to(dev)
    rargs = (labels, tables, syn.FREE_ID, steps)
    views = rm.render_views_cuda(*rargs)
    again = rm.render_views_cuda(*rargs)
    want = rm.render_views_plain(*rargs)
    torch.cuda.synchronize()
    differ = (views != want).any(-1).float().mean().item()
    view_err = (views.int() - want.int()).abs().max().item()
    log(f"  render {tuple(views.shape)} uint8, grid {occ_size}, {steps} "
        f"steps: share of pixels differing from the plain version "
        f"{differ:.3e} (tol {PIXEL_MISMATCH}), max |d| {view_err}, bitwise "
        f"{torch.equal(views, want)}; two launches bitwise equal "
        f"{torch.equal(views, again)}")
    if differ > PIXEL_MISMATCH or not torch.equal(views, again):
        raise RuntimeError("render kernel disagrees with its plain version")
    del again, want
    k = [cuda_ms(torch, lambda: rm.render_views_cuda(*rargs), 20)]
    pl = [cuda_ms(torch, lambda: rm.render_views_plain(*rargs), 1)]
    pl.append(cuda_ms(torch, lambda: rm.render_views_plain(*rargs), 1))
    k.append(cuda_ms(torch, lambda: rm.render_views_cuda(*rargs), 20))
    log(f"    times ms: kernel {k[0]:.4f}, plain {pl[0]:.4f}, plain "
        f"{pl[1]:.4f}, kernel {k[1]:.4f}")
    dirs, o_vox = syn.camera_rays(rig["R"], rig["t"], rig["K"], hw,
                                  m.pc_range, vs, dev)
    R = dirs.shape[1]
    origins = [torch.from_numpy(o).to(dev)[None].expand(R, 3) for o in o_vox]
    occ = torch.from_numpy(sem != syn.FREE_ID).to(dev)

    def scene(fn):
        return lambda: [fn(occ, o, d, steps) for o, d in zip(origins, dirs)]

    got, want = scene(rm.dda_raymarch_cuda)(), scene(rm.dda_raymarch_plain)()
    err = max(compare_marches(torch, f"dda camera {c}", g, w)
              for c, (g, w) in enumerate(zip(got, want)))
    raw_k = cuda_ms(torch, scene(rm.dda_raymarch_cuda), 10)
    # steps this run's rays take: the voxels between start and end, + 1
    n_steps = sum(int(((c - torch.floor(o).int()).abs().sum(1) + 1).sum())
                  for (_, c, _), o in zip(got, origins))
    ops = n_steps * DDA_OPS_PER_STEP
    # each epilogue's own traffic: the render reads the scene tables and the
    # uint8 grid and writes the views; the raw one reads the directions and
    # the occupancy and writes dist, coord and hit
    tab = nbytes(*(getattr(tables, f) for f in ("rot", "origin", "u", "v",
                                                "tex", "sky", "palette")))
    b_ms, by = least_time(tab + labels.numel() + views.numel(), ops)
    raw_b, raw_by = least_time(
        nbytes(dirs) + occ.numel() + R * m.num_cams * (4 + 12 + 1), ops)
    k_ms, pl_ms = sum(k) / 2, sum(pl) / 2
    log(f"  dda scene {m.num_cams} x {m.img_h} x {m.img_w} rays, grid "
        f"{occ_size}, {steps} steps, {n_steps / (R * m.num_cams):.1f} steps "
        f"a ray: render kernel {k_ms:.4f} ms (one launch: directions, "
        f"march, shading), plain {pl_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
        f"tables and grid in, views out), render kernel at "
        f"{b_ms / k_ms:.1%} of it; raw epilogue {raw_k:.4f} ms (6 "
        f"launches), bound {raw_b:.4f} ms ({raw_by}; rays in, dist / coord "
        f"/ hit out), at {raw_b / raw_k:.1%} of it")
    results["ray_march_dda"] = {"max_abs_err": max(err, view_err),
                                "ms": k_ms, "plain_ms": pl_ms,
                                "bound_ms": b_ms, "bound_by": by,
                                "library_ms": None, "raw_ms": raw_k,
                                "raw_bound_ms": raw_b}
    del got, want, dirs, origins, views
    torch.cuda.empty_cache()

    # fan DDA at the eval shape: prediction and GT grids, 8 origins; the
    # raw epilogue on packed occupancy, the render epilogue on the labels
    # and flows as the eval loop hands them over (int64 prediction, bf16
    # flow; int32 GT, fp32 flow)
    rng = np.random.RandomState(12)
    gt, gt_flow = syn.make_scene(1, occ_size)
    pred = gt.copy()
    flip = rng.rand(*occ_size) < 0.01
    pred[flip] = rng.randint(0, syn.FREE_ID + 1, int(flip.sum()))
    occs = torch.from_numpy(np.stack([pred, gt]) != syn.FREE_ID).to(dev)
    o_m = np.concatenate([rng.uniform(-30, 30, (8, 2)),
                          rng.uniform(0.5, 2.5, (8, 1))], 1).astype(
        np.float32)
    o_vox = (o_m - np.asarray(m.pc_range[:3], np.float32)) / np.float32(vs)
    fan = FAN_TABLES(generate_lidar_rays(), 360, dev)
    fargs = (occs, torch.from_numpy(o_vox).to(dev), *fan)
    got = rv.dda_raymarch_fan_vec_cuda(*fargs)
    want = rv.dda_raymarch_fan_vec_plain(*fargs)
    err = compare_marches(torch, f"fan raw {tuple(got[0].shape)}", got, want)
    raw_k = cuda_ms(torch, lambda: rv.dda_raymarch_fan_vec_cuda(*fargs), 10)
    v0 = torch.floor(fargs[1][:, :2]).int()[None, :, None, None]
    crossings = int(((got[1][..., :2] - v0).abs().sum(-1) + 1).sum())
    ops = crossings * FAN_OPS_PER_CROSSING
    raw_b, raw_by = least_time(
        nbytes(fargs[1], *fan) + occs.shape[0] * occ_size[0] * occ_size[1]
        * 4 + got[0].numel() * (4 + 12 + 1), ops)
    n_rays = got[0].numel()
    del got, want
    sems = [torch.from_numpy(pred.astype(np.int64)).to(dev),
            torch.from_numpy(gt).to(dev)]
    flows = [torch.from_numpy(gt_flow + 0.1 * rng.randn(*gt_flow.shape)).to(
        dev, torch.bfloat16), torch.from_numpy(gt_flow).to(dev)]
    rfa = (fargs[1], *fan, cfg.eval.voxel_size, syn.FREE_ID)
    got = rv.fan_render_cuda(sems, flows, *rfa)
    again = rv.fan_render_cuda(sems, flows, *rfa)
    want = rv.fan_render_plain(sems, flows, *rfa)
    ones = [rv.fan_render_cuda([s], [f], *rfa) for s, f in zip(sems, flows)]
    torch.cuda.synchronize()
    same = {k: torch.equal(got[k], want[k]) for k in ("label", "flow")}
    d_err = (got["dist"] - want["dist"]).abs().max().item()
    d_rel = ((got["dist"] - want["dist"]).abs()
             / want["dist"].abs().clamp(min=1e-6)).max().item()
    twice = all(torch.equal(got[k], again[k]) for k in got)
    split = all(torch.equal(got[k], torch.cat([o[k] for o in ones]))
                for k in got)
    log(f"  fan render {tuple(got['dist'].shape)}: label, flow bitwise "
        f"equal to the plain version {same}; dist max |d| {d_err:.3e}, max "
        f"rel {d_rel:.3e} (tol {DIST_RTOL}), bitwise "
        f"{torch.equal(got['dist'], want['dist'])}; two launches bitwise "
        f"{twice}; G = 2 equal to two G = 1 calls {split}")
    if not (all(same.values()) and d_rel <= DIST_RTOL and twice and split):
        raise RuntimeError("fan render kernel disagrees with its plain "
                           "version")
    k, pl = in_turns(torch, lambda: rv.fan_render_cuda(sems, flows, *rfa),
                     lambda: rv.fan_render_plain(sems, flows, *rfa), 5)
    # the render's own traffic: origins and fan tables in, the label and
    # flow of each ray's end voxel, dist / label / flow out (the labels of
    # the columns walked, which depend on the walk, are left out)
    ends = sum(n_rays // len(sems) * (s.element_size() + 2 * f.element_size())
               for s, f in zip(sems, flows))
    b_ms, by = least_time(nbytes(fargs[1], *fan, got["dist"], got["label"],
                                 got["flow"]) + ends, ops)
    log(f"  fan: {crossings / n_rays:.1f} crossings a ray; render kernel "
        f"{k:.4f} ms (one launch: prediction and GT, pitch-major dist / "
        f"label / flow), plain {pl:.4f} ms, bound {b_ms:.4f} ms ({by}), "
        f"render kernel at {b_ms / k:.1%} of it; raw epilogue {raw_k:.4f} "
        f"ms, bound {raw_b:.4f} ms ({raw_by}), at {raw_b / raw_k:.1%} of it")
    results["ray_march_fan"] = {"max_abs_err": max(err, d_err), "ms": k,
                                "plain_ms": pl, "bound_ms": b_ms,
                                "bound_by": by, "library_ms": None,
                                "raw_ms": raw_k, "raw_bound_ms": raw_b}
    del got, again, want, ones, sems, flows, occs

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
    from occnet_tpu_torch.evaluation.ray_metrics import FAN_TABLES
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.ray_march import DDA, RENDER
    from occnet_tpu_torch.ops.ray_march_vec import FAN, FAN_RENDER
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.tools import train as cli
    from occnet_tpu_torch.training import eval_loop
    cfg = turbo_occ()
    RENDER.launches = DDA.launches = 0
    ds = SyntheticOccDataset(cfg.data, cfg.model, 2, seed=0, training=False,
                             device_normalize=True)
    per_scene = RENDER.launches / len(ds)
    iou = gt_ray_iou(torch, cfg, ds.get_sample(0), "cuda")
    log(f"  2 val scenes at {cfg.model.img_h} x {cfg.model.img_w} x "
        f"{cfg.model.num_cams}, grid {tuple(cfg.data.occ_size)}: render ms "
        f"{[round(x, 3) for x in ds.render_ms]} (the first builds nothing: "
        f"the library is loaded), {per_scene:.0f} render launches a scene "
        f"(raw DDA {DDA.launches}); GT-vs-GT RayIoU {iou}")
    if per_scene != 1 or DDA.launches or iou != 1.0:
        raise RuntimeError("val scene rendering or GT-vs-GT RayIoU wrong")
    del ds

    kernels = {"lift": LIFT, "tap": TAP, "fan": FAN_RENDER, "fan_raw": FAN}
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
    RENDER.launches = DDA.launches = FAN_RENDER.launches = FAN.launches = 0
    FAN_TABLES.clear()
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
            "tap": cfg.model.encoder.num_layers, "fan": 1, "fan_raw": 0}
    mean = {k: float(np.mean([f[k] for f in frames]))
            for k in ("forward", "render", "counts")}
    log(f"  train CLI: {len(steps)} steps, losses "
        f"{[round(h['loss'], 4) for h in steps]}; {wall:.1f} s in all; "
        f"peak allocated {peak:.3f} GiB; render launches {RENDER.launches} "
        f"(12 scenes; raw DDA {DDA.launches}), fan render launches "
        f"{FAN_RENDER.launches} (raw {FAN.launches}), fan tables built "
        f"{FAN_TABLES.builds} time(s); card {nvidia_smi()}")
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
    if any(f["launches"] != want for f in frames) \
            or RENDER.launches != 12 or DDA.launches or FAN_TABLES.builds != 1:
        raise RuntimeError("eval launch counts are wrong")
    results["ray_march_dda"]["launches"] = RENDER.launches
    results["ray_march_fan"]["launches"] = FAN_RENDER.launches


def grads_held(torch, label, got, want, tol, names):
    """Each pair of gradients finite and within tol x max|want|; returns the
    largest max|got - want|."""
    worst = 0.0
    parts = []
    for n, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        parts.append(f"{n} {err:.3e} of max {scale:.3e}")
        if not (torch.isfinite(a).all().item() and err <= tol * scale):
            raise RuntimeError(f"{label}: {n} kernel disagrees with plain "
                               f"({err} > {tol} x {scale})")
        worst = max(worst, err)
    log(f"  {label}: max|kernel-plain| " + ", ".join(parts)
        + f" (tol {tol} x max|plain|)")
    return worst


def turns(torch, fns, reps):
    """Each callable of ``fns`` (label -> fn) timed by CUDA events in the
    order a, b, ..., b, a on one card; returns label -> mean ms."""
    order = list(fns) + list(fns)[::-1]
    times = [(k, cuda_ms(torch, fns[k], reps)) for k in order]
    log("    times ms: " + ", ".join(f"{k} {t:.4f}" for k, t in times))
    return {k: sum(t for j, t in times if j == k) / 2 for k in fns}


def bwd_times(torch, kernel, plain, reps, args):
    """``kernel(*args)`` timed, in turns with ``plain(*args)`` when it is
    given; returns label -> ms."""
    fns = {"kernel": kernel}
    if plain is not None:
        fns["plain"] = plain
    return turns(torch, {k: (lambda f=f: f(*args)) for k, f in fns.items()},
                 reps)


def held_twice(torch, label, fn, plain, args, tol, names, exact):
    """fn(*args) twice against plain(*args): every gradient within tol x
    max|plain| (`grads_held`), the ``exact`` ones (indices) bitwise equal
    over the two launches; returns the worst max|kernel - plain|."""
    got, again, want = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    worst = grads_held(torch, label, got, want, tol, names)
    same = all(torch.equal(got[i], again[i]) for i in exact)
    rerun = [f"{names[i]} "
             f"{(got[i].float() - again[i].float()).abs().max().item():.3e}"
             for i in range(len(got)) if i not in exact and got[i] is not None]
    log(f"    two launches: {', '.join(names[i] for i in exact)} bitwise "
        f"equal {same}; max|diff| {', '.join(rerun)} (fp32 atomics)")
    if not same:
        raise RuntimeError(f"{label}: one-writer gradients differ between "
                           f"two launches")
    return worst


def batch_split_held(torch, label, fn, args, tol, names, exact):
    """fn at B = 2 against two B = 1 calls on the same inputs (the tensors
    of ``args`` sliced along their batch dimension): the ``exact`` outputs
    bitwise equal, the others within tol x max|B = 2 result|."""
    def part(i, j):
        return [a[i:j] if isinstance(a, torch.Tensor) else a for a in args]

    both = fn(*part(0, 2))
    ones = [fn(*part(i, i + 1)) for i in range(2)]
    torch.cuda.synchronize()
    parts = []
    for k, n in enumerate(names):
        if both[k] is None:
            continue
        cat = torch.cat([o[k] for o in ones])
        if k in exact:
            ok = torch.equal(both[k], cat)
            parts.append(f"{n} bitwise {ok}")
        else:
            err = (both[k].float() - cat.float()).abs().max().item()
            scale = both[k].float().abs().max().item()
            ok = err <= tol * scale
            parts.append(f"{n} max|diff| {err:.3e} of {scale:.3e}")
        if not ok:
            raise RuntimeError(f"{label}: B = 2 differs from two B = 1 "
                               f"calls in {n}")
    log("    B=2 against two B=1 calls: " + ", ".join(parts))


def msda_levels(v, shapes, loc, attn, g):
    """Each level of an MSDA call alone, as an L = 1 call on the level's
    value rows: [(label, args)], contiguous."""
    out, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        out.append((f"level {lvl} {h}x{w}", (
            v[:, start:start + h * w].contiguous(), [(h, w)],
            loc[:, :, :, lvl:lvl + 1].contiguous(),
            attn[:, :, :, lvl:lvl + 1].contiguous(), g)))
        start += h * w
    return out


def msda_bwd_split(torch, label, v, shapes, loc, attn, g, reps=5):
    """Step 0's split: the kernel timed on each level alone."""
    from occnet_tpu_torch.ops import msda
    for lvl, args in msda_levels(v, shapes, loc, attn, g):
        log(f"  msda_bwd {label} {lvl} alone (L = 1):")
        bwd_times(torch, msda.msda_backward_cuda, None, reps, args)


def report_times(label, t, nb):
    """One line: the times of `bwd_times` beside the bound of ``nb``
    compulsory bytes; returns the bound in ms."""
    b_ms, by = least_time(nb, 0.0)
    log(f"  {label}: kernel {t['kernel']:.4f} ms"
        + (f", plain {t['plain']:.4f} ms" if "plain" in t else "")
        + f"; compulsory {nb / 1e6:.1f} MB, bound {b_ms:.4f} ms ({by}), "
        f"kernel at {b_ms / t['kernel']:.1%} of it")
    return b_ms


def msda_bwd_case(torch, label, v, shapes, loc, attn, g, tol, plain=True,
                  batch_split=False, reps=3):
    """One msda_bwd case: held to the plain version, dloc and dattn bitwise
    over two launches (and at B = 2 against two B = 1 calls), then timed in
    turns with the plain version; returns (worst error, times, bound ms)."""
    from occnet_tpu_torch.ops import msda
    args = (v, shapes, loc, attn, g)
    names = ("dvalue", "dloc", "dattn")
    worst = held_twice(torch, label, msda.msda_backward_cuda,
                       msda.msda_backward_plain, args, tol, names, (1, 2))
    if batch_split:
        batch_split_held(torch, label, msda.msda_backward_cuda, args, tol,
                         names, (1, 2))
    t = bwd_times(torch, msda.msda_backward_cuda,
                  msda.msda_backward_plain if plain else None, reps, args)
    # the value rows the samples touch, loc, attn, grad read once; dvalue,
    # dloc, dattn written once
    nb = msda_touched(torch, v, shapes, loc)[0] + nbytes(loc, attn, g, v,
                                                         loc, attn)
    return worst, t, report_times(label, t, nb)


def msda_draw(torch, gen, N, Q, H, D, shapes, P):
    """value, loc in [-0.2, 1.2], softmaxed attn and an output gradient
    (fp32) of one MSDA call, from ``gen``."""
    dev = torch.device("cuda")
    L, V = len(shapes), sum(h * w for h, w in shapes)
    v32 = torch.randn(N, V, H, D, generator=gen, device=dev)
    loc = torch.rand(N, Q, H, L, P, 2, generator=gen, device=dev) * 1.4 - 0.2
    attn = torch.softmax(torch.randn(N, Q, H, L * P, generator=gen,
                                     device=dev), -1
                         ).reshape(N, Q, H, L, P).contiguous()
    g32 = torch.randn(N, Q, H * D, generator=gen, device=dev)
    return v32, loc, attn, g32


def hot_rows(torch, loc, gen, rows=(5, 8), of=15):
    """``loc`` with every sample of camera 0, head 0 inside rows
    [rows[0], rows[1]] of a level of ``of`` rows (y in [5, 8): the corners
    take rows 5-8 of level 3) and anywhere along x."""
    hot = loc.clone()
    sel = hot[0, :, 0]
    y = rows[0] + (rows[1] - rows[0]) * torch.rand(
        sel[..., 1].shape, generator=gen, device=loc.device)
    sel[..., 1] = (y + 0.5) / of
    sel[..., 0] = torch.rand(sel[..., 0].shape, generator=gen,
                             device=loc.device)
    return hot


def phase_msda_bwd_kernels(torch, cfg, results):
    """occ_msda_bwd against msda_backward_plain at base_occ's SCA and TSA
    shapes, bf16 and f32 values, locations in [-0.2, 1.2] (border samples),
    random output gradients: every gradient within the tolerance, dloc and
    dattn bitwise equal over two launches and at B = 2 against two B = 1
    calls (dvalue within the tolerance); each timed in turns against the
    plain version, and in bf16 each SCA level alone (step 0's split); then
    the hot-row case: every sample of camera 0, head 0 inside 4 rows of
    level 3."""
    m = cfg.model
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(12)
    sca, tsa = m.encoder.sca, m.encoder.tsa
    D = m.embed_dims // sca.num_heads
    cases = [("SCA", m.num_cams, sca.max_queries_per_cam, sca.num_heads,
              SCA_LEVELS, sca.num_points),
             ("TSA", tsa.num_bev_queue, m.bev_h * m.bev_w, tsa.num_heads,
              [(m.bev_h, m.bev_w)], tsa.num_points)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    worst = 0.0
    for name, N, Q, H, shapes, P in cases:
        v32, loc, attn, g32 = msda_draw(torch, gen, N, Q, H, D, shapes, P)
        for dtype in (torch.bfloat16, torch.float32):
            v, g = v32.to(dtype), g32.to(dtype)
            tol = BWD_BF16_TOL if dtype == torch.bfloat16 else BWD_F32_TOL
            label = (f"msda_bwd {name} value {tuple(v.shape)} {dtype}, "
                     f"Q={Q}, L={len(shapes)}, P={P}")
            err, t, b_ms = msda_bwd_case(torch, label, v, shapes, loc, attn,
                                         g, tol, batch_split=True)
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                tot["ms"] += t["kernel"]
                tot["plain_ms"] += t["plain"]
                tot["bound_ms"] += b_ms
                if len(shapes) > 1:
                    msda_bwd_split(torch, name, v, shapes, loc, attn, g)
            del v, g
        if name == "SCA":
            hot = hot_rows(torch, loc, gen)
            for dtype in (torch.bfloat16, torch.float32):
                v, g = v32.to(dtype), g32.to(dtype)
                tol = BWD_BF16_TOL if dtype == torch.bfloat16 \
                    else BWD_F32_TOL
                err, _, _ = msda_bwd_case(
                    torch, f"msda_bwd SCA, camera 0 head 0 in rows 5-8 of "
                    f"level 3, {dtype}", v, shapes, hot, attn, g, tol,
                    plain=False)
                worst = max(worst, err)
                del v, g
            del hot
        del v32, loc, attn, g32
    log(f"  msda_bwd per encoder layer (1 TSA + 1 SCA call, bf16): kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; card {nvidia_smi()}")
    results["msda_bwd"] = {"max_abs_err": worst, **tot, "bound_by": "bytes",
                           "library_ms": None}


def dcn_draw(torch, gen, B, h, w, C, stride, calibrated):
    """x, offsets, mask U(0, 1) and a columns gradient (fp32) of one DCN
    layer: phase 12's offsets (N(0, 2^2) px, 1 % at +/-30 px) or, with
    ``calibrated``, U(-DCN_TRAIN_MAX_PX, DCN_TRAIN_MAX_PX) px."""
    from occnet_tpu_torch.ops import deform_conv as dc
    dev = torch.device("cuda")
    ho, wo = dc.out_size(h, w, stride)
    x32 = torch.randn(B, h, w, C, generator=gen, device=dev)
    if calibrated:
        off = (torch.rand(B, ho, wo, 9, 2, generator=gen, device=dev) * 2
               - 1) * DCN_TRAIN_MAX_PX
    else:
        off = torch.randn(B, ho, wo, 9, 2, generator=gen, device=dev) * 2.0
        far = torch.rand(B, ho, wo, 9, 2, generator=gen, device=dev) < 0.01
        off = torch.where(far, torch.sign(off) * 30.0, off).contiguous()
    mask = torch.rand(B, ho, wo, 9, generator=gen, device=dev)
    g32 = torch.randn(B, ho * wo, 9 * C, generator=gen, device=dev)
    return x32, off, mask, g32


def dcn_bwd_case(torch, label, x, off, mask, g, stride, tol, plain=True,
                 batch_split=False):
    """One dcn_bwd case: held to the plain version, doffset and dmask
    bitwise over two launches (and at B = 2 against two B = 1 calls, and
    a need_dx=False launch skipping dx with the same doffset and dmask);
    then timed in turns with the plain version; the share of samples that
    took the kernel's scatter logged; returns (worst error, times, bound
    ms)."""
    from occnet_tpu_torch.ops import deform_conv as dc
    args = (x, off, mask, g, stride)
    names = ("dx", "doffset", "dmask")
    B, h, w, C = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    far = dc.backward_far_share(off, h, w, C, stride, sms)
    log(f"    {far:.4%} of the samples scattered (far path; the rest "
        f"gathered)")
    worst = held_twice(torch, label, dc.deform_sample_backward_cuda,
                       dc.deform_sample_backward_plain, args, tol, names,
                       (1, 2))
    if batch_split:
        batch_split_held(torch, label, dc.deform_sample_backward_cuda, args,
                         tol, names, (1, 2))
        full = dc.deform_sample_backward_cuda(*args)
        nodx = dc.deform_sample_backward_cuda(*args, need_dx=False)
        if nodx[0] is not None or not (torch.equal(full[1], nodx[1])
                                       and torch.equal(full[2], nodx[2])):
            raise RuntimeError(f"{label}: need_dx=False did not skip dx "
                               f"alone")
        log("    need_dx=False: dx None, doffset and dmask bitwise equal")
        del full, nodx
    t = bwd_times(torch, dc.deform_sample_backward_cuda,
                  dc.deform_sample_backward_plain if plain else None, 3, args)
    # x, offsets, mask, dcols read once; dx, doffset, dmask written once
    nb = nbytes(x, off, mask, g, x, off, mask)
    return worst, t, report_times(label, t, nb)


def phase_dcn_bwd_kernels(torch, results):
    """occ_deform_sample_bwd against deform_sample_backward_plain at the
    four DCN shapes of R101-DCN (B = 6; stride 1 and the two stride-2 stage
    entries): bf16 and f32 at phase 12's offsets, bf16 at calibrated
    offsets (|offset| <= DCN_TRAIN_MAX_PX); the checks of `dcn_bwd_case`
    and its timing (step 0's per-shape split), summed per train step."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(13)
    B = 6
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    cal = {"ms": 0.0}
    worst = 0.0
    for name, h, w, C, stride, count in DCN_SHAPES:
        for calibrated in (False, True):
            x32, off, mask, g32 = dcn_draw(torch, gen, B, h, w, C, stride,
                                           calibrated)
            draw = "calibrated" if calibrated else "phase 12's"
            for dtype in ((torch.bfloat16,) if calibrated
                          else (torch.bfloat16, torch.float32)):
                x, g = x32.to(dtype), g32.to(dtype)
                tol = BWD_BF16_TOL if dtype == torch.bfloat16 \
                    else BWD_F32_TOL
                label = (f"dcn_bwd {name} x {tuple(x.shape)} {dtype} stride "
                         f"{stride}, {draw} offsets")
                err, t, b_ms = dcn_bwd_case(
                    torch, label, x, off, mask, g, stride, tol,
                    plain=not calibrated, batch_split=not calibrated)
                worst = max(worst, err)
                if dtype == torch.bfloat16:
                    acc = cal if calibrated else tot
                    acc["ms"] += t["kernel"] * count
                    if not calibrated:
                        tot["plain_ms"] += t["plain"] * count
                        tot["bound_ms"] += b_ms * count
                del x, g
            del x32, off, mask, g32
    log(f"  dcn_bwd per train step (26 launches, bf16), phase 12's offsets: "
        f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; calibrated offsets: kernel "
        f"{cal['ms']:.4f} ms; card {nvidia_smi()}")
    results["dcn_bwd"] = {"max_abs_err": worst, **tot, "bound_by": "bytes",
                          "library_ms": None, "ms_calibrated": cal["ms"]}


@contextlib.contextmanager
def captured_backward(store, keys):
    """Inside the block the MSDA and DCN sampling backward wrappers record
    into ``store`` the inputs (references, no copies) of the calls named in
    ``keys``: "SCA" and "TSA" keep the last MSDA call with L > 1 and L = 1,
    the first encoder layer's (the backward runs the layers in reverse),
    "layer3_1" the last stride-1 C = 256 DCN call."""
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops import msda
    orig_m, orig_d = msda.msda_backward_cuda, dc.deform_sample_backward_cuda

    def m(value, shapes, loc, attn, grad):
        key = "SCA" if len(shapes) > 1 else "TSA"
        if key in keys:
            store[key] = (value, list(shapes), loc, attn, grad)
        return orig_m(value, shapes, loc, attn, grad)

    def d(x, offset, mask, dcols, stride=1, need_dx=True):
        if "layer3_1" in keys and stride == 1 and x.shape[-1] == 256:
            store["layer3_1"] = (x, offset, mask, dcols, stride)
        return orig_d(x, offset, mask, dcols, stride, need_dx)

    msda.msda_backward_cuda, dc.deform_sample_backward_cuda = m, d
    try:
        yield
    finally:
        msda.msda_backward_cuda = orig_m
        dc.deform_sample_backward_cuda = orig_d


def bwd_real(torch, name, store, results):
    """The backward kernels on a real train step's inputs captured by
    `captured_backward`: a base_occ step's first encoder layer (SCA and TSA,
    SCA also level by level) and an R101-DCN step's layer3_1, each held to
    its plain version, the one-writer gradients bitwise over two launches,
    timed in turns with the plain version; r101_dcn_occ's layer3_1 time
    goes into the kernels line."""
    from occnet_tpu_torch.ops.dcn_window import needed_radius
    if "SCA" in store:
        for key in ("SCA", "TSA"):
            v, shapes, loc, attn, g = store[key]
            inside = ((loc >= 0) & (loc <= 1)).all(-1).float().mean().item()
            label = (f"msda_bwd on a real {name} step, layer 0 {key}: value "
                     f"{tuple(v.shape)} {v.dtype}, loc {tuple(loc.shape)}, "
                     f"{inside:.1%} of samples inside their level")
            _, t, b_ms = msda_bwd_case(torch, label, v, shapes, loc, attn, g,
                                       BWD_BF16_TOL)
            r = results.setdefault("msda_bwd", {})
            r["ms_real"] = r.get("ms_real", 0.0) + t["kernel"]
            if len(shapes) > 1:
                msda_bwd_split(torch, f"real {key}", v, shapes, loc, attn, g)
    if "layer3_1" in store:
        x, off, mask, g, stride = store["layer3_1"]
        ho, wo = off.shape[1:3]
        label = (f"dcn_bwd on a real {name} step, layer3_1: x "
                 f"{tuple(x.shape)} {x.dtype}, max|offset| "
                 f"{off.abs().max().item():.3f} px, needed radius "
                 f"{int(needed_radius(off, ho, wo))}")
        _, t, _ = dcn_bwd_case(torch, label, x, off, mask, g, stride,
                               BWD_BF16_TOL)
        if name == "r101_dcn_occ":
            results.setdefault("dcn_bwd", {})["ms_real_layer3_1"] = \
                t["kernel"]


def train_step_parity(torch, label, cfg, sd, batch, trunk_l2=False,
                      make_step=None, l2_leaves=()):
    """One train step of ``cfg`` from the state_dict ``sd`` on ``batch``
    (numpy) on the card and on the CPU: loss within 1e-3 relative, every
    gradient within GRAD_RTOL x max|g| per leaf (with ``trunk_l2`` the
    trunk's leaves, and the leaves named in ``l2_leaves``, within
    TRUNK_L2_RTOL in L2 instead), BN statistics within 1e-3, certificate 0
    on both.  ``make_step`` builds the step (default
    `training.train.make_train_step`)."""
    from occnet_tpu_torch.tools.train import to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(cfg, sd, dev)
        metrics = (make_step or make_train_step)(cfg)(state,
                                                     to_device(batch, dev))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in state.model.named_parameters()
                 if p.grad is not None}
        stats = {n: b.detach().cpu() for n, b in state.model.named_buffers()}
        runs[dev] = (float(metrics["loss"]), grads, stats,
                     int(metrics["cert_overflow"]))
    (lg, gg, sg, cg), (lc, gc, sc, cc) = runs["cuda"], runs["cpu"]
    if gg.keys() != gc.keys():
        raise RuntimeError(f"{label}: card and CPU differ in which leaves "
                           f"get grads")
    worst, worst_name, worst_l2, l2_name = 0.0, "", 0.0, ""
    for n in gc:
        if (trunk_l2 and n.startswith("backbone.")) or n in l2_leaves:
            rel = (gg[n] - gc[n]).norm().item() / max(gc[n].norm().item(),
                                                      1e-30)
            if rel > worst_l2:
                worst_l2, l2_name = rel, n
            continue
        scale = max(gc[n].abs().max().item(), 1e-12)
        rel = (gg[n] - gc[n]).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, n
    stat_err = max([(sg[n] - sc[n]).float().abs().max().item()
                    for n in sc] or [0.0])
    held = ("trunk leaves" if not l2_leaves else
            f"{'trunk and ' if trunk_l2 else ''}{', '.join(l2_leaves)}")
    trunk = (f"; {held} worst ||card-cpu||/||g|| = {worst_l2:.3e} "
             f"({l2_name}; tol {TRUNK_L2_RTOL})"
             if trunk_l2 or l2_leaves else "")
    log(f"  {label} fp32 train step: loss card {lg:.6f} cpu {lc:.6f}; "
        f"{len(gc)} gradient leaves, worst max|card-cpu|/max|g| = "
        f"{worst:.3e} ({worst_name}; tol {GRAD_RTOL}){trunk}; BN statistics "
        f"max|card-cpu| {stat_err:.3e}; cert_overflow card {cg} cpu {cc}")
    if not (abs(lg - lc) <= 1e-3 * abs(lc) and worst <= GRAD_RTOL
            and worst_l2 <= TRUNK_L2_RTOL and stat_err <= 1e-3
            and np.isfinite(lg) and cg == cc == 0):
        raise RuntimeError(f"card and CPU train steps disagree ({label})")


def small_exact_cfg(mode="gather", dcn_mode=None):
    """The small configs of the port's CPU tests, fp32, with nothing random
    in the step: without ``dcn_mode`` tiny_occ cut to 2 layers, 64 channels,
    a 10 x 10 BEV and 96 x 128 images with static top-K SCA sized for the
    ring rig (tests/test_torch_gather.py); with it an R50 trunk with DCN
    stages 3-4 at radius DCN_RADIUS, a 6 x 6 BEV, 64 x 96 images and
    dense-masked SCA, in encoder ``mode`` (tests/test_torch_dcn.py)."""
    from occnet_tpu_torch import geometry
    from occnet_tpu_torch.config import apply_overrides, tiny_occ
    cfg = tiny_occ()
    m = cfg.model
    enc = dataclasses.replace(m.encoder, mode=mode, num_layers=2, ffn_dim=64,
                              num_points_in_pillar=4)
    if dcn_mode is None:
        m = dataclasses.replace(m, img_h=96, img_w=128, bev_h=10, bev_w=10,
                                pillar_h=4, embed_dims=64, out_dim=8,
                                compute_dtype="float32", encoder=enc)
        k = geometry.calibration_topk(m, ring_rig(m, 1), multiple=8)
        sca = dataclasses.replace(enc.sca, max_queries_per_cam=k)
    else:
        bb = dataclasses.replace(m.backbone, type="resnet50",
                                 dcn_stages=(False, False, True, True),
                                 dcn_mode=dcn_mode,
                                 dcn_window_radius=DCN_RADIUS)
        m = dataclasses.replace(m, img_h=64, img_w=96, bev_h=6, bev_w=6,
                                pillar_h=4, embed_dims=64, out_dim=8,
                                compute_dtype="float32", backbone=bb,
                                encoder=enc)
        sca = dataclasses.replace(enc.sca, max_queries_per_cam=0)
    m = dataclasses.replace(m, encoder=dataclasses.replace(enc, sca=sca))
    return apply_overrides(dataclasses.replace(cfg, model=m), {
        "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
        "model.encoder.tsa.dropout": "0", "model.encoder.sca.dropout": "0",
        "optim.grad_clip_norm": "1e9"})


def phase_train_exact_parity(torch):
    """Card vs CPU train steps of the small gather config (static top-K:
    gather -> MSDA -> scatter_add_) and of the small DCN config in the two
    pairings that train (window DCN + dense encoder, gather DCN + gather
    encoder)."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.models.resnet import dcn_layer_indices
    from occnet_tpu_torch.ops.deform_conv import DEFORM_BWD
    from occnet_tpu_torch.ops.msda import MSDA_BWD
    from occnet_tpu_torch.tools.train import make_synthetic_batch
    for label, cfg, trunk_l2 in (
            ("small gather", small_exact_cfg(), True),
            ("small R50-DCN window + dense",
             small_exact_cfg("dense", "window"), False),
            ("small R50-DCN gather + gather",
             small_exact_cfg("gather", "gather"), False)):
        m = cfg.model
        batch = make_synthetic_batch(cfg, 1, np.random.RandomState(4))
        batch["img"] = np.random.RandomState(5).randn(
            1, m.num_cams, m.img_h, m.img_w, 3).astype(np.float32)
        if m.backbone.dcn_stages[2]:
            sd = dcn_weights(torch, cfg, "cpu", batch["img"],
                             batch["ego2img"], seed=3, randomize=True,
                             max_px=DCN_TRAIN_MAX_PX)
        else:
            sd = from_jax_variables(randomize_variables(
                init_jax_style_variables(cfg, seed=1), seed=2))
        MSDA_BWD.launches = DEFORM_BWD.launches = 0
        train_step_parity(torch, label, cfg, sd, batch, trunk_l2)
        log(f"    launches on the card: msda_bwd {MSDA_BWD.launches}, "
            f"dcn_bwd {DEFORM_BWD.launches}")
        want_msda = 2 * m.encoder.num_layers if m.encoder.mode == "gather" \
            else 0
        want_dcn = len(dcn_layer_indices(50, m.backbone.dcn_stages))
        if (MSDA_BWD.launches, DEFORM_BWD.launches) != (want_msda, want_dcn):
            raise RuntimeError(f"{label}: backward launches "
                               f"{(MSDA_BWD.launches, DEFORM_BWD.launches)}"
                               f" != {(want_msda, want_dcn)}")


def phase_train_full(torch, name, steps, results):
    """``steps`` timed train steps of the named config at full width (bf16,
    B = 1, config defaults) after one warm-up, through the train CLI's step;
    for R101-DCN the trunk's FrozenBN statistics and the DCN offsets
    (drawn from a seed, |offset| <= DCN_TRAIN_MAX_PX) calibrated on the
    batch, which trains without grid mask and photometric distortion.
    Returns the backward kernels' launches over the timed steps."""
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops.msda import MSDA, MSDA_BWD
    from occnet_tpu_torch.tools.profile_turbo import device_profile
    from occnet_tpu_torch.tools.train import make_synthetic_batch, to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    cfg = get_config(name)
    dcn = cfg.model.backbone.dcn_stages[2]
    if dcn:
        # random weights keep the window certificate only on the images the
        # offsets were calibrated on: the photometric distortion and the
        # grid mask each move calibrated offsets past R = 3, so the
        # R101-DCN steps train on the batch as calibrated (dropout stays)
        cfg = apply_overrides(cfg, {"model.use_grid_mask": "false",
                                    "data.device_distortion": "false"})
    m = cfg.model
    t0 = time.perf_counter()
    nb = make_synthetic_batch(cfg, 1, np.random.RandomState(14))
    if dcn:
        sd = dcn_weights(torch, cfg, "cuda", nb["img"], nb["ego2img"],
                         seed=15, max_px=DCN_TRAIN_MAX_PX, normalise_bn=True)
    else:
        sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    state = create_train_state(cfg, sd, "cuda")
    del sd
    batch = to_device(nb, "cuda")
    step_fn = make_train_step(cfg, seed=0)
    log(f"  {name} train state ready in {time.perf_counter() - t0:.1f} s; "
        f"{m.backbone.type}, DCN {m.backbone.dcn_mode if dcn else 'none'}, "
        f"{m.encoder.mode} encoder; images {tuple(batch['img'].shape)} uint8")
    metrics = step_fn(state, batch)                  # warm-up
    torch.cuda.synchronize()
    log(f"  warm-up step: loss {float(metrics['loss']):.4f}, cert_overflow "
        f"{int(metrics['cert_overflow'])}")
    kernels = {"msda": MSDA, "msda_bwd": MSDA_BWD,
               "dcn_conv": dc.DEFORM_CONV, "dcn_sample": dc.DEFORM,
               "dcn_bwd": dc.DEFORM_BWD}
    per_step = {"msda": 0, "msda_bwd": 0, "dcn_conv": 0, "dcn_sample": 0,
                "dcn_bwd": 0}
    if m.encoder.mode == "gather":
        ks = state.model.head.transformer.encoder.layer0.cross_attn \
            .topk_sizes(m.bev_h * m.bev_w)
        per_step["msda"] = per_step["msda_bwd"] = \
            m.encoder.num_layers * (1 + (len(set(ks)) or 1))
    if dcn:
        per_step.update(dcn_conv=26, dcn_sample=26, dcn_bwd=26)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    host, phases = [], []
    for _ in range(steps):
        ev = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(label):
            ev[label] = torch.cuda.Event(enable_timing=True)
            ev[label].record()

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
        log(f"  step {state.step - 1}: loss {vals['loss']:.4f} gnorm "
            f"{vals['grad_norm']:.3f} cert_overflow "
            f"{int(vals['cert_overflow'])}; host {host[-1]:.3f} ms; device "
            f"forward {phases[-1]['forward']:.3f} / backward "
            f"{phases[-1]['backward']:.3f} / optimizer "
            f"{phases[-1]['optimizer']:.3f} ms")
        if not (np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])):
            raise RuntimeError(f"{name}: non-finite loss or grad norm")
        if vals["cert_overflow"] != 0:
            raise RuntimeError(f"{name}: cert_overflow "
                               f"{vals['cert_overflow']}")
    launches = {k: v.launches for k, v in kernels.items()}
    want = {k: n * steps for k, n in per_step.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean = {k: sum(p[k] for p in phases) / steps for k in phases[0]}
    log(f"  {name}: {steps} train steps, host ms "
        f"{[round(x, 3) for x in host]}, mean {sum(host) / steps:.3f}; "
        f"device mean forward {mean['forward']:.3f} / backward "
        f"{mean['backward']:.3f} / optimizer {mean['optimizer']:.3f} ms; "
        f"peak allocated {peak:.3f} GiB; launches {launches} (expected "
        f"{want}); card {nvidia_smi()}")
    if launches != want:
        raise RuntimeError(f"{name}: train launch counts {launches} != "
                           f"{want}")
    # the profiled step (after the peak is read) keeps its backward kernels'
    # inputs for `bwd_real`
    store = {}
    keys = ({"SCA", "TSA"} if m.encoder.mode == "gather" and not dcn
            else set()) | ({"layer3_1"} if dcn else set())
    with captured_backward(store, keys):
        prof = device_profile(lambda: step_fn(state, batch))
    log(f"  one more step under torch.profiler: device kernels and copies "
        f"{prof['kernel_ms']:.3f} ms summed, card busy {prof['busy_ms']:.3f} "
        f"ms of a {prof['span_ms']:.3f} ms span; backward kernels: msda_bwd "
        f"{prof['msda_bwd_ms']:.3f} ms, dcn_bwd {prof['dcn_bwd_ms']:.3f} "
        f"ms; the largest:")
    for k, v in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {v:9.3f} ms  {k[:100]}")
    del state, batch, step_fn
    torch.cuda.empty_cache()
    bwd_real(torch, name, store, results)
    del store
    torch.cuda.empty_cache()
    return {"msda_bwd": launches["msda_bwd"], "dcn_bwd": launches["dcn_bwd"]}


# --- phases 25-27: nuScenes-layout data, reference checkpoints, the CLIs ---

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "occnet_tpu_torch", "data", "fixtures")
MINISET_FRAMES = 4       # frames of the data root, two scenes
# the cameras of a nuScenes infos entry, in the order of data.nuscenes
NUSC_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
             "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def write_miniset(root):
    """A nuScenes / OpenOcc-layout data root with the layout of
    tests/test_cli.py's `_write_miniset`: MINISET_FRAMES frames in two
    scenes on the ring rig (each camera i yawed 2*pi*i/6, focal w/2), a
    per-frame ego yaw, the six committed 900 x 1600 camera JPEGs of
    occnet_tpu_torch/data/fixtures/ for every frame, labels.npz with ~1 %
    occupied voxels (random classes, flow on half of them) and three infos
    pkls: infos_val.pkl (every frame), infos_train.pkl (the first scene)
    and infos_val2.pkl (the first two frames)."""
    import pickle
    import shutil
    h, w = 900, 1600
    os.makedirs(os.path.join(root, "imgs"))
    for ci, name in enumerate(NUSC_CAMS):
        shutil.copy(os.path.join(FIXTURES, f"cam{ci}.jpg"),
                    os.path.join(root, "imgs", f"{name}.jpg"))
    rng = np.random.RandomState(0)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    per_scene = MINISET_FRAMES // 2
    infos = []
    for fi in range(MINISET_FRAMES):
        token, scene = f"tok{fi}", f"scene-{fi // per_scene + 1:04d}"
        yaw = 0.05 * (fi % per_scene)
        cams = {}
        for ci, name in enumerate(NUSC_CAMS):
            a = 2 * np.pi * ci / 6
            rz = np.array([[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
            cams[name] = {
                "data_path": f"imgs/{name}.jpg",
                "cam_intrinsic": np.array([[w / 2.0, 0, w / 2],
                                           [0, w / 2.0, h / 2], [0, 0, 1]]),
                "sensor2lidar_rotation": rz @ base,
                "sensor2lidar_translation": np.array([1.0, 0.0, 1.5])}
        occ_rel = f"openocc_v2/{scene}/{token}/labels.npz"
        os.makedirs(os.path.dirname(os.path.join(root, occ_rel)))
        sem = np.full((200, 200, 16), 16, np.uint8)
        occ = rng.rand(200, 200, 16) < 0.01
        sem[occ] = rng.randint(0, 16, int(occ.sum()))
        flow = np.zeros((200, 200, 16, 2), np.float16)
        moving = occ & (rng.rand(200, 200, 16) < 0.5)
        flow[moving] = rng.randn(int(moving.sum()), 2)
        np.savez_compressed(os.path.join(root, occ_rel), semantics=sem,
                            flow=flow)
        infos.append({
            "token": token, "cams": cams,
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "lidar2ego_rotation": [1.0, 0.0, 0.0, 0.0],
            "ego2global_translation": [100.0 + 2.0 * fi, 50.0, 0.0],
            "ego2global_rotation": [np.cos(yaw / 2), 0.0, 0.0,
                                    np.sin(yaw / 2)],
            "occ_path": occ_rel, "scene_token": scene, "timestamp": fi})
    for name, sel in (("infos_val.pkl", infos),
                      ("infos_train.pkl", infos[:per_scene]),
                      ("infos_val2.pkl", infos[:2])):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({"infos": sel, "metadata": {"version": "v1.0-mini"}},
                        f)


def torchvision_resnet(params, stats, depth, prefix=""):
    """A JAX-layout ResNet subtree (no DCN) in torchvision's names and
    layouts, conv1 back in BGR input order: the inverse of
    `utils.torch_convert.convert_torchvision_resnet`."""
    from occnet_tpu_torch.models.resnet import STAGE_BLOCKS
    sd = {}

    def conv(src, dst):
        sd[f"{prefix}{dst}.weight"] = np.transpose(src["kernel"],
                                                   (3, 2, 0, 1))

    def bn(p, st, dst):
        for a, b in (("weight", p["scale"]), ("bias", p["bias"]),
                     ("running_mean", st["mean"]),
                     ("running_var", st["var"])):
            sd[f"{prefix}{dst}.{a}"] = b

    conv({"kernel": params["conv1"]["kernel"][:, :, ::-1, :]}, "conv1")
    bn(params["bn1"], stats["bn1"], "bn1")
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n):
            p, st = params[f"layer{stage + 1}_{b}"], \
                stats[f"layer{stage + 1}_{b}"]
            dst = f"layer{stage + 1}.{b}"
            for ci in (1, 2, 3):
                conv(p[f"conv{ci}"], f"{dst}.conv{ci}")
                bn(p[f"bn{ci}"], st[f"bn{ci}"], f"{dst}.bn{ci}")
            if "downsample_conv" in p:
                conv(p["downsample_conv"], f"{dst}.downsample.0")
                bn(p["downsample_bn"], st["downsample_bn"],
                   f"{dst}.downsample.1")
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def reference_checkpoint(variables, depth=50):
    """A JAX-layout BEVFormerOcc tree (ResNet without DCN, gather encoder)
    as the reference's checkpoint: the inverse of
    `utils.torch_convert.convert_bevformer_occ_checkpoint`, after
    tests/test_full_convert.py's `_fabricate_state_dict`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = torchvision_resnet(params["backbone"], stats["backbone"], depth,
                            "img_backbone.")

    def lin(src, dst):
        sd[f"{dst}.weight"] = np.transpose(src["kernel"])
        if "bias" in src:
            sd[f"{dst}.bias"] = src["bias"]

    def conv2d(src, dst):
        sd[f"{dst}.weight"] = np.transpose(src["kernel"], (3, 2, 0, 1))
        sd[f"{dst}.bias"] = src["bias"]

    neck = params["neck"]
    n_lat = sum(k.startswith("lateral_") for k in neck)
    for i in range(n_lat):
        conv2d(neck[f"lateral_{i}"], f"img_neck.lateral_convs.{i}.conv")
        conv2d(neck[f"fpn_{i}"], f"img_neck.fpn_convs.{i}.conv")
    for j in range(sum(k.startswith("fpn_extra_") for k in neck)):
        conv2d(neck[f"fpn_extra_{j}"], f"img_neck.fpn_convs.{n_lat + j}.conv")
    head = params["head"]
    R, T = "pts_bbox_head", "pts_bbox_head.transformer"
    trans = head["transformer"]
    sd[f"{R}.bev_embedding.weight"] = head["bev_embedding"]
    for k in ("row_embed", "col_embed"):
        sd[f"{R}.positional_encoding.{k}.weight"] = \
            head["positional_encoding"][k]
    sd[f"{T}.level_embeds"] = trans["level_embeds"]
    sd[f"{T}.cams_embeds"] = trans["cams_embeds"]
    for lname, layer in trans["encoder"].items():
        E = f"{T}.encoder.layers.{int(lname.replace('layer', ''))}"
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            lin(layer["self_attn"][name], f"{E}.attentions.0.{name}")
        for name in ("sampling_offsets", "attention_weights", "value_proj"):
            lin(layer["cross_attn"]["deformable_attention"][name],
                f"{E}.attentions.1.deformable_attention.{name}")
        lin(layer["cross_attn"]["output_proj"],
            f"{E}.attentions.1.output_proj")
        lin(layer["ffn"]["fc1"], f"{E}.ffns.0.layers.0.0")
        lin(layer["ffn"]["fc2"], f"{E}.ffns.0.layers.1")
        for j in range(3):
            sd[f"{E}.norms.{j}.weight"] = layer[f"norm{j + 1}"]["scale"]
            sd[f"{E}.norms.{j}.bias"] = layer[f"norm{j + 1}"]["bias"]
    for j in (0, 1):
        dec = trans[f"decoder{j}"]
        decs = stats["head"]["transformer"][f"decoder{j}"]["bn"]
        sd[f"{T}.decoder.{j}.conv.weight"] = np.transpose(
            dec["conv"]["kernel"], (4, 3, 0, 1, 2))
        for a, b in (("weight", dec["bn"]["scale"]),
                     ("bias", dec["bn"]["bias"]),
                     ("running_mean", decs["mean"]),
                     ("running_var", decs["var"])):
            sd[f"{T}.decoder.{j}.bn.{a}"] = b
    for name in ("predicter", "flow_predicter"):
        lin(trans[name]["fc1"], f"{T}.{name}.0")
        lin(trans[name]["fc2"], f"{T}.{name}.2")
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def cpu_name() -> str:
    """The host CPU as /proc/cpuinfo names it (its model name, else its
    vendor / family / model / part fields), with the core count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break               # the first processor only
                k, _, v = line.partition(":")
                fields[k.strip()] = v.strip()
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    name = (model if model != "unknown" else "") or ", ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                     "CPU implementer", "CPU part")
        if k in fields) or "not named by /proc/cpuinfo"
    return f"{name} ({os.cpu_count()} cores)"


class FrameMarks:
    """`mark(name)` of the test CLI: a CUDA event, the host clock and the
    launch counts of ``kernels`` at each mark; `frames()` splits them per
    frame ("frame" starts one)."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels, self.marks = torch, kernels, []

    def __call__(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter(),
                           {k: v.launches for k, v in self.kernels.items()}))

    def frames(self):
        self.torch.cuda.synchronize()
        out, cur = [], None
        for name, ev, t, counts in self.marks:
            if name == "frame":
                cur = {"_ev": ev, "_t": t, "_n": counts, "launches": {}}
                out.append(cur)
                continue
            cur[name] = (cur["_ev"].elapsed_time(ev), (t - cur["_t"]) * 1e3)
            cur["launches"] = {k: counts[k] - cur["_n"][k] for k in counts}
            cur["_ev"], cur["_t"] = ev, t
        return out


def log_frames(frames, load_ms, stages):
    """Mean ms a frame by CUDA events / host clock of each stage, and the
    host's load (decode + labels) ms on the loader thread."""
    log(f"  host load (6 JPEG decodes + labels) ms a frame: "
        f"{[round(x, 3) for x in load_ms]}, mean "
        f"{float(np.mean(load_ms)):.3f}; CPU {cpu_name()}")
    for st in stages:
        dev = [f[st][0] for f in frames]
        host = [f[st][1] for f in frames]
        log(f"  {st:8s} ms a frame, CUDA events {[round(x, 3) for x in dev]}"
            f" / host clock {[round(x, 3) for x in host]}")
    log(f"  launches a frame {[f['launches'] for f in frames]}")


def phase_data_base_occ(torch, results, root):
    """Phase 25: the committed fixtures decoded to their digests, a
    reference checkpoint converted bit for bit, the test CLI on base_occ
    (--torch-checkpoint --eval --format-only), then ray_casting + metric."""
    import hashlib
    from occnet_tpu_torch.config import get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data import jpeg
    from occnet_tpu_torch.evaluation.submission import (load_submission,
                                                        score_submissions)
    from occnet_tpu_torch.models import head
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.ops.ray_march_vec import FAN, FAN_RENDER
    from occnet_tpu_torch.tools import metric, ray_casting
    from occnet_tpu_torch.tools import test as test_cli
    from occnet_tpu_torch.utils.torch_convert import (
        load_bevformer_into_state_dict)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)["sha256_of_rgb_uint8"]
    t = time.perf_counter()
    jpeg.library()
    log(f"  JPEG decoder built/loaded in {time.perf_counter() - t:.2f} s "
        f"(host c++)")
    ms = []
    for name, want in sorted(digests.items()):
        t = time.perf_counter()
        px = jpeg.read_jpeg(os.path.join(FIXTURES, name))
        ms.append((time.perf_counter() - t) * 1e3)
        got = hashlib.sha256(px.tobytes()).hexdigest()
        if px.shape != (900, 1600, 3) or got != want:
            raise RuntimeError(f"{name}: decoded {px.shape} {got}, "
                               f"tf.io.decode_jpeg gives {want}")
    log(f"  6 fixtures decoded to tf.io.decode_jpeg's digests; decode ms "
        f"(host, one thread) {[round(x, 3) for x in ms]}; CPU {cpu_name()}")

    cfg = get_config("base_occ")
    m = cfg.model
    work = os.path.join(root, "work_base_occ")
    pth = os.path.join(root, "bevformer_occ.pth")
    v = init_jax_style_variables(cfg, seed=0)
    torch.save({"state_dict": {k: torch.from_numpy(a) for k, a in
                               reference_checkpoint(v).items()}}, pth)
    want = from_jax_variables(v)
    other = from_jax_variables(init_jax_style_variables(cfg, seed=1))
    got = load_bevformer_into_state_dict(
        other, torch.load(pth, weights_only=True)["state_dict"], depth=50,
        num_encoder_layers=m.encoder.num_layers)
    moved = sum(not torch.equal(other[k], want[k]) for k in want)
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k])
                                            for k in want):
        raise RuntimeError("the reference checkpoint did not convert back "
                           "to its weights bit for bit")
    log(f"  reference .pth ({os.path.getsize(pth) / 2 ** 20:.1f} MiB, "
        f"{len(want)} tensors) converted into a seed-1 init: all equal to "
        f"the weights it was made from ({moved} tensors moved)")

    preds = {}

    def capture(outs):              # kept on the card: no extra sync
        occ, flow = get_occ(outs)
        preds[len(preds)] = (occ[0].clone(), flow[0].float())
        return occ, flow

    get_occ = head.get_occ
    kernels = {"msda": MSDA, "fan": FAN_RENDER, "fan_raw": FAN}
    for k in kernels.values():
        k.launches = 0
    marks = FrameMarks(torch, kernels)
    sub_path = os.path.join(root, "submission.gz")
    t = time.perf_counter()
    with patched(head, "get_occ", capture):
        summary = test_cli.main([
            "--config", "base_occ", "--torch-checkpoint", pth, "--eval",
            "--format-only", "--max-samples", str(MINISET_FRAMES),
            "--work-dir", work, "--out", sub_path, "--set",
            f"data.data_root={root}", "data.val_ann=infos_val.pkl"],
            mark=marks)
    wall = time.perf_counter() - t
    launches = {k: v.launches for k, v in kernels.items()}
    frames = marks.frames()
    ks = summary["per_cam_topk"]
    want_msda = MINISET_FRAMES * m.encoder.num_layers * (1 + len(set(ks)))
    want_l = {"msda": want_msda, "fan": 2 * MINISET_FRAMES, "fan_raw": 0}
    scores = summary["scores"]
    log(f"  test CLI (base_occ, {MINISET_FRAMES} frames, --eval "
        f"--format-only) in {wall:.1f} s: auto top-K per camera {ks}, "
        f"certificate {summary['overflow']}, scores {scores}; launches "
        f"{launches} (expected {want_l}); card {nvidia_smi()}")
    log_frames(frames, summary["load_ms"], ("forward", "render", "counts"))
    sub = load_submission(sub_path)["results"]
    finite = all(np.isfinite(a.astype(np.float32)).all()
                 for r in sub.values() for a in r.values())
    if summary["overflow"] != 0 or launches != want_l \
            or sorted(sub) != summary["tokens"] or len(sub) != MINISET_FRAMES \
            or not finite:
        raise RuntimeError("the test CLI's run on base_occ is wrong")
    # mAVE (and so OccScore) is NaN exactly when no ray of a flow class is a
    # true positive, the reference's semantics; the point clouds are finite
    if not all(np.isfinite(scores[k]) and 0 <= scores[k] <= 1 for k in
               ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4")) \
            or np.isnan(scores["mAVE"]) != np.isnan(scores["OccScore"]):
        raise RuntimeError(f"test CLI scores wrong: {scores}")
    results.setdefault("phase_launches", {})["25"] = launches

    pred_dir = os.path.join(root, "preds")
    os.makedirs(pred_dir)
    for i, tok in enumerate(summary["tokens"]):
        np.savez(os.path.join(pred_dir, f"{tok}.npz"),
                 semantics=preds[i][0].cpu().numpy(),
                 flow=preds[i][1].cpu().numpy())
    FAN_RENDER.launches = 0
    pred_gz, gt_gz = (os.path.join(root, f"{n}.gz") for n in ("pred", "gt"))
    t = time.perf_counter()
    ray_casting.main(["--pred-dir", pred_dir, "--infos",
                      os.path.join(root, "infos_val.pkl"), "--data-root",
                      root, "--pred-out", pred_gz, "--gt-out", gt_gz])
    cast_s = time.perf_counter() - t
    same = metric.main(["--pred", gt_gz, "--gt", gt_gz])
    scored = metric.main(["--pred", pred_gz, "--gt", gt_gz])
    direct = score_submissions(pred_gz, gt_gz)
    cast = load_submission(pred_gz)["results"]
    log(f"  ray_casting: {2 * MINISET_FRAMES} grids in {cast_s:.2f} s, fan "
        f"render launches {FAN_RENDER.launches}; metric GT vs GT {same}; "
        f"prediction vs GT {scored}")
    if FAN_RENDER.launches != 2 * MINISET_FRAMES \
            or abs(same["RayIoU"] - 1) > 1e-9 \
            or abs(same["OccScore"] - 1) > 1e-9:
        raise RuntimeError("GT against GT does not score 1")
    if any(not (scored[k] == direct[k] or (np.isnan(scored[k])
                                           and np.isnan(direct[k])))
           for k in direct):
        raise RuntimeError("the metric CLI disagrees with score_submissions")
    for tok, r in sub.items():
        if any(not np.array_equal(r[k], cast[tok][k]) for k in r):
            raise RuntimeError(f"{tok}: the test CLI's submission and "
                               f"ray_casting's differ")


def dcn_needs(torch, pred, imgs, e2i):
    """Each DCN block's needed_radius on one request where the JAX package
    runs the window kernel (`window_supported`), else 0, computed from each
    layer's own offsets by forward pre-hooks."""
    from occnet_tpu_torch.ops.dcn_window import needed_radius, window_supported
    from occnet_tpu_torch.ops.deform_conv import ModulatedDeformConv
    needs, hooks = {}, []

    def probe(name, mod, inputs):
        x = inputs[0]
        off, _ = mod.offset_and_mask(x)
        needs[name] = (int(needed_radius(off, *x.shape[2:]))
                       if window_supported(x.shape[3], 3, mod.stride, 1)
                       else 0)

    for name, mod in pred.model.backbone.named_modules():
        if isinstance(mod, ModulatedDeformConv):
            hooks.append(mod.register_forward_pre_hook(
                lambda mm, i, n=name.split(".")[0]: probe(n, mm, i)))
    try:
        pred.infer(imgs, e2i)
    finally:
        for h in hooks:
            h.remove()
    return needs


def phase_data_dcn(torch, results, root):
    """Phase 26: the test CLI on turbo_r101_dcn_occ with the DCN radius
    probe, on the miniset, random weights calibrated on its first frame."""
    from occnet_tpu_torch.config import get_config
    from occnet_tpu_torch.data.nuscenes import NuSceneOccDataset
    from occnet_tpu_torch.models.resnet import dcn_layer_indices
    from occnet_tpu_torch.ops import deform_conv as dc
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.ray_march_vec import FAN_RENDER
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.tools import test as test_cli
    cfg = get_config("turbo_r101_dcn_occ")
    m = cfg.model
    s0 = NuSceneOccDataset(dataclasses.replace(cfg.data, data_root=root),
                           os.path.join(root, "infos_val.pkl"),
                           training=False).get_sample(0)
    imgs, e2i = s0["img"][None], s0["ego2img"][None]
    sd = dcn_weights(torch, cfg, "cuda", imgs, e2i, seed=11)
    ckpt = os.path.join(root, "ckpt_r101_dcn.pt")
    torch.save({"step": 0, "model": sd}, ckpt)
    needs = dcn_needs(torch, Predictor(cfg, sd, "cuda"), imgs, e2i)
    del sd
    idx = dcn_layer_indices(101, m.backbone.dcn_stages)
    want_radii = tuple(needs[n] for n in sorted(idx, key=idx.get))
    torch.cuda.empty_cache()
    kernels = {"dcn_conv": dc.DEFORM_CONV, "dcn_sample": dc.DEFORM,
               "lift": LIFT, "tap": TAP, "fan": FAN_RENDER}
    for k in kernels.values():
        k.launches = 0
    marks = FrameMarks(torch, kernels)
    t = time.perf_counter()
    summary = test_cli.main([
        "--config", "turbo_r101_dcn_occ", "--checkpoint", ckpt, "--eval",
        "--max-samples", str(MINISET_FRAMES), "--work-dir",
        os.path.join(root, "work_dcn"), "--set", f"data.data_root={root}",
        "data.val_ann=infos_val.pkl"], mark=marks)
    wall = time.perf_counter() - t
    launches = {k: v.launches for k, v in kernels.items()}
    frames = marks.frames()
    per_req = {"dcn_conv": 26, "dcn_sample": 0,
               "lift": m.num_feature_levels, "tap": m.encoder.num_layers}
    want_frame = {**per_req, "fan": 1}
    # the probe is one more request
    want_l = {k: (MINISET_FRAMES + 1) * n for k, n in per_req.items()}
    want_l["fan"] = MINISET_FRAMES
    log(f"  test CLI (turbo_r101_dcn_occ, {MINISET_FRAMES} frames, --eval) "
        f"in {wall:.1f} s: probed radii {summary['dcn_radii']} (needed "
        f"{want_radii}, configured R={m.backbone.dcn_window_radius}), "
        f"certificate {summary['overflow']}, scores {summary['scores']}; "
        f"launches {launches} (expected {want_l}); card {nvidia_smi()}")
    log_frames(frames, summary["load_ms"], ("forward", "render", "counts"))
    if summary["dcn_radii"] != want_radii or summary["overflow"] != 0 \
            or launches != want_l \
            or any(f["launches"] != want_frame for f in frames) \
            or not np.isfinite(summary["scores"]["RayIoU"]):
        raise RuntimeError("the test CLI's run on turbo_r101_dcn_occ is "
                           "wrong")
    results.setdefault("phase_launches", {})["26"] = launches


def phase_data_train(torch, results, root):
    """Phase 27: the train CLI on the miniset (turbo_occ, full width, B = 1,
    2 steps) with a torchvision-layout backbone checkpoint and the eval
    hook, then one more step resumed from its checkpoint."""
    from occnet_tpu_torch.config import get_config
    from occnet_tpu_torch.convert import init_jax_style_variables
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD, LIFT_BWD_INDEX
    from occnet_tpu_torch.ops.ray_march_vec import FAN_RENDER
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    from occnet_tpu_torch.tools import train as train_cli
    cfg = get_config("turbo_occ")
    m = cfg.model
    # a torchvision-layout ResNet-50 (he-normal convs of another seed than
    # the CLI's init, identity statistics), conv1 in BGR order
    v = init_jax_style_variables(cfg, seed=5)
    tv = torchvision_resnet(v["params"]["backbone"],
                            v["batch_stats"]["backbone"], 50)
    r50 = os.path.join(root, "resnet50.pth")
    torch.save({k: torch.from_numpy(a) for k, a in tv.items()}, r50)
    work = os.path.join(root, "work_train")
    argv = ["--config", "turbo_occ", "--work-dir", work,
            "--backbone-checkpoint", r50, "--eval-interval-epochs", "1",
            "--set", f"data.data_root={root}",
            "data.train_ann=infos_train.pkl", "data.val_ann=infos_val2.pkl"]
    kernels = {"lift": LIFT, "tap": TAP, "lift_bwd": LIFT_BWD,
               "lift_bwd_index": LIFT_BWD_INDEX, "tap_bwd": TAP_BWD,
               "fan": FAN_RENDER}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    history = train_cli.main(argv + ["--max-steps", "2"])
    wall = time.perf_counter() - t
    launches = {k: v.launches for k, v in kernels.items()}
    steps = [h for h in history if "loss" in h]
    evals = [h for h in history if h.get("tag") == "eval"]
    L, E = m.num_feature_levels, m.encoder.num_layers
    want_l = {"lift": 2 * L + 2 * L, "tap": 2 * E + 2 * E,
              "lift_bwd": 2 * L, "lift_bwd_index": 2 * L, "tap_bwd": 2 * E,
              "fan": 2}
    log(f"  train CLI (turbo_occ, 2 steps on {len(steps)} logged, eval on "
        f"2 val frames) in {wall:.1f} s: losses "
        f"{[round(h['loss'], 4) for h in steps]}, eval {evals}; peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
        f"launches {launches} (expected {want_l}); card {nvidia_smi()}")
    ck = torch.load(os.path.join(work, "ckpt.pt"), weights_only=True)
    conv1 = ck["model"]["backbone.conv1.weight"].cpu().numpy()
    if [h["step"] for h in steps] != [0, 1] \
            or not all(np.isfinite(h["loss"]) for h in steps) \
            or len(evals) != 1 or not np.isfinite(evals[0]["RayIoU"]) \
            or launches != want_l or ck["step"] != 2 \
            or not np.array_equal(conv1, tv["conv1.weight"][:, ::-1]):
        raise RuntimeError("the train CLI's run on the miniset is wrong")
    LIFT_BWD.launches = 0
    resumed = train_cli.main(argv + ["--resume", "--max-steps", "3"])
    ck = torch.load(os.path.join(work, "ckpt.pt"), weights_only=True)
    log(f"  resumed: {resumed}; lift_bwd launches {LIFT_BWD.launches}; "
        f"checkpoint step {ck['step']}")
    if [h["step"] for h in resumed if "loss" in h] != [2] \
            or not np.isfinite(resumed[0]["loss"]) or ck["step"] != 3 \
            or LIFT_BWD.launches != L:
        raise RuntimeError("the train CLI did not resume from its checkpoint")
    results.setdefault("phase_launches", {})["27"] = launches


# --- phases 28-31: the temporal path (history BEV, streaming, clips) ---

TEMPORAL_FRAMES = 4      # frames a scene streamed at full width (2 scenes)
TEMPORAL_YAW_DEG = 3.0   # the ego's yaw change a frame
TEMPORAL_STEP_M = 2.0    # the ego's translation a frame, metres
# a nearest-rotation source coordinate this near a .5 tie may round either
# way under another cos / sin (tests/test_torch_temporal.py)
ROT_TIE_PX = 6.1e-5
TEMPORAL_TRAIN = (("turbo_occ", 2), ("turbo_occ", 4), ("base_occ", 2))
# the dense clip step's BEV query table is not determined by fp32 at
# tiny_turbo_occ's size: 1e-5 of noise on the images flips bf16 roundings
# of the lift's features and moves its gradient by 7.2 % of max|g| on the
# CPU (the single-frame step's: 1.5 %; every other leaf <= 3.4 %; the
# gather clip step's worst leaf 1.1 %), so it is held in relative L2
# (TRUNK_L2_RTOL), as phase 21 holds the gather config's trunk
CLIP_L2_LEAVES = ("head.bev_embedding",)


def scene_poses(n, scene):
    """n ego2global poses of a scene: the ego drives TEMPORAL_STEP_M ahead
    and turns TEMPORAL_YAW_DEG left a frame."""
    poses, x, y, yaw = [], 100.0 * scene, 50.0, 10.0 * scene
    for _ in range(n):
        a = np.deg2rad(yaw)
        p = np.eye(4)
        p[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        p[:2, 3] = x, y
        poses.append(p)
        x, y = x + TEMPORAL_STEP_M * np.cos(a), y + TEMPORAL_STEP_M * np.sin(a)
        yaw += TEMPORAL_YAW_DEG
    return poses


def stream_frames(m, scenes, n, rng, hw):
    """``scenes`` x ``n`` frames (uint8 (1, cams, h, w, 3) images, the ring
    rig, scene token, ego2global pose) in stream order."""
    e2i = ring_rig(m, 1)
    return [(rng.randint(0, 256, (1, m.num_cams, *hw, 3), dtype=np.uint8),
             e2i, f"scene-{s}", pose)
            for s in range(scenes) for pose in scene_poses(n, s)]


def clip_batch(cfg, T, rng, hw, uint8, padded=0):
    """A B = 1 clip of T frames on the ring rig, as `data.clips.ClipDataset`
    makes one: its first ``padded`` + 1 frames the same frame (a scene
    younger than the queue, prev_exists False), then a new frame and pose
    each; each transition's alignment from `clip_alignment`; random labels
    for the last frame.  Images uint8 (augmented on the card) or float
    (taken as they are)."""
    from occnet_tpu_torch.data.clips import clip_alignment
    m = cfg.model
    idx = [0] * (padded + 1) + list(range(1, T - padded))
    poses = scene_poses(T - padded, 0)
    if uint8:
        imgs = rng.randint(0, 256, (T - padded, m.num_cams, *hw, 3),
                           dtype=np.uint8)
    else:
        imgs = rng.randn(T - padded, m.num_cams, *hw, 3).astype(np.float32)
    rot, shifts = np.zeros(T, np.float32), np.zeros((T, 2), np.float32)
    exists = np.zeros(T, bool)
    for t in range(1, T):
        if idx[t] != idx[t - 1]:
            exists[t] = True
            rot[t], shifts[t] = clip_alignment(poses[idx[t - 1]],
                                               poses[idx[t]], m.pc_range,
                                               (m.bev_h, m.bev_w))
    grid = (1, m.bev_w, m.bev_h, m.pillar_h)
    return {"img": imgs[idx][None],
            "ego2img": np.repeat(ring_rig(m, 1)[:, None], T, axis=1),
            "rot_deg": rot[None], "shifts": shifts[None],
            "prev_exists": exists[None], "shift": shifts[-1:].copy(),
            "voxel_semantics": rng.randint(0, m.num_classes, grid),
            "voxel_flow": rng.randn(*grid, 2).astype(np.float32)}


def temporal_small_cfg(name):
    """tiny_turbo_occ / tiny_occ in fp32 with nothing random in a step and
    no clipping (as `small_train_cfg`); tiny_occ with the static top-K
    sized for the ring rig, as phase 10."""
    from occnet_tpu_torch import geometry
    from occnet_tpu_torch.config import apply_overrides, get_config
    cfg = apply_overrides(get_config(name), {
        "model.compute_dtype": "float32", "model.use_grid_mask": "false",
        "model.encoder.ffn_dropout": "0", "model.encoder.tsa.dropout": "0",
        "model.encoder.sca.dropout": "0", "optim.grad_clip_norm": "1e9"})
    if cfg.model.encoder.mode == "gather":
        k = geometry.calibration_topk(cfg.model, ring_rig(cfg.model, 1))
        cfg = apply_overrides(cfg, {"model.encoder.sca.max_queries_per_cam":
                                    k})
    return cfg


def certificates(torch, outs):
    return sum(int(v) for k, v in outs.items() if k.endswith("_overflow"))


def phase_temporal_parity(torch):
    """Phase 28: the rotation's source indices at full width, then
    tiny_turbo_occ and tiny_occ (fp32) card vs CPU: a 2-scene x 3-frame
    stream (history BEV and logits) and one clip train step (T = 3, one
    padded frame)."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.ops.transforms import (nearest_source_index,
                                                 rotation_cos_sin,
                                                 rotation_source)
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.temporal import (StreamingInferenceState,
                                                    make_temporal_train_step)
    rng = np.random.RandomState(20)
    ang = np.concatenate([rng.uniform(-5, 5, 200), rng.uniform(-180, 180, 50),
                          [0.0, 90.0, -90.0, 180.0]]).astype(np.float32)
    hw, c = (200, 200), (100.0, 100.0)
    maps = {}
    for dev in ("cuda", "cpu"):
        # the angles on each device: cos / sin taken there
        idx, valid = nearest_source_index(
            *rotation_cos_sin(torch.from_numpy(ang).to(dev)), hw, c)
        maps[dev] = torch.where(valid, idx, -1).cpu()
    sx, sy = rotation_source(*rotation_cos_sin(torch.from_numpy(ang)), hw, c)
    tie = torch.minimum((sx - sx.floor() - 0.5).abs(),
                        (sy - sy.floor() - 0.5).abs()).reshape(len(ang), -1)
    differ = maps["cuda"] != maps["cpu"]
    near = tie < ROT_TIE_PX
    log(f"  rotation source indices at 200 x 200, {len(ang)} angles: "
        f"{int(differ.sum())} cells differ card vs CPU, "
        f"{int((differ & ~near).sum())} of them farther than {ROT_TIE_PX} "
        f"px from a .5 tie ({int(near.sum())} cells that near)")
    if (differ & ~near).any():
        raise RuntimeError("the rotation's source indices differ between "
                           "card and CPU away from a tie")

    for name in ("tiny_turbo_occ", "tiny_occ"):
        cfg = temporal_small_cfg(name)
        m = cfg.model
        sd = from_jax_variables(randomize_variables(
            init_jax_style_variables(cfg, seed=1), seed=2))
        frames = stream_frames(m, 2, 3, rng, (m.img_h, m.img_w))
        runs = {}
        for dev in ("cuda", "cpu"):
            state = StreamingInferenceState(Predictor(cfg, sd, dev))
            runs[dev] = []
            for img, e2i, scene, pose in frames:
                outs = state.step(img, e2i, scene, pose)
                runs[dev].append((outs["bev_embed"].float().cpu(),
                                  outs["occ"].float().cpu(),
                                  certificates(torch, outs)))
        bev_err = max((g[0] - c_[0]).abs().max().item()
                      for g, c_ in zip(runs["cuda"], runs["cpu"]))
        err = max((g[1] - c_[1]).abs().max().item()
                  for g, c_ in zip(runs["cuda"], runs["cpu"]))
        agree = min((g[1].argmax(-1) == c_[1].argmax(-1)).float().mean()
                    .item() for g, c_ in zip(runs["cuda"], runs["cpu"]))
        certs = [r[2] for r in runs["cuda"] + runs["cpu"]]
        log(f"  {name} fp32 stream, 2 scenes x 3 frames (yaw "
            f"{TEMPORAL_YAW_DEG} deg, {TEMPORAL_STEP_M} m a frame): max"
            f"|card-cpu| history BEV {bev_err:.3e}, logits {err:.3e} (atol "
            f"{LOGIT_ATOL}), worst argmax agreement {agree:.5f}; "
            f"certificates {certs}")
        if not (bev_err <= LOGIT_ATOL and err <= LOGIT_ATOL and agree >= 0.99
                and not any(certs)):
            raise RuntimeError(f"{name}: card and CPU streams disagree")
        batch = clip_batch(cfg, 3, rng, (m.img_h, m.img_w), uint8=False,
                           padded=1)
        dense = m.encoder.mode == "dense"
        train_step_parity(torch, f"{name} clip (T = 3, prev_exists "
                                 f"{batch['prev_exists'][0].tolist()})",
                          cfg, sd, batch, trunk_l2=not dense,
                          make_step=make_temporal_train_step,
                          l2_leaves=CLIP_L2_LEAVES if dense else ())


def phase_temporal_serve(torch, results):
    """Phase 29: turbo_occ and base_occ stream 2 scenes x TEMPORAL_FRAMES
    full-width uint8 frames through `StreamingInferenceState`: launches a
    frame as single-frame requests, certificates 0, the first frame of a
    scene equal to a single-frame request and the later ones not, host ms a
    frame, the align / forward split by CUDA events, the single-frame
    latency of the same frames in turns (stream, single, single, stream),
    peak memory."""
    from occnet_tpu_torch.config import get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.ops.tsa import TAP
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.temporal import StreamingInferenceState
    launches_all = {}
    for name in ("turbo_occ", "base_occ"):
        cfg = get_config(name)
        m = cfg.model
        pred = Predictor(cfg, from_jax_variables(
            init_jax_style_variables(cfg, seed=0)), "cuda")
        frames = stream_frames(m, 2, TEMPORAL_FRAMES,
                               np.random.RandomState(21), (900, 1600))
        if m.encoder.mode == "dense":
            kernels = {"lift": LIFT, "tap": TAP}
            per_frame = {"lift": m.num_feature_levels,
                         "tap": m.encoder.num_layers}
        else:
            ks = pred.model.head.transformer.encoder.layer0.cross_attn \
                .topk_sizes(m.bev_h * m.bev_w)
            kernels = {"msda": MSDA}
            per_frame = {"msda": m.encoder.num_layers
                         * (1 + (len(set(ks)) or 1))}
        warm = StreamingInferenceState(pred)          # first use of the ops
        for img, e2i, scene, pose in frames[:2]:
            warm.step(img, e2i, scene, pose)
        torch.cuda.synchronize()

        def stream_pass(count):
            state = StreamingInferenceState(pred)
            host, split, occ, cert = [], [], [], 0
            if count:
                torch.cuda.reset_peak_memory_stats()
                for k in kernels.values():
                    k.launches = 0
            for img, e2i, scene, pose in frames:
                ev = {n: torch.cuda.Event(enable_timing=True)
                      for n in ("start", "end")}

                def mark(label):
                    ev[label] = torch.cuda.Event(enable_timing=True)
                    ev[label].record()

                t = time.perf_counter()
                ev["start"].record()
                outs = state.step(img, e2i, scene, pose, mark=mark)
                ev["end"].record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
                a = ev.get("align")
                split.append(((ev["start"].elapsed_time(a) if a else 0.0),
                              (a or ev["start"]).elapsed_time(ev["end"])))
                occ.append(outs["occ"])
                cert += certificates(torch, outs)
            launches = ({k: v.launches for k, v in kernels.items()}
                        if count else None)
            return host, split, occ, cert, launches

        def single_pass():
            host, occ = [], []
            for img, e2i, _, _ in frames:
                t = time.perf_counter()
                occ.append(pred.infer(img, e2i)["occ"])
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            return host, occ

        s1, sp1, occ_s, cert, launches = stream_pass(True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        p1, occ_p = single_pass()
        p2, _ = single_pass()
        s2, sp2, _, _, _ = stream_pass(False)
        n = len(frames)
        want = {k: v * n for k, v in per_frame.items()}
        first = [i % TEMPORAL_FRAMES == 0 for i in range(n)]
        same = [torch.equal(a, b) for a, b in zip(occ_s, occ_p)]
        hist = [i for i in range(n) if not first[i]]
        log(f"  {name} stream, 2 scenes x {TEMPORAL_FRAMES} frames (yaw "
            f"{TEMPORAL_YAW_DEG} deg and {TEMPORAL_STEP_M} m a frame): "
            f"launches {launches} (expected {want}); certificates {cert}; "
            f"logits equal to the single-frame request {same}; peak "
            f"allocated {peak:.3f} GiB; card {nvidia_smi()}")
        for label, h in (("stream", s1), ("single", p1), ("single", p2),
                         ("stream", s2)):
            log(f"    {label} host ms a frame {[round(x, 3) for x in h]}, "
                f"frames with history mean "
                f"{float(np.mean([h[i] for i in hist])):.3f}")
        for label, sp in (("first", sp1), ("second", sp2)):
            log(f"    {label} stream by CUDA events, frames with history: "
                f"align ms {[round(sp[i][0], 4) for i in hist]}, forward ms "
                f"{[round(sp[i][1], 3) for i in hist]}")
        if launches != want or cert != 0 \
                or same != first:
            raise RuntimeError(f"{name}: the streamed run is wrong")
        launches_all.update(launches)
        del pred, occ_s, occ_p
        torch.cuda.empty_cache()
    results.setdefault("phase_launches", {})["29"] = launches_all


def phase_temporal_train(torch, results):
    """Phase 30: clip train steps at full width (bf16, B = 1, config
    defaults) through the train CLI's temporal step: turbo_occ at T = 2
    and 4, base_occ at T = 2; 1 warm-up + FULL_TRAIN_STEPS timed steps;
    finite losses, certificates 0, launches a step (history frames run the
    forward kernels only), host ms, the CUDA-event split of history /
    forward / backward / optimizer, peak memory."""
    from occnet_tpu_torch.config import get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD, LIFT_BWD_INDEX
    from occnet_tpu_torch.ops.msda import MSDA, MSDA_BWD
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    from occnet_tpu_torch.tools.train import to_device
    from occnet_tpu_torch.training.temporal import make_temporal_train_step
    from occnet_tpu_torch.training.train import create_train_state
    launches_all = {}
    for name, T in TEMPORAL_TRAIN:
        cfg = get_config(name)
        m = cfg.model
        L, E = m.num_feature_levels, m.encoder.num_layers
        state = create_train_state(cfg, from_jax_variables(
            init_jax_style_variables(cfg, seed=0)), "cuda")
        batch = to_device(clip_batch(cfg, T, np.random.RandomState(22),
                                     (900, 1600), uint8=True), "cuda")
        step_fn = make_temporal_train_step(cfg, seed=0)
        metrics = step_fn(state, batch)                    # warm-up
        torch.cuda.synchronize()
        if m.encoder.mode == "dense":
            kernels = {"lift": LIFT, "tap": TAP, "lift_bwd": LIFT_BWD,
                       "lift_bwd_index": LIFT_BWD_INDEX, "tap_bwd": TAP_BWD}
            per_step = {"lift": L * T, "tap": E * T, "lift_bwd": L,
                        "lift_bwd_index": L, "tap_bwd": E}
        else:
            ks = state.model.head.transformer.encoder.layer0.cross_attn \
                .topk_sizes(m.bev_h * m.bev_w)
            per_layer = 1 + (len(set(ks)) or 1)
            kernels = {"msda": MSDA, "msda_bwd": MSDA_BWD}
            per_step = {"msda": E * per_layer * T, "msda_bwd": E * per_layer}
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        host, phases = [], []
        for _ in range(FULL_TRAIN_STEPS):
            ev = {"start": torch.cuda.Event(enable_timing=True)}

            def mark(label):
                ev[label] = torch.cuda.Event(enable_timing=True)
                ev[label].record()

            t = time.perf_counter()
            ev["start"].record()
            metrics = step_fn(state, batch, mark)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
            order = ("start", "history", "forward", "backward", "optimizer")
            phases.append({b: ev[a].elapsed_time(ev[b])
                           for a, b in zip(order, order[1:])})
            vals = {k: float(v) for k, v in metrics.items()}
            log(f"  {name} T = {T} step {state.step - 1}: loss "
                f"{vals['loss']:.4f} gnorm {vals['grad_norm']:.3f} "
                f"cert_overflow {int(vals['cert_overflow'])}; host "
                f"{host[-1]:.3f} ms; device "
                + " / ".join(f"{k} {v:.3f}" for k, v in phases[-1].items())
                + " ms")
            if not (np.isfinite(vals["loss"])
                    and np.isfinite(vals["grad_norm"])
                    and vals["cert_overflow"] == 0):
                raise RuntimeError(f"{name} T = {T}: non-finite loss or a "
                                   f"nonzero certificate")
        launches = {k: v.launches for k, v in kernels.items()}
        want = {k: n * FULL_TRAIN_STEPS for k, n in per_step.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mean = {k: sum(p[k] for p in phases) / FULL_TRAIN_STEPS
                for k in phases[0]}
        log(f"  {name} T = {T}: {FULL_TRAIN_STEPS} clip steps, host ms "
            f"{[round(x, 3) for x in host]}, mean "
            f"{sum(host) / FULL_TRAIN_STEPS:.3f}; device mean "
            + " / ".join(f"{k} {v:.3f}" for k, v in mean.items())
            + f" ms; peak allocated {peak:.3f} GiB; launches {launches} "
            f"(expected {want}); card {nvidia_smi()}")
        if launches != want:
            raise RuntimeError(f"{name} T = {T}: clip step launch counts "
                               f"{launches} != {want}")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        del state, batch, step_fn
        torch.cuda.empty_cache()
    results.setdefault("phase_launches", {})["30"] = launches_all


def phase_temporal_data(torch, results, root):
    """Phase 31: the test CLI with --video --eval --format-only on base_occ
    over the data root's 2 scenes, then the train CLI with --temporal-queue
    2 on turbo_occ for 2 steps and one more resumed."""
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.data.nuscenes import NuSceneOccDataset
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD, LIFT_BWD_INDEX
    from occnet_tpu_torch.ops.msda import MSDA
    from occnet_tpu_torch.ops.ray_march_vec import FAN, FAN_RENDER
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    from occnet_tpu_torch.tools import test as test_cli
    from occnet_tpu_torch.tools import train as train_cli
    cfg = apply_overrides(get_config("base_occ"), {"data.data_root": root})
    m = cfg.model
    kernels = {"msda": MSDA, "fan": FAN_RENDER, "fan_raw": FAN}
    for k in kernels.values():
        k.launches = 0
    marks = FrameMarks(torch, kernels)
    t = time.perf_counter()
    summary = test_cli.main([
        "--config", "base_occ", "--video", "--eval", "--format-only",
        "--work-dir", os.path.join(root, "work_video"), "--out",
        os.path.join(root, "video.gz"), "--set", f"data.data_root={root}",
        "data.val_ann=infos_val.pkl"], mark=marks)
    wall = time.perf_counter() - t
    launches = {k: v.launches for k, v in kernels.items()}
    frames = marks.frames()
    ks = summary["per_cam_topk"]
    want = {"msda": MINISET_FRAMES * m.encoder.num_layers
            * (1 + len(set(ks))), "fan": 2 * MINISET_FRAMES, "fan_raw": 0}
    scores = summary["scores"]
    ds = NuSceneOccDataset(cfg.data, os.path.join(root, "infos_val.pkl"),
                           training=False)
    gt_iou = gt_ray_iou(torch, cfg, ds.get_sample(0), "cuda")
    log(f"  test CLI --video (base_occ, {MINISET_FRAMES} frames in 2 scenes, "
        f"--eval --format-only) in {wall:.1f} s: auto top-K per camera {ks},"
        f" certificate {summary['overflow']}, scores {scores}; GT vs GT "
        f"RayIoU {gt_iou}; launches {launches} (expected {want}); card "
        f"{nvidia_smi()}")
    for i, f in enumerate(frames):
        log(f"    frame {i}: " + ", ".join(
            f"{st} {f[st][0]:.3f} / {f[st][1]:.3f}" for st in
            ("align", "forward", "render", "counts") if st in f)
            + " ms (CUDA events / host clock)")
    if summary["overflow"] != 0 or launches != want \
            or len(summary["tokens"]) != MINISET_FRAMES \
            or not all(np.isfinite(scores[k]) and 0 <= scores[k] <= 1
                       for k in ("RayIoU", "RayIoU@1", "RayIoU@2",
                                 "RayIoU@4")) \
            or abs(gt_iou - 1) > 1e-9 \
            or ["align" in f for f in frames] != [False, True, False, True]:
        raise RuntimeError("the test CLI's --video run is wrong")
    results.setdefault("phase_launches", {})["31"] = dict(launches)

    work = os.path.join(root, "work_temporal")
    argv = ["--config", "turbo_occ", "--work-dir", work, "--temporal-queue",
            "2", "--set", f"data.data_root={root}",
            "data.train_ann=infos_train.pkl"]
    kernels = {"lift": LIFT, "tap": TAP, "lift_bwd": LIFT_BWD,
               "lift_bwd_index": LIFT_BWD_INDEX, "tap_bwd": TAP_BWD}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    history = train_cli.main(argv + ["--max-steps", "2"])
    wall = time.perf_counter() - t
    tl = {k: v.launches for k, v in kernels.items()}
    L, E = m.num_feature_levels, m.encoder.num_layers
    want = {"lift": 2 * 2 * L, "tap": 2 * 2 * E, "lift_bwd": 2 * L,
            "lift_bwd_index": 2 * L, "tap_bwd": 2 * E}
    log(f"  train CLI --temporal-queue 2 (turbo_occ, 2 steps) in {wall:.1f} "
        f"s: {history}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
        f"{tl} (expected {want})")
    ck = torch.load(os.path.join(work, "ckpt.pt"), weights_only=True)
    if [h["step"] for h in history] != [0, 1] or tl != want \
            or not all(np.isfinite(h["loss"]) and h["cert_overflow"] == 0
                       for h in history) or ck["step"] != 2:
        raise RuntimeError("the train CLI's --temporal-queue run is wrong")
    LIFT_BWD.launches = LIFT.launches = 0
    resumed = train_cli.main(argv + ["--resume", "--max-steps", "3"])
    ck = torch.load(os.path.join(work, "ckpt.pt"), weights_only=True)
    log(f"  resumed: {resumed}; lift {LIFT.launches} / lift_bwd "
        f"{LIFT_BWD.launches} launches; checkpoint step {ck['step']}")
    if [h["step"] for h in resumed] != [2] or ck["step"] != 3 \
            or not np.isfinite(resumed[0]["loss"]) \
            or (LIFT.launches, LIFT_BWD.launches) != (2 * L, L):
        raise RuntimeError("the train CLI did not resume its clip training")
    for k, v in tl.items():
        results["phase_launches"]["31"][k] = v


# --- phases 32-35: the runtime (bench entry point, data parallelism over
# torch.distributed, the distributed CLIs) ---

REPO = os.path.dirname(os.path.abspath(__file__))
LAUNCH_TIMEOUT_S = 420   # each subprocess and torchrun launch of 32-35
DIST_STEP_CFGS = {"turbo_occ": ("lift", "tap", "lift_bwd", "tap_bwd"),
                  "turbo_occ_fp32": ("lift", "tap", "lift_bwd", "tap_bwd"),
                  "base_occ": ("msda", "msda_bwd")}


def run_cmd(cmd, label, env=None):
    """Run ``cmd`` from the repo root with the repo on PYTHONPATH; raises on
    a nonzero exit (a failed rank fails its launcher) or past
    LAUNCH_TIMEOUT_S.  Returns (stdout, seconds)."""
    full = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OCCNET_DIST_TIMEOUT_S="300",
        OMP_NUM_THREADS="4", **(env or {}))
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=full, capture_output=True,
                       text=True, timeout=LAUNCH_TIMEOUT_S)
    dt = time.perf_counter() - t
    if r.returncode != 0:
        raise RuntimeError(f"{label} failed (rc {r.returncode}):\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout, dt


def torchrun(n, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), *args]


def phase_bench(torch, results):
    """Phase 32: the speed entry point in its own process."""
    out, dt = run_cmd([sys.executable, "-m", "occnet_tpu_torch.tools.bench"],
                      "tools/bench.py", {"BENCH_ITERS": "20"})
    line = json.loads(out.strip().splitlines()[-1])
    log(f"  tools/bench.py in {dt:.1f} s: {json.dumps(line)}")
    keys = {"metric", "value", "unit", "vs_baseline", "device",
            "power_limit"}
    if not keys <= line.keys() or not line["value"] > 0 \
            or line["out_shape"] != [1, 200, 200, 16, 17]:
        raise RuntimeError(f"tools/bench.py printed {line}")
    results["runtime"]["bench"] = line


def dist_step_cfg(name):
    """``name`` with dropout 0 (a rank's dropout masks follow (seed, step,
    rank), so only a step without dropout is the B = N step); grid mask
    and photometric distortion stay on.  A ``_fp32`` suffix computes in
    float32."""
    from occnet_tpu_torch.config import apply_overrides, get_config
    fp32 = name.endswith("_fp32")
    return apply_overrides(get_config(name[:-5] if fp32 else name), {
        "model.encoder.ffn_dropout": "0", "model.encoder.tsa.dropout": "0",
        "model.encoder.sca.dropout": "0",
        **({"model.compute_dtype": "float32"} if fp32 else {})})


def dist_step_batch(cfg, batch_size):
    from occnet_tpu_torch.tools.train import make_synthetic_batch
    return make_synthetic_batch(cfg, batch_size, np.random.RandomState(0))


def kernel_counters(names):
    from occnet_tpu_torch.ops.lift_cuda import LIFT, LIFT_BWD
    from occnet_tpu_torch.ops.msda import MSDA, MSDA_BWD
    from occnet_tpu_torch.ops.tsa import TAP, TAP_BWD
    k = {"lift": LIFT, "tap": TAP, "lift_bwd": LIFT_BWD, "tap_bwd": TAP_BWD,
         "msda": MSDA, "msda_bwd": MSDA_BWD}
    return {n: k[n] for n in names}


def dist_step_rank(argv):
    """One rank of phase 33 (``chip_smoke.py dist-step OUT BACKEND
    CONFIGS``, under torchrun): for each config one step at B = 1 on this
    rank's part of the global batch (saved for the comparison: rank 0's
    parameters and gradients, every rank's metrics), then one more step
    timed (host ms, CUDA-event split with the gradient all-reduce, peak
    memory, hand-kernel launches), and how many leaves differ between the
    ranks."""
    import torch
    import torch.distributed as dist
    from occnet_tpu_torch import parallel
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.parallel.multihost import local_device, shutdown
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    out_dir, backend, names = argv[0], argv[1], argv[2].split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.initialize(backend)
    rank, world = parallel.process_shard()
    dev = local_device("cuda")
    res = {"world": world, "backend": backend, "device": str(dev)}
    try:
        for name in names:
            cfg = dist_step_cfg(name)
            state = create_train_state(cfg, from_jax_variables(
                init_jax_style_variables(cfg, seed=0)), dev)
            batch = parallel.global_batch(parallel.shard_batch(
                dist_step_batch(cfg, world), parallel.make_mesh()), dev)
            step = make_train_step(cfg, seed=0)
            met = {k: float(v) for k, v in step(state, batch).items()}
            r = {"metrics": met}
            if rank == 0:
                r["params"] = {n: p.detach().cpu() for n, p in
                               state.model.named_parameters()}
                r["grads"] = {n: p.grad.detach().float().cpu() for n, p in
                              state.model.named_parameters()
                              if p.grad is not None}
                r["buffers"] = {n: b.detach().cpu() for n, b in
                                state.model.named_buffers()}
            differ = 0
            for t in list(state.model.parameters()) + list(
                    state.model.buffers()):
                ref = t.detach().clone()
                if world > 1:
                    dist.broadcast(ref, 0)
                differ += int(not torch.equal(ref, t.detach()))
            r["differ"] = differ
            counters = kernel_counters(DIST_STEP_CFGS[name])
            for k in counters.values():
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = {"start": torch.cuda.Event(enable_timing=True)}

            def mark(label):
                ev[label] = torch.cuda.Event(enable_timing=True)
                ev[label].record()

            t = time.perf_counter()
            ev["start"].record()
            met2 = step(state, batch, mark)
            torch.cuda.synchronize()
            r["step_ms"] = (time.perf_counter() - t) * 1e3
            r["loss2"] = float(met2["loss"])
            order = ["start", "forward", "backward"] + (
                ["allreduce"] if world > 1 else []) + ["optimizer"]
            r["split_ms"] = {b: ev[a].elapsed_time(ev[b])
                             for a, b in zip(order, order[1:])}
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["launches"] = {k: v.launches for k, v in counters.items()}
            res[name] = r
            del state, batch
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        parallel.barrier()
    finally:
        shutdown()


def single_step(torch, name, batch_size):
    """The in-process step of `dist_step_rank` at B = ``batch_size``: (state
    after it, metrics, the initial state_dict on the host)."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.tools.train import to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    cfg = dist_step_cfg(name)
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    state = create_train_state(cfg, sd, "cuda")
    batch = dist_step_batch(cfg, batch_size)
    met = make_train_step(cfg, seed=0)(state, to_device(batch, "cuda"))
    return state, {k: float(v) for k, v in met.items()}, sd


def b2_reference(torch, name):
    """The in-process B = 2 step of ``name`` on the host: its metrics,
    gradients, first update (parameters after - before) and buffers."""
    state, met, sd = single_step(torch, name, 2)
    ref = {"metrics": met,
           "grads": {n: p.grad.detach().float().cpu() for n, p in
                     state.model.named_parameters() if p.grad is not None},
           "update": {n: p.detach().cpu() - sd[n] for n, p in
                      state.model.named_parameters()},
           "buffers": {n: b.detach().cpu() for n, b in
                       state.model.named_buffers()}, "sd": sd}
    del state
    torch.cuda.empty_cache()
    return ref


def step_distance(got, ref):
    """How far the world-2 step ``got`` (rank 0's record) lies from the
    B = 2 step ``ref``: per leaf |g - g_ref|max / |g_ref|max and the L2
    ratio, the whole gradient and the whole first update in relative L2,
    the grad norm and loss relative, the BN statistics' largest
    difference."""
    def l2(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    if got["grads"].keys() != ref["grads"].keys():
        raise RuntimeError("the world-2 and B = 2 steps give gradients to "
                           "different leaves")
    names = sorted(ref["grads"])
    leaf = {n: ((got["grads"][n] - ref["grads"][n]).abs().max().item()
                / max(ref["grads"][n].abs().max().item(), 1e-30),
                l2(got["grads"][n], ref["grads"][n])) for n in names}
    whole = torch_cat([got["grads"][n] for n in names])
    whole_ref = torch_cat([ref["grads"][n] for n in names])
    upd = torch_cat([got["params"][n] - ref["sd"][n] for n in names])
    upd_ref = torch_cat([ref["update"][n] for n in names])
    gm, rm = got["metrics"], ref["metrics"]
    return {"leaf": leaf, "grad_l2": l2(whole, whole_ref),
            "update_l2": l2(upd, upd_ref),
            "grad_norm": abs(gm["grad_norm"] - rm["grad_norm"])
            / rm["grad_norm"],
            "loss": abs(gm["loss"] - rm["loss"]) / abs(rm["loss"]),
            "stats": max((b - got["buffers"][n]).float().abs().max().item()
                         for n, b in ref["buffers"].items())}


def torch_cat(tensors):
    import torch
    return torch.cat([t.reshape(-1).float() for t in tensors])


def log_ranks(label, ranks, name):
    for i, r in enumerate(ranks):
        x = r[name]
        log(f"    {label} rank {i} ({r['backend']}, {r['device']}) {name}: "
            f"loss {x['metrics']['loss']:.6f} then {x['loss2']:.6f}; "
            f"timed step {x['step_ms']:.3f} ms host, device split "
            + ", ".join(f"{k} {v:.3f}" for k, v in x["split_ms"].items())
            + f" ms; peak {x['peak_gib']:.3f} GiB; launches "
            f"{x['launches']}; leaves differing from rank 0: "
            f"{x['differ']}")


def phase_dist_step(torch, results, tmp):
    """Phase 33: full-width steps at B = 1 a rank over torchrun: NCCL at
    world 1 against the in-process step (bitwise), gloo at world 2 with
    both ranks on the one card against the in-process B = 2 step, in fp32
    and in bf16, base_occ at world 2 over gloo (MSDA and its backward under
    the group); NCCL at world 2 where two cards show; and the entry
    point's dry run (`python -m occnet_tpu_torch.entry dryrun 2`) on the
    card.

    On the card a step is deterministic (the same B = 2 step twice is
    bitwise equal), so the world-2 step differs from the B = 2 step only
    by the order of its sums (B = 1 shapes, the statistics' and the
    gradients' all-reduces).  In fp32 that moves no leaf by more than
    1e-4 of its max (the B = 2 step with its samples swapped, augmentation
    off: 4.4e-5), and the fp32 world-2 step is held to phase 7's bounds:
    loss and BN statistics 1e-3, every leaf within GRAD_RTOL of its max;
    with the whole gradient within 1e-4 in L2 and the first update within
    1e-3 in L2 (tests/test_torch_parallel.py's bound), grad norm 1e-4.
    In bf16 the same reorderings flip bf16 roundings, and on leaves whose
    gradient is a sum that nearly cancels (|g|max ~ 1e-6 on some encoder
    leaves) that moves the gradient far beyond GRAD_RTOL.  So each bf16
    leaf's reach is measured: how far the bf16 B = 2 gradient lies from
    the fp32 one.  A leaf within GRAD_RTOL / 2 (the rounding does not
    reach it) is held to GRAD_RTOL; a leaf the rounding reaches is held to
    twice its reach (both bf16 steps approximate the same fp32 step), and
    so are the whole gradient, the first update and the grad norm; loss
    and statistics to 1e-3."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _dist_step_checks(torch, results, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _dist_step_checks(torch, results, tmp):
    runs = {}
    plan = [("nccl1", 1, "nccl", "turbo_occ"),
            ("gloo2", 2, "gloo", "turbo_occ,turbo_occ_fp32,base_occ")]
    if torch.cuda.device_count() >= 2:
        plan.append(("nccl2", 2, "nccl", "turbo_occ"))
    for label, n, backend, names in plan:
        out = os.path.join(tmp, label)
        os.makedirs(out)
        _, dt = run_cmd(torchrun(n, os.path.join(REPO, "chip_smoke.py"),
                                 "dist-step", out, backend, names),
                        f"the {label} launch")
        runs[label] = [torch.load(os.path.join(out, f"rank{r}.pt"),
                                  weights_only=False) for r in range(n)]
        log(f"  {label}: world {n}, {backend}, {names} in {dt:.1f} s")
        for name in names.split(","):
            log_ranks(label, runs[label], name)
    if torch.cuda.device_count() < 2:
        log("  NCCL at world 2 not run: the machine shows one card (NCCL "
            "takes one card a rank)")
    # NCCL world 1 against the in-process step: bitwise expected
    state, met, _ = single_step(torch, "turbo_occ", 1)
    got = runs["nccl1"][0]["turbo_occ"]
    same_p = sum(torch.equal(p.detach().cpu(), got["params"][n])
                 for n, p in state.model.named_parameters())
    same_b = sum(torch.equal(b.detach().cpu(), got["buffers"][n])
                 for n, b in state.model.named_buffers())
    n_p = len(got["params"])
    worst = max((p.detach().cpu() - got["params"][n]).abs().max().item()
                for n, p in state.model.named_parameters())
    log(f"  nccl1 vs in-process B = 1: loss {got['metrics']['loss']!r} vs "
        f"{met['loss']!r}, grad norm {got['metrics']['grad_norm']!r} vs "
        f"{met['grad_norm']!r}; {same_p}/{n_p} parameters and "
        f"{same_b}/{len(got['buffers'])} buffers bitwise equal (worst "
        f"|diff| {worst:.3e})")
    if got["metrics"] != met or same_p != n_p \
            or same_b != len(got["buffers"]):
        raise RuntimeError("the NCCL world-1 step is not the in-process step")
    del state
    torch.cuda.empty_cache()
    # gloo world 2 against the in-process B = 2 step, fp32 then bf16
    ranks = runs["gloo2"]
    ref32 = b2_reference(torch, "turbo_occ_fp32")
    d32 = step_distance(ranks[0]["turbo_occ_fp32"], ref32)
    ref16 = b2_reference(torch, "turbo_occ")
    d16 = step_distance(ranks[0]["turbo_occ"], ref16)
    # each bf16 leaf's reach: the bf16 B = 2 gradient against the fp32 one
    reach = step_distance({"grads": ref16["grads"], "metrics":
                           ref16["metrics"], "buffers": ref16["buffers"],
                           "params": {n: ref16["sd"][n] + u for n, u in
                                      ref16["update"].items()}}, ref32)
    held = {n: GRAD_RTOL if r[0] <= GRAD_RTOL / 2 else 2 * r[0]
            for n, r in reach["leaf"].items()}
    bad16 = [n for n, (e, _) in d16["leaf"].items() if e > held[n]]
    bad32 = [n for n, (e, _) in d32["leaf"].items() if e > GRAD_RTOL]

    def worst(d, k):
        n = max(d["leaf"], key=lambda n: d["leaf"][n][k])
        return f"{d['leaf'][n][k]:.3e} ({n})"

    for label, d in (("fp32", d32), ("bf16", d16), ("bf16 vs fp32 B = 2",
                                                    reach)):
        log(f"  gloo2 {label}: loss {d['loss']:.2e}, grad norm "
            f"{d['grad_norm']:.2e}, whole gradient L2 {d['grad_l2']:.3e}, "
            f"first update L2 {d['update_l2']:.3e}, BN statistics "
            f"{d['stats']:.3e}; worst leaf max {worst(d, 0)}, L2 "
            f"{worst(d, 1)}")
    n_reached = sum(h > GRAD_RTOL for h in held.values())
    log(f"  bf16 leaves the rounding reaches (bf16 B = 2 over GRAD_RTOL / 2 "
        f"from fp32): {n_reached}/{len(held)}, held to twice their reach; "
        f"the other {len(held) - n_reached} to GRAD_RTOL; over: {bad16}; "
        f"fp32 leaves over GRAD_RTOL: {bad32}")
    same_metrics = all(ranks[0][k]["metrics"] == ranks[1][k]["metrics"]
                       for k in ("turbo_occ", "turbo_occ_fp32", "base_occ"))
    ok32 = (d32["loss"] <= 1e-3 and d32["stats"] <= 1e-3 and not bad32
            and d32["grad_l2"] <= 1e-4 and d32["update_l2"] <= 1e-3
            and d32["grad_norm"] <= 1e-4)
    ok16 = (d16["loss"] <= 1e-3 and d16["stats"] <= 1e-3 and not bad16
            and d16["grad_l2"] <= 2 * reach["grad_l2"]
            and d16["update_l2"] <= 2 * reach["update_l2"]
            and d16["grad_norm"] <= 2 * reach["grad_norm"] + 1e-6)
    if not (ok32 and ok16 and same_metrics and all(
            r[k]["differ"] == 0 and r[k]["metrics"]["cert_overflow"] == 0
            for r in ranks for k in DIST_STEP_CFGS)):
        raise RuntimeError(f"the gloo world-2 step is not the B = 2 step "
                           f"(fp32 ok {ok32}, bf16 ok {ok16}, ranks' metrics "
                           f"equal {same_metrics})")
    results["runtime"]["dist_step_check"] = {
        k: {m: d[m] for m in ("loss", "grad_norm", "grad_l2", "update_l2",
                              "stats")} | {
            "worst_leaf_max": max(e for e, _ in d["leaf"].values()),
            "worst_leaf_l2": max(e for _, e in d["leaf"].values())}
        for k, d in (("fp32", d32), ("bf16", d16), ("bf16_vs_fp32", reach))}
    results["runtime"]["dist_step_check"]["bf16_leaves_reached"] = [
        n_reached, len(held)]
    del ref16, ref32
    # the dry run of the entry point, on the card (two ranks share it over
    # gloo where one card shows)
    out, dt = run_cmd([sys.executable, "-m", "occnet_tpu_torch.entry",
                       "dryrun", "2"], "the entry point's dry run")
    log(f"  entry dryrun 2 in {dt:.1f} s: " + "; ".join(
        out.strip().splitlines()))
    if out.count("on cuda:") != 3 or "OK" not in out:
        raise RuntimeError(f"the dry run did not run on the card:\n{out}")
    from occnet_tpu_torch.config import get_config
    m = get_config("turbo_occ").model
    n_exact = get_config("base_occ").model.encoder.num_layers
    want = {"turbo_occ": {"lift": m.num_feature_levels,
                          "tap": m.encoder.num_layers,
                          "lift_bwd": m.num_feature_levels,
                          "tap_bwd": m.encoder.num_layers},
            "base_occ": {"msda": 2 * n_exact, "msda_bwd": 2 * n_exact}}
    want["turbo_occ_fp32"] = want["turbo_occ"]
    for label, rs in runs.items():
        for name in want:
            for r in rs:
                if name in r and (r[name]["launches"] != want[name]
                                  or not np.isfinite(r[name]["loss2"])
                                  or r[name]["metrics"]["cert_overflow"]):
                    raise RuntimeError(
                        f"{label} {name}: launches {r[name]['launches']} "
                        f"!= {want[name]} or a non-finite loss / nonzero "
                        f"certificate")
    results["runtime"]["dist_step"] = {
        label: [{name: {k: r[name][k] for k in ("step_ms", "split_ms",
                                                 "peak_gib", "launches")}
                 for name in DIST_STEP_CFGS if name in r} for r in rs]
        for label, rs in runs.items()}


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_dist_train(torch, results, root, tmp):
    """Phase 34: dist_train.sh at world 1 (NCCL) on the data root, a
    one-frame train split (an epoch a step, so every step checkpoints),
    --distributed --profile 2, 4 steps: three checkpoints kept, the
    manager's metadata, metrics.jsonl in the JAX package's format with its
    "hbm" event, the trace naming the four hand kernels of the step and
    holding the spans' ``occ/`` ranges, the spans' summary beside it (the
    two profiled steps' items); then
    --resume from the step-2 checkpoint in a fresh work dir equal to the
    uninterrupted run."""
    import pickle
    import shutil
    with open(os.path.join(root, "infos_train.pkl"), "rb") as f:
        infos = pickle.load(f)
    infos["infos"] = infos["infos"][:1]
    with open(os.path.join(root, "infos_train1.pkl"), "wb") as f:
        pickle.dump(infos, f)
    script = os.path.join(REPO, "occnet_tpu_torch", "tools", "dist_train.sh")
    sets = ["--set", f"data.data_root={root}",
            "data.train_ann=infos_train1.pkl"]
    work = os.path.join(tmp, "dist_train")
    _, dt = run_cmd(["bash", script, "turbo_occ", "1", "--work-dir", work,
                     "--profile", "2", "--max-steps", "4", *sets],
                    "dist_train.sh")
    files = sorted(os.listdir(work))
    ck = torch.load(os.path.join(work, "ckpt.pt"), weights_only=True)
    ev = read_events(os.path.join(work, "metrics.jsonl"))
    listing = sorted(os.listdir(os.path.join(work, "trace")))
    traces = [t for t in listing if t.startswith("trace_")]
    summaries = [t for t in listing if t.startswith("spans_")]
    with open(os.path.join(work, "trace", traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    with open(os.path.join(work, "trace", summaries[0])) as f:
        roots = [it["root"] for it in json.load(f)]
    kern = {k: sum(s in n for n in names) for k, s in (
        ("lift", "lift_level_kernel"), ("tap", "tap_kernel<"),
        ("lift_bwd", "lift_bwd_kernel"), ("tap_bwd", "tap_bwd_kernel"))}
    hbm = [e for e in ev if e["tag"] == "hbm"]
    train = [e for e in ev if e["tag"] == "train"]
    log(f"  dist_train.sh (world 1, nccl, 4 steps, --profile 2) in "
        f"{dt:.1f} s: work dir {files}; ckpt.pt -> "
        f"{os.readlink(os.path.join(work, 'ckpt.pt'))} (step {ck['step']}, "
        f"env {ck['env']}); losses {[round(e['loss'], 4) for e in train]}; "
        f"hbm {hbm}; trace {traces[0]}: kernel names {kern}, "
        f"occ/train.step {'occ/train.step' in names}; spans {summaries}: "
        f"roots {roots}")
    steps = sorted(int(f[5:-3]) for f in files
                   if f.startswith("ckpt_") and f.endswith(".pt"))
    if steps != [2, 3, 4] or ck["step"] != 4 \
            or ck["env"]["world_size"] != 1 or "config" not in ck \
            or [e["step"] for e in train] != [0, 1, 2, 3] \
            or not all({"ts", "step", "tag", "loss", "grad_norm",
                        "s_per_it"} <= e.keys() for e in train) \
            or len(hbm) != 1 or not hbm[0]["peak_bytes_in_use"] > 0 \
            or len(traces) != 1 or not all(kern.values()) \
            or "occ/train.step" not in names or len(summaries) != 1 \
            or roots != ["train.step"] * 2:
        raise RuntimeError("dist_train.sh's run is not what it should be")
    resumed = os.path.join(tmp, "dist_train_resumed")
    os.makedirs(resumed)
    shutil.copy(os.path.join(work, "ckpt_2.pt"), resumed)
    _, dt = run_cmd(["bash", script, "turbo_occ", "1", "--work-dir", resumed,
                     "--resume", "--max-steps", "4", *sets],
                    "dist_train.sh --resume")
    ck2 = torch.load(os.path.join(resumed, "ckpt.pt"), weights_only=True)
    ev2 = read_events(os.path.join(resumed, "metrics.jsonl"))
    diff = max((a.float() - ck2["model"][n].float()).abs().max().item()
               for n, a in ck["model"].items())
    same = sum(torch.equal(a, ck2["model"][n]) for n, a in
               ck["model"].items())
    log(f"  --resume from ckpt_2.pt in {dt:.1f} s: steps "
        f"{[e['step'] for e in ev2 if e['tag'] == 'train']}, checkpoint "
        f"step {ck2['step']}; {same}/{len(ck['model'])} tensors bitwise "
        f"equal to the uninterrupted run's, worst |diff| {diff:.3e}")
    if ck2["step"] != 4 or [e["step"] for e in ev2 if e["tag"] == "train"] \
            != [2, 3] or diff > 1e-6:
        raise RuntimeError("--resume did not continue the run")
    results["runtime"]["dist_train"] = {"s_per_it": train[-1]["s_per_it"],
                                        "peak_bytes": hbm[0][
                                            "peak_bytes_in_use"]}
    return os.path.join(work, "ckpt.pt")


def phase_dist_test(torch, results, root, tmp, ckpt):
    """Phase 35: dist_test.sh at world 2 (gloo, both ranks on the one card)
    on the data root's 4 val frames with phase 34's checkpoint, --eval
    --format-only, against the single-process test CLI in its own process
    (the same torch defaults): the scores equal and the merged submission
    equal, token for token."""
    import gzip
    import pickle
    args = ["--eval", "--format-only", "--set", f"data.data_root={root}",
            "data.val_ann=infos_val.pkl"]
    dist_dir = os.path.join(tmp, "dist_test")
    script = os.path.join(REPO, "occnet_tpu_torch", "tools", "dist_test.sh")
    out, dt = run_cmd(["bash", script, "turbo_occ", ckpt, "2",
                       "--dist-backend", "gloo", "--work-dir", dist_dir,
                       "--out", os.path.join(dist_dir, "sub.gz"), *args],
                      "dist_test.sh")
    one_dir = os.path.join(tmp, "single_test")
    _, dt1 = run_cmd([sys.executable, "-m", "occnet_tpu_torch.tools.test",
                      "--config", "turbo_occ", "--checkpoint", ckpt,
                      "--work-dir", one_dir, "--out",
                      os.path.join(one_dir, "sub.gz"), *args],
                     "the single-process test CLI")
    scores, single = ({}, {})
    for d, into in ((dist_dir, scores), (one_dir, single)):
        with open(os.path.join(d, "eval_results.json")) as f:
            into.update(json.load(f))
    subs = []
    for d in (dist_dir, one_dir):
        with gzip.open(os.path.join(d, "sub.gz"), "rb") as f:
            subs.append(pickle.load(f))
    same = subs[0]["results"].keys() == subs[1]["results"].keys() and all(
        np.array_equal(subs[0]["results"][t][k], a)
        for t, e in subs[1]["results"].items() for k, a in e.items())
    eq = scores.keys() == single.keys() and all(
        (np.isnan(v) and np.isnan(scores[k])) or v == scores[k]
        for k, v in single.items())
    log(f"  dist_test.sh (world 2, gloo, one card) in {dt:.1f} s: "
        f"{scores}; the single-process CLI in {dt1:.1f} s: {single}; "
        f"scores equal {eq}; submissions "
        f"({len(subs[0]['results'])} tokens) equal {same}")
    if not (eq and same and len(subs[0]["results"]) == MINISET_FRAMES):
        raise RuntimeError("dist_test.sh differs from the single-process CLI")
    results["runtime"]["dist_test_s"] = dt


# --- phases 36-40: VoVNet, the detection path, the other renders ---

VOVNET_HW = (67, 93)     # odd: every stage's ceil-mode pool hangs off the edge
MODULE_RTOL = 1e-4       # card vs CPU, fp32 modules: x max|CPU|
DEPTH_RTOL = 1e-5        # expected depth and its gradient, card vs CPU
DECODER_Q = 900          # object queries of the detection decoder
DECODER_REPS = 20        # launches a timing at the decoder's tiny shape
RENDER_REPS = 20         # launches (calls) a timing of phase 40
DETECTION_DECODER_LAYERS = 6


def vovnet_cfg(spec, base="base_occ"):
    from occnet_tpu_torch.config import apply_overrides, get_config
    return apply_overrides(get_config(base), {
        "model.backbone.type": "vovnet", "model.backbone.vovnet_spec": spec})


def phase_vovnet_parity(torch):
    """Every VoVNet preset, fp32, at an odd input size on the card and on
    the CPU from the same random weights (the JAX initialisers, every norm
    and bias randomised): each output within MODULE_RTOL of max|CPU|."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables,
                                          randomize_variables)
    from occnet_tpu_torch.models.vovnet import VOVNET_SPECS, VoVNet
    x = torch.randn(2, 3, *VOVNET_HW, generator=torch.Generator()
                    .manual_seed(36))
    for spec in VOVNET_SPECS:
        sd = from_jax_variables(randomize_variables(
            init_jax_style_variables(vovnet_cfg(spec, "tiny_occ"), seed=1),
            seed=2))
        net = VoVNet(spec, (1, 2, 3), -1)
        net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()
                             if k.startswith("backbone.")})
        with torch.no_grad():
            want, _ = net(x)
            got, _ = net.cuda()(x.cuda())
        errs = []
        for g, w in zip(got, want):
            err = (g.cpu() - w).abs().max().item()
            scale = w.abs().max().item()
            errs.append(err / scale)
            if not (torch.isfinite(g).all() and err <= MODULE_RTOL * scale):
                raise RuntimeError(f"VoVNet {spec}: card {err} from the CPU "
                                   f"(max {scale})")
        log(f"  {spec} at {VOVNET_HW}: outputs "
            f"{[tuple(o.shape[1:]) for o in got]}, card vs CPU max|diff| / "
            f"max|CPU| {', '.join(f'{e:.2e}' for e in errs)}")


def phase_vovnet_serve_train(torch, results):
    """base_occ with a VoVNet-99-eSE trunk at full width, bf16: REQUESTS
    served requests (certificate 0, 8 msda launches each, latency, peak),
    then 1 warm-up + FULL_TRAIN_STEPS timed train steps through the CLI's
    step (config defaults): finite losses, 8 msda + 8 msda_bwd launches a
    step, the frozen stem and stage 2 moved by AdamW's decay alone (p (1 -
    lr wd), as optax decays them), every other leaf moved."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.ops.msda import MSDA, MSDA_BWD
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.tools.train import make_synthetic_batch, to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    cfg = vovnet_cfg("V-99-eSE")
    m = cfg.model
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    e2i = ring_rig(m, 1)
    pred = Predictor(cfg, sd, "cuda")
    n_params = sum(p.numel() for p in pred.model.backbone.parameters())
    rng = np.random.RandomState(37)
    reqs = [rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3),
                        dtype=np.uint8) for _ in range(REQUESTS + 1)]
    pred(reqs[0], e2i)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MSDA.launches = 0
    lat = []
    for imgs in reqs[1:]:
        t = time.perf_counter()
        occ, flow, logits = pred(imgs, e2i, with_logits=True)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        if not (torch.isfinite(logits).all() and torch.isfinite(flow).all()):
            raise RuntimeError("VoVNet base_occ: non-finite logits or flow")
        if pred.sca_topk_overflow != 0:
            raise RuntimeError(f"sca_topk_overflow {pred.sca_topk_overflow}")
    serve_launches = MSDA.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = REQUESTS * 2 * m.encoder.num_layers
    log(f"  serve base_occ + V-99-eSE ({n_params / 1e6:.2f}M trunk "
        f"parameters): {REQUESTS} requests, latency ms "
        f"{[round(x, 3) for x in lat]}, mean {sum(lat) / len(lat):.3f}; peak "
        f"allocated {peak:.3f} GiB; sca_topk_overflow "
        f"{pred.sca_topk_overflow}; msda launches {serve_launches} (expected "
        f"{want}); card {nvidia_smi()}")
    if serve_launches != want:
        raise RuntimeError(f"VoVNet serve: msda launches {serve_launches} != "
                           f"{want}")
    del pred
    torch.cuda.empty_cache()

    state = create_train_state(cfg, sd, "cuda")
    del sd
    batch = to_device(make_synthetic_batch(cfg, 1, np.random.RandomState(
        38)), "cuda")
    step_fn = make_train_step(cfg, seed=0)
    metrics = step_fn(state, batch)          # warm-up
    torch.cuda.synchronize()
    log(f"  warm-up step: loss {float(metrics['loss']):.4f}")
    wd = cfg.optim.weight_decay
    group_lr = {id(p): g for g in state.optimizer.param_groups
                for p in g["params"]}
    frozen = {n for n, _ in state.model.named_parameters()
              if n.startswith(("backbone.stem", "backbone.stage2_"))}
    torch.cuda.reset_peak_memory_stats()
    MSDA.launches = MSDA_BWD.launches = 0
    host = []
    for _ in range(FULL_TRAIN_STEPS):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        t = time.perf_counter()
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or int(metrics["cert_overflow"]) != 0:
            raise RuntimeError(f"VoVNet train step: loss {loss}, "
                               f"cert_overflow {metrics['cert_overflow']}")
        decayed = still = 0
        for n, p in state.model.named_parameters():
            lr = group_lr[id(p)]["lr"]
            if n in frozen:
                want_p = before[n].mul(1 - lr * wd)
                if not torch.allclose(p.detach(), want_p, rtol=1e-6, atol=0):
                    raise RuntimeError(f"frozen {n} moved otherwise than "
                                       f"AdamW's decay")
                decayed += int(torch.equal(p.detach(), want_p))
            elif torch.equal(p.detach(), before[n]):
                still += 1
        log(f"  step {state.step - 1}: loss {loss:.4f}, host "
            f"{host[-1]:.3f} ms; {len(frozen)} frozen leaves moved by the "
            f"decay alone ({decayed} bitwise p (1 - lr wd)); live leaves "
            f"unchanged: {still}")
        if still:
            raise RuntimeError(f"{still} trainable leaves did not move")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = 2 * m.encoder.num_layers
    launches = {"msda": MSDA.launches, "msda_bwd": MSDA_BWD.launches}
    log(f"  train base_occ + V-99-eSE: {FULL_TRAIN_STEPS} steps, host ms "
        f"{[round(x, 3) for x in host]}, mean "
        f"{sum(host) / len(host):.3f}; peak allocated {peak:.3f} GiB; "
        f"launches {launches} (expected {per_step} each a step); card "
        f"{nvidia_smi()}")
    if launches != {k: per_step * FULL_TRAIN_STEPS for k in launches}:
        raise RuntimeError(f"VoVNet train launches {launches}")
    results["vovnet"] = {"serve_msda": serve_launches,
                         "train_msda_bwd": launches["msda_bwd"]}
    del state, batch
    torch.cuda.empty_cache()


def decoder_locations(torch, gen, ref_kind, Q, H, P, hw):
    """Sampling locations of the detection decoder's cross-attention at
    (1, Q, H, 1, P, 2): point references in [-0.1, 1.1]^2 plus offsets of
    a few cells (/ (w, h)), or box references (cx, cy in [-0.1, 1.1], w, h
    in [0, 0.1]) plus offsets / P * (w, h) * 0.5; a share of the samples
    lies off the map."""
    dev = torch.device("cuda")
    h, w = hw
    off = torch.randn(1, Q, H, 1, P, 2, generator=gen, device=dev) * 4.0
    ref = torch.rand(1, Q, 2, generator=gen, device=dev) * 1.2 - 0.1
    if ref_kind == "point":
        norm = torch.tensor([w, h], dtype=torch.float32, device=dev)
        return (ref[:, :, None, None, None, :] + off / norm).contiguous()
    wh = torch.rand(1, Q, 2, generator=gen, device=dev) * 0.1
    return (ref[:, :, None, None, None, :] + off / torch.tensor(
        float(P), device=dev) * wh[:, :, None, None, None, :] * 0.5
            ).contiguous()


def phase_detection_kernels(torch, results):
    """msda.cu and msda_bwd.cu at the detection decoder's shape: value (1,
    200 x 200, 8, 32), Q = 900, one level, 4 points, point and box
    references with samples off the map, bf16 and f32: the forward against
    msda_plain (phase 9's tolerances), the backward against
    msda_backward_plain (BWD_*_TOL x max|plain|, dloc / dattn bitwise over
    two launches), each timed in turns with the plain version against its
    bound, which reads only the value rows the samples touch."""
    from occnet_tpu_torch.ops import msda
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(38)
    H, D, P, shapes = 8, 32, 4, [(200, 200)]
    V = 200 * 200
    v32 = torch.randn(1, V, H, D, generator=gen, device="cuda")
    attn = torch.softmax(torch.randn(1, DECODER_Q, H, P, generator=gen,
                                     device="cuda"), -1
                         ).reshape(1, DECODER_Q, H, 1, P).contiguous()
    g32 = torch.randn(1, DECODER_Q, H * D, generator=gen, device="cuda")
    fwd = {"worst": 0.0}
    bwd = {"worst": 0.0}
    for kind in ("point", "box"):
        loc = decoder_locations(torch, gen, kind, DECODER_Q, H, P, (200, 200))
        x = loc[..., 0] * 200 - 0.5
        y = loc[..., 1] * 200 - 0.5
        off_map = ((x <= -1) | (x >= 200) | (y <= -1) | (y >= 200)
                   ).float().mean().item()
        for dtype in (torch.bfloat16, torch.float32):
            v, g = v32.to(dtype), g32.to(dtype)
            got = msda.msda_cuda(v, shapes, loc, attn)
            want = msda.msda_plain(v, shapes, loc, attn)
            torch.cuda.synchronize()
            bitwise = torch.equal(got, want)
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            bound = (MSDA_BF16_TOL + MSDA_BF16_TOL * want.abs()
                     if dtype == torch.bfloat16
                     else MSDA_F32_ATOL + MSDA_F32_RTOL * want.abs())
            err = diff.max().item()
            log(f"  msda decoder {kind} references {dtype}: {off_map:.1%} of "
                f"samples off the map; max|kernel-plain| {err:.3e}, bitwise "
                f"{bitwise}")
            if not (bool((diff <= bound).all())
                    and bool(torch.isfinite(got).all())):
                raise RuntimeError(f"msda kernel disagrees with plain at the "
                                   f"decoder shape ({kind}, {dtype})")
            fwd["worst"] = max(fwd["worst"], err)
            k, p = in_turns(torch, lambda: msda.msda_cuda(v, shapes, loc,
                                                          attn),
                            lambda: msda.msda_plain(v, shapes, loc, attn),
                            DECODER_REPS)
            b_ms, by = msda_bound(torch, v, shapes, loc, attn)
            touched = msda_touched(torch, v, shapes, loc)[0]
            log(f"  msda decoder {kind} {dtype}: kernel {k:.4f} ms, plain "
                f"{p:.4f} ms, bound {b_ms:.4f} ms ({by}, {b_ms / k:.1%}; "
                f"value rows touched {touched / 1e6:.2f} MB of "
                f"{nbytes(v) / 1e6:.2f} MB)")
            tol = BWD_BF16_TOL if dtype == torch.bfloat16 else BWD_F32_TOL
            worst, t, bb_ms = msda_bwd_case(
                torch, f"msda_bwd decoder {kind} value {tuple(v.shape)} "
                f"{dtype}, Q={DECODER_Q}, L=1, P={P}", v, shapes, loc, attn,
                g, tol, reps=DECODER_REPS)
            bwd["worst"] = max(bwd["worst"], worst)
            if dtype == torch.bfloat16 and kind == "point":
                fwd.update(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=by)
                bwd.update(ms=t["kernel"], plain_ms=t["plain"],
                           bound_ms=bb_ms)
    results["msda"]["decoder_shape"] = {
        "shape": "value (1, 40000, 8, 32) bf16, Q 900, L 1, P 4, point "
                 "references", "max_abs_err": fwd.pop("worst"), **fwd}
    results["msda_bwd"]["decoder_shape"] = {
        "shape": "value (1, 40000, 8, 32) bf16, Q 900, L 1, P 4, point "
                 "references", "max_abs_err": bwd.pop("worst"), **bwd,
        "bound_by": "bytes"}


def perception_model(torch, m, num_query, layers, dtype, seed):
    """A PerceptionTransformer with the JAX initialisers' random weights
    (every zero kernel and identity norm randomised), eval mode."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_perception_variables,
                                          randomize_variables)
    from occnet_tpu_torch.models.perception import PerceptionTransformer
    pt = PerceptionTransformer(m, num_query=num_query, decoder_layers=layers,
                               dtype=dtype)
    pt.load_state_dict(from_jax_variables(randomize_variables(
        init_jax_style_perception_variables(m, num_query=num_query,
                                            decoder_layers=layers,
                                            seed=seed), seed=seed + 1)))
    return pt.eval()


def can_bus_and_prev(torch, m, batch, seed):
    """A can-bus signal (the ego 1.5 m ahead, 0.3 rad of yaw, the prev BEV
    turned by 10 degrees) and a random prev BEV, float32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    cb = torch.zeros(batch, 18)
    cb[:, 0], cb[:, 1], cb[:, -2], cb[:, -1] = 1.5, -0.5, 0.3, 10.0
    return cb, torch.randn(batch, m.bev_h * m.bev_w, m.embed_dims,
                           generator=gen)


def phase_detection(torch, results):
    """The detection path.  Small, fp32, card vs CPU: PerceptionTransformer
    at tests/test_torch_detection.py's sizes with and without can-bus /
    prev BEV, every output within MODULE_RTOL of max|CPU|, certificates 0.
    Full width, bf16: base_occ's R50 + FPN features of 6 x 928 x 1600
    uint8 images -> PerceptionTransformer at base_occ's widths (200 x 200
    BEV, 256 channels, 4 encoder layers, 900 queries, 6 decoder layers)
    with can-bus and a prev BEV (the first request's BEV) ->
    decode_layer_boxes of the last layer -> nms_free_decode (300 boxes) on
    a stand-in classifier: REQUESTS timed requests, the certificate raised
    on when nonzero, 8 + 6 msda launches each, a CUDA-event split."""
    from occnet_tpu_torch.config import apply_overrides, tiny_occ
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.pipeline import make_device_normalizer
    from occnet_tpu_torch.models.bbox import (decode_layer_boxes,
                                              nms_free_decode)
    from occnet_tpu_torch.models.detector import OccNet
    from occnet_tpu_torch.ops.msda import MSDA
    small = apply_overrides(tiny_occ(), {
        "model.img_h": "32", "model.img_w": "48", "model.bev_h": "8",
        "model.bev_w": "8", "model.pillar_h": "2", "model.embed_dims": "32",
        "model.num_cams": "2", "model.num_feature_levels": "2",
        "model.compute_dtype": "float32", "model.encoder.num_layers": "1",
        "model.encoder.ffn_dim": "64",
        "model.encoder.num_points_in_pillar": "2",
        "model.encoder.sca.num_levels": "2"}).model
    pt = perception_model(torch, small, 12, 2, torch.float32, 40)
    gen = torch.Generator().manual_seed(41)
    feats = [torch.randn(1, 2, 8, 12, 32, generator=gen),
             torch.randn(1, 2, 4, 6, 32, generator=gen)]
    e2i = torch.from_numpy(ring_rig(small, 1, spacing=np.pi) @ np.array(
        [[np.cos(0.3), -np.sin(0.3), 0, 0], [np.sin(0.3), np.cos(0.3), 0, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]], np.float32))
    cb, prev = can_bus_and_prev(torch, small, 1, 42)
    for kw in ({}, {"can_bus": cb, "prev_bev": prev}):
        with torch.no_grad():
            want = pt(feats, e2i, **kw)
            got = pt.cuda()([f.cuda() for f in feats], e2i.cuda(),
                            **{k: v.cuda() for k, v in kw.items()})
            pt.cpu()
        errs = []
        for g, w in zip(got[:4], want[:4]):
            err = (g.cpu() - w).abs().max().item()
            errs.append(err / w.abs().max().item())
            if err > MODULE_RTOL * w.abs().max().item():
                raise RuntimeError(f"PerceptionTransformer card vs CPU: "
                                   f"{err}")
        if int(got[4]) or int(want[4]):
            raise RuntimeError("small PerceptionTransformer certificate")
        what = "with can-bus + prev BEV" if kw else "single frame"
        log(f"  small PerceptionTransformer fp32 {what}: card vs CPU "
            f"max|diff| / max|CPU| (bev, states, init ref, refs) "
            f"{', '.join(f'{e:.2e}' for e in errs)}")
    del pt

    cfg = exact_cfg("base_occ")
    m = cfg.model
    dev = torch.device("cuda")
    occ = OccNet(m)
    occ.load_state_dict(from_jax_variables(init_jax_style_variables(
        cfg, seed=0)))
    trunk = occ.to(dev).eval()
    normalize = make_device_normalizer(cfg.data)
    pt = perception_model(torch, m, DECODER_Q, DETECTION_DECODER_LAYERS,
                          torch.bfloat16, 43).to(dev)
    n_cls = 10
    w_cls = (torch.randn(m.embed_dims, n_cls, generator=torch.Generator()
                         .manual_seed(44)) * m.embed_dims ** -0.5).to(dev)
    e2i = torch.from_numpy(ring_rig(m, 1)).to(dev)
    cb, _ = can_bus_and_prev(torch, m, 1, 45)
    cb = cb.to(dev)
    post_center = [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0]
    marks = {}

    def mark(label):
        marks[label] = torch.cuda.Event(enable_timing=True)
        marks[label].record()

    hooks = [pt.decoder.register_forward_pre_hook(
                 lambda *_: mark("encoder")),
             pt.decoder.register_forward_hook(lambda *_: mark("decoder"))]

    @torch.inference_mode()
    def request(imgs, prev=None):
        mark("start")
        feats, _ = trunk.extract_img_feat(normalize(
            torch.from_numpy(imgs).to(dev, non_blocking=True)))
        mark("trunk+fpn")
        bev, states, ref, refs, overflow = pt(feats, e2i, cb, prev)
        if int(overflow):
            raise RuntimeError(f"sca_topk_overflow {int(overflow)}: the "
                               f"detection request is not the exact model's")
        lvl = DETECTION_DECODER_LAYERS - 1
        codes = pt.reg_branches[lvl](states[lvl])
        boxes = decode_layer_boxes(codes, lvl, ref, refs, m.pc_range)
        det = nms_free_decode(states[lvl, 0].float() @ w_cls, boxes[0],
                              post_center, max_num=300)
        mark("decode")
        if tuple(states.shape) != (DETECTION_DECODER_LAYERS, 1, DECODER_Q,
                                   m.embed_dims):
            raise RuntimeError(f"inter_states {tuple(states.shape)}")
        return bev, refs, det

    rng = np.random.RandomState(46)
    reqs = [rng.randint(0, 256, (1, m.num_cams, 900, 1600, 3),
                        dtype=np.uint8) for _ in range(REQUESTS + 1)]
    prev, _, _ = request(reqs[0])            # warm-up; its BEV is the history
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MSDA.launches = 0
    lat, splits = [], []
    for imgs in reqs[1:]:
        t = time.perf_counter()
        bev, refs, det = request(imgs, prev)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        names = list(marks)
        splits.append({b: marks[a].elapsed_time(marks[b])
                       for a, b in zip(names, names[1:])})
        if not (torch.isfinite(bev.float()).all()
                and torch.isfinite(det["bboxes"]).all()
                and bool(((refs >= 0) & (refs <= 1)).all())):
            raise RuntimeError("detection request: non-finite output or a "
                               "reference off [0, 1]")
        if tuple(det["bboxes"].shape) != (300, 9) \
                or int(det["labels"].max()) >= n_cls:
            raise RuntimeError(f"detection decode: {det['bboxes'].shape}")
    launches = MSDA.launches
    want = REQUESTS * (2 * m.encoder.num_layers + DETECTION_DECODER_LAYERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean = {k: sum(s[k] for s in splits) / len(splits) for k in splits[0]}
    log(f"  detection, base_occ widths, bf16: {REQUESTS} requests, host ms "
        f"{[round(x, 3) for x in lat]}, mean {sum(lat) / len(lat):.3f}; "
        f"CUDA-event split (mean ms) "
        f"{', '.join(f'{k} {v:.3f}' for k, v in mean.items())}; peak "
        f"allocated {peak:.3f} GiB; {int(det['valid'].sum())} of 300 boxes "
        f"in the centre range; msda launches {launches} (expected {want}); "
        f"card {nvidia_smi()}")
    if launches != want:
        raise RuntimeError(f"detection msda launches {launches} != {want}")
    results["msda"]["detection_launches"] = launches
    for h in hooks:
        h.remove()
    del trunk, pt, occ
    torch.cuda.empty_cache()


def render_scene():
    """tests/test_torch_render_extra.py's 200 x 200 x 16 grid (1 %
    occupied), its prediction (0.2 % of the voxels changed), random flow,
    the lidar fan and two ego origins."""
    from occnet_tpu_torch.evaluation.ray_metrics import generate_lidar_rays
    rng = np.random.RandomState(1)
    sem = np.full((200, 200, 16), 16, np.int32)
    blob = rng.rand(200, 200, 16) < 0.01
    sem[blob] = rng.randint(0, 16, int(blob.sum()))
    pred = sem.copy()
    flip = rng.rand(200, 200, 16) < 0.002
    pred[flip] = rng.randint(0, 17, int(flip.sum()))
    flow = rng.randn(200, 200, 16, 2).astype(np.float32)
    origins = np.array([[0.5, 0.3, 1.8], [5.0, -3.0, 1.9]], np.float32)
    return sem, pred, flow, generate_lidar_rays(), origins


def phase_renders(torch, results):
    """render_sample (the dda kernel's raw epilogue, one launch for both
    origins' 14,040 rays) and render_sample_fast (the fan kernel's render
    epilogue, one launch for both origins) on the card against the same
    functions on the CPU (their plain versions: labels and flow equal, dist
    within DIST_RTOL), the fast render also against render_pred_gt on the
    card; each kernel timed over RENDER_REPS launches in turns with its
    plain version on the card, against its bound.  render_expected_depth
    at 200 x 200 x 16 (one origin, the fan's 14,040 rays to random ranges)
    and the gradient of render_depth_loss, card vs CPU within DEPTH_RTOL of
    max|CPU|, each arm timed over RENDER_REPS calls after a warm-up, and
    one call of each under torch.profiler: its kernel launches and the
    device's busy time against the call's span."""
    from occnet_tpu_torch.evaluation import ray_metrics as rm
    from occnet_tpu_torch.ops import ray_march, ray_march_vec, render_diff
    from occnet_tpu_torch.tools.profile_turbo import device_profile
    sem, pred, flow, rays, origins = render_scene()
    valid = np.array([True, True])
    T, R = origins.shape[0], rays.shape[0]
    dev = torch.device("cuda")
    grids = {k: (torch.from_numpy(a), torch.from_numpy(a).to(dev))
             for k, a in (("sem", sem), ("pred", pred), ("flow", flow))}

    def held(label, got, want, atol, rtol):
        """labels, valid and flow equal; |dist diff| <= atol + rtol |want|;
        returns max|dist diff|."""
        for k in ("label", "valid", "flow"):
            if not torch.equal(got[k].cpu(), want[k].cpu()):
                raise RuntimeError(f"{label}: {k} differs")
        w = want["dist"].cpu()
        d = (got["dist"].cpu() - w).abs()
        if not bool((d <= atol + rtol * w.abs()).all()):
            raise RuntimeError(f"{label}: dist {d.max().item()}")
        return d.max().item()

    ray_march.DDA.launches = 0
    got = rm.render_sample(grids["sem"][1], grids["flow"][1], rays, origins,
                           valid)
    torch.cuda.synchronize()
    dda_launches = ray_march.DDA.launches
    t = time.perf_counter()
    want = rm.render_sample(grids["sem"][0], grids["flow"][0], rays, origins,
                            valid)
    cpu_s = time.perf_counter() - t
    err = held("render_sample", got, want, 0.0, DIST_RTOL)
    o = torch.from_numpy(rm._origins_vox(origins, 0.4, rm._PC_RANGE)).to(dev)
    d = torch.from_numpy(rays).to(dev)
    occ = grids["sem"][1] != rm.FREE_ID
    o_r = o[:, None].expand(T, R, 3).reshape(T * R, 3).contiguous()
    d_r = d[None].expand(T, R, 3).reshape(T * R, 3).contiguous()
    k_ms, p_ms = in_turns(
        torch, lambda: ray_march.dda_raymarch_cuda(occ, o_r, d_r, 448),
        lambda: ray_march.dda_raymarch_plain(occ, o_r, d_r, 448),
        RENDER_REPS)
    # steps this run's rays take: the voxels between start and end, + 1
    _, coord, _ = ray_march.dda_raymarch_cuda(occ, o_r, d_r, 448)
    n_steps = int(((coord - torch.floor(o_r).int()).abs().sum(1) + 1).sum())
    b_ms, by = least_time(nbytes(o_r, d_r) + occ.numel()
                          + T * R * (4 + 12 + 1),
                          n_steps * DDA_OPS_PER_STEP)
    log(f"  render_sample {T} x {R} rays, 448 steps: card vs CPU labels and "
        f"flow equal, max|dist diff| {err:.3e} m; {dda_launches} dda kernel "
        f"launch; raw kernel {k_ms:.4f} ms, plain on the card {p_ms:.4f} ms "
        f"(CPU {cpu_s * 1e3:.1f} ms), bound {b_ms:.4f} ms ({by}, "
        f"{n_steps / (T * R):.1f} steps a ray)")
    if dda_launches != 1:
        raise RuntimeError(f"render_sample: {dda_launches} dda launches")
    results["ray_march_dda"]["render_sample"] = {
        "launches": dda_launches, "ms": k_ms, "plain_ms": p_ms,
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": by}

    ray_march_vec.FAN_RENDER.launches = 0
    fast = rm.render_sample_fast(grids["pred"][1], grids["flow"][1], rays,
                                 origins, valid)
    torch.cuda.synchronize()
    fan_launches = ray_march_vec.FAN_RENDER.launches
    want = rm.render_sample_fast(grids["pred"][0], grids["flow"][0], rays,
                                 origins, valid)
    err = held("render_sample_fast", fast, want, 0.0, DIST_RTOL)
    p, _ = rm.render_pred_gt(grids["pred"][1], grids["flow"][1],
                             grids["sem"][1], grids["flow"][1], rays,
                             origins, valid)
    err_vec = held("render_sample_fast vs render_pred_gt", fast, p, 0.0,
                   DIST_RTOL)
    az, dz, scale = rm.FAN_TABLES(rays, 360, dev)
    sem_p, flow_p = grids["pred"][1], grids["flow"][1]
    rfa = ([sem_p], [flow_p], o, az, dz, scale, 0.4, rm.FREE_ID)
    k_ms, p_ms = in_turns(
        torch, lambda: ray_march_vec.fan_render_cuda(*rfa),
        lambda: ray_march_vec.fan_render_plain(*rfa), RENDER_REPS)
    # crossings this run's rays take (phase 16's count); origins, fan
    # tables and packed columns in, each ray's end voxel's label and flow
    # read, dist / label / flow out
    _, coord, _ = ray_march_vec.dda_raymarch_fan_vec_cuda(
        (sem_p != rm.FREE_ID)[None], o, az, dz, scale)
    v0 = torch.floor(o[:, :2]).int()[None, :, None, None]
    crossings = int(((coord[..., :2] - v0).abs().sum(-1) + 1).sum())
    b_ms, by = least_time(
        nbytes(o, az, dz, scale) + sem_p.shape[0] * sem_p.shape[1] * 4
        + T * R * (4 + 4 + 8 + sem_p.element_size()
                   + 2 * flow_p.element_size()),
        crossings * FAN_OPS_PER_CROSSING)
    log(f"  render_sample_fast {T} x {R} rays: card vs CPU labels and flow "
        f"equal, max|dist diff| {err:.3e} m; against render_pred_gt on the "
        f"card max|dist diff| {err_vec:.3e} m; {fan_launches} fan kernel "
        f"launch; kernel {k_ms:.4f} ms, plain on the card {p_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({by}, {crossings / (T * R):.1f} crossings a "
        f"ray)")
    if fan_launches != 1:
        raise RuntimeError(f"render_sample_fast: {fan_launches} launches")
    results["ray_march_fan"]["render_sample_fast"] = {
        "launches": fan_launches, "ms": k_ms, "plain_ms": p_ms,
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": by}

    rng = np.random.RandomState(47)
    sigma = (rng.rand(1, 200, 200, 16) * 0.3).astype(np.float32)
    origin = np.array([[100.3, 99.6, 5.2]], np.float32)
    pts = (origin + rays * rng.uniform(5, 60, (R, 1))).astype(np.float32)
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        s = torch.from_numpy(sigma).to(device).requires_grad_(True)
        args = (torch.from_numpy(origin).to(device),
                torch.from_numpy(pts).to(device))
        pd, gd = render_diff.render_expected_depth(s, *args)
        render_diff.render_depth_loss(s, *args).backward()
        out[name] = (pd.detach().cpu(), gd.cpu(), s.grad.cpu())
    errs = []
    for a, b, label in zip(out["card"], out["cpu"], ("pred", "gt", "grad")):
        e = (a - b).abs().max().item()
        errs.append(f"{label} {e:.3e} of max {b.abs().max().item():.3e}")
        if not (torch.isfinite(a).all() and e <= DEPTH_RTOL
                * b.abs().max().item()):
            raise RuntimeError(f"render_expected_depth card vs CPU: {label}")
    s = torch.from_numpy(sigma).to(dev).requires_grad_(True)
    args = (torch.from_numpy(origin).to(dev), torch.from_numpy(pts).to(dev))

    def fwd_bwd():
        s.grad = None
        render_diff.render_depth_loss(s, *args).backward()

    def fwd():
        with torch.no_grad():
            render_diff.render_expected_depth(s, *args)

    t = turns(torch, {"forward": fwd, "forward + backward": fwd_bwd},
              RENDER_REPS)
    prof = {}
    for label, fn in (("forward", fwd), ("forward + backward", fwd_bwd)):
        t0 = time.perf_counter()
        dp = prof[label] = device_profile(fn)
        log(f"    {label} under torch.profiler: "
            f"{sum(dp['n_by_name'].values())} kernel launches, device busy "
            f"{dp['busy_ms']:.3f} ms of a {dp['span_ms']:.3f} ms span "
            f"(host clock {(time.perf_counter() - t0) * 1e3:.1f} ms)")
    log(f"  render_expected_depth + gradient, 200 x 200 x 16, {R} rays: card "
        f"vs CPU max|diff| {', '.join(errs)}; {(out['card'][0] >= 0).sum()} "
        f"rays enter; card forward (no grad) {t['forward']:.3f} ms, "
        f"forward + backward {t['forward + backward']:.3f} ms")
    results["render_diff"] = {
        "ms": t["forward + backward"], "forward_ms": t["forward"],
        "launches": {k: sum(dp["n_by_name"].values())
                     for k, dp in prof.items()},
        "busy_ms": {k: dp["busy_ms"] for k, dp in prof.items()}}



# --- phases 41-42: BEV-query sharding over a model axis, the soak report ---

QSHARD_MP = 2                # model ranks of phase 41 (gloo, one card)
QSHARD_CFGS = {"turbo_occ": ("lift", "tap", "lift_bwd", "tap_bwd"),
               "base_occ": ("msda", "msda_bwd")}
QSHARD_RTOL = 1e-3           # loss and BN statistics, sharded vs unsharded
SOAK_SCENES, SOAK_STEPS = 4, 8   # phase 42: two epochs, an eval after each


def qshard_cfg(name):
    """``name`` with its BEV queries sharded over the model axis
    (``bev_shard_axis = "model"``, ``parallel.mp = 2``), the config's
    dropout and grid mask on."""
    from occnet_tpu_torch.config import apply_overrides, get_config
    return apply_overrides(get_config(name), {
        "model.bev_shard_axis": "model", "parallel.mp": str(QSHARD_MP)})


def timed_step(torch, step, state, batch, counters):
    """One more step of ``step``, timed: host ms, the CUDA-event split by
    the step's marks with the halo / gather collectives inside the forward
    and the backward taken apart (`parallel.qshard.collective_events`),
    peak GiB of the step and the hand kernels' launches."""
    from occnet_tpu_torch.parallel.qshard import collective_events
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [("start", torch.cuda.Event(enable_timing=True), 0)]
    with collective_events() as events:
        def mark(label):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append((label, e, len(events)))

        t = time.perf_counter()
        ev[0][1].record()
        met = step(state, batch, mark)
        torch.cuda.synchronize()
    host = (time.perf_counter() - t) * 1e3
    split = {}
    for (_, a, na), (label, b, nb) in zip(ev, ev[1:]):
        coll = sum(s.elapsed_time(e) for s, e in events[na:nb])
        split[label] = a.elapsed_time(b) - coll
        if coll:
            split[f"{label} collectives"] = coll
    return {"step_ms": host, "split_ms": split, "loss2": float(met["loss"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: v.launches for k, v in counters.items()}}


def qshard_step_rank(argv):
    """One rank of phase 41 (``chip_smoke.py qshard-step OUT CONFIGS``,
    under torchrun: 2 gloo ranks sharing the card, dp = 1 x mp = 2): for
    each config one step with the BEV queries sharded on the B = 1 batch
    (rank 0 saves its gradients, parameters and buffers; every rank its
    metrics and how many leaves differ from rank 0's), then one more step
    timed (`timed_step`)."""
    import torch
    import torch.distributed as dist
    from occnet_tpu_torch import parallel
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.parallel.multihost import local_device, shutdown
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    out_dir, names = argv[0], argv[1].split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.initialize("gloo")
    rank, world = parallel.process_shard()
    dev = local_device("cuda")
    mesh = parallel.make_mesh(1, QSHARD_MP)
    res = {"world": world, "device": str(dev),
           "mesh": (mesh.dp, mesh.mp, mesh.data_rank, mesh.model_rank)}
    try:
        for name in names:
            cfg = qshard_cfg(name)
            state = create_train_state(cfg, from_jax_variables(
                init_jax_style_variables(cfg, seed=0)), dev)
            batch = parallel.global_batch(parallel.shard_batch(
                dist_step_batch(cfg, 1), mesh), dev)
            step = make_train_step(cfg, seed=0, mesh=mesh)
            r = {"metrics": {k: float(v) for k, v in
                             step(state, batch).items()}}
            if rank == 0:
                r["params"] = {n: p.detach().cpu() for n, p in
                               state.model.named_parameters()}
                r["grads"] = {n: p.grad.detach().float().cpu() for n, p in
                              state.model.named_parameters()
                              if p.grad is not None}
                r["buffers"] = {n: b.detach().cpu() for n, b in
                                state.model.named_buffers()}
            differ = 0
            for t in list(state.model.parameters()) + list(
                    state.model.buffers()):
                ref = t.detach().clone()
                dist.broadcast(ref, 0)
                differ += int(not torch.equal(ref, t.detach()))
            r["differ"] = differ
            r.update(timed_step(torch, step, state, batch,
                                kernel_counters(QSHARD_CFGS[name])))
            res[name] = r
            del state, batch
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        parallel.barrier()
    finally:
        shutdown()


def qshard_reference(torch, name):
    """The in-process unsharded step of `qshard_step_rank` (a one-rank
    layout) on the same weights and batch: its metrics, gradients, first
    update, buffers, and one more step timed."""
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.parallel import Mesh
    from occnet_tpu_torch.tools.train import to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    cfg = qshard_cfg(name)
    sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    state = create_train_state(cfg, sd, "cuda")
    batch = to_device(dist_step_batch(cfg, 1), "cuda")
    step = make_train_step(cfg, seed=0, mesh=Mesh(1, 1, 0, 0))
    met = {k: float(v) for k, v in step(state, batch).items()}
    ref = {"metrics": met,
           "grads": {n: p.grad.detach().float().cpu() for n, p in
                     state.model.named_parameters() if p.grad is not None},
           "update": {n: p.detach().cpu() - sd[n] for n, p in
                      state.model.named_parameters()},
           "buffers": {n: b.detach().cpu() for n, b in
                       state.model.named_buffers()}, "sd": sd}
    ref.update(timed_step(torch, step, state, batch,
                          kernel_counters(QSHARD_CFGS[name])))
    del state, batch
    torch.cuda.empty_cache()
    return ref


def relative_stats(got, ref):
    """The BN statistics' largest difference, relative to each buffer's
    largest magnitude (at least 1)."""
    return max((got[n].float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1.0)
               for n, b in ref.items() if b.is_floating_point())


def log_rank_step(label, r):
    """One line of a `timed_step` record."""
    log(f"    {label}: step {r['step_ms']:.3f} ms host; CUDA events "
        + ", ".join(f"{k} {v:.3f}" for k, v in r["split_ms"].items())
        + f" ms; peak {r['peak_gib']:.3f} GiB; launches {r['launches']}")


def phase_qshard(torch, results, tmp):
    """Phase 41: model-parallel steps.  (1) `turbo_occ` and `base_occ` at
    full width, bf16, B = 1, dropout and grid mask on, at dp = 1 x mp = 2
    with the BEV queries sharded (torchrun, 2 gloo ranks on the one card),
    against the in-process unsharded step on the same weights and batch
    (the sharded step draws the unsharded step's dropout masks): loss and
    BN statistics within QSHARD_RTOL relative, every gradient leaf within
    GRAD_RTOL of its max; the ranks' parameters and buffers bitwise equal
    after the update, the same hand kernels launched as by the unsharded
    step, base_occ's certificate 0.
    Each rank's step split and peak beside the unsharded step's.  (2) The
    kernels at the sharded shapes against their plain versions
    (`phase_qshard_kernels`)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _qshard_checks(torch, results, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    phase_qshard_kernels(torch, results)


def _qshard_checks(torch, results, tmp):
    out = os.path.join(tmp, "qshard")
    os.makedirs(out)
    names = ",".join(QSHARD_CFGS)
    _, dt = run_cmd(torchrun(QSHARD_MP, os.path.join(REPO, "chip_smoke.py"),
                             "qshard-step", out, names),
                    "the dp = 1 x mp = 2 launch")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(QSHARD_MP)]
    log(f"  dp = 1 x mp = 2 launch (gloo, both ranks on {ranks[0]['device']}"
        f") in {dt:.1f} s: meshes {[r['mesh'] for r in ranks]}; card "
        f"{nvidia_smi()}")
    summary = {}
    for name in QSHARD_CFGS:
        ref16 = qshard_reference(torch, name)
        got = ranks[0][name]
        d = step_distance(got, ref16)
        bad = [n for n, (e, _) in d["leaf"].items() if e > GRAD_RTOL]
        stats = relative_stats(got["buffers"], ref16["buffers"])
        worst = max(d["leaf"], key=lambda n: d["leaf"][n][0])
        for i, r in enumerate(ranks):
            log_rank_step(f"{name} rank {i}", r[name])
        log_rank_step(f"{name} unsharded (in process)", ref16)
        log(f"  {name} sharded vs unsharded: loss {d['loss']:.2e}, BN "
            f"statistics {stats:.2e} (relative), grad norm "
            f"{d['grad_norm']:.2e}, whole gradient L2 {d['grad_l2']:.3e}, "
            f"first update L2 {d['update_l2']:.3e}; worst leaf "
            f"{d['leaf'][worst][0]:.3e} of its max ({worst}); leaves over "
            f"GRAD_RTOL: {bad}; peak per rank "
            f"{[round(r[name]['peak_gib'], 3) for r in ranks]} GiB against "
            f"{ref16['peak_gib']:.3f} GiB unsharded; certificates "
            f"{[r[name]['metrics']['cert_overflow'] for r in ranks]}")
        same = all(r[name]["metrics"] == ranks[0][name]["metrics"]
                   and r[name]["differ"] == 0 for r in ranks)
        want = ref16["launches"]
        if not (d["loss"] <= QSHARD_RTOL and stats <= QSHARD_RTOL
                and not bad and same
                and all(r[name]["launches"] == want for r in ranks)
                and all(r[name]["metrics"]["cert_overflow"] == 0
                        and np.isfinite(r[name]["loss2"]) for r in ranks)
                and ref16["metrics"]["cert_overflow"] == 0):
            raise RuntimeError(
                f"{name}: the sharded step is not the unsharded step (loss "
                f"{d['loss']}, statistics {stats}, leaves over {bad}, ranks "
                f"equal {same}, launches {[r[name]['launches'] for r in ranks]}"
                f" vs {want})")
        summary[name] = {
            "loss": d["loss"], "stats": stats, "grad_l2": d["grad_l2"],
            "update_l2": d["update_l2"],
            "worst_leaf_max": d["leaf"][worst][0],
            "ranks": [{k: r[name][k] for k in ("step_ms", "split_ms",
                                                "peak_gib", "launches")}
                      for r in ranks],
            "unsharded": {k: ref16[k] for k in ("step_ms", "split_ms",
                                                 "peak_gib", "launches")}}
        del ref16
        torch.cuda.empty_cache()
    results["qshard"] = summary


def phase_qshard_kernels(torch, results):
    """The hand kernels at the shapes of a model rank at mp = 2, against
    their plain versions with the tolerances of phases 3, 6, 9 and 19:
    the lift of each half of turbo_occ's BEV rows (forward bitwise, the
    backward within one bf16 step, its index bitwise the plain index with
    the premise holding); the tap attention and its backward on a half
    plus its halo, (1, 2, 102, 200, 256) bf16, the halo rows' attention
    zero (within TAP_TOL); MSDA and its backward at base_occ's TSA shape
    with Q = 20,000 queries over the whole 40,000-row value (bf16 and
    f32)."""
    from occnet_tpu_torch.config import base_occ, turbo_occ
    from occnet_tpu_torch.ops import msda, tsa
    from occnet_tpu_torch.ops.lift_cuda import (lift_bwd_index,
                                                lift_bwd_index_plain,
                                                lift_level_bwd_cuda,
                                                lift_level_bwd_plain,
                                                lift_level_cuda,
                                                lift_level_plain)
    m = turbo_occ().model
    dev = torch.device("cuda")
    C = m.embed_dims
    gen = torch.Generator(device=dev).manual_seed(41)
    levels = [(116, 200), (58, 100), (29, 50), (15, 25)]
    rows = m.bev_h // QSHARD_MP
    e2i = torch.from_numpy(ring_rig(m, 1)).to(dev)
    feats = [torch.randn(1, m.num_cams, h, w, C, generator=gen, device=dev
                         ).to(torch.bfloat16) for h, w in levels]
    worst_bwd = 0.0
    for r0 in range(0, m.bev_h, rows):
        geo, inv = lift_geometry(m, e2i, levels, (r0, r0 + rows))
        ZR = geo[0][1].shape[2]
        for (h, w), (p1, p2, st), f in zip(levels, geo, feats):
            uk = torch.empty(1, ZR, m.bev_w, C, dtype=torch.bfloat16,
                             device=dev)
            up = torch.empty_like(uk)
            lift_level_cuda(f, p1, p2, st, inv, uk)
            lift_level_plain(f, p1, p2, st, inv, up)
            ix = lift_bwd_index(p1, p2, st, (h, w))
            ix.check()
            runs, excess = lift_bwd_index_plain(p1, p2, st, (h, w))
            g = torch.randn(1, ZR, m.bev_w, C, generator=gen, device=dev
                            ).to(torch.bfloat16)
            dk = lift_level_bwd_cuda(g, p1, p2, st, inv, (h, w),
                                     index=ix).float()
            dp = lift_level_bwd_plain(g, p1, p2, st, inv, (h, w)).float()
            bad = bf16_step_apart(torch, dk, dp)
            worst_bwd = max(worst_bwd, (dk - dp).abs().max().item())
            if not (torch.equal(uk, up) and torch.equal(ix.runs, runs)
                    and int(excess) == 0 and not bad
                    and torch.isfinite(dk).all().item()):
                raise RuntimeError(f"lift at rows [{r0}, {r0 + rows}) level "
                                   f"{h}x{w}: kernel differs from plain")
        log(f"  lift rows [{r0}, {r0 + rows}) (ZR = {ZR}), 4 levels: forward "
            f"bitwise equal to the plain version, backward index bitwise "
            f"(premise holds), backward within one bf16 step")
    heads, nq = m.encoder.tsa.num_heads, m.encoder.tsa.num_bev_queue
    H = rows + 2
    v = torch.randn(1, nq, H, m.bev_w, C, generator=gen, device=dev
                    ).to(torch.bfloat16)
    attn = torch.softmax(torch.randn(1, H, m.bev_w, nq, len(tsa.TSA_TAPS),
                                     heads, generator=gen, device=dev),
                         dim=4).to(torch.bfloat16)
    attn[:, 0] = 0
    attn[:, -1] = 0
    g = torch.randn(1, H, m.bev_w, C, generator=gen, device=dev)
    tap_err = []
    for label, got, want in (
            ("tap", (tsa.tap_attention_cuda(v, attn),),
             (tsa.tap_attention_plain(v, attn),)),
            ("tap_bwd", tsa.tap_attention_bwd_cuda(v, attn, g),
             tsa.tap_attention_bwd_plain(v, attn, g))):
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            ok = bool(((a - b).abs() <= TAP_TOL + TAP_TOL * b.abs()).all())
            tap_err.append((a - b).abs().max().item())
            if not (ok and torch.isfinite(a).all().item()):
                raise RuntimeError(f"{label} at {tuple(v.shape)} differs from "
                                   f"plain")
    k = cuda_ms(torch, lambda: tsa.tap_attention_cuda(v, attn), 10)
    kb = cuda_ms(torch, lambda: tsa.tap_attention_bwd_cuda(v, attn, g), 10)
    log(f"  tap and tap_bwd at {tuple(v.shape)} (a half of the rows and its "
        f"halo, H = {H}): within {TAP_TOL} of the plain versions (max|diff| "
        f"{max(tap_err):.3e}); kernel {k:.4f} / {kb:.4f} ms")
    del v, attn, g
    bm = base_occ().model
    t = bm.encoder.tsa
    D = bm.embed_dims // t.num_heads
    Q = bm.bev_h * bm.bev_w // QSHARD_MP
    shapes = [(bm.bev_h, bm.bev_w)]
    v32, loc, attn, g32 = msda_draw(torch, gen, t.num_bev_queue, Q,
                                    t.num_heads, D, shapes, t.num_points)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        v = v32.to(dtype)
        a, b = (msda.msda_cuda(v, shapes, loc, attn).float(),
                msda.msda_plain(v, shapes, loc, attn).float())
        tol = ((MSDA_BF16_TOL, MSDA_BF16_TOL) if dtype == torch.bfloat16
               else (MSDA_F32_ATOL, MSDA_F32_RTOL))
        if not bool(((a - b).abs() <= tol[0] + tol[1] * b.abs()).all()):
            raise RuntimeError(f"msda at Q = {Q} ({dtype}) differs from "
                               f"plain")
        worst = max(worst, (a - b).abs().max().item())
        err, tb, _ = msda_bwd_case(
            torch, f"msda_bwd TSA value {tuple(v.shape)} {dtype}, Q={Q}", v,
            shapes, loc, attn, g32.to(dtype),
            BWD_BF16_TOL if dtype == torch.bfloat16 else BWD_F32_TOL,
            plain=False, reps=2)
        worst = max(worst, err)
        del v
    log(f"  msda at base_occ's TSA shape, Q = {Q} queries over "
        f"{bm.bev_h * bm.bev_w} value rows, bf16 and f32: within the "
        f"phase 9 / 19 bounds (max|diff| {worst:.3e})")
    results["qshard_kernels"] = {"lift_bwd_max_abs_err": worst_bwd,
                                 "tap_max_abs_err": max(tap_err),
                                 "tap_ms": k, "tap_bwd_ms": kb,
                                 "msda_max_abs_err": worst}


def phase_soak(torch, results):
    """Phase 42: the soak report.  The train CLI in process on
    `turbo_occ` at full width, SOAK_SCENES synthetic scenes (an epoch of
    SOAK_SCENES steps), SOAK_STEPS steps with the eval hook after each
    epoch and a checkpoint at each; then `tools.soak_report` over its work
    directory: the JAX tool's keys, the manager's checkpoint steps, a
    finite peak, no abort, two evals."""
    import shutil
    import tempfile
    from occnet_tpu_torch.tools import soak_report
    from occnet_tpu_torch.tools import train as cli
    from occnet_tpu_torch.training.checkpoint import CheckpointManager
    work = tempfile.mkdtemp(prefix="chip_smoke_soak_")
    t = time.perf_counter()
    try:
        cli.main(["--config", "turbo_occ", "--synthetic-geometric",
                  str(SOAK_SCENES), "--synthetic-render-scale", "4",
                  "--eval-interval-epochs", "1", "--max-steps",
                  str(SOAK_STEPS), "--work-dir", work])
        rep = soak_report.soak_report(work, "turbo_occ")
        mngr = CheckpointManager(work)
        kept = mngr.all_steps()
        mngr.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t
    keys = {"config", "steps_logged", "first_step", "last_step",
            "loss_first", "loss_last", "s_per_it_early", "s_per_it_late",
            "s_per_it_drift_pct", "cert_overflow_total", "evals",
            "checkpoints", "peak_hbm_gib", "aborts"}
    log(f"  train CLI ({SOAK_STEPS} steps, {SOAK_SCENES} scenes) and the "
        f"report in {wall:.1f} s: {json.dumps(rep)}; card {nvidia_smi()}")
    if not (rep.keys() == keys and rep["checkpoints"] == kept
            and kept == [SOAK_SCENES, SOAK_STEPS]
            and rep["peak_hbm_gib"] is not None
            and np.isfinite(rep["peak_hbm_gib"]) and rep["aborts"] == 0
            and len(rep["evals"]) == 2 and rep["cert_overflow_total"] == 0):
        raise RuntimeError(f"the soak report is wrong: {rep}")
    results["soak"] = rep


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.ops import _build
    from occnet_tpu_torch.utils.profiling import spans

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; nvidia-smi: {smi}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    with spans() as rec:
        _build.library()
    for setup in rec.summary():         # none if loaded before this phase
        log(f"[2 build] kernels built/loaded in "
            f"{setup['spans']['setup.kernels']['host_ms'] * 1e-3:.2f} s "
            f"(compiled: {setup['counters']['kernels.built']:.0f})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())

    cfg = turbo_occ()
    results = {"lift": {}, "tap": {}, "lift_geometry": {}}
    log("[3 kernels] kernel vs plain at main-path shapes")
    phase_kernels(torch, cfg, results)
    log("[4 parity] same weights, card vs CPU (tiny_turbo_occ, fp32)")
    phase_parity(torch, cfg)
    log("[5 serve] turbo_occ full width, bf16")
    phase_serve(torch, cfg, results)
    torch.cuda.empty_cache()
    results.update(lift_bwd={}, lift_bwd_index={}, tap_bwd={})
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
    log("[12 kernels (dcn)] DCNv2 sampling and fused kernels vs plain at "
        "R101-DCN's four DCN shapes")
    phase_dcn_kernels(torch, results)
    torch.cuda.empty_cache()
    log("[13 dcn parity] tiny R101-DCN, fp32, window DCN, dense and gather "
        "encoders, card vs CPU")
    results["dcn"]["launches"] = phase_dcn_parity(torch)
    log("[14 serve turbo_r101_dcn_occ] full width, bf16, window DCN, dense "
        "encoder")
    results["dcn_conv"]["launches"] = phase_serve_dcn(
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
    torch.cuda.empty_cache()
    log("[19 kernels (msda backward)] kernel vs plain at base_occ's SCA and "
        "TSA shapes")
    phase_msda_bwd_kernels(torch, exact_cfg("base_occ"), results)
    torch.cuda.empty_cache()
    log("[20 kernels (dcn backward)] kernel vs plain at R101-DCN's four DCN "
        "shapes")
    phase_dcn_bwd_kernels(torch, results)
    torch.cuda.empty_cache()
    log("[21 train parity (exact, DCN)] small gather and R50-DCN configs, "
        "fp32, card vs CPU")
    phase_train_exact_parity(torch)
    bwd = {"msda_bwd": 0, "dcn_bwd": 0}
    for i, cfg_name in enumerate(("base_occ", "turbo_r101_dcn_occ",
                                  "r101_dcn_occ")):
        log(f"[{22 + i} train {cfg_name}] full width, bf16, B=1, config "
            f"defaults")
        for k, n in phase_train_full(torch, cfg_name, FULL_TRAIN_STEPS,
                                     results).items():
            bwd[k] += n
    results["msda_bwd"]["launches"] = bwd["msda_bwd"]
    results["dcn_bwd"]["launches"] = bwd["dcn_bwd"]
    torch.cuda.empty_cache()

    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_nusc_")
    try:
        write_miniset(root)
        for n, label, fn in (
                (25, "data, conversion and the test CLI on base_occ",
                 phase_data_base_occ),
                (26, "the test CLI on turbo_r101_dcn_occ with the DCN "
                     "radius probe", phase_data_dcn),
                (27, "the train CLI on the miniset (turbo_occ)",
                 phase_data_train)):
            log(f"[{n} {label}] full width, {MINISET_FRAMES}-frame "
                f"nuScenes-layout data root")
            t = time.perf_counter()
            fn(torch, results, root)
            torch.cuda.empty_cache()
            log(f"  phase {n}: {time.perf_counter() - t:.1f} s")
        for n, label, run in (
                (28, "temporal parity: the rotation at full width; "
                     "tiny_turbo_occ and tiny_occ fp32 streams and clip "
                     "train steps, card vs CPU",
                 lambda: phase_temporal_parity(torch)),
                (29, "temporal serve: turbo_occ and base_occ streams, full "
                     "width, bf16", lambda: phase_temporal_serve(torch,
                                                                 results)),
                (30, "temporal train: clip steps at full width, bf16, B = 1",
                 lambda: phase_temporal_train(torch, results)),
                (31, "temporal data root: the test CLI --video on base_occ, "
                     "the train CLI --temporal-queue 2 on turbo_occ",
                 lambda: phase_temporal_data(torch, results, root))):
            log(f"[{n} {label}]")
            t = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            log(f"  phase {n}: {time.perf_counter() - t:.1f} s")
        results["runtime"] = {}
        ckpt = {}
        for n, label, run in (
                (32, "bench: tools/bench.py, the turbo_occ forward",
                 lambda: phase_bench(torch, results)),
                (33, "data-parallel steps over torchrun: turbo_occ at NCCL "
                     "world 1 and at gloo world 2 in bf16 and fp32, base_occ "
                     "at gloo world 2, the entry point's dry run",
                 lambda: phase_dist_step(torch, results, root)),
                (34, "dist_train.sh at world 1: 4 steps, --profile 2, the "
                     "checkpoint manager, --resume",
                 lambda: ckpt.update(path=phase_dist_train(torch, results,
                                                           root, root))),
                (35, "dist_test.sh at world 2 against the single-process "
                     "test CLI", lambda: phase_dist_test(
                         torch, results, root, root, ckpt["path"]))):
            log(f"[{n} {label}]")
            t = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            log(f"  phase {n}: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for n, label, run in (
            (36, "VoVNet parity: the 7 presets, fp32, card vs CPU",
             lambda: phase_vovnet_parity(torch)),
            (37, "VoVNet: base_occ with V-99-eSE served and trained at full "
                 "width, bf16", lambda: phase_vovnet_serve_train(torch,
                                                                 results)),
            (38, "detection kernels: msda / msda_bwd at the decoder's shape",
             lambda: phase_detection_kernels(torch, results)),
            (39, "detection: PerceptionTransformer card vs CPU; the "
                 "full-width detection path",
             lambda: phase_detection(torch, results)),
            (40, "renders: render_sample, render_sample_fast, "
                 "render_expected_depth", lambda: phase_renders(torch,
                                                                results))):
        log(f"[{n} {label}]")
        t = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        log(f"  phase {n}: {time.perf_counter() - t:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_qshard_")
    try:
        for n, label, run in (
                (41, "model-parallel steps: turbo_occ and base_occ at dp = 1 "
                     "x mp = 2 with the BEV queries sharded (gloo, one card) "
                     "against the unsharded step; the kernels at the "
                     "sharded shapes", lambda: phase_qshard(torch, results,
                                                            tmp)),
                (42, "soak report: the turbo_occ train CLI with the eval "
                     "hook and checkpoints, then tools.soak_report",
                 lambda: phase_soak(torch, results))):
            log(f"[{n} {label}]")
            t = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            log(f"  phase {n}: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[43 lift geometry] the geometry kernel vs plain, bitwise, on the "
        "ring, overlapping and random rigs; timed; no synchronising call")
    t = time.perf_counter()
    phase_lift_geometry(torch, results)
    log(f"  phase 43: {time.perf_counter() - t:.1f} s")

    kernels = [
        dict(name="lift", route="cuda",
             source="occnet_tpu_torch/csrc/lift.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:101,176,443",
             design="a block per (BEV row, run of "
                    "columns, all z-anchors) stages its cells' tap lists in "
                    "shared memory, then gathers them in batches; bitwise "
                    "equal to its plain version",
             **results["lift"]),
        dict(name="lift_geometry", route="cuda",
             source="occnet_tpu_torch/csrc/lift_geometry.cu",
             replaces="none: XLA-fused glue (occnet_tpu/ops/lift_pallas.py:"
                      "618, occnet_tpu/ops/planar_lift.py:40,298)",
             design="a block per (level, sample, BEV row): a thread a "
                    "(camera, z-anchor) plane builds its homography and "
                    "image line in shared memory, then coalesced stores of "
                    "the row's pos2 and pos1; level 0 counts the cameras "
                    "by marks in shared memory; bitwise equal to its plain "
                    "version",
             **results["lift_geometry"]),
        dict(name="tap", route="cuda",
             source="occnet_tpu_torch/csrc/tap.cu",
             replaces="occnet_tpu/ops/tsa_pallas.py:88",
             design="8 x 8 tiles of cells with their "
                    "halo staged in shared memory by cp.async, channel "
                    "groups of 64 double-buffered",
             **results["tap"]),
        dict(name="lift_bwd", route="cuda",
             source="occnet_tpu_torch/csrc/lift_bwd.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:270,493",
             **results["lift_bwd"]),
        dict(name="lift_bwd_index", route="cuda",
             source="occnet_tpu_torch/csrc/lift_bwd.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:270,493",
             **results["lift_bwd_index"]),
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
        dict(name="dcn_conv", route="cuda",
             source="occnet_tpu_torch/csrc/deform_conv.cu",
             replaces="occnet_tpu/ops/dcn_window.py:133,174,342",
             **results["dcn_conv"]),
        dict(name="lift_pass2", route="cuda",
             source="occnet_tpu_torch/csrc/lift_pass2.cu",
             replaces="occnet_tpu/ops/lift_pallas.py:385",
             **results["lift_pass2"]),
        dict(name="ray_march_dda", route="cuda",
             source="occnet_tpu_torch/csrc/ray_march.cu",
             replaces="occnet_tpu/ops/ray_march.py:32,"
                      "occnet_tpu/data/synthetic.py:165",
             design="dda_kernel: the whole scene render in one launch "
                    "(directions, march, shading; a raw epilogue for "
                    "dda_raymarch), the grid packed into column bitmasks "
                    "in shared memory, 8 x 4 pixel tiles a warp",
             **results["ray_march_dda"]),
        dict(name="ray_march_fan", route="cuda",
             source="occnet_tpu_torch/csrc/ray_march.cu",
             replaces="occnet_tpu/ops/ray_march_vec.py:123,"
                      "occnet_tpu/evaluation/ray_metrics.py:149",
             design="fan_kernel: prediction and GT of an eval frame in one "
                    "launch, pitch-major dist / label / flow (a raw "
                    "epilogue for dda_raymarch_fan_vec); a warp walks an "
                    "azimuth's columns once for all its rings, 32 "
                    "crossings a lane each, z-boundary times tabulated",
             **results["ray_march_fan"]),
        dict(name="msda_bwd", route="cuda",
             source="occnet_tpu_torch/csrc/msda_bwd.cu",
             replaces="occnet_tpu/ops/msda_pallas.py:369",
             **results["msda_bwd"]),
        dict(name="dcn_bwd", route="cuda",
             source="occnet_tpu_torch/csrc/deform_conv_bwd.cu",
             replaces="occnet_tpu/ops/dcn_window.py:310,"
                      "occnet_tpu/ops/deform_conv.py:34",
             **results["dcn_bwd"]),
    ]
    # launches on the data path (phases 25-27) and the temporal path
    # (phases 29-31), by phase, for the kernels each runs (each phase zeroes
    # the counts before its run)
    alias = {"fan": "ray_march_fan", "dcn_conv": "dcn_conv",
             "dcn_sample": "dcn"}
    for phase, counts in results["phase_launches"].items():
        key = ("data_path_launches" if int(phase) <= 27
               else "temporal_launches")
        for kname, n in counts.items():
            for k in kernels:
                if k["name"] == alias.get(kname, kname) and n:
                    k.setdefault(key, {})[phase] = n
    # launches of the VoVNet, detection and render paths (phases 37, 39,
    # 40), each counted from 0 over its own run
    by_name = {k["name"]: k for k in kernels}
    by_name["msda"]["vovnet_serve_launches"] = results["vovnet"]["serve_msda"]
    by_name["msda_bwd"]["vovnet_train_launches"] = \
        results["vovnet"]["train_msda_bwd"]
    # launches of a model rank's sharded step (phase 41, rank 0, counted
    # from 0 over one step)
    for name in QSHARD_CFGS:
        for kname, n in results["qshard"][name]["ranks"][0][
                "launches"].items():
            by_name[kname]["qshard_launches"] = n
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    for k in kernels:
        if not keys <= k.keys():
            raise RuntimeError(f"kernel {k['name']} lacks {keys - k.keys()}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["dist-step"]:
        dist_step_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["qshard-step"]:
        qshard_step_rank(sys.argv[2:])
    else:
        main()
