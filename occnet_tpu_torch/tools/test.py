"""Evaluation / submission CLI of the port (counterpart of `tools/test.py`).

    python -m occnet_tpu_torch.tools.test --config base_occ \
        --torch-checkpoint bevformer_occ.pth --eval --format-only \
        --out submission.gz --set data.data_root=/data/nuscenes/
    python -m occnet_tpu_torch.tools.test --config tiny_occ --eval \
        --device cpu --set data.data_root=... data.val_ann=...
    python -m occnet_tpu_torch.tools.test --config turbo_occ --video \
        --eval --checkpoint work_dirs/torch_turbo_occ/ckpt.pt --set ...

Loads weights (a reference BEVFormerOcc ``.pth`` with ``--torch-checkpoint``,
else the port's checkpoint: the file ``--checkpoint`` or the newest of the
directory ``--checkpoint``, by default ``<work-dir>/ckpt.pt``, else random
weights with a warning), runs inference over the val split of
``data.data_root`` in order (`data.sampler.contiguous_shard_indices`), and
with ``--eval`` scores RayIoU / mAVE / OccScore (written to
``<work-dir>/eval_results.json``) and with ``--format-only`` writes a
challenge submission (``--out``).  The device is the card unless ``--device
cpu`` says otherwise.

As in the JAX CLI:

- each frame's ego origins come from the FULL info list, even under
  ``--max-samples`` (the reference extracts a scene's whole trajectory
  before slicing, `ego_pose_extractor.py:30-35`);
- gather-mode configs size the SCA top-K per camera from the first frame's
  cameras (`geometry.calibration_topk`; ``--no-auto-topk`` keeps the
  configured K);
- window-mode DCN configs run one forward on the first frame with the
  loaded weights, take each DCN layer's `ops.dcn_window.needed_radius`, and
  rebuild the model with exactly those radii (``--no-auto-dcn-radius``
  keeps the configured ones);
- the exactness certificates are summed over all frames on the device; a
  nonzero sum aborts after the run (``--allow-topk-overflow`` warns
  instead).

With ``--video`` the val split streams in order through
`training.temporal.StreamingInferenceState`: each frame's BEV is the next
frame's history within a scene, aligned by the ego motion between their
poses, and a new scene starts without history (the reference's
video_test_mode / prev_frame_info).  The auto top-K and the DCN radius
probe run single-frame on the first frame first, and the certificates of
every frame are summed as on the single-frame path.

Metric counts stay on the device and are fetched every 32 frames; a
submission's frames are rendered on the inference device as they come.

``--distributed`` evaluates over the ranks of a launcher (`torchrun`,
`tools/dist_test.sh`), as the reference's 8-GPU dist_test.sh and the JAX
CLI do: each rank takes a contiguous shard of the val split
(`data.sampler.contiguous_shard_indices`; the wrap-around padding that
makes the JAX CLI's shards equal is not run, so the last shard may be
shorter and no frame is predicted twice), every rank calibrates
on the split's first frame, the ego origins still come from the full info
list, each frame's metric counts are all-gathered and summed in the
split's order (so the float64 flow-error sums are bitwise the
single-process ones), the certificates are summed over the ranks, and
each rank writes ``<out>.part<rank>``, which rank 0 merges after a barrier
(`evaluation.submission.merge_submissions`).  Rank 0 prints and writes the
scores.  With ``--video`` each rank streams its own shard: a scene cut at a
shard boundary starts a fresh history on the later rank, like the
reference's per-GPU streaming state.

The JAX CLI's choice of implementation (``--msda-impl``, host or device
normalisation) is not carried: the port has one route a device and always
uploads uint8.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from occnet_tpu_torch.training.eval_loop import (COUNT_KEYS,
                                                 merge_frame_counts)

FLUSH = 32          # frames whose metric counts are fetched at once


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="occnet_tpu_torch eval")
    p.add_argument("--config", default="base_occ")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference BEVFormerOcc .pth to convert and "
                        "evaluate")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint file, or a directory of "
                        "them (its newest; defaults to <work-dir>/ckpt.pt)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--video", action="store_true",
                   help="temporal streaming inference: carry the BEV across "
                        "the sequential frames of a scene, aligned by the "
                        "ego motion (the reference's video_test_mode / "
                        "prev_frame_info)")
    p.add_argument("--out", default="submission.gz")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--no-auto-topk", dest="auto_topk", action="store_false",
                   help="keep the configured SCA top-K instead of sizing it "
                        "per camera from the first frame (+2%% margin, "
                        "rounded up to 1024)")
    p.add_argument("--allow-topk-overflow", action="store_true",
                   help="warn instead of aborting on a nonzero exactness "
                        "certificate (sca_topk_overflow / "
                        "dcn_window_overflow)")
    p.add_argument("--no-auto-dcn-radius", dest="auto_dcn_radius",
                   action="store_false",
                   help="keep the configured window-DCN radii instead of "
                        "probing each layer's need on the first frame")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; the CPU only with "
                        "--device cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="evaluate a contiguous shard of the val split on "
                        "each rank of torchrun's environment; counts "
                        "all-gathered, rank 0 reports and merges")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl with a card, "
                        "gloo without)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL")
    return p.parse_args(argv)


def _timed_sample(dataset, idx: int):
    """(sample, host ms of loading it: JPEG decode and labels)."""
    t = time.perf_counter()
    s = dataset.get_sample(idx)
    return s, (time.perf_counter() - t) * 1e3


def probe_dcn_radii(predictor, sample) -> dict:
    """{DCN layer index: needed_radius} over one request, for the layers the
    JAX package runs on its window kernel (`window_supported`), measured on
    each layer's own offsets by forward pre-hooks."""
    from occnet_tpu_torch.ops.dcn_window import needed_radius, window_supported
    from occnet_tpu_torch.ops.deform_conv import ModulatedDeformConv
    from occnet_tpu_torch.models.resnet import dcn_layer_indices
    bb = predictor.cfg.model.backbone
    name2idx = dcn_layer_indices(int(bb.type.replace("resnet", "")),
                                 bb.dcn_stages)
    needed, hooks = {}, []

    def probe(i, mod, inputs):
        x = inputs[0]
        h, w = x.shape[2:]
        if window_supported(w, 3, mod.stride, 1):
            off, _ = mod.offset_and_mask(x)
            needed[i] = needed_radius(off, h, w)

    for name, mod in predictor.model.backbone.named_modules():
        if isinstance(mod, ModulatedDeformConv):
            i = name2idx[name.split(".")[0]]
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, i=i: probe(i, m, inp)))
    try:
        predictor.infer(sample["img"][None], sample["ego2img"][None])
    finally:
        for h in hooks:
            h.remove()
    return {i: int(v) for i, v in needed.items()}


def main(argv: Optional[Sequence[str]] = None,
         mark: Optional[Callable[[str], None]] = None) -> dict:
    """Runs the CLI; returns {"scores" and "counts" (the metric's summed
    counts) with --eval, "tokens" (this rank's), "overflow" (summed over
    the ranks), "per_cam_topk", "dcn_radii", "load_ms"} (the host ms of
    loading each frame).  ``mark(name)``, when
    given, is called before each frame ("frame") and after its "forward",
    "render" and "counts" stages (and, with --video, after a streamed
    frame's "align")."""
    args = parse_args(argv)
    from occnet_tpu_torch import parallel
    from occnet_tpu_torch.parallel import multihost
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("occnet_tpu_torch.tools.test: no CUDA device is "
                         "available; pass --device cpu to run on the CPU")
    joined = (args.distributed and not multihost.is_initialized()
              and parallel.initialize(args.dist_backend))
    try:
        if args.distributed:
            device = multihost.local_device(device)
        return _run(args, device, mark)
    finally:
        if joined:
            multihost.shutdown()


def _run(args, device: torch.device,
         mark: Optional[Callable[[str], None]]) -> dict:
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    from occnet_tpu_torch.data.nuscenes import NuSceneOccDataset
    from occnet_tpu_torch.data.sampler import contiguous_shard_indices
    from occnet_tpu_torch.evaluation.ego_pose import (extract_ego_origins,
                                                      pad_origins)
    from occnet_tpu_torch.evaluation.ray_metrics import (
        RayMetricAccumulator, format_metrics_table, generate_lidar_rays,
        occ_score_from_metrics, render_pred_gt)
    from occnet_tpu_torch.evaluation.submission import (merge_submissions,
                                                        save_submission,
                                                        submission_entry)
    from occnet_tpu_torch.geometry import calibration_topk
    from occnet_tpu_torch.models.head import get_occ
    from occnet_tpu_torch.parallel import (allgather_host, barrier,
                                           process_shard)
    from occnet_tpu_torch.serve import Predictor
    from occnet_tpu_torch.training.checkpoint import CheckpointManager
    from occnet_tpu_torch.training.temporal import StreamingInferenceState

    rank, world = process_shard()

    def print0(*a):
        if rank == 0:
            print(*a)

    cfg = get_config(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    work_dir = args.work_dir or os.path.join("work_dirs",
                                             "torch_" + args.config)
    os.makedirs(work_dir, exist_ok=True)

    dataset = NuSceneOccDataset(
        cfg.data, os.path.join(cfg.data.data_root, cfg.data.val_ann),
        training=False)
    n = len(dataset) if args.max_samples is None else min(
        len(dataset), args.max_samples)
    # this rank's contiguous shard without the wrap-around padding of
    # equal shards: a padded frame would be predicted twice, and under
    # --video after the wrong history
    order = contiguous_shard_indices(n, world, rank)
    shard_len = len(order)
    order = order[:max(0, min(shard_len, n - rank * shard_len))]
    if rank == 0:
        print(f"val set: {n} frames" + (
            f" ({world} ranks x <= {shard_len})" if world > 1 else ""))
    first = dataset.get_sample(0)

    m = cfg.model
    per_cam_topk = None
    if (m.encoder.mode == "gather" and args.auto_topk
            and 0 < m.encoder.sca.max_queries_per_cam < m.bev_h * m.bev_w
            and not m.encoder.sca.per_cam_topk):
        # the rig is fixed per dataset, so one frame's projection bounds the
        # compaction; the certificate still catches any frame beyond it
        per_cam_topk = calibration_topk(m, first["ego2img"][None],
                                        per_camera=True)
        cfg = apply_overrides(cfg, {"model.encoder.sca.per_cam_topk":
                                    per_cam_topk})
        print0(f"auto top-K: per_cam_topk={per_cam_topk} (uniform was "
              f"{m.encoder.sca.max_queries_per_cam}; --no-auto-topk pins the "
              f"configured value)")

    ckpt = args.checkpoint or os.path.join(work_dir, "ckpt.pt")
    if os.path.isdir(ckpt):
        mngr = CheckpointManager(ckpt)
        step = mngr.latest_step()
        ckpt = (mngr.path(step) if step is not None
                else os.path.join(ckpt, "ckpt.pt"))
    if args.torch_checkpoint:
        from occnet_tpu_torch.utils.torch_convert import (
            load_bevformer_into_state_dict)
        ref = torch.load(args.torch_checkpoint, map_location="cpu",
                         weights_only=True)
        # modules absent from the checkpoint keep the init's values
        sd = load_bevformer_into_state_dict(
            from_jax_variables(init_jax_style_variables(cfg, seed=0)),
            ref.get("state_dict", ref),
            depth=int(m.backbone.type.replace("resnet", "")),
            num_encoder_layers=m.encoder.num_layers)
        print0(f"loaded reference torch checkpoint {args.torch_checkpoint}")
    elif os.path.exists(ckpt):
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        sd = saved["model"]
        print0(f"loaded checkpoint {ckpt} (step {saved['step']})")
    else:
        print0("WARNING: no checkpoint found: evaluating random weights")
        sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
    pred = Predictor(cfg, sd, device)

    dcn_radii = None
    bb = m.backbone
    if bb.dcn_mode == "window" and any(bb.dcn_stages) \
            and args.auto_dcn_radius:
        # the offsets are functions of the loaded weights: one forward on
        # the first frame gives each layer's need, and each layer then runs
        # at exactly that radius (layers off the window kernel take 0)
        needed = probe_dcn_radii(pred, first)
        if needed:
            from occnet_tpu_torch.models.resnet import dcn_layer_indices
            n_layers = len(dcn_layer_indices(
                int(bb.type.replace("resnet", "")), bb.dcn_stages))
            dcn_radii = tuple(needed.get(i, 0) for i in range(n_layers))
            cfg = apply_overrides(cfg, {"model.backbone.dcn_window_radii":
                                        dcn_radii})
            pred = Predictor(cfg, sd, device)
            print0(f"auto DCN radii (per layer, probe on frame 0): "
                  f"{list(dcn_radii)} (configured R={bb.dcn_window_radius}; "
                  f"--no-auto-dcn-radius pins it)")
    del sd

    stream = StreamingInferenceState(pred) if args.video else None
    origins_by_token = dict(extract_ego_origins(dataset.infos))
    rays = generate_lidar_rays()
    acc = RayMetricAccumulator()
    results, pending, load_ms, tokens = {}, [], [], []
    overflow = torch.zeros((), dtype=torch.int64, device=device)

    # the frames' counts are kept apart, gathered from every rank and
    # summed in the split's frame order: the float64 flow-error sums then
    # add in the single-process order, so the totals are bitwise its own
    frame_counts = []

    def flush():
        frame_counts.extend({k: c[k].cpu().numpy().astype(
            getattr(acc, k).dtype) for k in COUNT_KEYS} for c in pending)
        pending.clear()

    t0 = time.time()
    n_local = len(order)
    with ThreadPoolExecutor(max_workers=2) as pool:
        depth = min(4, n_local)
        futures = [pool.submit(_timed_sample, dataset, int(order[i]))
                   for i in range(depth)]
        for i in range(n_local):
            s, ms = futures.pop(0).result()
            load_ms.append(ms)
            if i + depth < n_local:
                futures.append(pool.submit(_timed_sample, dataset,
                                           int(order[i + depth])))
            if mark:
                mark("frame")
            if stream is not None:
                outs = stream.step(s["img"][None], s["ego2img"][None],
                                   s["scene_token"], s["ego2global"], mark)
            else:
                outs = pred.infer(s["img"][None], s["ego2img"][None])
            for k in ("sca_topk_overflow", "dcn_window_overflow"):
                if outs.get(k) is not None:
                    overflow = overflow + outs[k]
            occ_cls, flow = get_occ(outs)
            if mark:
                mark("forward")
            origins = origins_by_token[s["token"]]
            tokens.append(s["token"])
            if args.format_only:
                results[s["token"]] = submission_entry(
                    occ_cls[0], flow[0], rays, origins)
            if args.eval:
                padded, valid = pad_origins(origins, cfg.eval.max_origins)
                gt = [torch.from_numpy(np.ascontiguousarray(s[k])).to(device)
                      for k in ("voxel_semantics", "voxel_flow")]
                p_r, g_r = render_pred_gt(occ_cls[0], flow[0], *gt, rays,
                                          padded, valid)
                if mark:
                    mark("render")
                pending.append(acc.count_async(p_r, g_r))
                if mark:
                    mark("counts")
                if len(pending) >= FLUSH:
                    flush()
            if (i + 1) % 50 == 0:
                print0(f"{i + 1}/{n_local}  "
                       f"{(time.time() - t0) / (i + 1):.2f}s/frame")
    flush()
    overflow = int(np.sum(allgather_host(np.int64(overflow.item()))))
    if overflow > 0:
        msg = (f"exactness-certificate overflow={overflow}: the SCA top-K "
               f"dropped visible BEV queries and/or DCN samples lie outside "
               f"the window radius; results are NOT exact for this config "
               f"(raise model.encoder.sca.max_queries_per_cam / "
               f"model.backbone.dcn_window_radius)")
        if not args.allow_topk_overflow:
            raise RuntimeError(msg + "; pass --allow-topk-overflow to score "
                               "anyway")
        print("WARNING: " + msg)

    summary = {"tokens": tokens, "overflow": overflow,
               "per_cam_topk": per_cam_topk, "dcn_radii": dcn_radii,
               "load_ms": load_ms}
    if args.eval:
        # every rank's frame counts, zero-padded to the shard length
        merge_frame_counts(acc, frame_counts, shard_len, world, range(world))
        summary["counts"] = {k: np.asarray(getattr(acc, k))
                             for k in COUNT_KEYS + ("num_samples",)}
        metrics = acc.finalize()
        scores = occ_score_from_metrics(metrics)
        if rank == 0:
            print(format_metrics_table(metrics))
            print(json.dumps(scores, indent=2))
            with open(os.path.join(work_dir, "eval_results.json"), "w") as f:
                json.dump(scores, f)
        summary["scores"] = scores
    if args.format_only:
        if world == 1:
            save_submission(args.out, results)
            print(f"wrote {args.out}")
        else:
            save_submission(f"{args.out}.part{rank}", results)
            barrier("submission_parts")
            if rank == 0:
                parts = [f"{args.out}.part{r}" for r in range(world)]
                cnt = merge_submissions(parts, args.out)
                for p in parts:
                    os.remove(p)
                print(f"wrote {args.out} ({cnt} samples)")
            barrier("submission")
    return summary


if __name__ == "__main__":
    main()
