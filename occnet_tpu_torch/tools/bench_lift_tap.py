"""The lift forward (`csrc/lift.cu`) and tap-attention forward (`csrc/tap.cu`)
kernels of two checkouts, timed in turns on one card at turbo_occ's
main-path shapes.

    python -m occnet_tpu_torch.tools.bench_lift_tap --parent DIR [--ablate]

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``).  Each checkout's `lift.cu` and
`tap.cu` are built by nvcc into a library of their own (flags of
`ops/_build.py`), and both are called through the same C entry points on
the same inputs: the lift at every level of a B = 1 frame on the ring rig
of the train CLI (6 cameras, levels 116x200 .. 15x25, C = 256, 8 z-anchors
over the 200 x 200 BEV grid, bf16 output), and the tap attention at (1, 2,
200, 200, 256) bf16 with 8 heads.  Every case runs this checkout, the other,
the other, this checkout (CUDA events, mean of ``--reps`` launches after a
warm-up).

``--ablate`` adds development builds made by editing the sources before
they are compiled (each edit must match once, or the tool stops):

- the lift with its feature gathers removed (geometry and stores only) and
  with nothing but its stores, for both checkouts, and this checkout's
  lift with every feature load replaced by a value made from its address
  (the gathers' arithmetic without their memory traffic);
- this checkout's lift with 8 feature loads in flight a lane and 8 cameras
  staged at a time (instead of 4 and 4), and its tap kernel with 16 x 8
  tiles (instead of 8 x 8), each timed against this checkout.

The edited builds that remove work compute wrong values and are timed
only.  Prints ptxas's register count of each build and one line per case,
and with ``--out`` writes the times as JSON.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from occnet_tpu_torch.ops import _build
from occnet_tpu_torch.ops.lift_cuda import LIFT
from occnet_tpu_torch.ops.tsa import TAP

SOURCES = ("lift.cu", "tap.cu")
LEVELS = ((116, 200), (58, 100), (29, 50), (15, 25))

# edits of a development build: (file, old text, new text)
Edit = Tuple[str, str, str]
# the earlier sampler (a warp a cell, the camera loop in the kernel)
PARENT_NO_GATHER: List[Edit] = [(
    "lift.cu", "occ::load8(fb + ((long long)y * w + x) * C, v);",
    "for (int i = 0; i < 8; ++i) v[i] = 0.0f;")]
PARENT_STORE_ONLY: List[Edit] = [(
    "lift.cu", "for (int a = 0; a < A; ++a) {",
    "for (int a = 0; a < 0; ++a) {")]
# this checkout's: a block stages tap lists, then gathers them
CHANGE_NO_GATHER: List[Edit] = [(
    "lift.cu", "const int n = count[cell];", "const int n = 0;")]
CHANGE_NO_LOAD: List[Edit] = [(
    "lift.cu", "raw[q] = __ldg(reinterpret_cast<const uint4*>(src));",
    "raw[q] = make_uint4((unsigned)(size_t)src, 0u, 0u, 0u);")]
CHANGE_STORE_ONLY: List[Edit] = CHANGE_NO_GATHER + [(
    "lift.cu", "if (threadIdx.x < cells) {", "if (threadIdx.x < 0) {")]
CHANGE_BATCH8: List[Edit] = [
    ("lift.cu", "constexpr int kCamChunk = 4;",
     "constexpr int kCamChunk = 8;"),
    ("lift.cu", "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")]
CHANGE_TAP16: List[Edit] = [
    ("tap.cu", "constexpr int kTY = 8;", "constexpr int kTY = 16;")]


def build(csrc: str, edits: Sequence[Edit] = ()) -> ctypes.CDLL:
    """nvcc `lift.cu` and `tap.cu` of the directory ``csrc`` (with
    ``edits`` applied) into one library under `csrc/build/bench/` of this
    checkout, keyed by the edited sources."""
    texts = {}
    for name in (*SOURCES, "common.cuh"):
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
    for name, old, new in edits:
        if texts[name].count(old) != 1:
            raise RuntimeError(f"edit of {name} does not match once: {old!r}")
        texts[name] = texts[name].replace(old, new)
    digest = hashlib.sha256()
    for name in sorted(texts):
        digest.update(name.encode() + texts[name].encode())
    out = os.path.join(_build.BUILD_DIR, "bench", digest.hexdigest()[:16])
    so = os.path.join(out, "lib.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        for name, text in texts.items():
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
        nvcc = _build._nvcc()
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(out, s), "-o",
             os.path.join(out, s + ".o")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for s in SOURCES]
        for src, p in zip(SOURCES, procs):
            log = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
            print(f"  build {out[-16:]} {src}: " + " | ".join(
                line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line))
        res = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                              so + ".tmp", *[os.path.join(out, s + ".o")
                                             for s in SOURCES]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            shutil.rmtree(out, ignore_errors=True)
            raise RuntimeError(f"link failed:\n{res.stderr[-4000:]}")
        os.replace(so + ".tmp", so)
    lib = ctypes.CDLL(so)
    for kernel in (LIFT, TAP):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return lib


def inputs(device) -> Dict[str, object]:
    """turbo_occ's lift geometry of a B = 1 frame at every level, random
    bf16 features, and a random tap-attention input, from seed 0."""
    from occnet_tpu_torch.config import turbo_occ
    from occnet_tpu_torch.ops import planar_lift
    from occnet_tpu_torch.tools.train import ring_rig
    m = turbo_occ().model
    Z = m.encoder.num_points_in_pillar
    bev_hw = (m.bev_h, m.bev_w)
    g = torch.Generator(device=device).manual_seed(0)
    e2i = torch.from_numpy(ring_rig(m, 1)).to(device)
    z = torch.from_numpy(planar_lift.z_anchors(m.pc_range, Z)).to(device)
    H = planar_lift.plane_homographies(e2i, m.pc_range, z, bev_hw)
    levels, inv = [], None
    for h, w in LEVELS:
        Ml = planar_lift.feature_homographies(H, h, w, (m.img_h, m.img_w))
        p1, p2, st, valid = planar_lift.level_geometry(Ml, bev_hw, h, w)
        if inv is None:
            count = valid.any(dim=2).sum(dim=1).float().clamp(min=1.0)
            inv = (1.0 / count).reshape(1, -1).contiguous()
        feat = torch.randn(1, m.num_cams, h, w, m.embed_dims, generator=g,
                           device=device).to(torch.bfloat16)
        levels.append((feat, p1, p2, st))
    out = torch.empty(1, len(LEVELS), Z * m.bev_h, m.bev_w, m.embed_dims,
                      dtype=torch.bfloat16, device=device)
    nq, heads = m.encoder.tsa.num_bev_queue, m.encoder.tsa.num_heads
    v = torch.randn(1, nq, m.bev_h, m.bev_w, m.embed_dims, generator=g,
                    device=device).to(torch.bfloat16)
    attn = torch.softmax(torch.randn(1, m.bev_h, m.bev_w, nq, 9, heads,
                                     generator=g, device=device), dim=4
                         ).to(torch.bfloat16)
    tap_out = torch.empty(1, m.bev_h, m.bev_w, m.embed_dims,
                          device=device)
    return {"levels": levels, "inv": inv, "out": out, "v": v, "attn": attn,
            "tap_out": tap_out}


def lift_call(lib, x, lvls: Sequence[int]):
    """One launch of ``lib``'s lift kernel at each level of ``lvls``."""
    stream = torch.cuda.current_stream().cuda_stream
    inv = x["inv"]
    args = []
    for lvl in lvls:
        feat, p1, p2, st = x["levels"][lvl]
        B, A, h, w, C = feat.shape
        ZR, M = p2.shape[2], p2.shape[3]
        out = x["out"][:, lvl]
        args.append((feat.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                     st.data_ptr(), inv.data_ptr(), out.data_ptr(), 1, B, A,
                     h, w, C, ZR, inv.shape[1] // M, M, out.stride(0),
                     stream))

    def go():
        for a in args:
            err = lib.occ_lift_level(*a)
            if err:
                raise RuntimeError(f"occ_lift_level: cudaError {err}")
    return go


def tap_call(lib, x):
    """One launch of ``lib``'s tap-attention kernel."""
    v, attn, out = x["v"], x["attn"], x["tap_out"]
    B, nq, H, W, C = v.shape
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = lib.occ_tap_attention(v.data_ptr(), attn.data_ptr(),
                                    out.data_ptr(), 1, B, nq, H, W, C,
                                    attn.shape[-1], stream)
        if err:
            raise RuntimeError(f"occ_tap_attention: cudaError {err}")
    return go


def cuda_ms(fn, reps: int) -> float:
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


def in_turns(a, b, reps: int) -> List[float]:
    """Times of a, b, b, a."""
    return [cuda_ms(a, reps), cuda_ms(b, reps), cuda_ms(b, reps),
            cuda_ms(a, reps)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True,
                   help="root of the checkout to compare with")
    p.add_argument("--ablate", action="store_true",
                   help="also time the development builds")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", help="write the times as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_lift_tap: needs a CUDA device")
    here = os.path.dirname(_build.BUILD_DIR)
    there = os.path.join(args.parent, "occnet_tpu_torch", "csrc")
    libs = {"change": build(here), "parent": build(there)}
    lift_pairs = [("change", "parent")]
    tap_pairs = [("change", "parent")]
    if args.ablate:
        libs.update({
            "change_no_gather": build(here, CHANGE_NO_GATHER),
            "parent_no_gather": build(there, PARENT_NO_GATHER),
            "change_store_only": build(here, CHANGE_STORE_ONLY),
            "parent_store_only": build(there, PARENT_STORE_ONLY),
            "change_no_load": build(here, CHANGE_NO_LOAD),
            "change_batch8": build(here, CHANGE_BATCH8),
            "change_tap16": build(here, CHANGE_TAP16)})
        lift_pairs += [("change_no_gather", "parent_no_gather"),
                       ("change_store_only", "parent_store_only"),
                       ("change_no_load", "change"),
                       ("change_batch8", "change")]
        tap_pairs.append(("change_tap16", "change"))
    x = inputs(torch.device("cuda"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    res: Dict[str, object] = {"card": smi}

    def report(key, a, b, t):
        res[f"{key} {a} / {b}"] = t
        print(f"{key}: {a} {t[0]:.4f}, {b} {t[1]:.4f}, {b} {t[2]:.4f}, "
              f"{a} {t[3]:.4f} ms", flush=True)

    every = range(len(LEVELS))
    for a, b in lift_pairs:
        for lvl, hw in enumerate(LEVELS):
            report(f"lift level {lvl} {hw}", a, b, in_turns(
                lift_call(libs[a], x, [lvl]), lift_call(libs[b], x, [lvl]),
                args.reps))
        report("lift 4 levels", a, b, in_turns(
            lift_call(libs[a], x, every), lift_call(libs[b], x, every),
            args.reps))
    for a, b in tap_pairs:
        report("tap (1, 2, 200, 200, 256) bf16", a, b, in_turns(
            tap_call(libs[a], x), tap_call(libs[b], x), args.reps * 5))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
