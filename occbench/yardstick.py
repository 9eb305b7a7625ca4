"""The yardstick: the card's peaks, the least time of a kernel call from the
operations and bytes it needs, and the model's operations counted from the
configuration's shapes.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
power limit (dense rates, no sparsity).  A kernel's least time is the larger
of its bytes over the memory rate and its operations over the rate of the
unit that does them; each input byte is counted read once and each output
byte written once, and where the work depends on the data (MSDA's samples)
only what these inputs need is counted.  A share of it is the least time
over the measured time, so it cannot pass 100 % unless a count is too high
or a time leaves out work.

Nothing here imports the program: the counts follow the shapes of the
configuration file and of the tensors a call was given.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12      # HBM3, 80 GB
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # bf16 / fp16 on the tensor cores, dense

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def least_time_s(nbytes: float, fp32_flops: float = 0.0
                 ) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of bytes over the memory rate
    and fp32 operations over the CUDA cores' rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": fp32_flops / FP32_FLOPS}
    by = max(times, key=times.get)
    return times[by], by


# ---------------------------------------------------------------------------
# Kernel calls: bytes and operations from the call's shapes
# ---------------------------------------------------------------------------

def lift_level_cost(B: int, A: int, h: int, w: int, C: int, ZR: int, M: int,
                    Q: int, live: int, feat_bytes: int = 2,
                    out_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, fp32 operations) of one level of the lift forward: features
    (B, A, h, w, C), pos1 (B, A, ZR, w + h) f32, pos2 (B, A, ZR, M) f32,
    steep (B, A, ZR) bool and inv_count (B, Q) f32 read once, the
    (B, ZR, M, C) output written once; ``live`` (camera, cell) pairs, each
    2 x 2 taps of a multiply and an add a channel."""
    nb = (B * A * h * w * C * feat_bytes + B * A * ZR * (w + h) * 4
          + B * A * ZR * M * 4 + B * A * ZR + B * Q * 4
          + B * ZR * M * C * out_bytes)
    return float(nb), float(live) * C * 8


def lift_bwd_level_cost(B: int, A: int, h: int, w: int, C: int, ZR: int,
                        M: int, Q: int, live: int, g_bytes: int = 2,
                        dfeat_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, fp32 operations) of one level of the lift backward: the
    output gradient (B, ZR, M, C), the geometry and inv_count read once,
    the feature gradient (B, A, h, w, C) written once; the forward's
    operations, transposed."""
    nb = (B * ZR * M * C * g_bytes + B * A * ZR * (w + h) * 4
          + B * A * ZR * M * 4 + B * A * ZR + B * Q * 4
          + B * A * h * w * C * dfeat_bytes)
    return float(nb), float(live) * C * 8


def tap_cost(B: int, nq: int, H: int, W: int, C: int, heads: int, taps: int,
             v_bytes: int = 2, attn_bytes: int = 2, out_bytes: int = 4
             ) -> Tuple[float, float]:
    """(bytes, fp32 operations) of the tap attention forward: v (B, nq, H,
    W, C) and attn (B, H, W, nq, taps, heads) read once, out (B, H, W, C)
    written once; a multiply and an add an output element, slot and tap."""
    nb = (B * nq * H * W * C * v_bytes + B * H * W * nq * taps * heads
          * attn_bytes + B * H * W * C * out_bytes)
    return float(nb), float(B * H * W * C * nq * taps * 2)


def msda_corners(loc, shapes: Sequence[Tuple[int, int]]):
    """For each level of ``loc`` (N, Q, H, L, P, 2) normalised xy: the
    (valid, row) of each of the 2 x 2 bilinear corners, x = loc_x * w - 0.5
    and y = loc_y * h - 0.5 as grid_sample with align_corners=False, a
    corner counted only inside its level.  Yields (level, valid, row)."""
    import torch
    for lvl, (h, w) in enumerate(shapes):
        ll = loc[:, :, :, lvl].float()
        x = (ll[..., 0] * w - 0.5).clamp(-2.0, w + 1.0)
        y = (ll[..., 1] * h - 0.5).clamp(-2.0, h + 1.0)
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        for dy in (0, 1):
            for dx in (0, 1):
                cx, cy = x0 + dx, y0 + dy
                valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                yield lvl, valid, cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)


def msda_touched(value_shape: Sequence[int], shapes, loc
                 ) -> Tuple[int, int]:
    """(distinct value rows touched, in-level corners) of one MSDA call:
    a row is one (batch, head, position) of value (N, V, H, D) that some
    sample's in-level bilinear corner reads."""
    import torch
    N, V, H, _ = value_shape
    dev = loc.device
    base = (torch.arange(N, device=dev)[:, None, None, None] * H
            + torch.arange(H, device=dev)[None, None, :, None]) * V
    starts, s = [], 0
    for h, w in shapes:
        starts.append(s)
        s += h * w
    keys, corners = [], 0
    for lvl, valid, row in msda_corners(loc, shapes):
        keys.append((base + starts[lvl] + row)[valid])
        corners += int(valid.sum())
    return int(torch.unique(torch.cat(keys)).numel()), corners


def msda_cost(c: Dict) -> Tuple[float, float]:
    """(bytes, fp32 operations) of one MSDA forward call ``c`` (value
    (N, V, H, D), its element size, the touched rows and in-level corners,
    Q, the bytes of loc and attn): the touched value rows, loc and attn read
    once, the (N, Q, H * D) output written once in value's type; a multiply
    and an add a channel for each in-level corner."""
    N, _, H, D = c["value_shape"]
    nb = (c["rows"] * D * c["value_bytes"] + c["loc_bytes"] + c["attn_bytes"]
          + N * c["Q"] * H * D * c["value_bytes"])
    return float(nb), float(c["corners"]) * D * 2


def msda_bwd_cost(c: Dict) -> Tuple[float, float]:
    """(bytes, fp32 operations) of the backward of MSDA call ``c``: the
    touched value rows, loc, attn and the output gradient read once; dvalue
    (whole), dloc and dattn written once; per in-level corner a multiply
    and an add a channel for dvalue and as many for the corner's dot
    product."""
    N, V, H, D = c["value_shape"]
    la = c["loc_bytes"] + c["attn_bytes"]
    nb = (c["rows"] * D * c["value_bytes"] + la
          + N * c["Q"] * H * D * c["value_bytes"]
          + N * V * H * D * c["value_bytes"] + la)
    return float(nb), float(c["corners"]) * D * 4


# ---------------------------------------------------------------------------
# The model's operations, from the configuration
# ---------------------------------------------------------------------------

def _conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def resnet_convs(depth: int, H: int, W: int, frozen_stages: int
                 ) -> Tuple[List[Tuple[float, str]], List[Tuple[int, int]]]:
    """[(operations of one image, kind)] of every conv of the trunk, kind
    "frozen" (stem and stages <= frozen_stages: no backward), "first" (a
    trainable conv reading a frozen stage's output: no input gradient) or
    "train"; and the (h, w) of each stage's output."""
    convs, sizes = [], []

    def conv(cin, cout, k, s, h, w, kind):
        ho, wo = _conv_out(h, k, s), _conv_out(w, k, s)
        convs.append((2.0 * cin * cout * k * k * ho * wo, kind))
        return ho, wo

    h, w = conv(3, 64, 7, 2, H, W, "frozen" if frozen_stages >= 0
                else "train")
    h, w = _conv_out(h, 3, 2), _conv_out(w, 3, 2)        # max pool
    cin, mid = 64, 64
    for stage, n in enumerate(RESNET_BLOCKS[depth]):
        frozen = stage + 1 <= frozen_stages
        for b in range(n):
            s = 2 if (b == 0 and stage > 0) else 1
            reads_frozen = (b == 0 and not frozen
                            and stage == max(frozen_stages, 0)
                            and frozen_stages >= 0)
            first = "frozen" if frozen else ("first" if reads_frozen
                                             else "train")
            rest = "frozen" if frozen else "train"
            conv(cin, mid, 1, 1, h, w, first)
            ho, wo = conv(mid, mid, 3, s, h, w, rest)
            conv(mid, mid * 4, 1, 1, ho, wo, rest)
            if cin != mid * 4 or s != 1:
                conv(cin, mid * 4, 1, s, h, w, first)
            h, w, cin = ho, wo, mid * 4
        sizes.append((h, w))
        mid *= 2
    return convs, sizes


def feature_levels(m: Dict) -> List[Tuple[int, int]]:
    """(h, w) of the FPN levels the encoder reads, from the model config."""
    bb = m["backbone"]
    depth = int(bb["type"].replace("resnet", ""))
    _, sizes = resnet_convs(depth, m["img_h"], m["img_w"],
                            bb["frozen_stages"])
    levels = [sizes[i] for i in bb["out_indices"]]
    while len(levels) < m["neck"]["num_outs"]:
        h, w = levels[-1]
        levels.append((_conv_out(h, 3, 2), _conv_out(w, 3, 2)))
    return levels


def model_flops(m: Dict, batch: int, train: bool) -> float:
    """The model's matrix operations (convolutions, linear layers and the
    dense SCA's einsum; what the tensor cores take) for one forward of
    ``batch`` samples, and with ``train`` its backward too: twice the
    forward for every trainable layer (input and weight gradients), none
    for the frozen stem and stages, and no input gradient for a trainable
    conv that reads a frozen stage.  ``m`` is the model part of the
    configuration file.  The sampling ops (lift, tap, MSDA) and the
    elementwise work are not counted."""
    bb, enc = m["backbone"], m["encoder"]
    if not bb["type"].startswith("resnet") or any(bb["dcn_stages"]):
        raise ValueError("model_flops counts plain ResNet trunks only")
    depth = int(bb["type"].replace("resnet", ""))
    cams, C = m["num_cams"], m["embed_dims"]
    imgs = batch * cams
    trunk, sizes = resnet_convs(depth, m["img_h"], m["img_w"],
                                bb["frozen_stages"])
    mult = {"frozen": 1.0, "first": 2.0, "train": 3.0} if train else \
        {"frozen": 1.0, "first": 1.0, "train": 1.0}
    total = sum(f * mult[k] for f, k in trunk) * imgs
    step = 3.0 if train else 1.0          # forward (+ backward) of the rest

    def lin(rows: float, cin: int, cout: int) -> float:
        return 2.0 * rows * cin * cout

    levels = feature_levels(m)
    stage_ch = [64 * 2 ** s * 4 for s in range(4)]
    fpn = 0.0
    for i, s in enumerate(bb["out_indices"]):
        h, w = sizes[s]
        fpn += lin(h * w, stage_ch[s], C) + lin(h * w, 9 * C, C)
    for h, w in levels[len(bb["out_indices"]):]:
        fpn += lin(h * w, 9 * C, C)
    total += fpn * imgs * step

    Q = m["bev_h"] * m["bev_w"]
    V = sum(h * w for h, w in levels)
    tsa, sca = enc["tsa"], enc["sca"]
    L, Z = m["num_feature_levels"], enc["num_points_in_pillar"]
    layer = lin(Q, C, enc["ffn_dim"]) * 2 + lin(Q, C, C) * 2  # FFN, 2 out
    if enc["mode"] == "dense":
        pre = lin(cams * V, C, C)                     # shared value proj
        layer += lin(2 * Q, C, C)                     # TSA value proj
        layer += lin(Q, 2 * C, tsa["num_bev_queue"] * tsa["num_heads"] * 9)
        layer += lin(Q, C, sca["num_heads"] * L * Z)  # SCA weights
        layer += 2.0 * Q * C * L * Z                  # SCA einsum
    else:
        pre = 0.0
        K = min(sca["max_queries_per_cam"] or Q, Q)
        nq, H = tsa["num_bev_queue"], tsa["num_heads"]
        layer += lin(2 * Q, C, C)
        layer += lin(Q, 2 * C, nq * H * tsa["num_levels"]
                     * tsa["num_points"] * 3)          # offsets + weights
        layer += lin(cams * V, C, C)                   # SCA value proj
        layer += lin(cams * K, C, sca["num_heads"] * sca["num_levels"]
                     * sca["num_points"] * 3)
    enc_f = pre + layer * enc["num_layers"]
    vox = Q * m["pillar_h"]
    mid, od = C // m["pillar_h"], m["out_dim"]
    dec = lin(vox, 27 * mid, od) + lin(vox, 27 * od, od)
    dec += lin(vox, od, 2 * od) * 2 + lin(vox, 2 * od, m["num_classes"]) \
        + lin(vox, 2 * od, 2)
    total += (enc_f + dec) * batch * step
    return total


def mfu_percent(flops_per_item: float, items: int, window_s: float) -> float:
    """The share of the bf16 tensor-core peak that ``items`` of
    ``flops_per_item`` each over ``window_s`` seconds make, in %."""
    return 100.0 * flops_per_item * items / (window_s * BF16_TC_FLOPS)


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q % of them at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(1, -(-len(xs) * q // 100))
    return float(xs[int(k) - 1])
