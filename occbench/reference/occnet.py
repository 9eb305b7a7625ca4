"""Plain PyTorch reference of the OccNet occupancy model and its train step,
frozen in the benchmark and importing nothing of the program under test.

The model (OpenDriveLab/OccNet `bevformer_base_occ.py`, as the configuration
file states it): images -> ResNet (frozen batch norm) -> FPN -> a BEVFormer
encoder -> Conv3d voxel decoder -> occupancy and flow MLP heads; the loss is
cross entropy over the voxels plus L1 flow; the update clips by the global
norm and takes an AdamW step.  Two encoders:

- ``gather``: deformable temporal self-attention and spatial
  cross-attention.  Each camera's visible queries are selected exactly
  (every query with an anchor inside the image, as the original rebatches
  them), where the program takes a static top-K and certifies it.
  Deformable sampling is `torch.nn.functional.grid_sample`.
- ``dense``: the planar lift (each BEV cell and z-anchor sampled by two
  one-dimensional linear passes along and across its image line, averaged
  over the cameras that see the cell), a 3 x 3 tap self-attention over the
  [query, query] BEV grids, and an attention over the (level, z) slots.

Everything runs in float32 with TF32 off, unless a quantizer is given:
the control computes each convolution's and linear layer's inputs and
weights in fp8 (e4m3, one scale a tensor).  Weights come as a dict of the
parameter names of the configuration's model, made by the benchmark from
its seed.  Random draws (photometric distortion, grid mask, dropout) come
from a `torch.Generator` seeded from (seed, step), drawn in the model's
order and shapes, so a step's draws are the step's whatever the precision.
Memory: the trunk is recomputed a sample at a time in the backward and the
deformable sampling a block of queries at a time, so a step of 4 full-size
samples fits next to nothing else on one 80 GB card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from occbench.reference import geometry

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
QUERY_BLOCK = 8192


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 at one scale a tensor (amax -> 448), back in
    float32; the gradient passes straight through."""
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


class Net:
    """The model over a dict of float32 weights ``P`` and a model config
    dict ``m`` (the configuration file's ``config.model``)."""

    def __init__(self, P: Params, m: Dict, quant: Quant = None):
        self.P, self.m, self.q = P, m, quant or (lambda x: x)
        enc = m["encoder"]
        self.mode = enc["mode"]
        if self.mode not in ("dense", "gather"):
            raise ValueError(f"unknown encoder mode {self.mode!r}")
        bb = m["backbone"]
        if not bb["type"].startswith("resnet") or any(bb["dcn_stages"]) \
                or not bb["norm_eval"]:
            raise ValueError("the reference covers ResNet trunks with frozen "
                             "batch norm and no DCN")

    # -- layers ------------------------------------------------------------
    def linear(self, x, name, bias=True):
        b = self.P[name + ".bias"] if bias else None
        return F.linear(self.q(x), self.q(self.P[name + ".weight"]), b)

    def conv(self, x, name, k, stride=1, bias=False):
        b = self.P[name + ".bias"] if bias else None
        return F.conv2d(self.q(x), self.q(self.P[name + ".weight"]), b,
                        stride, k // 2)

    def frozen_bn(self, x, name):
        P = self.P
        inv = torch.rsqrt(P[name + ".running_var"] + 1e-5)
        mul = P[name + ".weight"] * inv
        add = P[name + ".bias"] - P[name + ".running_mean"] * mul
        return x * mul[:, None, None] + add[:, None, None]

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"],
                            self.P[name + ".bias"], 1e-5)

    # -- trunk and neck ------------------------------------------------------
    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(N, 3, H, W) -> the FPN levels, NCHW."""
        bb = self.m["backbone"]
        depth = int(bb["type"].replace("resnet", ""))
        frozen = bb["frozen_stages"]
        pre = "backbone."
        with torch.set_grad_enabled(torch.is_grad_enabled() and frozen < 0):
            x = F.relu(self.frozen_bn(self.conv(x, pre + "conv1", 7, 2),
                                      pre + "bn1"))
            x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        cin, mid = 64, 64
        for stage, n in enumerate(BLOCKS[depth]):
            grad = torch.is_grad_enabled() and stage + 1 > frozen
            with torch.set_grad_enabled(grad):
                for b in range(n):
                    s = 2 if (b == 0 and stage > 0) else 1
                    p = f"{pre}layer{stage + 1}_{b}."
                    y = F.relu(self.frozen_bn(self.conv(x, p + "conv1", 1),
                                              p + "bn1"))
                    y = F.relu(self.frozen_bn(self.conv(y, p + "conv2", 3, s),
                                              p + "bn2"))
                    y = self.frozen_bn(self.conv(y, p + "conv3", 1), p + "bn3")
                    if cin != mid * 4 or s != 1:
                        x = self.frozen_bn(
                            self.conv(x, p + "downsample_conv", 1, s),
                            p + "downsample_bn")
                    x = F.relu(y + x)
                    cin = mid * 4
            if stage in bb["out_indices"]:
                outs.append(x)
            mid *= 2
        return self.fpn(outs)

    def fpn(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n_in = len(inputs)
        lat = [self.conv(x, f"neck.lateral_{i}", 1, bias=True)
               for i, x in enumerate(inputs)]
        for i in range(n_in - 1, 0, -1):
            up = F.interpolate(lat[i], scale_factor=2, mode="nearest")
            h, w = lat[i - 1].shape[-2:]
            lat[i - 1] = lat[i - 1] + up[..., :h, :w]
        outs = [self.conv(lat[i], f"neck.fpn_{i}", 3, bias=True)
                for i in range(n_in)]
        for i in range(self.m["neck"]["num_outs"] - n_in):
            src = outs[-1]
            if self.m["neck"]["relu_before_extra_convs"] and i > 0:
                src = F.relu(src)
            outs.append(self.conv(src, f"neck.fpn_extra_{i}", 3, 2,
                                  bias=True))
        return outs

    def image_features(self, img: torch.Tensor) -> List[torch.Tensor]:
        """(B, cams, H, W, 3) -> [(B, cams, h, w, C)] a level; in training
        the trunk and neck are recomputed a sample at a time in the
        backward."""
        B, A, H, W, _ = img.shape

        def one(x):
            return self.trunk(x.permute(0, 3, 1, 2))

        if torch.is_grad_enabled():
            per = [checkpoint(one, img[b], use_reentrant=False)
                   for b in range(B)]
            feats = [torch.stack([p[lvl] for p in per])
                     for lvl in range(len(per[0]))]
        else:
            feats = [f.reshape(B, A, *f.shape[1:])
                     for f in one(img.reshape(B * A, H, W, 3))]
        return [f.permute(0, 1, 3, 4, 2) for f in feats]

    # -- the head --------------------------------------------------------
    def forward(self, img, ego2img, train: bool = False,
                gen: Optional[torch.Generator] = None):
        """img (B, cams, H, W, 3) normalised float32, ego2img (B, cams, 4,
        4) -> (occ logits (B, X, Y, Z, classes), flow (B, X, Y, Z, 2))."""
        m = self.m
        if train and m["use_grid_mask"]:
            img = grid_mask(img, gen, m["grid_mask_prob"])
        feats = self.image_features(img)
        P = self.P
        B = img.shape[0]
        hh, ww = m["bev_h"], m["bev_w"]
        row, col = P["head.positional_encoding.row_embed"], \
            P["head.positional_encoding.col_embed"]
        f = row.shape[1]
        pos = torch.cat([col[None].expand(hh, ww, f),
                         row[:, None].expand(hh, ww, f)], dim=-1)
        pos = pos.reshape(1, hh * ww, 2 * f).expand(B, -1, -1)
        query = P["head.bev_embedding"][None].expand(B, -1, -1)
        t = "head.transformer."
        feats = [x + P[t + "cams_embeds"][None, :, None, None, :]
                 + P[t + "level_embeds"][lvl]
                 if m["use_cams_embeds"] else x + P[t + "level_embeds"][lvl]
                 for lvl, x in enumerate(feats)]
        drop = Dropout(train, gen)
        if self.mode == "dense":
            value = self.lift([self.linear(x, t + "shared_value_proj")
                               for x in feats], ego2img)
            for lid in range(m["encoder"]["num_layers"]):
                p = f"{t}encoder.layer{lid}."
                query = self.layer_norm(self.dense_tsa(query, pos, p, drop),
                                        p + "norm1")
                query = self.layer_norm(self.dense_sca(query, value, p, drop),
                                        p + "norm2")
                query = self.layer_norm(self.ffn(query, p, drop), p + "norm3")
        else:
            value = torch.cat([x.reshape(*x.shape[:2], -1, x.shape[-1])
                               for x in feats], dim=2)
            shapes = [tuple(x.shape[2:4]) for x in feats]
            ref_2d = torch.from_numpy(geometry.plane_points(hh, ww)).to(
                img.device)
            ref_cam, mask = geometry.project(
                geometry.pillar_points(
                    hh, ww, m["pc_range"][5] - m["pc_range"][2],
                    m["encoder"]["num_points_in_pillar"]),
                m["pc_range"], ego2img, (m["img_h"], m["img_w"]))
            for lid in range(m["encoder"]["num_layers"]):
                p = f"{t}encoder.layer{lid}."
                query = self.layer_norm(self.tsa(query, pos, ref_2d, p, drop),
                                        p + "norm1")
                query = self.layer_norm(
                    self.sca(query, value, shapes, ref_cam, mask, p, drop),
                    p + "norm2")
                query = self.layer_norm(self.ffn(query, p, drop), p + "norm3")
        return self.decode(query, train)

    def ffn(self, x, p, drop):
        y = drop(F.relu(self.linear(x, p + "ffn.fc1")),
                 self.m["encoder"]["ffn_dropout"])
        return drop(self.linear(y, p + "ffn.fc2"),
                    self.m["encoder"]["ffn_dropout"]) + x

    # -- dense encoder -------------------------------------------------------
    def lift(self, feats: Sequence[torch.Tensor], ego2img: torch.Tensor
             ) -> torch.Tensor:
        """[(B, cams, h, w, C)] -> (B, L, Z, Q, C): each level sampled at
        every BEV cell's z-anchors by the two-pass taps, summed over the
        cameras and divided by the number that see the cell."""
        m = self.m
        Z = m["encoder"]["num_points_in_pillar"]
        levels = [tuple(x.shape[2:4]) for x in feats]
        geo, count = geometry.lift_geometry(
            ego2img, m["pc_range"], Z, (m["bev_h"], m["bev_w"]),
            (m["img_h"], m["img_w"]), levels)
        B, Q = count.shape
        inv = (1.0 / count)[:, None, :].expand(B, Z, Q).reshape(B, Z * Q)
        out = []
        for x, (pos1, pos2, steep), (h, w) in zip(feats, geo, levels):
            taps = [geometry.lift_taps(pos1, pos2, steep, a, h, w)
                    for a in range(x.shape[1])]
            y = TapSum.apply(x, taps) * inv[..., None]
            out.append(y.reshape(B, Z, Q, x.shape[-1]))
        return torch.stack(out, dim=1)

    def dense_tsa(self, query, pos, p, drop):
        m, enc = self.m, self.m["encoder"]
        B, Q, C = query.shape
        heads, nq = enc["tsa"]["num_heads"], enc["tsa"]["num_bev_queue"]
        T = len(TAPS)
        identity = query
        value = torch.stack([query, query], dim=1)
        q = query + pos
        query_aug = torch.cat([value[:, 0], q], dim=-1)
        value = self.linear(value, p + "self_attn.value_proj")
        attn = self.linear(query_aug, p + "self_attn.attention_weights")
        attn = torch.softmax(attn.reshape(B, Q, heads, nq, T), dim=-1)
        hh, ww = m["bev_h"], m["bev_w"]
        v = value.reshape(B, nq, hh, ww, C)
        a = attn.permute(0, 1, 3, 4, 2).reshape(B, hh, ww, nq, T, heads)
        out = checkpoint(tap_attention, v, a, use_reentrant=False)
        out = self.linear(out.reshape(B, Q, C), p + "self_attn.output_proj")
        return drop(out, enc["tsa"]["dropout"]) + identity

    def dense_sca(self, query, lifted, p, drop):
        enc = self.m["encoder"]
        B, Q, C = query.shape
        heads = enc["sca"]["num_heads"]
        L, Z = lifted.shape[1], lifted.shape[2]
        attn = self.linear(query, p + "cross_attn.attention_weights")
        attn = torch.softmax(attn.reshape(B, Q, heads, L * Z), dim=-1)
        attn = attn.reshape(B, Q, heads, L, Z)
        v = lifted.reshape(B, L, Z, Q, heads, C // heads)
        out = torch.einsum("blzqhd,bqhlz->bqhd", self.q(v),
                           self.q(attn)).reshape(B, Q, C)
        out = self.linear(out, p + "cross_attn.output_proj")
        return drop(out, enc["sca"]["dropout"]) + query

    # -- gather encoder ------------------------------------------------------
    def tsa(self, query, pos, ref_2d, p, drop):
        cfg = self.m["encoder"]["tsa"]
        B, Q, C = query.shape
        H, L, Pn, nq = (cfg["num_heads"], cfg["num_levels"],
                        cfg["num_points"], cfg["num_bev_queue"])
        identity = query
        value = torch.stack([query, query], dim=1)
        q = query + pos
        query_aug = torch.cat([value[:, 0], q], dim=-1)
        value = self.linear(value.reshape(B * nq, Q, C),
                            p + "self_attn.value_proj")
        value = value.reshape(B * nq, Q, H, C // H)
        off = self.linear(query_aug, p + "self_attn.sampling_offsets")
        off = off.reshape(B, Q, H, nq, L, Pn, 2)
        attn = self.linear(query_aug, p + "self_attn.attention_weights")
        attn = torch.softmax(attn.reshape(B, Q, H, nq, L * Pn), dim=-1)
        attn = attn.reshape(B, Q, H, nq, L, Pn).permute(
            0, 3, 1, 2, 4, 5).reshape(B * nq, Q, H, L, Pn)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * nq, Q, H, L, Pn, 2)
        hh, ww = self.m["bev_h"], self.m["bev_w"]
        norm = torch.tensor([[ww, hh]], dtype=torch.float32,
                            device=query.device)
        ref = ref_2d[None].expand(B * nq, Q, L, 2)
        loc = ref[:, :, None, :, None, :] + off / norm[None, None, None, :,
                                                       None, :]
        out = msda(value, [(hh, ww)], loc, attn)
        out = out.reshape(B, nq, Q, C).mean(dim=1)
        out = self.linear(out, p + "self_attn.output_proj")
        return drop(out, cfg["dropout"]) + identity

    def sca(self, query, value, shapes, ref_cam, mask, p, drop):
        cfg = self.m["encoder"]["sca"]
        B, Q, C = query.shape
        A = value.shape[1]
        H, L, Pn = cfg["num_heads"], cfg["num_levels"], cfg["num_points"]
        Z = ref_cam.shape[3]
        d = p + "cross_attn.deformable_attention."
        visible = mask.any(dim=-1).permute(1, 0, 2)            # (B, A, Q)
        count = visible.sum(dim=1).clamp(min=1).float()
        v = self.linear(value, d + "value_proj").reshape(B, A, -1, H, C // H)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        slots = []
        for b in range(B):
            acc = torch.zeros(Q, C, device=query.device)
            for a in range(A):
                idx = torch.nonzero(visible[b, a])[:, 0]
                n = idx.numel()
                if n == 0:
                    continue
                qs = query[b, idx][None]
                off = self.linear(qs, d + "sampling_offsets").reshape(
                    1, n, H, L, Pn, 2) / norm[None, None, None, :, None, :]
                att = self.linear(qs, d + "attention_weights")
                att = torch.softmax(att.reshape(1, n, H, L * Pn), dim=-1)
                att = att.reshape(1, n, H, L, Pn)
                ref = ref_cam[a, b, idx][None, :, None, None, None, :, :]
                loc = (ref + off.reshape(1, n, H, L, Pn // Z, Z, 2)).reshape(
                    1, n, H, L, Pn, 2)
                out = msda(v[b:b + 1, a], shapes, loc, att)[0]
                acc = acc.index_add(0, idx, out)
            slots.append(acc)
        out = torch.stack(slots) / count[..., None]
        out = self.linear(out, p + "cross_attn.output_proj")
        return drop(out, cfg["dropout"]) + query

    # -- decoder and heads -------------------------------------------------
    def decode(self, bev: torch.Tensor, train: bool):
        m = self.m
        B = bev.shape[0]
        mid = m["embed_dims"] // m["pillar_h"]
        x = bev.reshape(B, m["bev_h"], m["bev_w"], mid, m["pillar_h"])
        x = x.permute(0, 3, 4, 1, 2)
        t = "head.transformer."
        for name in ("decoder0", "decoder1"):
            x = F.conv3d(self.q(x), self.q(self.P[t + name + ".conv.weight"]),
                         None, 1, 1)
            x = F.relu(self.bn3d(x, t + name + ".bn", train))
        x = x.permute(0, 4, 3, 2, 1)

        def mlp(name, act):
            y = act(self.linear(x, t + name + ".fc1"))
            return self.linear(y, t + name + ".fc2")

        return mlp("predicter", F.softplus), mlp("flow_predicter", F.relu)

    def bn3d(self, x, name, train):
        """Batch statistics E[x] and E[x^2] - E[x]^2 (clipped at 0) in
        training, the running ones otherwise."""
        P = self.P
        if train:
            dims = (0, 2, 3, 4)
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp(min=0.0)
        else:
            mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        mul = torch.rsqrt(var + 1e-5) * P[name + ".weight"]
        shape = (-1, 1, 1, 1)
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + P[name + ".bias"].reshape(shape)


class Dropout:
    """Inverted dropout whose masks are uniform draws from the step's
    generator, one draw of the activation's shape a call, kept where the
    draw is at least the rate."""

    def __init__(self, train: bool, gen: Optional[torch.Generator]):
        self.train, self.gen = train, gen

    def __call__(self, x, rate):
        if not self.train or rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


class TapSum(torch.autograd.Function):
    """out (B, N, C) = sum over cameras a and taps t of wt * x[b, a, pix]
    for x (B, A, h, w, C); the backward adds each weighted output gradient
    back into its pixel."""

    @staticmethod
    def forward(ctx, x, taps):
        B, A, h, w, C = x.shape
        flat = x.reshape(B, A, h * w, C)
        N = taps[0][0][0].shape[1]
        out = torch.zeros(B, N, C, dtype=x.dtype, device=x.device)
        for a in range(A):
            for wt, pix in taps[a]:
                for b in range(B):
                    out[b] += wt[b, :, None] * flat[b, a, pix[b]]
        ctx.taps, ctx.shape = taps, x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        B, A, h, w, C = ctx.shape
        dx = torch.zeros(B, A, h * w, C, dtype=g.dtype, device=g.device)
        for a in range(A):
            for wt, pix in ctx.taps[a]:
                for b in range(B):
                    dx[b, a].index_add_(0, pix[b], wt[b, :, None] * g[b])
        return dx.reshape(ctx.shape), None


def tap_attention(v: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """v (B, nq, H, W, C), attn (B, H, W, nq, taps, heads) -> (B, H, W, C):
    out[y, x] = (1 / nq) sum_{n, t} attn[y, x, n, t] * v[n, y - dy, x - dx]
    over the 3 x 3 taps (dy, dx), zero outside the grid."""
    B, nq, H, W, C = v.shape
    heads = attn.shape[-1]
    pad = F.pad(v, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(B, H, W, heads, C // heads, device=v.device)
    for t, (dy, dx) in enumerate(TAPS):
        sh = pad[:, :, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W].reshape(
            B, nq, H, W, heads, C // heads)
        out = out + torch.einsum("bnywhd,bywnh->bywhd", sh,
                                 attn[:, :, :, :, t, :])
    return (out / nq).reshape(B, H, W, C)


def _msda_block(value, shapes, loc, attn):
    N, _, H, D = value.shape
    Q, Pn = loc.shape[1], loc.shape[4]
    out, start = 0.0, 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            N * H, D, h, w)
        grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            N * H, Q, Pn, 2) * 2.0 - 1.0
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)              # (NH, D, Q, P)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(N * H, 1, Q, Pn)
        out = out + (s * a).sum(dim=-1)
        start += h * w
    return out.reshape(N, H, D, Q).permute(0, 3, 1, 2).reshape(N, Q, H * D)


def msda(value, shapes, loc, attn) -> torch.Tensor:
    """Multi-scale deformable attention: value (N, V, H, D) levels
    flattened, loc (N, Q, H, L, P, 2) normalised xy, attn (N, Q, H, L, P)
    -> (N, Q, H * D) = sum over levels and points of attn times the
    bilinear sample (grid_sample, zero padding, align_corners=False);
    blocks of queries, recomputed in the backward."""
    Q = loc.shape[1]
    if not torch.is_grad_enabled() or Q <= QUERY_BLOCK:
        return _msda_block(value, shapes, loc, attn)
    return torch.cat([
        checkpoint(_msda_block, value, shapes, loc[:, i:i + QUERY_BLOCK],
                   attn[:, i:i + QUERY_BLOCK], use_reentrant=False)
        for i in range(0, Q, QUERY_BLOCK)], dim=1)


def grid_mask(img: torch.Tensor, gen: torch.Generator, prob: float,
              ratio: float = 0.5) -> torch.Tensor:
    """One grid mask for every image of the batch: applied with
    probability ``prob``, period d uniform in [2, H), stripes of length
    clip(int(d * ratio + 0.5), 1, d - 1) at random phases on a 1.5x canvas
    cropped centrally; a pixel is kept in a row or a column stripe."""
    h, w = img.shape[2:4]
    dev = img.device

    def uni():
        return torch.rand((), generator=gen, device=dev)

    apply = uni() < prob
    d = torch.randint(2, h, (), generator=gen, device=dev)
    st_h = (uni() * d).floor().long().clamp(max=d - 1)
    st_w = (uni() * d).floor().long().clamp(max=d - 1)
    ln = torch.minimum((d.float() * ratio + 0.5).long().clamp(min=1), d - 1)
    ys = torch.arange(h, device=dev) + ((3 * h) // 2 - h) // 2
    xs = torch.arange(w, device=dev) + ((3 * w) // 2 - w) // 2
    keep = (torch.remainder(ys - st_h, d) < ln)[:, None] | \
        (torch.remainder(xs - st_w, d) < ln)[None, :]
    mask = torch.where(apply, keep, torch.ones_like(keep)).to(img.dtype)
    return img * mask[None, None, :, :, None]


# ---------------------------------------------------------------------------
# Input processing, loss and the update
# ---------------------------------------------------------------------------

def mean_std(data: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = np.asarray(data["img_mean"], np.float32)
    std = np.asarray(data["img_std"], np.float32)
    if not data["to_rgb"]:
        mean, std = mean[::-1].copy(), std[::-1].copy()
    return torch.from_numpy(mean), torch.from_numpy(std)


def normalize(imgs: torch.Tensor, data: Dict, divisor: int = 32
              ) -> torch.Tensor:
    """uint8 or float (..., H, W, 3) RGB -> (x - mean) / std, zero-padded
    at the bottom and right to multiples of ``divisor``."""
    mean, std = mean_std(data)
    out = (imgs.float() - mean.to(imgs.device)) / std.to(imgs.device)
    h, w = out.shape[-3], out.shape[-2]
    return F.pad(out, (0, 0, 0, (-w) % divisor, 0, (-h) % divisor))


def _rgb_to_hsv(img):
    rgb = img / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    delta = maxc - minc
    zero = torch.zeros((), device=img.device)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), zero)
    dz = delta.clamp(min=1e-12)
    h = torch.where(maxc == r, torch.remainder((g - b) / dz, 6.0),
                    torch.where(maxc == g, (b - r) / dz + 2.0,
                                (r - g) / dz + 4.0))
    h = torch.where(delta > 0, h * 60.0, zero)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    i = torch.remainder(torch.floor(h), 6)
    f = h - torch.floor(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([v, q, p, p, t], v), select([t, v, v, q, p], p),
                        select([p, p, t, v, v], q)], dim=-1) * 255.0


def photometric(imgs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The train-time photometric distortion of float (..., H, W, 3) RGB in
    [0, 255], one draw set an image (each step on with probability 0.5):
    brightness +-32, contrast x[0.5, 1.5] before or after the HSV round
    trip, saturation x[0.5, 1.5], hue +-18 degrees, a channel permutation."""
    lead = imgs.shape[:-3]
    img = imgs.reshape((-1,) + imgs.shape[-3:])
    n, dev = img.shape[0], img.device

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def gate():
        return torch.rand(n, generator=gen, device=dev) < 0.5

    d = {"bright_on": gate(), "bright": uni(-32.0, 32.0), "mode1": gate(),
         "contrast_pre_on": gate(), "contrast_pre": uni(0.5, 1.5),
         "sat_on": gate(), "sat": uni(0.5, 1.5), "hue_on": gate(),
         "hue": uni(-18.0, 18.0), "contrast_post_on": gate(),
         "contrast_post": uni(0.5, 1.5)}
    d["perm"] = torch.rand(n, 3, generator=gen, device=dev).argsort(-1)
    d["swap_on"] = gate()

    def per(x):
        return x.reshape(-1, 1, 1, 1)

    def per3(x):
        return x.reshape(-1, 1, 1)

    img = torch.where(per(d["bright_on"]), img + per(d["bright"]), img)
    img = torch.where(per(d["mode1"] & d["contrast_pre_on"]),
                      img * per(d["contrast_pre"]), img)
    hsv = _rgb_to_hsv(img)
    s = torch.where(per3(d["sat_on"]), hsv[..., 1] * per3(d["sat"]),
                    hsv[..., 1])
    h = hsv[..., 0] + torch.where(per3(d["hue_on"]), per3(d["hue"]),
                                  torch.zeros((), device=dev))
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    img = _hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    img = torch.where(per(~d["mode1"] & d["contrast_post_on"]),
                      img * per(d["contrast_post"]), img)
    swapped = torch.gather(img, -1, d["perm"].reshape(-1, 1, 1, 3).expand(
        img.shape))
    img = torch.where(per(d["swap_on"]), swapped, img)
    return img.reshape(lead + imgs.shape[-3:])


def loss_fn(occ, flow, semantics, voxel_flow, loss_cfg: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(occupancy loss, flow loss): mean cross entropy over the voxels and
    the mean absolute flow error, each times its weight."""
    if loss_cfg["class_weights"] or loss_cfg["use_mask"] \
            or loss_cfg["flow_fg_weight"] != 1.0:
        raise ValueError("the reference covers the unweighted, unmasked loss")
    logp = torch.log_softmax(occ.reshape(-1, occ.shape[-1]), dim=-1)
    ce = -logp.gather(1, semantics.long().reshape(-1, 1))[:, 0]
    l1 = (flow - voxel_flow.float()).abs()
    return loss_cfg["occ_weight"] * ce.mean(), \
        loss_cfg["flow_weight"] * l1.mean()


def lr_at(step: int, o: Dict) -> float:
    """Linear warm-up from warmup_ratio, then cosine to min_lr_ratio over
    total_epochs * steps_per_epoch steps."""
    total = o["total_epochs"] * o["steps_per_epoch"]
    frac = min(max(step / max(o["warmup_iters"], 1), 0.0), 1.0)
    warm = 1.0 - (1.0 - frac) * (1.0 - o["warmup_ratio"])
    prog = min(max(step / max(total, 1), 0.0), 1.0)
    lo = o["lr"] * o["min_lr_ratio"]
    cos = lo + (o["lr"] - lo) * 0.5 * (1 + math.cos(math.pi * prog))
    return cos * (warm if step < o["warmup_iters"] else 1.0)


def lr_mult(name: str, cfg: Dict) -> float:
    """0 for the stem and the frozen stages, the backbone multiplier for
    the rest of the trunk, 1 elsewhere."""
    frozen = cfg["model"]["backbone"]["frozen_stages"]
    parts = name.split(".")
    if parts[0] != "backbone":
        return 1.0
    sub = parts[1] if len(parts) > 1 else ""
    if sub in ("conv1", "bn1") and frozen >= 0:
        return 0.0
    if any(sub.startswith(f"layer{s}_") for s in range(1, frozen + 1)):
        return 0.0
    return cfg["optim"]["backbone_lr_mult"]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % 2 ** 63)


def train_steps(weights: Params, param_names: Sequence[str], cfg: Dict,
                seed: int, batches: Sequence[Dict[str, torch.Tensor]],
                quant: Quant = None, keep: Optional[int] = None) -> Dict:
    """The first ``len(batches)`` steps from ``weights``: per step the
    distortion, normalisation and padding of the uint8 images, the grid
    mask and dropout of the step's generator, forward, loss, backward,
    the global-norm clip and AdamW at the step's learning rate.  ``keep``
    cuts every batch to its first ``keep`` samples (a fault: half of the
    batch left out).  Returns {"loss": [a step], "grad": {name: first
    gradient as clipped}, "delta": {name: change over all the steps}}."""
    m, o = cfg["model"], cfg["optim"]
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    train = [n for n in param_names if lr_mult(n, cfg) != 0.0]
    for n in train:
        params[n].requires_grad_(True)
    groups: Dict[float, List[torch.Tensor]] = {}
    for n in train:
        groups.setdefault(lr_mult(n, cfg), []).append(params[n])
    opt = torch.optim.AdamW(
        [{"params": ps, "lr_mult": mult} for mult, ps in groups.items()],
        lr=o["lr"], betas=(0.9, 0.999), eps=1e-8,
        weight_decay=o["weight_decay"])
    net = Net(params, m, quant)
    start = {n: params[n].detach().clone() for n in train}
    losses, first = [], None
    for step, batch in enumerate(batches):
        dev = batch["ego2img"].device
        gen = step_generator(seed, step, dev)
        sl = slice(None) if keep is None else slice(0, keep)
        img = batch["img"][sl].float()
        if cfg["data"]["device_distortion"]:
            img = photometric(img, gen)
        img = normalize(img, cfg["data"])
        occ, flow = net.forward(img, batch["ego2img"][sl], True, gen)
        lo, lf = loss_fn(occ, flow, batch["voxel_semantics"][sl],
                         batch["voxel_flow"][sl], cfg["loss"])
        loss = lo + lf
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ps = [params[n] for n in train]
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in ps]))
        keep_g = norm < o["grad_clip_norm"]
        for p in ps:
            p.grad.copy_(torch.where(keep_g, p.grad,
                                     p.grad / norm * o["grad_clip_norm"]))
        if first is None:
            first = {n: float(torch.linalg.vector_norm(params[n].grad))
                     for n in train}
        lr = lr_at(step, o)
        for g in opt.param_groups:
            g["lr"] = lr * g["lr_mult"]
        opt.step()
        losses.append(float(loss.detach()))
    delta = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n]))
             for n in train}
    return {"loss": losses, "grad": first, "delta": delta}
