"""Weight bridge between the JAX package and the port.

`from_jax_variables` turns the JAX package's ``{"params", "batch_stats"}``
tree (numpy-convertible leaves) into the port's ``state_dict``;
`to_jax_variables` is its inverse, so a state_dict trained by the port can
be compared with, or handed back to, the JAX package as a flax tree.  The
port's module names mirror the flax scopes, so a key is the flax path joined
by dots, with the leaf renamed and laid out for PyTorch:

  Dense kernel (in, out)             -> Linear weight (out, in)
  Conv kernel (kh, kw, I, O)         -> Conv2d weight (O, I, kh, kw)
  Conv3d kernel (kd, kh, kw, I, O)   -> Conv3d weight (O, I, kd, kh, kw)
                                        (kd is the pillar/z axis both sides)
  DenseGeneral kernel (C, H, D) or   -> weight, unchanged (the detection
  (H, D, C)                             decoder's self-attention)
  bias                               -> bias
  BatchNorm / LayerNorm scale        -> weight
  batch_stats mean / var             -> running_mean / running_var
  tables (embeddings, row/col_embed) -> unchanged

JAX -> port is a straight transpose; there is no RGB flip of conv1 (that flip
belongs to torchvision -> JAX, `occnet_tpu/utils/torch_convert.py`).

`init_jax_style_variables` builds the JAX package's tree for a config (a
ResNet trunk with or without DCN stages, or VoVNet; dense or gather
encoder), and `init_jax_style_perception_variables` the tree of the
detection path's `PerceptionTransformer`, with numpy, using the JAX
initialisers, so the port runs at the activation scale the JAX package runs
at without importing JAX.
`randomize_variables` fills the zero/identity-initialised leaves (attention
weights, biases, norm scales, BN statistics) with random values, so a
comparison also exercises their layouts.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from occnet_tpu_torch.config import ModelConfig

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_KERNEL_PERM = {2: (1, 0), 3: (0, 1, 2), 4: (3, 2, 0, 1),
                5: (4, 3, 0, 1, 2)}


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> the port's state_dict."""
    out = {}
    for path, leaf in _flatten(variables["params"]):
        arr = np.array(leaf, np.float32)
        *scope, name = path
        if name == "kernel":
            arr, name = arr.transpose(_KERNEL_PERM[arr.ndim]), "weight"
        elif name == "scale":
            name = "weight"
        out[".".join(scope + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        *scope, name = path
        out[".".join(scope + [_STAT_NAMES[name]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return out


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's state_dict -> the JAX ``{"params", "batch_stats"}`` tree
    of numpy float32 leaves; the inverse of `from_jax_variables`."""
    params: dict = {}
    stats: dict = {}
    stat_names = {v: k for k, v in _STAT_NAMES.items()}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        *scope, name = key.split(".")
        if name in stat_names:
            _set(stats, "/".join(scope + [stat_names[name]]), arr)
            continue
        if name == "weight" and arr.ndim == 1:
            name = "scale"
        elif name == "weight":
            arr = arr.transpose(np.argsort(_KERNEL_PERM[arr.ndim]))
            name = "kernel"
        _set(params, "/".join(scope + [name]), np.ascontiguousarray(arr))
    return {"params": params, "batch_stats": stats}


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    *scope, leaf = path.split("/")
    for k in scope:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


class _Init:
    """The JAX initialisers drawn with numpy from one `RandomState`, and
    the tree writers of `init_jax_style_variables`."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.params: dict = {}
        self.stats: dict = {}

    def truncated(self, shape, scale):
        """variance_scaling(scale, fan_in, truncated_normal) on [-2, 2]."""
        std = np.sqrt(scale / np.prod(shape[:-1])) / .87962566103423978
        x = self.rng.randn(*shape)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = self.rng.randn(int(bad.sum()))
            bad = np.abs(x) > 2.0
        return (x * std).astype(np.float32)

    def he_normal(self, shape):
        return self.truncated(shape, 2.0)

    def lecun_normal(self, shape):
        return self.truncated(shape, 1.0)

    def xavier(self, shape):
        rf = int(np.prod(shape[:-2]))
        lim = np.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
        return self.rng.uniform(-lim, lim, shape).astype(np.float32)

    def set(self, path, value):
        _set(self.params, path, value)

    def dense(self, path, i, o, zero=False, bias=None, kernel=None):
        self.set(path + "/kernel", np.zeros((i, o), np.float32) if zero
                 else (kernel or self.xavier)((i, o)))
        self.set(path + "/bias", np.zeros(o, np.float32) if bias is None
                 else bias.astype(np.float32))

    def norm(self, path, c, stats_too=False):
        self.set(path + "/scale", np.ones(c, np.float32))
        self.set(path + "/bias", np.zeros(c, np.float32))
        if stats_too:
            _set(self.stats, path + "/mean", np.zeros(c, np.float32))
            _set(self.stats, path + "/var", np.ones(c, np.float32))

    def tree(self) -> dict:
        return {"params": self.params, "batch_stats": self.stats}


def _init_resnet(init: _Init, m: ModelConfig, bb: str) -> None:
    """he_normal convs (the DCN layers' weights included), zero
    `conv_offset`s, identity norms and statistics."""
    from occnet_tpu_torch.models.resnet import STAGE_BLOCKS
    init.set(f"{bb}/conv1/kernel", init.he_normal((7, 7, 3, 64)))
    init.norm(f"{bb}/bn1", 64, True)
    in_ch, mid = 64, 64
    depth = int(m.backbone.type.replace("resnet", ""))
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            p = f"{bb}/layer{stage + 1}_{b}"
            for name, shape in (("conv1", (1, 1, in_ch, mid)),
                                ("conv2", (3, 3, mid, mid)),
                                ("conv3", (1, 1, mid, mid * 4))):
                init.set(f"{p}/{name}/kernel", init.he_normal(shape))
            if m.backbone.dcn_stages[stage]:
                # DCNv2: conv2/kernel is the deformable conv's weight, and
                # its zero-initialised conv_offset predicts 2 * 9 offsets
                # and 9 mask logits
                init.set(f"{p}/conv2/conv_offset/kernel",
                         np.zeros((3, 3, mid, 27), np.float32))
                init.set(f"{p}/conv2/conv_offset/bias",
                         np.zeros(27, np.float32))
            init.norm(f"{p}/bn1", mid, True)
            init.norm(f"{p}/bn2", mid, True)
            init.norm(f"{p}/bn3", mid * 4, True)
            if in_ch != mid * 4 or stride != 1:
                init.set(f"{p}/downsample_conv/kernel",
                         init.he_normal((1, 1, in_ch, mid * 4)))
                init.norm(f"{p}/downsample_bn", mid * 4, True)
            in_ch = mid * 4
        mid *= 2


def _init_vovnet(init: _Init, spec: str, bb: str) -> None:
    """he_normal convs (depthwise ones too), the eSE gates' 1x1 conv
    lecun_normal with a zero bias, identity norms and statistics."""
    from occnet_tpu_torch.models.vovnet import VOVNET_SPECS
    s = VOVNET_SPECS[spec]

    def conv_bn(p, k, cin, cout):
        init.set(f"{p}/conv/kernel", init.he_normal((k, k, cin, cout)))
        init.norm(f"{p}/bn", cout, True)

    def dw_block(p, c):
        init.set(f"{p}/dw_conv/kernel", init.he_normal((3, 3, 1, c)))
        init.set(f"{p}/pw_conv/kernel", init.he_normal((1, 1, c, c)))
        init.norm(f"{p}/pw_bn", c, True)

    stem = s["stem"]
    conv_bn(f"{bb}/stem0", 3, 3, stem[0])
    if s["dw"]:
        dw_block(f"{bb}/stem1", stem[1])
        dw_block(f"{bb}/stem2", stem[2])
    else:
        conv_bn(f"{bb}/stem1", 3, stem[0], stem[1])
        conv_bn(f"{bb}/stem2", 3, stem[1], stem[2])
    ch = stem[2]
    for stage in range(4):
        conv, out = s["conv"][stage], s["out"][stage]
        for b in range(s["blocks"][stage]):
            p = f"{bb}/stage{stage + 2}_{b}"
            x = ch
            if s["dw"] and ch != conv:
                conv_bn(f"{p}/reduction", 1, ch, conv)
                x = conv
            for i in range(s["layers"]):
                if s["dw"]:
                    dw_block(f"{p}/l{i}", conv)
                else:
                    conv_bn(f"{p}/l{i}", 3, x, conv)
                x = conv
            conv_bn(f"{p}/concat", 1, ch + s["layers"] * conv, out)
            init.set(f"{p}/ese/fc/kernel", init.lecun_normal((1, 1, out,
                                                              out)))
            init.set(f"{p}/ese/fc/bias", np.zeros(out, np.float32))
            ch = out


def _init_encoder_layer(init: _Init, p: str, m: ModelConfig, mode: str
                        ) -> None:
    """One BEVFormer encoder layer of ``mode``: xavier_uniform Dense
    kernels, zeros for `attention_weights` and `sampling_offsets`, the
    radial grid for `sampling_offsets` biases, identity norms."""
    from occnet_tpu_torch.models.attention import radial_offset_bias
    from occnet_tpu_torch.ops.tsa import TSA_TAPS
    C, e = m.embed_dims, m.encoder
    L, Z = m.num_feature_levels, e.num_points_in_pillar
    H, nq = e.tsa.num_heads, e.tsa.num_bev_queue
    if mode == "dense":
        init.dense(f"{p}/self_attn/value_proj", C, C)
        init.dense(f"{p}/self_attn/attention_weights", 2 * C,
                   nq * H * len(TSA_TAPS), zero=True)
        init.dense(f"{p}/self_attn/output_proj", C, C)
        init.dense(f"{p}/cross_attn/attention_weights", C,
                   e.sca.num_heads * L * Z, zero=True)
    else:
        tL, tP = e.tsa.num_levels, e.tsa.num_points
        init.dense(f"{p}/self_attn/value_proj", C, C)
        init.dense(f"{p}/self_attn/sampling_offsets", 2 * C,
                   nq * H * tL * tP * 2, zero=True,
                   bias=radial_offset_bias(H, tL * nq, tP))
        init.dense(f"{p}/self_attn/attention_weights", 2 * C,
                   nq * H * tL * tP, zero=True)
        init.dense(f"{p}/self_attn/output_proj", C, C)
        s = e.sca
        da = f"{p}/cross_attn/deformable_attention"
        init.dense(f"{da}/value_proj", C, C)
        init.dense(f"{da}/sampling_offsets", C,
                   s.num_heads * s.num_levels * s.num_points * 2, zero=True,
                   bias=radial_offset_bias(s.num_heads, s.num_levels,
                                           s.num_points))
        init.dense(f"{da}/attention_weights", C,
                   s.num_heads * s.num_levels * s.num_points, zero=True)
    init.dense(f"{p}/cross_attn/output_proj", C, C)
    init.dense(f"{p}/ffn/fc1", C, e.ffn_dim)
    init.dense(f"{p}/ffn/fc2", e.ffn_dim, C)
    for n in ("norm1", "norm2", "norm3"):
        init.norm(f"{p}/{n}", C)


def init_jax_style_variables(cfg, seed: int = 0) -> dict:
    """The flax init tree of `occnet_tpu.models.detector.OccNet` for
    ``cfg`` (OccNetConfig or ModelConfig: a ResNet or VoVNet trunk, a dense
    or gather encoder), drawn with numpy from ``seed`` with the same
    initialisers: he_normal for trunk convs (the DCN layers' weights
    included), lecun_normal for the VoVNet eSE gates, xavier_uniform for
    FPN convs / Dense / Conv3d, zeros for the DCN layers' `conv_offset`,
    for `attention_weights`, `sampling_offsets` kernels and biases, the
    radial grid (`radial_offset_bias`) for `sampling_offsets` biases,
    normal(1) for embeddings, uniform[0, 1) for positional tables, identity
    norms and BN statistics."""
    m: ModelConfig = getattr(cfg, "model", cfg)
    from occnet_tpu_torch.models.resnet import stage_channels
    from occnet_tpu_torch.models.vovnet import vovnet_channels
    if m.encoder.mode not in ("dense", "gather"):
        raise ValueError(f"unknown encoder mode {m.encoder.mode!r}")
    init = _Init(seed)
    rng = init.rng
    f32 = np.float32
    if m.backbone.type == "vovnet":
        _init_vovnet(init, m.backbone.vovnet_spec, "backbone")
        ins = vovnet_channels(m.backbone.vovnet_spec, m.backbone.out_indices)
    else:
        _init_resnet(init, m, "backbone")
        ins = stage_channels(m.backbone.out_indices)

    # neck
    C = m.embed_dims
    convs = ([(f"lateral_{i}", 1, c) for i, c in enumerate(ins)]
             + [(f"fpn_{i}", 3, C) for i in range(len(ins))]
             + [(f"fpn_extra_{i}", 3, C)
                for i in range(m.neck.num_outs - len(ins))])
    for name, k, cin in convs:
        init.set(f"neck/{name}/kernel", init.xavier((k, k, cin, C)))
        init.set(f"neck/{name}/bias", np.zeros(C, f32))

    # head
    Q = m.bev_h * m.bev_w
    init.set("head/bev_embedding", rng.randn(Q, C).astype(f32))
    init.set("head/positional_encoding/row_embed",
             rng.uniform(0, 1, (m.bev_h, C // 2)).astype(f32))
    init.set("head/positional_encoding/col_embed",
             rng.uniform(0, 1, (m.bev_w, C // 2)).astype(f32))
    t = "head/transformer"
    init.set(f"{t}/level_embeds",
             rng.randn(m.num_feature_levels, C).astype(f32))
    init.set(f"{t}/cams_embeds", rng.randn(m.num_cams, C).astype(f32))
    e = m.encoder
    if e.mode == "dense":
        init.dense(f"{t}/shared_value_proj", C, C)
    for lid in range(e.num_layers):
        _init_encoder_layer(init, f"{t}/encoder/layer{lid}", m, e.mode)
    middle = C // m.pillar_h
    for name, cin in (("decoder0", middle), ("decoder1", m.out_dim)):
        init.set(f"{t}/{name}/conv/kernel",
                 init.xavier((3, 3, 3, cin, m.out_dim)))
        init.norm(f"{t}/{name}/bn", m.out_dim, True)
    for name, out in (("predicter", m.num_classes), ("flow_predicter", 2)):
        init.dense(f"{t}/{name}/fc1", m.out_dim, m.out_dim * 2)
        init.dense(f"{t}/{name}/fc2", m.out_dim * 2, out)
    return init.tree()


def init_jax_style_perception_variables(
        cfg, num_query: int = 900, code_size: int = 10,
        decoder_layers: int = 6, can_bus_norm: bool = True,
        seed: int = 0) -> dict:
    """The flax init tree of `occnet_tpu.models.perception.
    PerceptionTransformer` (its encoder in gather mode, whatever
    ``cfg``'s), drawn with numpy from ``seed`` with its initialisers:
    normal(1) for the embeddings and the query table, uniform[0, 1) for the
    positional tables, xavier_uniform for its Dense kernels (lecun_normal
    for the self-attention's and the regression branches'), zeros for the
    decoder's `sampling_offsets` / `attention_weights` kernels and
    `attention_weights` bias, the radial grid for its `sampling_offsets`
    bias, zero biases, identity norms."""
    from occnet_tpu_torch.models.attention import radial_offset_bias
    m: ModelConfig = getattr(cfg, "model", cfg)
    init = _Init(seed)
    rng = init.rng
    f32 = np.float32
    C = m.embed_dims
    init.set("level_embeds", rng.randn(m.num_feature_levels, C).astype(f32))
    init.set("cams_embeds", rng.randn(m.num_cams, C).astype(f32))
    init.set("bev_embedding", rng.randn(m.bev_h * m.bev_w, C).astype(f32))
    init.set("query_embedding", rng.randn(num_query, 2 * C).astype(f32))
    init.set("positional_encoding/row_embed",
             rng.uniform(0, 1, (m.bev_h, C // 2)).astype(f32))
    init.set("positional_encoding/col_embed",
             rng.uniform(0, 1, (m.bev_w, C // 2)).astype(f32))
    init.dense("can_bus_mlp/fc1", 18, C // 2)
    init.dense("can_bus_mlp/fc2", C // 2, C)
    if can_bus_norm:
        init.norm("can_bus_mlp/norm", C)
    init.dense("reference_points", C, 3)
    for lid in range(m.encoder.num_layers):
        _init_encoder_layer(init, f"encoder/layer{lid}", m, "gather")
    H, P = 8, 4               # the decoder's heads and points (JAX's)
    D = C // H
    for lid in range(decoder_layers):
        p = f"decoder/layer{lid}"
        for name in ("query", "key", "value"):
            init.set(f"{p}/self_attn/{name}/kernel",
                     init.lecun_normal((C, H * D)).reshape(C, H, D))
            init.set(f"{p}/self_attn/{name}/bias", np.zeros((H, D), f32))
        init.set(f"{p}/self_attn/out/kernel",
                 init.lecun_normal((H * D, C)).reshape(H, D, C))
        init.set(f"{p}/self_attn/out/bias", np.zeros(C, f32))
        ca = f"{p}/cross_attn"
        init.dense(f"{ca}/value_proj", C, C)
        init.dense(f"{ca}/sampling_offsets", C, H * P * 2, zero=True,
                   bias=radial_offset_bias(H, 1, P))
        init.dense(f"{ca}/attention_weights", C, H * P, zero=True)
        init.dense(f"{ca}/output_proj", C, C)
        init.dense(f"{p}/ffn_fc1", C, m.encoder.ffn_dim)
        init.dense(f"{p}/ffn_fc2", m.encoder.ffn_dim, C)
        for n in ("norm1", "norm2", "norm3"):
            init.norm(f"{p}/{n}", C)
    for i in range(decoder_layers):
        for name, o in (("fc1", C), ("fc2", C), ("out", code_size)):
            init.dense(f"reg_branch{i}/{name}", C, o,
                       kernel=init.lecun_normal)
    return init.tree()


def randomize_variables(variables, seed: int) -> dict:
    """Copy of ``variables`` whose zero- or identity-initialised leaves are
    random: all-zero kernels xavier-uniform, biases N(0, 0.1^2), norm scales
    U(0.5, 1.5), BN means N(0, 0.1^2) and variances U(0.5, 1.5).  Other
    kernels and the embedding tables keep their (already random) values."""
    rng = np.random.RandomState(seed)

    def fill(tree, collection):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, collection)
                continue
            a = np.array(v, np.float32)
            if collection == "batch_stats":
                a = (rng.normal(0, 0.1, a.shape) if k == "mean"
                     else rng.uniform(0.5, 1.5, a.shape))
            elif k == "kernel" and not a.any():
                rf = int(np.prod(a.shape[:-2]))
                lim = np.sqrt(6.0 / (rf * (a.shape[-2] + a.shape[-1])))
                a = rng.uniform(-lim, lim, a.shape)
            elif k == "bias":
                a = rng.normal(0, 0.1, a.shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, a.shape)
            out[k] = a.astype(np.float32)
        return out

    return {c: fill(variables[c], c) for c in ("params", "batch_stats")
            if c in variables}


def calibrate_dcn_offsets(model: torch.nn.Module, img: torch.Tensor,
                          ego2img: torch.Tensor, max_px: float,
                          max_logit: float = 4.0) -> Dict[str, Tuple]:
    """Rescale, in place, every DCN layer's conv_offset kernel so that the
    largest |offset| the layer predicts for this input is ``max_px`` and
    its largest |mask logit| ``max_logit``, layer by layer in forward order
    (each layer sees the calibrated layers before it).  For random-weight
    runs: the init's zero kernel samples only integer positions, and a
    random kernel on a random trunk's large activations sends every sample
    far off the image and saturates the mask.  Returns {conv_offset
    weight's state_dict key: (offset factor, mask factor)}, so the same
    factors can scale another copy of the weights."""
    from occnet_tpu_torch.ops.deform_conv import TAPS, ModulatedDeformConv
    factors: Dict[str, Tuple] = {}
    hooks = []

    def calibrate(name, mod, inputs):
        off, mask = mod.offset_and_mask(inputs[0])
        logit = torch.logit(mask.double())
        f = []
        for rows, out, top in ((slice(0, 2 * TAPS), off, max_px),
                               (slice(2 * TAPS, 3 * TAPS), logit, max_logit)):
            bias = mod.conv_offset.bias[rows].double()
            rest = (out.reshape(-1, bias.numel()) - bias).abs().max().item()
            f.append((top - bias.abs().max().item()) / max(rest, 1e-30))
            mod.conv_offset.weight[rows] *= f[-1]
        factors[name + ".conv_offset.weight"] = tuple(f)

    for name, mod in model.named_modules():
        if isinstance(mod, ModulatedDeformConv):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, i, n=name: calibrate(n, m, i)))
    try:
        with torch.no_grad():
            model(img, ego2img)
    finally:
        for h in hooks:
            h.remove()
    return factors
