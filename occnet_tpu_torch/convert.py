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
  bias                               -> bias
  BatchNorm / LayerNorm scale        -> weight
  batch_stats mean / var             -> running_mean / running_var
  tables (embeddings, row/col_embed) -> unchanged

JAX -> port is a straight transpose; there is no RGB flip of conv1 (that flip
belongs to torchvision -> JAX, `occnet_tpu/utils/torch_convert.py`).

`init_jax_style_variables` builds the JAX package's tree for a ResNet config
(with or without DCN stages; dense or gather encoder) with numpy, using the JAX initialisers, so the port
runs at the activation scale the JAX package runs at without importing JAX.
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
_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


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


def init_jax_style_variables(cfg, seed: int = 0) -> dict:
    """The flax init tree of `occnet_tpu.models.detector.OccNet` for a
    ResNet ``cfg`` (OccNetConfig or ModelConfig) with a dense or gather
    encoder, drawn with numpy from ``seed`` with the same initialisers:
    he_normal for ResNet convs (the DCN layers' weights included),
    xavier_uniform for FPN convs / Dense / Conv3d, zeros for the DCN
    layers' `conv_offset`, for `attention_weights`, `sampling_offsets`
    kernels and biases, the radial grid (`radial_offset_bias`) for `sampling_offsets`
    biases, normal(1) for embeddings, uniform[0, 1) for positional tables,
    identity norms and BN statistics."""
    m: ModelConfig = getattr(cfg, "model", cfg)
    from occnet_tpu_torch.models.attention import radial_offset_bias
    from occnet_tpu_torch.models.resnet import STAGE_BLOCKS, stage_channels
    from occnet_tpu_torch.ops.tsa import TSA_TAPS
    if m.encoder.mode not in ("dense", "gather"):
        raise ValueError(f"unknown encoder mode {m.encoder.mode!r}")
    rng = np.random.RandomState(seed)
    params: dict = {}
    stats: dict = {}
    f32 = np.float32

    def he_normal(shape):
        std = np.sqrt(2.0 / np.prod(shape[:-1])) / .87962566103423978
        x = rng.randn(*shape)
        bad = np.abs(x) > 2.0
        while bad.any():                       # truncated to [-2, 2]
            x[bad] = rng.randn(int(bad.sum()))
            bad = np.abs(x) > 2.0
        return (x * std).astype(f32)

    def xavier(shape):
        rf = int(np.prod(shape[:-2]))
        lim = np.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
        return rng.uniform(-lim, lim, shape).astype(f32)

    def dense(path, i, o, zero=False, bias=None):
        _set(params, path + "/kernel",
             np.zeros((i, o), f32) if zero else xavier((i, o)))
        _set(params, path + "/bias",
             np.zeros(o, f32) if bias is None else bias.astype(f32))

    def norm(path, c, stats_too=False):
        _set(params, path + "/scale", np.ones(c, f32))
        _set(params, path + "/bias", np.zeros(c, f32))
        if stats_too:
            _set(stats, path + "/mean", np.zeros(c, f32))
            _set(stats, path + "/var", np.ones(c, f32))

    # backbone
    bb = "backbone"
    _set(params, f"{bb}/conv1/kernel", he_normal((7, 7, 3, 64)))
    norm(f"{bb}/bn1", 64, True)
    in_ch, mid = 64, 64
    depth = int(m.backbone.type.replace("resnet", ""))
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            p = f"{bb}/layer{stage + 1}_{b}"
            for name, shape in (("conv1", (1, 1, in_ch, mid)),
                                ("conv2", (3, 3, mid, mid)),
                                ("conv3", (1, 1, mid, mid * 4))):
                _set(params, f"{p}/{name}/kernel", he_normal(shape))
            if m.backbone.dcn_stages[stage]:
                # DCNv2: conv2/kernel is the deformable conv's weight, and
                # its zero-initialised conv_offset predicts 2 * 9 offsets
                # and 9 mask logits
                _set(params, f"{p}/conv2/conv_offset/kernel",
                     np.zeros((3, 3, mid, 27), f32))
                _set(params, f"{p}/conv2/conv_offset/bias",
                     np.zeros(27, f32))
            norm(f"{p}/bn1", mid, True)
            norm(f"{p}/bn2", mid, True)
            norm(f"{p}/bn3", mid * 4, True)
            if in_ch != mid * 4 or stride != 1:
                _set(params, f"{p}/downsample_conv/kernel",
                     he_normal((1, 1, in_ch, mid * 4)))
                norm(f"{p}/downsample_bn", mid * 4, True)
            in_ch = mid * 4
        mid *= 2

    # neck
    C = m.embed_dims
    ins = stage_channels(m.backbone.out_indices)
    convs = ([(f"lateral_{i}", 1, c) for i, c in enumerate(ins)]
             + [(f"fpn_{i}", 3, C) for i in range(len(ins))]
             + [(f"fpn_extra_{i}", 3, C)
                for i in range(m.neck.num_outs - len(ins))])
    for name, k, cin in convs:
        _set(params, f"neck/{name}/kernel", xavier((k, k, cin, C)))
        _set(params, f"neck/{name}/bias", np.zeros(C, f32))

    # head
    Q = m.bev_h * m.bev_w
    _set(params, "head/bev_embedding", rng.randn(Q, C).astype(f32))
    _set(params, "head/positional_encoding/row_embed",
         rng.uniform(0, 1, (m.bev_h, C // 2)).astype(f32))
    _set(params, "head/positional_encoding/col_embed",
         rng.uniform(0, 1, (m.bev_w, C // 2)).astype(f32))
    t = "head/transformer"
    _set(params, f"{t}/level_embeds",
         rng.randn(m.num_feature_levels, C).astype(f32))
    _set(params, f"{t}/cams_embeds", rng.randn(m.num_cams, C).astype(f32))
    e = m.encoder
    if e.mode == "dense":
        dense(f"{t}/shared_value_proj", C, C)
    L, Z = m.num_feature_levels, e.num_points_in_pillar
    for lid in range(e.num_layers):
        p = f"{t}/encoder/layer{lid}"
        H, nq = e.tsa.num_heads, e.tsa.num_bev_queue
        if e.mode == "dense":
            dense(f"{p}/self_attn/value_proj", C, C)
            dense(f"{p}/self_attn/attention_weights", 2 * C,
                  nq * H * len(TSA_TAPS), zero=True)
            dense(f"{p}/self_attn/output_proj", C, C)
            dense(f"{p}/cross_attn/attention_weights", C,
                  e.sca.num_heads * L * Z, zero=True)
        else:
            tL, tP = e.tsa.num_levels, e.tsa.num_points
            dense(f"{p}/self_attn/value_proj", C, C)
            dense(f"{p}/self_attn/sampling_offsets", 2 * C,
                  nq * H * tL * tP * 2, zero=True,
                  bias=radial_offset_bias(H, tL * nq, tP))
            dense(f"{p}/self_attn/attention_weights", 2 * C,
                  nq * H * tL * tP, zero=True)
            dense(f"{p}/self_attn/output_proj", C, C)
            s = e.sca
            da = f"{p}/cross_attn/deformable_attention"
            dense(f"{da}/value_proj", C, C)
            dense(f"{da}/sampling_offsets", C,
                  s.num_heads * s.num_levels * s.num_points * 2, zero=True,
                  bias=radial_offset_bias(s.num_heads, s.num_levels,
                                          s.num_points))
            dense(f"{da}/attention_weights", C,
                  s.num_heads * s.num_levels * s.num_points, zero=True)
        dense(f"{p}/cross_attn/output_proj", C, C)
        dense(f"{p}/ffn/fc1", C, e.ffn_dim)
        dense(f"{p}/ffn/fc2", e.ffn_dim, C)
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{p}/{n}", C)
    middle = C // m.pillar_h
    for name, cin in (("decoder0", middle), ("decoder1", m.out_dim)):
        _set(params, f"{t}/{name}/conv/kernel",
             xavier((3, 3, 3, cin, m.out_dim)))
        norm(f"{t}/{name}/bn", m.out_dim, True)
    for name, out in (("predicter", m.num_classes), ("flow_predicter", 2)):
        dense(f"{t}/{name}/fc1", m.out_dim, m.out_dim * 2)
        dense(f"{t}/{name}/fc2", m.out_dim * 2, out)
    return {"params": params, "batch_stats": stats}


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
