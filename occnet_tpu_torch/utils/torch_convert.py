"""Reference PyTorch checkpoints -> the port's state_dict (a copy of the
converters of `occnet_tpu/utils/torch_convert.py`, which the port does not
import, with loaders that write the port's layout).

Capability equivalent of the reference's `pretrained='torchvision://
resnet50'` backbone init (config `bevformer_base_occ.py:58`) and of its
checkpoint load: `convert_torchvision_resnet` maps a torchvision ResNet-50 /
101 state_dict, `convert_bevformer_occ_checkpoint` a whole reference
`BEVFormerOcc` checkpoint and `convert_vovnet` a reference VoVNet's
(`models/backbones/vovnet.py`), onto the JAX package's parameter tree,
exactly as there.  Conventions:

- torch conv weight (O, I, kH, kW) -> flax (kH, kW, I, O)
- BatchNorm weight / bias -> FrozenBatchNorm scale / bias (params);
  running_mean / var -> batch_stats mean / var.
- Channel order: the input pipeline decodes RGB while the reference feeds
  BGR with to_rgb=False; `flip_input_channels=True` (default) reverses the
  input channels of conv1 so RGB inputs reproduce the BGR-trained
  activations.

`load_resnet_into_state_dict`, `load_vovnet_into_state_dict` and
`load_bevformer_into_state_dict` take the place of the JAX package's
`load_*_into_variables`: the converted tree goes through
`convert.from_jax_variables`'s layout rules into the port's keys and is
merged into a port state_dict with the same checks (a converted key the
model lacks raises KeyError, a shape mismatch ValueError; modules absent
from the checkpoint, the dense-mode extras, keep their values).

Works on plain dict state_dicts (torch.load(...) or its ['state_dict']);
tensors may be torch tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from occnet_tpu_torch.convert import from_jax_variables

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(t) -> np.ndarray:
    return np.transpose(_to_np(t), (2, 3, 1, 0))


def convert_torchvision_resnet(
    state_dict: Mapping[str, "np.ndarray"],
    depth: int = 50,
    flip_input_channels: bool = True,
) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats) trees for the `backbone` module."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}

    def bn_pair(src_prefix: str):
        p = {"scale": _to_np(sd[f"{src_prefix}.weight"]),
             "bias": _to_np(sd[f"{src_prefix}.bias"])}
        s = {"mean": _to_np(sd[f"{src_prefix}.running_mean"]),
             "var": _to_np(sd[f"{src_prefix}.running_var"])}
        return p, s

    w = _conv(sd["conv1.weight"])
    if flip_input_channels:
        w = w[:, :, ::-1, :].copy()
    params["conv1"] = {"kernel": w}
    params["bn1"], stats["bn1"] = bn_pair("bn1")

    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            src = f"layer{stage + 1}.{b}"
            dst = f"layer{stage + 1}_{b}"
            bp: Dict = {}
            bs: Dict = {}
            for ci in (1, 2, 3):
                if ci == 2 and f"{src}.conv2.conv_offset.weight" in sd:
                    # DCNv2 block (mmcv ModulatedDeformConv2dPack)
                    bp["conv2"] = {
                        "kernel": _conv(sd[f"{src}.conv2.weight"]),
                        "conv_offset": {
                            "kernel": _conv(
                                sd[f"{src}.conv2.conv_offset.weight"]),
                            "bias": _to_np(
                                sd[f"{src}.conv2.conv_offset.bias"]),
                        },
                    }
                else:
                    bp[f"conv{ci}"] = {
                        "kernel": _conv(sd[f"{src}.conv{ci}.weight"])}
                bp[f"bn{ci}"], bs[f"bn{ci}"] = bn_pair(f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv(sd[f"{src}.downsample.0.weight"])}
                bp["downsample_bn"], bs["downsample_bn"] = bn_pair(
                    f"{src}.downsample.1")
            params[dst] = bp
            stats[dst] = bs
    return params, stats


# ---------------------------------------------------------------------------
# VoVNet checkpoint conversion (reference models/backbones/vovnet.py)
# ---------------------------------------------------------------------------

def convert_vovnet(
    state_dict: Mapping[str, "np.ndarray"],
    spec: str = "V-99-eSE",
    flip_input_channels: bool = True,
) -> Tuple[Dict, Dict]:
    """torch VoVNet state_dict -> (params, batch_stats) trees for the
    `backbone` module.  Key layout of the reference module's OrderedDict
    naming: `stem.stem_1/conv.weight`,
    `stage2.OSA2_1.layers.0.OSA2_1_0/conv.weight`, depthwise presets with
    `/dw_conv3x3` + `/pw_conv1x1` + `/pw_norm`, `conv_reduction`, `concat`,
    `ese.fc`; `module.` and `backbone.` prefixes dropped."""
    from occnet_tpu_torch.models.vovnet import VOVNET_SPECS

    s = VOVNET_SPECS[spec]
    sd = {k.replace("module.", "").replace("backbone.", ""): v
          for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}

    def bn_pair(src):
        p = {"scale": _to_np(sd[f"{src}.weight"]),
             "bias": _to_np(sd[f"{src}.bias"])}
        st = {"mean": _to_np(sd[f"{src}.running_mean"]),
              "var": _to_np(sd[f"{src}.running_var"])}
        return p, st

    def conv_bn(src):
        bp = {"conv": {"kernel": _conv(sd[f"{src}/conv.weight"])}}
        bp["bn"], bs = bn_pair(f"{src}/norm")
        return bp, {"bn": bs}

    def dw_block(src):
        bp = {"dw_conv": {"kernel": _conv(sd[f"{src}/dw_conv3x3.weight"])},
              "pw_conv": {"kernel": _conv(sd[f"{src}/pw_conv1x1.weight"])}}
        bp["pw_bn"], bs = bn_pair(f"{src}/pw_norm")
        return bp, {"pw_bn": bs}

    # stem (BGR -> RGB flip on the first conv, as for ResNet)
    w = _conv(sd["stem.stem_1/conv.weight"])
    if flip_input_channels:
        w = w[:, :, ::-1, :].copy()
    params["stem0"] = {"conv": {"kernel": w}}
    params["stem0"]["bn"], bs0 = bn_pair("stem.stem_1/norm")
    stats["stem0"] = {"bn": bs0}
    for i, post in ((1, "stem_2"), (2, "stem_3")):
        params[f"stem{i}"], stats[f"stem{i}"] = (
            dw_block if s["dw"] else conv_bn)(f"stem.{post}")

    for stage in range(4):
        sn = stage + 2
        for b in range(s["blocks"][stage]):
            src = f"stage{sn}.OSA{sn}_{b + 1}"
            bp: Dict = {}
            bs: Dict = {}
            red = f"{src}.conv_reduction.OSA{sn}_{b + 1}_reduction_0"
            if f"{red}/conv.weight" in sd:
                bp["reduction"], bs["reduction"] = conv_bn(red)
            for i in range(s["layers"]):
                bp[f"l{i}"], bs[f"l{i}"] = (dw_block if s["dw"] else conv_bn)(
                    f"{src}.layers.{i}.OSA{sn}_{b + 1}_{i}")
            bp["concat"], bs["concat"] = conv_bn(
                f"{src}.concat.OSA{sn}_{b + 1}_concat")
            bp["ese"] = {"fc": {
                "kernel": _conv(sd[f"{src}.ese.fc.weight"]),
                "bias": _to_np(sd[f"{src}.ese.fc.bias"])}}
            params[f"stage{sn}_{b}"] = bp
            stats[f"stage{sn}_{b}"] = bs
    return params, stats


# ---------------------------------------------------------------------------
# Full BEVFormerOcc checkpoint conversion (reference train.py checkpoints)
# ---------------------------------------------------------------------------

def _lin(sd, src):
    """torch Linear -> flax Dense {kernel (I, O), bias}."""
    out = {"kernel": np.transpose(_to_np(sd[f"{src}.weight"]))}
    if f"{src}.bias" in sd:
        out["bias"] = _to_np(sd[f"{src}.bias"])
    return out


def _conv2d(sd, src):
    out = {"kernel": _conv(sd[f"{src}.weight"])}
    if f"{src}.bias" in sd:
        out["bias"] = _to_np(sd[f"{src}.bias"])
    return out


def _conv3d(t) -> np.ndarray:
    # torch (O, I, kD, kH, kW) -> flax (kD, kH, kW, I, O)
    return np.transpose(_to_np(t), (2, 3, 4, 1, 0))


def _ln(sd, src):
    return {"scale": _to_np(sd[f"{src}.weight"]),
            "bias": _to_np(sd[f"{src}.bias"])}


def convert_bevformer_occ_checkpoint(
    state_dict: Mapping[str, "np.ndarray"],
    depth: int = 50,
    num_encoder_layers: int = 4,
    flip_input_channels: bool = True,
) -> Tuple[Dict, Dict]:
    """Reference `BEVFormerOcc` checkpoint (tools/train.py work-dir .pth,
    key layout of the mmdet3d plugin modules) -> (params, batch_stats) trees
    for `OccupancyDetector` (gather/exact mode).

    Covered modules and their sources:
    - img_backbone                  -> backbone (torchvision ResNet layout)
    - img_neck (mmdet FPN)          -> neck lateral_{i}/fpn_{i}/fpn_extra_{i}
    - pts_bbox_head.bev_embedding   -> head/bev_embedding
    - positional_encoding           -> head/positional_encoding (row/col)
    - transformer.{level,cams}_embeds
    - encoder.layers.{i}: attentions.0 (TSA), attentions.1 (SCA +
      deformable_attention), ffns.0 (fc1/fc2), norms.{0,1,2} -> norm{1,2,3}
    - transformer.decoder.{0,1} Conv3d+BN3d -> decoder{0,1} (+batch_stats)
    - transformer.predicter / flow_predicter -> fc1/fc2 MLP heads

    Tensor layout conventions are identical on both sides (offsets reshape
    (B,Q,H,[nq,]L,P,2), attention softmax over the trailing L*P), so Linear
    weights convert by transpose alone.
    """
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    bb = {k[len("img_backbone."):]: v for k, v in sd.items()
          if k.startswith("img_backbone.")}
    params, stats = convert_torchvision_resnet(
        bb, depth=depth, flip_input_channels=flip_input_channels)
    params = {"backbone": params}
    stats = {"backbone": stats}

    # FPN neck: lateral_convs/fpn_convs (extra levels live in fpn_convs[n:])
    neck: Dict = {}
    n_lat = len({k.split(".")[2] for k in sd
                 if k.startswith("img_neck.lateral_convs.")})
    for i in range(n_lat):
        neck[f"lateral_{i}"] = _conv2d(sd, f"img_neck.lateral_convs.{i}.conv")
    n_fpn = len({k.split(".")[2] for k in sd
                 if k.startswith("img_neck.fpn_convs.")})
    for i in range(n_fpn):
        dst = f"fpn_{i}" if i < n_lat else f"fpn_extra_{i - n_lat}"
        neck[dst] = _conv2d(sd, f"img_neck.fpn_convs.{i}.conv")
    params["neck"] = neck

    R = "pts_bbox_head"
    T = f"{R}.transformer"
    head: Dict = {"bev_embedding": _to_np(sd[f"{R}.bev_embedding.weight"])}
    head["positional_encoding"] = {
        "row_embed": _to_np(sd[f"{R}.positional_encoding.row_embed.weight"]),
        "col_embed": _to_np(sd[f"{R}.positional_encoding.col_embed.weight"]),
    }
    trans: Dict = {
        "level_embeds": _to_np(sd[f"{T}.level_embeds"]),
        "cams_embeds": _to_np(sd[f"{T}.cams_embeds"]),
    }
    enc: Dict = {}
    for i in range(num_encoder_layers):
        E = f"{T}.encoder.layers.{i}"
        layer = {
            "self_attn": {
                name: _lin(sd, f"{E}.attentions.0.{name}")
                for name in ("sampling_offsets", "attention_weights",
                             "value_proj", "output_proj")},
            "cross_attn": {
                "deformable_attention": {
                    name: _lin(sd,
                               f"{E}.attentions.1.deformable_attention."
                               f"{name}")
                    for name in ("sampling_offsets", "attention_weights",
                                 "value_proj")},
                "output_proj": _lin(sd, f"{E}.attentions.1.output_proj"),
            },
            "ffn": {"fc1": _lin(sd, f"{E}.ffns.0.layers.0.0"),
                    "fc2": _lin(sd, f"{E}.ffns.0.layers.1")},
        }
        for j in range(3):
            layer[f"norm{j + 1}"] = _ln(sd, f"{E}.norms.{j}")
        enc[f"layer{i}"] = layer
    trans["encoder"] = enc

    trans_stats: Dict = {}
    for j in (0, 1):
        trans[f"decoder{j}"] = {
            "conv": {"kernel": _conv3d(sd[f"{T}.decoder.{j}.conv.weight"])},
            "bn": {"scale": _to_np(sd[f"{T}.decoder.{j}.bn.weight"]),
                   "bias": _to_np(sd[f"{T}.decoder.{j}.bn.bias"])},
        }
        trans_stats[f"decoder{j}"] = {
            "bn": {"mean": _to_np(sd[f"{T}.decoder.{j}.bn.running_mean"]),
                   "var": _to_np(sd[f"{T}.decoder.{j}.bn.running_var"])},
        }
    for name in ("predicter", "flow_predicter"):
        trans[name] = {"fc1": _lin(sd, f"{T}.{name}.0"),
                       "fc2": _lin(sd, f"{T}.{name}.2")}
    head["transformer"] = trans
    params["head"] = head
    stats["head"] = {"transformer": trans_stats}
    return params, stats


def merge_into_state_dict(state_dict: Mapping[str, torch.Tensor],
                          params: Dict, stats: Dict
                          ) -> Dict[str, torch.Tensor]:
    """A copy of the port's ``state_dict`` with the converted (params,
    batch_stats) trees, in the port's layout, written over its entries
    (each cast to the entry's dtype and device)."""
    out = dict(state_dict)
    converted = from_jax_variables({"params": params, "batch_stats": stats})
    for key, value in converted.items():
        if key not in state_dict:
            raise KeyError(f"unexpected converted key {key}")
        dst = state_dict[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(dst.shape)} "
                             f"vs {tuple(value.shape)}")
        out[key] = value.to(dtype=dst.dtype, device=dst.device)
    return out


def load_resnet_into_state_dict(state_dict: Mapping[str, torch.Tensor],
                                resnet_state_dict: Mapping, depth: int = 50,
                                flip_input_channels: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """The port's state_dict with its backbone replaced by a converted
    torchvision ResNet."""
    params, stats = convert_torchvision_resnet(resnet_state_dict, depth,
                                               flip_input_channels)
    return merge_into_state_dict(state_dict, {"backbone": params},
                                 {"backbone": stats})


def load_vovnet_into_state_dict(state_dict: Mapping[str, torch.Tensor],
                                vovnet_state_dict: Mapping,
                                spec: str = "V-99-eSE",
                                flip_input_channels: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """The port's state_dict with its backbone replaced by a converted
    reference VoVNet of preset ``spec``."""
    params, stats = convert_vovnet(vovnet_state_dict, spec,
                                   flip_input_channels)
    return merge_into_state_dict(state_dict, {"backbone": params},
                                 {"backbone": stats})


def load_bevformer_into_state_dict(state_dict: Mapping[str, torch.Tensor],
                                   reference_state_dict: Mapping,
                                   depth: int = 50,
                                   num_encoder_layers: int = 4,
                                   flip_input_channels: bool = True
                                   ) -> Dict[str, torch.Tensor]:
    """The port's state_dict with every module of a full reference
    BEVFormerOcc checkpoint converted into it."""
    params, stats = convert_bevformer_occ_checkpoint(
        reference_state_dict, depth=depth,
        num_encoder_layers=num_encoder_layers,
        flip_input_channels=flip_input_channels)
    return merge_into_state_dict(state_dict, params, stats)
