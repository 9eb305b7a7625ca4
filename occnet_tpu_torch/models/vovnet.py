"""VoVNet-V2 image trunk (port of `occnet_tpu/models/vovnet.py`): OSA blocks
with eSE attention, all 7 presets of the reference's `_STAGE_SPECS`.

As in the JAX package:

- depthwise presets (`dw`): an optional 1x1 reduction when a block's input
  has other than the stage's channels, then per layer a depthwise 3x3
  without norm or activation followed by a pointwise 1x1 + BN + ReLU;
- eSE in every block (GAP -> 1x1 conv with bias -> hard sigmoid
  clip(g + 3, 0, 6) / 6 -> gate), an identity residual on every block of a
  stage but the first;
- stage pooling: 3x3 / 2 max pool in ceil mode (the last window may hang
  off the bottom and right edges; no leading padding);
- every norm is `FrozenBatchNorm` (running statistics, also in training:
  the JAX `OccNet` calls its VoVNet without ``train``);
- ``frozen_stages``: -1 freezes nothing, 0 the stem, k >= 1 also stages
  2..k+1.  They run under `torch.no_grad()`, the counterpart of the JAX
  package's `stop_gradient` (their parameters get no gradient; the train
  step gives them zero gradients, so AdamW's decay still moves them as
  optax's does).

The hard sigmoid divides by a tensor: CUDA multiplies a tensor divided by a
Python scalar by the scalar's reciprocal, which rounds differently from the
CPU.  Convolutions are cuDNN (`F.conv2d`): the JAX package leaves them to
XLA, outside any Pallas kernel.  Tensors are NCHW.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.models.layers import Conv2d
from occnet_tpu_torch.models.resnet import FrozenBatchNorm

# stem channels, per-stage conv / out channels, layers a block, blocks a
# stage, depthwise flag (eSE is on in every preset, in every block)
VOVNET_SPECS: Dict[str, dict] = {
    "V-19-slim-dw-eSE": dict(stem=(64, 64, 64), conv=(64, 80, 96, 112),
                             out=(112, 256, 384, 512), layers=3,
                             blocks=(1, 1, 1, 1), dw=True),
    "V-19-dw-eSE": dict(stem=(64, 64, 64), conv=(128, 160, 192, 224),
                        out=(256, 512, 768, 1024), layers=3,
                        blocks=(1, 1, 1, 1), dw=True),
    "V-19-slim-eSE": dict(stem=(64, 64, 128), conv=(64, 80, 96, 112),
                          out=(112, 256, 384, 512), layers=3,
                          blocks=(1, 1, 1, 1), dw=False),
    "V-19-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224),
                     out=(256, 512, 768, 1024), layers=3,
                     blocks=(1, 1, 1, 1), dw=False),
    "V-39-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224),
                     out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 1, 2, 2), dw=False),
    "V-57-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224),
                     out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 1, 4, 3), dw=False),
    "V-99-eSE": dict(stem=(64, 64, 128), conv=(128, 160, 192, 224),
                     out=(256, 512, 768, 1024), layers=5,
                     blocks=(1, 3, 9, 3), dw=False),
}


def vovnet_channels(spec: str, out_indices: Sequence[int]
                    ) -> Tuple[int, ...]:
    """Output channels of the stages named by out_indices (0..3 -> stages
    2..5): the FPN's input channels."""
    return tuple(VOVNET_SPECS[spec]["out"][i] for i in out_indices)


def ceil_maxpool(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 max pool with ceil_mode: the JAX package's bottom /
    right -inf padding where the last window hangs off the edge."""
    return F.max_pool2d(x, 3, stride=2, ceil_mode=True)


class ConvBNRelu(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, features, kernel, stride=stride,
                           bias=False, dtype=dtype)
        self.bn = FrozenBatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DWConvBNRelu(nn.Module):
    """Depthwise 3x3 (no norm or activation) -> pointwise 1x1 + BN + ReLU;
    the input must have ``features`` channels."""

    def __init__(self, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw_conv = Conv2d(features, features, 3, stride=stride,
                              bias=False, dtype=dtype, groups=features)
        self.pw_conv = Conv2d(features, features, 1, bias=False, dtype=dtype)
        self.pw_bn = FrozenBatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.pw_bn(self.pw_conv(self.dw_conv(x))))


class eSEModule(nn.Module):
    """Effective squeeze-excite: GAP -> 1x1 conv -> hard sigmoid gate."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Conv2d(features, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.fc(x.mean(dim=(2, 3), keepdim=True))
        gate = torch.clamp(gate + 3.0, 0.0, 6.0) / gate.new_full((), 6.0)
        return x * gate


class OSABlock(nn.Module):
    def __init__(self, in_ch: int, conv_ch: int, out_ch: int, layers: int,
                 identity: bool, dw: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.identity = identity
        self.layers = layers
        ch = in_ch
        if dw and in_ch != conv_ch:
            # depthwise layers need in == stage channels: reduce once
            self.reduction = ConvBNRelu(in_ch, conv_ch, kernel=1, dtype=dtype)
            ch = conv_ch
        else:
            self.reduction = None
        for i in range(layers):
            self.add_module(f"l{i}", DWConvBNRelu(conv_ch, dtype=dtype) if dw
                            else ConvBNRelu(ch, conv_ch, dtype=dtype))
            ch = conv_ch
        self.concat = ConvBNRelu(in_ch + layers * conv_ch, out_ch, kernel=1,
                                 dtype=dtype)
        self.ese = eSEModule(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        feats = [x]
        if self.reduction is not None:
            x = self.reduction(x)
        for i in range(self.layers):
            x = getattr(self, f"l{i}")(x)
            feats.append(x)
        x = self.ese(self.concat(torch.cat(feats, dim=1)))
        return x + inp if self.identity else x


class VoVNet(nn.Module):
    """Returns (the feature maps named by out_indices, NCHW; None): the
    second item stands where the ResNet trunk returns its DCN certificate,
    which VoVNet never has."""

    def __init__(self, spec: str = "V-99-eSE",
                 out_indices: Tuple[int, ...] = (1, 2, 3),
                 frozen_stages: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = VOVNET_SPECS[spec]
        self.spec = spec
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        stem = s["stem"]
        self.stem0 = ConvBNRelu(3, stem[0], stride=2, dtype=dtype)
        if s["dw"]:
            self.stem1 = DWConvBNRelu(stem[1], dtype=dtype)
            self.stem2 = DWConvBNRelu(stem[2], stride=2, dtype=dtype)
        else:
            self.stem1 = ConvBNRelu(stem[0], stem[1], dtype=dtype)
            self.stem2 = ConvBNRelu(stem[1], stem[2], stride=2, dtype=dtype)
        self.stages: List[List[str]] = []
        ch = stem[2]
        for stage in range(4):
            names = []
            for b in range(s["blocks"][stage]):
                name = f"stage{stage + 2}_{b}"
                self.add_module(name, OSABlock(
                    ch, s["conv"][stage], s["out"][stage], s["layers"],
                    identity=b > 0, dw=s["dw"], dtype=dtype))
                names.append(name)
                ch = s["out"][stage]
            self.stages.append(names)

    def _frozen(self, stage: int):
        """no_grad for the stem (stage -1) and stages < frozen_stages."""
        return (torch.no_grad() if stage < self.frozen_stages
                else contextlib.nullcontext())

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        # ``train`` is ignored: every norm keeps its running statistics
        with self._frozen(-1):
            x = self.stem2(self.stem1(self.stem0(x)))
        outs = []
        for stage, names in enumerate(self.stages):
            with self._frozen(stage):
                if stage > 0:
                    x = ceil_maxpool(x)
                for name in names:
                    x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs, None
