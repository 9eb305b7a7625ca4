"""ResNet-50/101 image trunk (port of `occnet_tpu/models/resnet.py`).

"pytorch style" bottlenecks (stride on the 3x3 conv), explicit symmetric
padding: 7x7/2 pad 3 stem, 3/2 pad 1 max pool with -inf padding.  The norm is
`FrozenBatchNorm` (running statistics always, `norm_eval=True`) or
`TrainableBatchNorm` (batch statistics in training, `norm_eval=False`), both
folded into one multiply-add in the compute dtype.  With `dcn_stages`, the 3x3
conv of those stages' bottlenecks is a modulated deformable conv
(`ops/deform_conv.ModulatedDeformConv`, R101-DCN), whose sampling is the
CUDA kernel `csrc/deform_conv.cu`.  In training, the DCN layer's autograd
Function saves its input, offsets, mask and weight and recomputes the 9-tap
columns in the backward: the counterpart of the JAX package's `nn.remat`
of DCN blocks, which exists to drop those columns (~216 MB a block).  The
blocks themselves are not recomputed: a second forward would add the
window certificate into its counter twice and update a
`TrainableBatchNorm`'s running statistics twice.  `frozen_stages` runs the
stem and stages <= frozen_stages under `torch.no_grad()`, the counterpart of
the JAX package's `stop_gradient` (their parameters get no gradient and their
activations stay out of the autograd graph).  Convolutions are cuDNN
(`F.conv2d`): the JAX package leaves them to XLA, outside any Pallas kernel.
Tensors are NCHW inside.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from occnet_tpu_torch.models.layers import Conv2d
from occnet_tpu_torch.ops.deform_conv import ModulatedDeformConv
from occnet_tpu_torch.parallel.multihost import all_reduce_sum, world_size

STAGE_BLOCKS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


def dcn_layer_indices(depth: int, dcn_stages: Sequence[bool]
                      ) -> Dict[str, int]:
    """{block name -> flat DCN-layer index} over every DCN block in
    definition order: the indexing of `dcn_window_radii`."""
    out = {}
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        if dcn_stages[stage]:
            for b in range(n):
                out[f"layer{stage + 1}_{b}"] = len(out)
    return out


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed running statistics (`norm_eval=True`)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # x (N, C, H, W); ``train`` is ignored: the statistics are fixed
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(self.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(self.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class TrainableBatchNorm(FrozenBatchNorm):
    """BatchNorm with the names of `FrozenBatchNorm` (`norm_eval=False`): in
    training it normalises with the fp32 batch mean and biased variance
    (two-pass, `jnp.var`) over (N, H, W) and updates the running statistics
    with torch momentum 0.1 from those same biased statistics (this is not
    `F.batch_norm`, whose running variance is unbiased); in eval it uses the
    running statistics.  Under a process group of more than one rank the
    statistics are the global batch's (two differentiable all-reduces: the
    mean first, then the centred sum of squares); at world size 1 the
    arithmetic is the single-process one, bit for bit."""

    momentum = 0.1

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return super().forward(x)
        xf = x.float()
        if world_size() > 1:
            s = all_reduce_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)), xf.new_full((1,), x.numel()
                                                   // x.shape[1])]))
            mean = s[:-1] / s[-1]
            var = all_reduce_sum((xf - mean[:, None, None]).square().sum(
                dim=(0, 2, 3))) / s[-1]
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
        inv = torch.rsqrt(var + self.eps)
        mul = (self.weight * inv).to(self.dtype)
        add = (self.bias - mean * self.weight * inv).to(self.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with identity / projection shortcut; with
    ``dcn`` the 3x3 is a `ModulatedDeformConv` in ``dcn_mode``.  `forward`
    returns (output, the DCN layer's window certificate or None); a given
    ``count`` (1-element int32) is the DCN layer's certificate counter."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm_eval: bool = True,
                 dcn: bool = False, dcn_mode: str = "gather",
                 dcn_window_radius: int = 3):
        super().__init__()
        out_ch = mid * 4
        bn = FrozenBatchNorm if norm_eval else TrainableBatchNorm
        self.conv1 = Conv2d(in_ch, mid, 1, bias=False, dtype=dtype)
        self.bn1 = bn(mid, dtype=dtype)
        self.dcn = dcn
        if dcn:
            self.conv2 = ModulatedDeformConv(mid, mid, stride, dcn_mode,
                                             dcn_window_radius, dtype)
        else:
            self.conv2 = Conv2d(mid, mid, 3, stride=stride, bias=False,
                                dtype=dtype)
        self.bn2 = bn(mid, dtype=dtype)
        self.conv3 = Conv2d(mid, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = bn(out_ch, dtype=dtype)
        self.has_downsample = in_ch != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                          bias=False, dtype=dtype)
            self.downsample_bn = bn(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                count: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        identity = x
        y = F.relu(self.bn1(self.conv1(x), train))
        overflow = None
        if self.dcn:
            y, overflow = self.conv2(y, count)
        else:
            y = self.conv2(y)
        y = F.relu(self.bn2(y, train))
        y = self.bn3(self.conv3(y), train)
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + identity), overflow


def stage_channels(out_indices: Sequence[int]) -> Tuple[int, ...]:
    """Output channels of the stages named by out_indices (0..3 -> C2..C5)."""
    return tuple(64 * 2 ** s * 4 for s in out_indices)


class ResNet(nn.Module):
    """Returns (the feature maps named by out_indices, NCHW; the window
    certificate summed over the DCN layers that carry one, a 0-d int64
    tensor, or None when none does).

    ``dcn_stages`` switches DCNv2 on per stage (R101-DCN: (F, F, T, T)).
    ``dcn_mode`` "window" gives the layers that the JAX package runs on its
    window kernel a certificate at their radius: ``dcn_window_radii[i]``
    for the i-th DCN block (`dcn_layer_indices`) where given, else
    ``dcn_window_radius``."""

    def __init__(self, depth: int = 50, out_indices: Tuple[int, ...] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32, frozen_stages: int = 1,
                 norm_eval: bool = True,
                 dcn_stages: Sequence[bool] = (False, False, False, False),
                 dcn_mode: str = "gather", dcn_window_radius: int = 3,
                 dcn_window_radii: Sequence[int] = ()):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = Conv2d(3, 64, 7, stride=2, bias=False, dtype=dtype)
        self.bn1 = (FrozenBatchNorm if norm_eval else TrainableBatchNorm)(
            64, dtype=dtype)
        self.stages: List[List[str]] = []
        dcn_idx = dcn_layer_indices(depth, dcn_stages)
        # the DCN layers that may carry a window certificate -> counter slot
        self.window_layers = dict(dcn_idx) if dcn_mode == "window" else {}
        in_ch, mid = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{b}"
                i = dcn_idx.get(name)
                radius = (dcn_window_radii[i] if i is not None
                          and i < len(dcn_window_radii) else dcn_window_radius)
                self.add_module(name, Bottleneck(
                    in_ch, mid, stride, dtype, norm_eval, i is not None,
                    dcn_mode, radius))
                names.append(name)
                in_ch = mid * 4
            self.stages.append(names)
            mid *= 2

    def _frozen(self, stage: int):
        """no_grad for the stem (stage -1) and stages < frozen_stages."""
        return (torch.no_grad() if stage < self.frozen_stages
                else contextlib.nullcontext())

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        with self._frozen(-1):
            x = F.relu(self.bn1(self.conv1(x), train))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        # one certificate counter a window-mode DCN layer, zeroed in one
        # launch and summed in one: the layers add into them on the card
        counts = (torch.zeros(len(self.window_layers), dtype=torch.int32,
                              device=x.device) if self.window_layers else None)
        outs, certified = [], False
        for stage, names in enumerate(self.stages):
            with self._frozen(stage):
                for name in names:
                    j = self.window_layers.get(name)
                    x, over = getattr(self, name)(
                        x, train, None if j is None else counts[j:j + 1])
                    certified |= over is not None
            if stage in self.out_indices:
                outs.append(x)
        return outs, (counts.sum() if certified else None)
