"""Inputs and weights of a run, made from ``--seed`` on the run's device.

The rig is the ring of six pinhole cameras, each yawed 2 pi i / 6 with a
focal length of half the padded image width and the principal point at the
image centre (a 90 degree field of view; together they see every BEV cell).
Images are uniform uint8 RGB.  The samples of a batch span quiet to busy
scenes: from the first sample to the last the share of free voxels falls
from 95 % to 60 % and the flow's scale grows from 0.3 to 3 (normal flow on
flow-class voxels); the other voxels' classes are uniform.  So a batch's
loss depends on every sample, as a real batch's does.
Weights are one draw of standard normals on the device, cut into the
model's tensors and scaled a tensor at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FREE_SHARE = (0.95, 0.60)       # first and last sample of a batch
FLOW_SCALE = (0.3, 3.0)


def ring_rig(num_cams: int, img_h: int, img_w: int, batch: int
             ) -> np.ndarray:
    """(batch, cams, 4, 4) float32 ego-to-image matrices of the ring."""
    e2i = np.tile(np.eye(4, dtype=np.float32), (batch, num_cams, 1, 1))
    for ci in range(num_cams):
        a = 2 * np.pi * ci / num_cams
        R = np.array([[np.cos(a), -np.sin(a), 0], [0, 0, -1],
                      [np.sin(a), np.cos(a), 0.0]])
        K = np.array([[img_w / 2.0, 0, img_w / 2], [0, img_w / 2.0, img_h / 2],
                      [0, 0, 1]])
        e2i[:, ci, :3, :3] = (K @ R).astype(np.float32)
    return e2i


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one kind of input of a run."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + salt) % 2 ** 63)


def images(gen: torch.Generator, n: int, cams: int, h: int, w: int,
           device) -> torch.Tensor:
    """(n, cams, h, w, 3) uniform uint8 on ``device``."""
    return torch.randint(0, 256, (n, cams, h, w, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def labels(gen: torch.Generator, batch: int, occ_size: Sequence[int],
           num_classes: int, num_flow_classes: int, device
           ) -> Dict[str, torch.Tensor]:
    """voxel_semantics (uint8), voxel_flow (float32) and mask_camera (bool)
    of ``batch`` samples, from quiet to busy (`FREE_SHARE`, `FLOW_SCALE`)."""
    X, Y, Z = occ_size
    shape = (batch, X, Y, Z)
    t = torch.linspace(0.0, 1.0, batch, device=device) if batch > 1 else \
        torch.zeros(1, device=device)
    share = FREE_SHARE[0] + (FREE_SHARE[1] - FREE_SHARE[0]) * t
    scale = FLOW_SCALE[0] * (FLOW_SCALE[1] / FLOW_SCALE[0]) ** t
    free = torch.rand(shape, generator=gen, device=device) < \
        share[:, None, None, None]
    other = torch.randint(0, num_classes - 1, shape, generator=gen,
                          device=device)
    sem = torch.where(free, torch.full_like(other, num_classes - 1), other)
    flow = torch.randn(shape + (2,), generator=gen, device=device)
    flow = flow * (sem < num_flow_classes)[..., None] \
        * scale[:, None, None, None, None]
    mask = torch.rand(shape, generator=gen, device=device) < 0.8
    return {"voxel_semantics": sem.to(torch.uint8), "voxel_flow": flow,
            "mask_camera": mask}


def init_scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, offset) of a weight's standard normal draw: He scaling for
    convolutions, 1 / sqrt(fan in) for linear layers, normalisation scales
    near 1, small biases, unit embeddings."""
    last = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    is_norm = "bn" in owner or owner.startswith("norm")
    if last == "weight" and is_norm:
        return 0.1, 1.0
    if last in ("bias",) and is_norm:
        return 0.1, 0.0
    if last == "weight" and len(shape) >= 3:
        fan_in = int(np.prod(shape[1:]))
        return math.sqrt(2.0 / fan_in), 0.0
    if last == "weight" and len(shape) == 2:
        return 1.0 / math.sqrt(shape[1]), 0.0
    if last == "bias":
        return (1.0 if "sampling_offsets" in name else 0.02), 0.0
    if last in ("row_embed", "col_embed"):
        return 0.29, 0.5
    return 1.0, 0.0


def make_weights(spec: List[Tuple[str, Tuple[int, ...], bool]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every (name, shape, is_parameter) of ``spec``:
    parameters from one draw of normals on ``device`` (scaled by
    `init_scale`), batch-norm running means 0 and variances 1."""
    total = sum(int(np.prod(s)) for _, s, p in spec if p)
    flat = torch.randn(total, generator=generator(seed, 1, device),
                       device=device)
    out, o = {}, 0
    for name, shape, is_param in spec:
        if not is_param:
            fill = 1.0 if name.endswith("running_var") else 0.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = int(np.prod(shape))
        scale, offset = init_scale(name, shape)
        out[name] = flat[o:o + n].view(shape) * scale + offset
        o += n
    return out
