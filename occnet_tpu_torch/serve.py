"""Inference serving: `Predictor` answers (uint8 images, ego2img) requests
with the decoded occupancy and flow — normalise -> `OccNet` -> `get_occ`, the
counterpart of the inference body of
`occnet_tpu.training.eval_loop.run_evaluation`.

Both encoder modes serve: dense (`turbo_occ`: the planar lift and the TSA
tap attention) and gather (`base_occ`: deformable TSA and SCA).  On a CUDA
device their sampling runs as the hand-written kernels of
`occnet_tpu_torch/csrc/` (built at first use); on the CPU as their plain
PyTorch versions.

In gather mode a request raises when the SCA certificate `sca_topk_overflow`
is nonzero: the static top-K dropped visible queries, so the answer would not
be the exact model's (the JAX inference entry, `tools/test.py`, hard-fails on
it too).  Size K for the rig with `geometry.calibration_topk`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from occnet_tpu.config import OccNetConfig
from occnet_tpu_torch.data.pipeline import make_device_normalizer
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.head import get_occ

ArrayLike = Union[np.ndarray, torch.Tensor]


class Predictor:
    def __init__(self, cfg: OccNetConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device]):
        self.cfg = cfg
        self.device = torch.device(device)
        model = OccNet(cfg.model)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.normalize = make_device_normalizer(cfg.data)
        # the last request's certificate (gather mode; None in dense mode)
        self.sca_topk_overflow: Optional[int] = None

    @torch.inference_mode()
    def __call__(self, images: ArrayLike, ego2img: ArrayLike,
                 with_logits: bool = False) -> Tuple[torch.Tensor, ...]:
        """images uint8 (B, cams, H, W, 3) RGB (or already-normalised float),
        ego2img (B, cams, 4, 4).  Returns (occ_cls (B, X, Y, Z) int64,
        flow (B, X, Y, Z, 2)) on the predictor's device, plus the occ logits
        (B, X, Y, Z, classes) with ``with_logits``."""
        imgs = torch.as_tensor(images).to(self.device, non_blocking=True)
        e2i = torch.as_tensor(ego2img).to(self.device, torch.float32)
        x = self.normalize(imgs)
        m = self.cfg.model
        if tuple(x.shape[-3:-1]) != (m.img_h, m.img_w):
            raise ValueError(f"padded images are {tuple(x.shape[-3:-1])}, "
                             f"the config expects {(m.img_h, m.img_w)}")
        outs = self.model(x, e2i)
        overflow = outs.get("sca_topk_overflow")
        self.sca_topk_overflow = None if overflow is None else int(overflow)
        if self.sca_topk_overflow:
            raise RuntimeError(
                f"sca_topk_overflow={self.sca_topk_overflow}: the SCA top-K "
                f"(max_queries_per_cam / per_cam_topk) dropped visible "
                f"queries of this rig; size it with "
                f"occnet_tpu_torch.geometry.calibration_topk")
        occ_cls, flow = get_occ(outs)
        return (occ_cls, flow, outs["occ"]) if with_logits else (occ_cls,
                                                                  flow)
