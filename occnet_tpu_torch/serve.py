"""Inference serving: `Predictor` answers (uint8 images, ego2img) requests
with the decoded occupancy and flow — normalise -> `OccNet` -> `get_occ`, the
counterpart of the inference body of
`occnet_tpu.training.eval_loop.run_evaluation`.

Both encoder modes serve: dense (`turbo_occ`: the planar lift and the TSA
tap attention) and gather (`base_occ`: deformable TSA and SCA), on a
ResNet-50 or ResNet-101-DCN trunk (`turbo_r101_dcn_occ`, `r101_dcn_occ`).
On a CUDA device their sampling runs as the hand-written kernels of
`occnet_tpu_torch/csrc/` (built at first use); on the CPU as their plain
PyTorch versions.

A request raises when a certificate is nonzero, as the JAX inference entry
(`tools/test.py`) hard-fails on it:

- `sca_topk_overflow` (gather encoder): the static top-K dropped visible
  queries, so the answer would not be the exact model's.  Size K for the
  rig with `geometry.calibration_topk`.
- `dcn_window_overflow` (DCN in window mode): that many contributing DCN
  samples lie outside the window radius, where the JAX window model zeroes
  them.  The port samples them exactly, so its answer would differ from the
  JAX window model's.  Raise `dcn_window_radius` or `dcn_window_radii`
  (per DCN layer) until it is 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.data.pipeline import make_device_normalizer
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.head import get_occ
from occnet_tpu_torch.utils.profiling import span

ArrayLike = Union[np.ndarray, torch.Tensor]


class Predictor:
    def __init__(self, cfg: OccNetConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device]):
        model = OccNet(cfg.model)
        model.load_state_dict(state_dict)
        self._setup(cfg, model.to(device).eval(), torch.device(device))

    @classmethod
    def wrap(cls, cfg: OccNetConfig, model: OccNet) -> "Predictor":
        """A Predictor over an existing model (e.g. the one being trained),
        sharing its weights: no copy.  Requests run its inference branch
        (``train=False``) whatever its module mode."""
        self = cls.__new__(cls)
        self._setup(cfg, model, next(model.parameters()).device)
        return self

    def _setup(self, cfg, model, device):
        self.cfg = cfg
        self.device = device
        self.model = model
        self.normalize = make_device_normalizer(cfg.data)
        # the last request's certificates (None where the config has none)
        self.sca_topk_overflow: Optional[int] = None
        self.dcn_window_overflow: Optional[int] = None

    @torch.inference_mode()
    def infer(self, images: ArrayLike, ego2img: ArrayLike,
              prev_bev: Optional[torch.Tensor] = None,
              shift_ref_2d: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """The model's outputs for a request (bev_embed, occ logits, flow
        and the certificates, on the device), without checking the
        certificates and without waiting for the device: for a caller that
        sums the certificates over many requests (`tools.test`) or streams
        a scene (`training.temporal.StreamingInferenceState`, which passes
        the aligned history BEV and the shifted TSA reference)."""
        with span("serve.input"):
            imgs = torch.as_tensor(images).to(self.device, non_blocking=True)
            e2i = torch.as_tensor(ego2img).to(self.device, torch.float32,
                                              non_blocking=True)
            x = self.normalize(imgs)
        m = self.cfg.model
        if tuple(x.shape[-3:-1]) != (m.img_h, m.img_w):
            raise ValueError(f"padded images are {tuple(x.shape[-3:-1])}, "
                             f"the config expects {(m.img_h, m.img_w)}")
        return self.model(x, e2i, prev_bev, shift_ref_2d)

    @torch.inference_mode()
    def __call__(self, images: ArrayLike, ego2img: ArrayLike,
                 with_logits: bool = False) -> Tuple[torch.Tensor, ...]:
        """images uint8 (B, cams, H, W, 3) RGB (or already-normalised float),
        ego2img (B, cams, 4, 4).  Returns (occ_cls (B, X, Y, Z) int64,
        flow (B, X, Y, Z, 2)) on the predictor's device, plus the occ logits
        (B, X, Y, Z, classes) with ``with_logits``.  The request is the
        root span ``serve.request``; reading its certificates back, which
        waits for the card, the span ``serve.readback``."""
        with span("serve.request"):
            outs = self.infer(images, ego2img)
            certs = [outs.get(k) for k in ("sca_topk_overflow",
                                           "dcn_window_overflow")]
            if any(c is not None for c in certs):
                with span("serve.readback"):
                    certs = [None if c is None else int(c) for c in certs]
            self.sca_topk_overflow, self.dcn_window_overflow = certs
            if self.sca_topk_overflow:
                raise RuntimeError(
                    f"sca_topk_overflow={self.sca_topk_overflow}: the SCA "
                    f"top-K (max_queries_per_cam / per_cam_topk) dropped "
                    f"visible queries of this rig; size it with "
                    f"occnet_tpu_torch.geometry.calibration_topk")
            if self.dcn_window_overflow:
                raise RuntimeError(
                    f"dcn_window_overflow={self.dcn_window_overflow}: DCN "
                    f"samples lie outside the window radius, where the JAX "
                    f"window model zeroes them; raise "
                    f"model.backbone.dcn_window_radius (or the per-layer "
                    f"dcn_window_radii)")
            occ_cls, flow = get_occ(outs)
            return (occ_cls, flow, outs["occ"]) if with_logits \
                else (occ_cls, flow)
