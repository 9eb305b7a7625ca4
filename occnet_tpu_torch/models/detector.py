"""OccNet (port of `occnet_tpu/models/detector.py`): grid mask (training
only) -> image trunk (ResNet-50/101, optionally with DCNv2 stages, or
VoVNet-V2 with ``backbone.type = "vovnet"``) -> FPN -> OccHead.  In DCN
window mode the outputs carry the trunk's certificate
`dcn_window_overflow` (0-d int64), beside the gather encoder's
`sca_topk_overflow`, with ``only_bev`` too (history frames are checked as
well)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from occnet_tpu_torch.config import ModelConfig
from occnet_tpu_torch.models.fpn import FPN
from occnet_tpu_torch.models.head import OccHead
from occnet_tpu_torch.models.resnet import ResNet, stage_channels
from occnet_tpu_torch.models.vovnet import VoVNet, vovnet_channels
from occnet_tpu_torch.ops.grid_mask import grid_mask_apply, grid_mask_draw
from occnet_tpu_torch.utils.profiling import span


class OccNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        with span("setup.model"):
            bb = cfg.backbone
            self.cfg = cfg
            self.dtype = getattr(torch, cfg.compute_dtype)
            if bb.type == "vovnet":
                # its norms stay frozen in training, as the JAX OccNet calls
                # its VoVNet without ``train``
                self.backbone = VoVNet(bb.vovnet_spec, bb.out_indices,
                                       bb.frozen_stages, self.dtype)
                in_channels = vovnet_channels(bb.vovnet_spec, bb.out_indices)
            elif bb.type.startswith("resnet"):
                self.backbone = ResNet(int(bb.type.replace("resnet", "")),
                                       bb.out_indices, self.dtype,
                                       bb.frozen_stages, bb.norm_eval,
                                       bb.dcn_stages, bb.dcn_mode,
                                       bb.dcn_window_radius,
                                       tuple(bb.dcn_window_radii))
                in_channels = stage_channels(bb.out_indices)
            else:
                raise ValueError(f"unknown backbone type {bb.type!r}")
            self.neck = FPN(in_channels, cfg.embed_dims,
                            cfg.neck.num_outs,
                            cfg.neck.relu_before_extra_convs, self.dtype)
            self.head = OccHead(cfg, self.dtype)

    def extract_img_feat(self, img: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[List[torch.Tensor],
                                    Optional[torch.Tensor]]:
        """(B, cams, H, W, 3) -> (list of (B, cams, h, w, C) FPN levels, the
        trunk's DCN window certificate or None).  In training with
        `use_grid_mask`, one grid mask drawn from ``generator`` covers every
        image.  The trunk runs NCHW in channels-last memory (a permuted
        view); the backbone and the neck are the span ``model.trunk``."""
        b, n_cam, h, w, ch = img.shape
        x = img.reshape(b * n_cam, h, w, ch).to(self.dtype)
        if train and self.cfg.use_grid_mask:
            x = grid_mask_apply(x, *grid_mask_draw(
                generator, h, self.cfg.grid_mask_prob, x.device))
        with span("model.trunk"):
            feats, overflow = self.backbone(x.permute(0, 3, 1, 2), train)
            feats = self.neck(feats)
        return [f.permute(0, 2, 3, 1).reshape(b, n_cam, *f.shape[2:],
                                              f.shape[1])
                for f in feats], overflow

    def forward(self, img: torch.Tensor, ego2img: torch.Tensor,
                prev_bev: Optional[torch.Tensor] = None,
                shift_ref_2d: Optional[torch.Tensor] = None,
                only_bev: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """img (B, cams, H, W, 3) normalised, ego2img (B, cams, 4, 4).
        ``prev_bev`` (B, Q, C) is the history BEV aligned into this frame
        and ``shift_ref_2d`` (B, Q, 1, 2) the shifted TSA reference of its
        slot (`training/temporal.py`).  ``only_bev`` returns the BEV
        ("bev_embed") and the certificates alone.  ``train`` turns on the
        grid mask, dropout and batch statistics, with every random draw
        taken from ``generator`` (on the model's device), the dropout masks
        from ``dropout_generator`` when one is given (a data-parallel rank's
        own, see `training.train.make_train_step`)."""
        feats, overflow = self.extract_img_feat(img, train, generator)
        outs = self.head(feats, ego2img, prev_bev, shift_ref_2d, only_bev,
                         train, generator if dropout_generator is None
                         else dropout_generator)
        if overflow is not None:
            outs["dcn_window_overflow"] = overflow
        return outs
