"""OccNet (port of `occnet_tpu/models/detector.py`): grid mask (training
only) -> image trunk -> FPN -> OccHead."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from occnet_tpu.config import ModelConfig
from occnet_tpu_torch.models.fpn import FPN
from occnet_tpu_torch.models.head import OccHead
from occnet_tpu_torch.models.resnet import ResNet, stage_channels
from occnet_tpu_torch.ops.grid_mask import grid_mask_apply, grid_mask_draw


class OccNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        bb = cfg.backbone
        if not bb.type.startswith("resnet") or any(bb.dcn_stages):
            raise ValueError(f"occnet_tpu_torch ports the plain ResNet trunk "
                             f"only, got {bb.type} dcn={bb.dcn_stages}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.backbone = ResNet(int(bb.type.replace("resnet", "")),
                               bb.out_indices, self.dtype, bb.frozen_stages,
                               bb.norm_eval)
        self.neck = FPN(stage_channels(bb.out_indices), cfg.embed_dims,
                        cfg.neck.num_outs, cfg.neck.relu_before_extra_convs,
                        self.dtype)
        self.head = OccHead(cfg, self.dtype)

    def extract_img_feat(self, img: torch.Tensor, train: bool = False,
                         generator: Optional[torch.Generator] = None
                         ) -> List[torch.Tensor]:
        """(B, cams, H, W, 3) -> list of (B, cams, h, w, C) FPN levels.
        In training with `use_grid_mask`, one grid mask drawn from
        ``generator`` covers every image.  The trunk runs NCHW in
        channels-last memory (a permuted view)."""
        b, n_cam, h, w, ch = img.shape
        x = img.reshape(b * n_cam, h, w, ch).to(self.dtype)
        if train and self.cfg.use_grid_mask:
            x = grid_mask_apply(x, *grid_mask_draw(
                generator, h, self.cfg.grid_mask_prob, x.device))
        feats = self.neck(self.backbone(x.permute(0, 3, 1, 2), train))
        return [f.permute(0, 2, 3, 1).reshape(b, n_cam, *f.shape[2:],
                                              f.shape[1])
                for f in feats]

    def forward(self, img: torch.Tensor, ego2img: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """img (B, cams, H, W, 3) normalised, ego2img (B, cams, 4, 4).
        ``train`` turns on the grid mask, dropout and batch statistics, with
        every random draw taken from ``generator`` (on the model's device)."""
        return self.head(self.extract_img_feat(img, train, generator),
                         ego2img, train, generator)
