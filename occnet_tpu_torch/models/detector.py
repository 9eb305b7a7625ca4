"""OccNet eval forward (port of `occnet_tpu/models/detector.py`): image
trunk -> FPN -> OccHead.  Grid-mask augmentation is training-only and not
ported yet."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from occnet_tpu.config import ModelConfig
from occnet_tpu_torch.models.fpn import FPN
from occnet_tpu_torch.models.head import OccHead
from occnet_tpu_torch.models.resnet import ResNet, stage_channels


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
                               bb.out_indices, self.dtype)
        self.neck = FPN(stage_channels(bb.out_indices), cfg.embed_dims,
                        cfg.neck.num_outs, cfg.neck.relu_before_extra_convs,
                        self.dtype)
        self.head = OccHead(cfg, self.dtype)

    def extract_img_feat(self, img: torch.Tensor) -> List[torch.Tensor]:
        """(B, cams, H, W, 3) -> list of (B, cams, h, w, C) FPN levels.
        The trunk runs NCHW in channels-last memory (a permuted view)."""
        b, n_cam, h, w, ch = img.shape
        x = img.reshape(b * n_cam, h, w, ch).to(self.dtype).permute(0, 3, 1, 2)
        feats = self.neck(self.backbone(x))
        return [f.permute(0, 2, 3, 1).reshape(b, n_cam, *f.shape[2:],
                                              f.shape[1])
                for f in feats]

    def forward(self, img: torch.Tensor, ego2img: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """img (B, cams, H, W, 3) normalised, ego2img (B, cams, 4, 4)."""
        return self.head(self.extract_img_feat(img), ego2img)
