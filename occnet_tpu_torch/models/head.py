"""OccHead (port of `occnet_tpu/models/head.py`): the BEV query table, the
learned positional encoding, TransformerOcc, the CE + L1 occupancy/flow loss
`occ_flow_loss`, and the argmax decode `get_occ`.  In gather mode the outputs
carry the SCA exactness certificate `sca_topk_overflow` (0-d int64)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from occnet_tpu_torch.config import FLOW_CLASS_NAMES, LossConfig, ModelConfig
from occnet_tpu_torch.models.positional import LearnedPositionalEncoding2D
from occnet_tpu_torch.models.transformer_occ import TransformerOcc


class OccHead(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.bev_embedding = nn.Parameter(
            torch.randn(c.bev_h * c.bev_w, c.embed_dims))
        self.positional_encoding = LearnedPositionalEncoding2D(
            c.embed_dims // 2, c.bev_h, c.bev_w, dtype)
        self.transformer = TransformerOcc(c, dtype)

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                ego2img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        bev_pos = self.positional_encoding(mlvl_feats[0].shape[0])
        bev_embed, occ, flow, overflow = self.transformer(
            mlvl_feats, self.bev_embedding, bev_pos, ego2img, train,
            generator)
        outs = {"bev_embed": bev_embed, "occ": occ, "flow": flow}
        if overflow is not None:
            outs["sca_topk_overflow"] = overflow
        return outs


# GT labels below this bound are flow classes (they lead OCC_CLASS_NAMES);
# derived from the class list, not the literal 8 of the JAX package.
NUM_FLOW_CLASSES = len(FLOW_CLASS_NAMES)


def occ_flow_loss(occ_logits: torch.Tensor, flow_pred: torch.Tensor,
                  voxel_semantics: torch.Tensor, voxel_flow: torch.Tensor,
                  loss_cfg: LossConfig,
                  mask_camera: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE over the voxels (mean) + L1 flow (mean over elements), weighted by
    occ_weight / flow_weight; all loss math in fp32.  The branches of the
    JAX package: ``class_weights`` uses the torch `F.cross_entropy`
    reduction sum(w[y] * ce) / sum(w[y]); ``flow_fg_weight`` weights flow-class
    voxels in a weighted flow mean; ``use_mask`` with a camera mask masks
    both terms.  Returns (loss_occ, loss_flow)."""
    num_classes = occ_logits.shape[-1]
    logits = occ_logits.float().reshape(-1, num_classes)
    labels = voxel_semantics.long().reshape(-1)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    l1 = (flow_pred.float() - voxel_flow.float()).abs()
    if loss_cfg.class_weights:
        if len(loss_cfg.class_weights) != num_classes:
            raise ValueError(f"class_weights has {len(loss_cfg.class_weights)}"
                             f" entries for {num_classes} classes")
        w = torch.tensor(loss_cfg.class_weights, dtype=torch.float32,
                         device=logits.device)[labels]
    else:
        w = None

    def flow_mean(extra_mask=None):
        l1f = l1.reshape(-1, 2)
        if loss_cfg.flow_fg_weight == 1.0 and extra_mask is None:
            return l1f.mean()
        fw = torch.where(labels < NUM_FLOW_CLASSES, loss_cfg.flow_fg_weight,
                         torch.ones_like(l1f[:, 0]))
        if extra_mask is not None:
            fw = fw * extra_mask
        return (l1f * fw[:, None]).sum() / (fw.sum() * 2.0).clamp(min=1e-6)

    if loss_cfg.use_mask and mask_camera is not None:
        m = mask_camera.reshape(-1).float()
        wm = m if w is None else w * m
        loss_occ = (ce * wm).sum() / wm.sum().clamp(min=1e-6)
        loss_flow = flow_mean(m)
    elif w is not None:
        loss_occ = (ce * w).sum() / w.sum().clamp(min=1e-6)
        loss_flow = flow_mean()
    else:
        loss_occ = ce.mean()
        loss_flow = flow_mean()
    return loss_cfg.occ_weight * loss_occ, loss_cfg.flow_weight * loss_flow


def get_occ(outs: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-argmax semantic decode + raw flow."""
    return outs["occ"].float().argmax(dim=-1), outs["flow"]
