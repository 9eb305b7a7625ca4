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
from occnet_tpu_torch.parallel.multihost import all_reduce_, world_size


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
                ego2img: torch.Tensor, prev_bev: Optional[torch.Tensor] = None,
                shift_ref_2d: Optional[torch.Tensor] = None,
                only_bev: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """-> {"bev_embed", "occ", "flow"} (and the certificate); with
        ``only_bev`` (the history-BEV path) the BEV and the certificate
        alone: the decoder and the heads do not run."""
        bev_pos = self.positional_encoding(mlvl_feats[0].shape[0])
        if only_bev:
            bev_embed, overflow = self.transformer.get_bev_features(
                mlvl_feats, self.bev_embedding, bev_pos, ego2img, prev_bev,
                shift_ref_2d, train, generator)
            outs = {"bev_embed": bev_embed}
        else:
            bev_embed, occ, flow, overflow = self.transformer(
                mlvl_feats, self.bev_embedding, bev_pos, ego2img, prev_bev,
                shift_ref_2d, train, generator)
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
    both terms.  Returns (loss_occ, loss_flow).

    Under a process group of N > 1 ranks each rank holds 1 / N of the global
    batch, and the JAX step's losses are means over the global batch: the
    weighted and masked means divide by the all-reduced weight sum, and
    every term is returned as this rank's share scaled so that the average
    over ranks (the data-parallel gradient average) is the global mean.
    The plain means have equal counts on every rank and need no
    collective.  At world size 1 the arithmetic is unchanged: the
    all-reduce is the identity, ``num * 1`` is exact and the weight sums
    carry no gradient."""
    world = world_size()

    def weighted_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
        return num * world / all_reduce_(den.detach().clone()).clamp(
            min=1e-6)

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
        return weighted_mean((l1f * fw[:, None]).sum(), fw.sum() * 2.0)

    if loss_cfg.use_mask and mask_camera is not None:
        m = mask_camera.reshape(-1).float()
        wm = m if w is None else w * m
        loss_occ = weighted_mean((ce * wm).sum(), wm.sum())
        loss_flow = flow_mean(m)
    elif w is not None:
        loss_occ = weighted_mean((ce * w).sum(), w.sum())
        loss_flow = flow_mean()
    else:
        loss_occ = ce.mean()
        loss_flow = flow_mean()
    return loss_cfg.occ_weight * loss_occ, loss_cfg.flow_weight * loss_flow


def get_occ(outs: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-argmax semantic decode + raw flow."""
    return outs["occ"].float().argmax(dim=-1), outs["flow"]
