"""Detection box stack (port of `occnet_tpu/models/bbox.py`): the box codec,
the match costs, the Hungarian assignment and the NMS-free decoder.

- `normalize_bbox` / `denormalize_bbox`: 9-DoF (cx, cy, cz, w, l, h, rot,
  vx, vy) boxes <-> the 10-code network parameterisation (cx, cy, log w,
  log l, cz, log h, sin rot, cos rot, vx, vy).
- `bbox3d_l1_cost`, `focal_loss_cost`, `classification_cost`: the match
  costs of the assigner.
- `hungarian_assign_3d`: the costs on the CPU in fp32, the solve by scipy's
  `linear_sum_assignment` on the host, as in the JAX package.
- `decode_layer_boxes`: a decoder layer's box code against the reference
  that layer saw (``init_reference`` for layer 0, else
  ``inter_references[lvl - 1]``).
- `nms_free_decode`: top-k score decode with centre-range masking, static
  shapes (max_num boxes and a ``valid`` mask).  `torch.topk` and
  `lax.top_k` order tied scores differently.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from occnet_tpu_torch.models.decoder import inverse_sigmoid


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """(..., 7 or 9) gravity-centre boxes -> (..., 8 or 10) codes."""
    cx, cy, cz = bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 2:3]
    w = torch.log(bboxes[..., 3:4])
    l = torch.log(bboxes[..., 4:5])  # noqa: E741
    h = torch.log(bboxes[..., 5:6])
    rot = bboxes[..., 6:7]
    parts = [cx, cy, w, l, cz, h, torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(codes: torch.Tensor) -> torch.Tensor:
    """(..., 8 or 10) codes -> (..., 7 or 9) boxes."""
    rot = torch.atan2(codes[..., 6:7], codes[..., 7:8])
    cx, cy, cz = codes[..., 0:1], codes[..., 1:2], codes[..., 4:5]
    w = torch.exp(codes[..., 2:3])
    l = torch.exp(codes[..., 3:4])  # noqa: E741
    h = torch.exp(codes[..., 5:6])
    parts = [cx, cy, cz, w, l, h, rot]
    if codes.shape[-1] > 8:
        parts += [codes[..., 8:9], codes[..., 9:10]]
    return torch.cat(parts, dim=-1)


def bbox3d_l1_cost(bbox_pred: torch.Tensor, gt_codes: torch.Tensor,
                   weight: float = 1.0) -> torch.Tensor:
    """(Q, C) x (G, C) -> (Q, G) pairwise L1."""
    return (bbox_pred[:, None, :] - gt_codes[None, :, :]).abs().sum(-1) \
        * weight


def focal_loss_cost(cls_pred: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float = 2.0, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """mmdet `FocalLossCost`: (Q, num_cls) logits x (G,) labels ->
    (Q, G)."""
    p = torch.sigmoid(cls_pred)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * torch.pow(p, gamma)
    pos = -torch.log(p + eps) * alpha * torch.pow(1 - p, gamma)
    return (pos - neg)[:, gt_labels.long()] * weight


def classification_cost(cls_pred: torch.Tensor, gt_labels: torch.Tensor,
                        weight: float = 1.0) -> torch.Tensor:
    """mmdet `ClassificationCost`: minus the softmax score of the GT
    class."""
    score = torch.softmax(cls_pred, dim=-1)
    return -score[:, gt_labels.long()] * weight


def hungarian_assign_3d(bbox_pred, cls_pred, gt_bboxes, gt_labels,
                        cls_weight: float = 2.0, reg_weight: float = 0.25
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One-to-one matching of Q predictions (codes (Q, >=8), logits
    (Q, num_cls)) to G boxes (G, 7 or 9) with labels (G,), arrays or
    tensors.  Returns (assigned_gt_inds (Q,), assigned_labels (Q,)) int64:
    0 = background, g + 1 = matched to GT g; labels -1 where unmatched."""
    from scipy.optimize import linear_sum_assignment

    def cpu(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x.detach().cpu() if
                                          torch.is_tensor(x) else x),
                               dtype=dtype)

    Q, G = int(np.shape(bbox_pred)[0]), int(np.shape(gt_bboxes)[0])
    assigned = np.zeros((Q,), np.int64)
    labels = np.full((Q,), -1, np.int64)
    if G == 0 or Q == 0:
        return assigned, labels
    gt_labels = cpu(gt_labels, torch.int64)
    gt_codes = normalize_bbox(cpu(gt_bboxes))
    cost = (focal_loss_cost(cpu(cls_pred), gt_labels, weight=cls_weight)
            + bbox3d_l1_cost(cpu(bbox_pred)[:, :8], gt_codes[:, :8],
                             weight=reg_weight))
    rows, cols = linear_sum_assignment(cost.numpy())
    assigned[rows] = cols + 1
    labels[rows] = gt_labels.numpy()[cols]
    return assigned, labels


def decode_layer_boxes(codes: torch.Tensor, lvl: int,
                       init_reference: torch.Tensor,
                       inter_references: torch.Tensor,
                       pc_range: Sequence[float]) -> torch.Tensor:
    """Decoder layer ``lvl``'s box codes (..., Q, >=8) against the
    reference it saw: ``init_reference`` (..., Q, 3) for lvl 0, else
    ``inter_references[lvl - 1]`` (the decoder's post-refinement
    references, (L, ..., Q, 3)).  Returns the codes with (cx, cy, cz)
    replaced by the sigmoid-refined centres in metres over ``pc_range``,
    the layout `denormalize_bbox` / `nms_free_decode` read."""
    ref = init_reference if lvl == 0 else inter_references[lvl - 1]
    ref = inverse_sigmoid(ref.float())
    codes = codes.float()
    xy = torch.sigmoid(codes[..., 0:2] + ref[..., 0:2])
    z = torch.sigmoid(codes[..., 4:5] + ref[..., 2:3])
    pc = np.asarray(pc_range, np.float32)
    cx = xy[..., 0:1] * float(pc[3] - pc[0]) + float(pc[0])
    cy = xy[..., 1:2] * float(pc[4] - pc[1]) + float(pc[1])
    cz = z * float(pc[5] - pc[2]) + float(pc[2])
    return torch.cat([cx, cy, codes[..., 2:4], cz, codes[..., 5:]], dim=-1)


def nms_free_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                    post_center_range: Sequence[float], max_num: int = 100,
                    score_threshold: Optional[float] = None,
                    num_classes: Optional[int] = None) -> dict:
    """`NMSFreeCoder.decode_single` with static shapes: cls_scores
    (Q, num_cls) logits and bbox_preds (Q, 10) codes -> {"bboxes"
    (max_num, 9), "scores", "labels" (max_num,), "valid" (max_num,) bool}
    on their device.  With ``score_threshold``, the threshold decays by 0.9
    until a box passes (the reference's loop, on the host)."""
    num_classes = num_classes or cls_scores.shape[-1]
    scores = torch.sigmoid(cls_scores).reshape(-1)
    scores, idx = torch.topk(scores, max_num)
    labels = idx % num_classes
    boxes = denormalize_bbox(bbox_preds[idx // num_classes])
    pcr = torch.as_tensor(np.asarray(post_center_range, np.float32),
                          device=boxes.device)
    mask = ((boxes[:, :3] >= pcr[:3]).all(dim=1)
            & (boxes[:, :3] <= pcr[3:]).all(dim=1))
    if score_threshold is not None:
        s = scores.detach().cpu().numpy()
        thresh = float(score_threshold)
        keep = s > thresh
        while not keep.any():
            thresh *= 0.9
            if thresh < 0.01:
                keep = s > -1.0
                break
            keep = s >= thresh
        mask = mask & torch.as_tensor(keep, device=mask.device)
    return {"bboxes": boxes, "scores": scores, "labels": labels,
            "valid": mask}
