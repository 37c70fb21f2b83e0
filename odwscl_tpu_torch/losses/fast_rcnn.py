"""The fully supervised Fast R-CNN box-head loss on padded batches.

Counterpart of ``odwscl_tpu/losses/fast_rcnn.py``
(``prepare_fast_rcnn_targets``, ``fast_rcnn_loss``). Proposals match the
GT by IoU (no low-quality matches): below ``bg_iou`` background, between
the thresholds ignored, padding ignored; a balanced sample of
``batch_size_per_image`` proposals then trains the classifier (CE mean
over every sampled proposal of the batch) and the positives' class
columns the box regression (smooth-L1 summed over the positives / the
sampled count).

The sample's draw is ``uniform`` [B, 2, P] (positives', negatives') when
given, else from ``generator``: the JAX package draws the same two rows
per image from its keys (``jax.random.split(rng, B)``, then each image's
key split in two), so handing those uniforms in gives its exact sample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.matcher import BETWEEN_THRESHOLDS, balanced_sample, \
    match_proposals
from ..ops.losses import smooth_l1_loss
from ..structures.boxes import box_iou, encode_boxes


class FastRCNNTargets(NamedTuple):
    labels: torch.Tensor       # [B, P] int64 (0 bg, -1 ignored)
    reg_targets: torch.Tensor  # [B, P, 4] encoded against the matched GT
    pos_mask: torch.Tensor     # [B, P] sampled positives
    neg_mask: torch.Tensor     # [B, P] sampled negatives
    matched: torch.Tensor      # [B, P] matched GT index or a sentinel


def prepare_fast_rcnn_targets(
        boxes: torch.Tensor, box_mask: torch.Tensor, gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor, gt_mask: torch.Tensor,
        fg_iou: float = 0.5, bg_iou: float = 0.5,
        batch_size_per_image: int = 512, positive_fraction: float = 0.25,
        reg_weights: Tuple[float, float, float, float] = (10., 10., 5., 5.),
        generator: Optional[torch.Generator] = None,
        uniform: Optional[torch.Tensor] = None) -> FastRCNNTargets:
    """boxes [B, P, 4] proposals, box_mask [B, P]; gt_boxes [B, G, 4],
    gt_labels [B, G] (1..C-1), gt_mask [B, G]."""
    quality = torch.where(gt_mask[..., :, None] & box_mask[..., None, :],
                          box_iou(gt_boxes, boxes), 0.0)        # [B, G, P]
    matched = match_proposals(quality, gt_mask, fg_iou, bg_iou)
    safe = matched.clamp(min=0)
    labels = torch.where(matched >= 0,
                         torch.gather(gt_labels.long(), 1, safe), 0)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(box_mask, labels, -1)
    gt_sel = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    reg = encode_boxes(gt_sel, boxes, reg_weights)
    pos, neg = balanced_sample(labels, labels >= 0, batch_size_per_image,
                               positive_fraction, generator, uniform)
    return FastRCNNTargets(labels, reg, pos, neg, matched)


def fast_rcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                   targets: FastRCNNTargets,
                   cls_agnostic_bbox_reg: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(classification loss, box loss, accuracy). class_logits [B, P, C];
    box_regression [B, P, 4C] (or [B, P, 8] class-agnostic: background
    columns 0-3, foreground 4-7)."""
    labels = targets.labels
    sampled = targets.pos_mask | targets.neg_mask
    n_sampled = sampled.sum().clamp(min=1)
    safe = labels.clamp(min=0)
    logp = torch.log_softmax(class_logits.to(torch.float32), dim=-1)
    ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    cls_loss = torch.where(sampled, ce, 0.0).sum() / n_sampled
    preds = class_logits.argmax(dim=-1)
    acc = ((sampled & (preds == safe)).sum() / n_sampled).to(torch.float32)
    col0 = torch.ones_like(safe) if cls_agnostic_bbox_reg else safe
    cols = 4 * col0[..., None] + torch.arange(4, device=labels.device)
    reg_pred = torch.gather(box_regression.to(torch.float32), -1, cols)
    per_box = smooth_l1_loss(reg_pred, targets.reg_targets, beta=1.0)
    box_loss = (torch.where(targets.pos_mask[..., None], per_box, 0.0).sum()
                / n_sampled)
    return cls_loss, box_loss, acc
