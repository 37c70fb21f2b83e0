"""Proposal labels and subsampling for partial-label supervision.

Counterpart of ``odwscl_tpu/models/roi_sampler.py``
(``ROI_WEAK_HEAD.PARTIAL_LABELS`` point / scribble). Before the features
are pooled, each proposal gets a class from the partial annotations (point:
the first click strictly inside the box; scribble: the matcher over the
intersection / scribble area, -1 between the thresholds), then a balanced
FG/BG subset of ``ROI_HEADS.BATCH_SIZE_PER_IMAGE`` proposals is kept in its
original order: the proposal axis shrinks from P to min(P, that size),
with a mask for the unfilled tail.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures.boxes import box_iou_async
from .matcher import (BELOW_LOW_QUALITY, BETWEEN_THRESHOLDS, balanced_sample,
                      match_proposals)


def clicks_inside(boxes: torch.Tensor, clicks: torch.Tensor,
                  click_mask: torch.Tensor) -> torch.Tensor:
    """[B, K, P]: click k lies strictly inside box p (and is valid)."""
    cx = clicks[..., 0][:, :, None]
    cy = clicks[..., 1][:, :, None]
    return ((cx > boxes[:, None, :, 0]) & (cy > boxes[:, None, :, 1])
            & (cx < boxes[:, None, :, 2]) & (cy < boxes[:, None, :, 3])
            & click_mask[:, :, None])


def match_labels_point(boxes: torch.Tensor, clicks: torch.Tensor,
                       click_labels: torch.Tensor, click_mask: torch.Tensor
                       ) -> torch.Tensor:
    """[B, P, 4] boxes, [B, K, 2] clicks -> [B, P] int64 labels: the label
    of the first click strictly inside the box, else 0 (background)."""
    inside = clicks_inside(boxes, clicks, click_mask)        # [B, K, P]
    first = inside.to(torch.float32).argmax(dim=1)           # first True
    matched = inside.any(dim=1)
    lab = torch.gather(click_labels, 1, first)
    return torch.where(matched, lab, torch.zeros_like(lab))


def match_labels_scribble(boxes: torch.Tensor, scribbles: torch.Tensor,
                          scribble_labels: torch.Tensor,
                          scribble_mask: torch.Tensor, fg_iou: float,
                          bg_iou: float) -> torch.Tensor:
    """[B, P] int64 labels: the matched scribble's class, 0 below
    ``bg_iou``, -1 (ignored) between the thresholds; quality is the
    intersection over the scribble box's area."""
    m = match_proposals(box_iou_async(scribbles, boxes), scribble_mask,
                        fg_iou, bg_iou, allow_low_quality_matches=False)
    lab = torch.gather(scribble_labels, 1, m.clamp(min=0))
    lab = torch.where(m >= 0, lab, torch.zeros_like(lab))
    lab = torch.where(m == BELOW_LOW_QUALITY, torch.zeros_like(lab), lab)
    return torch.where(m == BETWEEN_THRESHOLDS, torch.full_like(lab, -1), lab)


def subsample_proposals(boxes: torch.Tensor, mask: torch.Tensor,
                        labels: torch.Tensor, batch_size_per_image: int,
                        positive_fraction: float,
                        generator: Optional[torch.Generator] = None,
                        uniform: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Balanced FG/BG subsample to [B, S] proposals, S = min(P,
    ``batch_size_per_image``). Returns (boxes [B, S, 4], mask [B, S], idx
    [B, S] indices into P): the selected proposals first in their original
    order, the tail index 0 and masked. ``uniform`` [B, 2, P] replaces the
    draw from ``generator`` (``balanced_sample``)."""
    pos, neg = balanced_sample(labels, mask, batch_size_per_image,
                               positive_fraction, generator, uniform)
    sel = pos | neg
    s = min(batch_size_per_image, sel.shape[1])
    order = torch.argsort((~sel).to(torch.int8), dim=1, stable=True)[:, :s]
    new_mask = torch.gather(sel, 1, order)
    idx = torch.where(new_mask, order, torch.zeros_like(order))
    new_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return new_boxes, new_mask, idx
