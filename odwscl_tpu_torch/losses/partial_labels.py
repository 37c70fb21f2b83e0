"""Pseudo labels filtered by partial labels (clicks or scribbles).

Counterpart of ``odwscl_tpu/losses/partial_labels.py``, active with
``ROI_WEAK_HEAD.PARTIAL_LABELS`` point / scribble and
``ROI_LOSS_REFINE``: a refinement branch's pseudo label survives only
where the partial annotations of its class support it.
"""

from __future__ import annotations

import torch

from ..models.matcher import match_proposals
from ..models.roi_sampler import clicks_inside
from ..structures.boxes import box_iou_async


def filter_pseudo_labels_point(pseudo_labels: torch.Tensor,
                               boxes: torch.Tensor, clicks: torch.Tensor,
                               click_labels: torch.Tensor,
                               click_mask: torch.Tensor) -> torch.Tensor:
    """pseudo_labels [B, P] with 0 where no click of the same class lies
    strictly inside the proposal. clicks [B, K, 2] (x, y)."""
    inside = clicks_inside(boxes, clicks, click_mask)        # [B, K, P]
    same = click_labels[:, :, None] == pseudo_labels[:, None, :]
    supported = (inside & same).any(dim=1)
    return torch.where(supported, pseudo_labels,
                       torch.zeros_like(pseudo_labels))


def filter_pseudo_labels_scribble(pseudo_labels: torch.Tensor,
                                  boxes: torch.Tensor,
                                  scribbles: torch.Tensor,
                                  scribble_labels: torch.Tensor,
                                  scribble_mask: torch.Tensor
                                  ) -> torch.Tensor:
    """pseudo_labels [B, P] with 0 where the proposal matches no scribble
    box (intersection / scribble area at 0.5) or the matched scribble's
    class differs. scribbles [B, S, 4]."""
    matched = match_proposals(box_iou_async(scribbles, boxes), scribble_mask,
                              0.5, 0.5, False)
    cls = torch.gather(scribble_labels, 1, matched.clamp(min=0))
    keep = (matched >= 0) & (cls == pseudo_labels)
    return torch.where(keep, pseudo_labels, torch.zeros_like(pseudo_labels))
