"""Train-time quality of the mined pseudo-GT boxes against real GT.

Counterpart of ``odwscl_tpu/utils/pgt_metrics.py``: per (image, class)
precision and recall of the pseudo-GT at IoU thresholds, batched over
padded masks, for debugging runs on datasets with GT boxes (no training
path calls it, in either package).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..structures.boxes import box_iou


def pgt_precision_recall(pgt_boxes: torch.Tensor, pgt_mask: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                         thresholds: Sequence[float] = (0.25, 0.5, 0.75)
                         ) -> Dict[str, torch.Tensor]:
    """pgt_boxes [B, N, 4] with pgt_mask [B, N], gt_boxes [B, G, 4] with
    gt_mask [B, G] -> {``pgt_prec_<T>``, ``pgt_rec_<T>``}: f32 scalars,
    the mean over the images that have both pseudo-GT and GT.

    Per image: tp = the (gt, pgt) pairs with IoU (+1 convention) > T;
    fn = the GT boxes that no pgt matches; precision = tp / |pgt|,
    recall = tp / (tp + fn)."""
    iou = box_iou(gt_boxes, pgt_boxes)                      # [B, G, N]
    pair_valid = gt_mask[:, :, None] & pgt_mask[:, None, :]
    out: Dict[str, torch.Tensor] = {}
    n_pgt = pgt_mask.sum(dim=1).to(torch.float32)
    any_img = (n_pgt > 0) & (gt_mask.sum(dim=1) > 0)
    denom_img = any_img.to(torch.float32).sum().clamp(min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=n_pgt.device)
    for t in thresholds:
        hit = (iou > t) & pair_valid
        tp = hit.sum(dim=(1, 2)).to(torch.float32)
        fn = (gt_mask & ~hit.any(dim=2)).sum(dim=1).to(torch.float32)
        prec = torch.where(any_img, tp / n_pgt.clamp(min=1.0), zero)
        rec = torch.where(any_img, tp / (tp + fn).clamp(min=1.0), zero)
        out[f"pgt_prec_{t:.2f}"] = prec.sum() / denom_img
        out[f"pgt_rec_{t:.2f}"] = rec.sum() / denom_img
    return out
