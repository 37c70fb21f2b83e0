"""IoU matcher and balanced FG/BG sampler on padded batches.

Counterpart of ``odwscl_tpu/models/matcher.py`` (``match_proposals``,
``balanced_sample``), used by the partial-label path
(``models/roi_sampler.py``, ``losses/partial_labels.py``). Batched over
leading dimensions: each proposal gets its matched GT index or one of the
sentinels ``BELOW_LOW_QUALITY`` (-1) and ``BETWEEN_THRESHOLDS`` (-2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BELOW_LOW_QUALITY = -1
BETWEEN_THRESHOLDS = -2


def match_proposals(match_quality: torch.Tensor, gt_mask: torch.Tensor,
                    high_threshold: float, low_threshold: float,
                    allow_low_quality_matches: bool = False) -> torch.Tensor:
    """match_quality [..., G, P] (GT x proposals), gt_mask [..., G] ->
    [..., P] int64: the best GT (the first on ties), or -1 below
    ``low_threshold`` (and everywhere without a GT), -2 between the
    thresholds. ``allow_low_quality_matches`` keeps, for each GT, the
    proposals of its highest positive quality matched."""
    quality = torch.where(gt_mask[..., :, None], match_quality,
                          torch.full_like(match_quality, -1.0))
    matched_vals = quality.amax(dim=-2)
    matches = quality.argmax(dim=-2)          # the first maximum
    out = torch.where(matched_vals < low_threshold,
                      torch.full_like(matches, BELOW_LOW_QUALITY), matches)
    between = (matched_vals >= low_threshold) & (matched_vals
                                                 < high_threshold)
    out = torch.where(between, torch.full_like(out, BETWEEN_THRESHOLDS), out)
    if allow_low_quality_matches:
        best_per_gt = quality.amax(dim=-1, keepdim=True)      # [..., G, 1]
        is_best = ((quality == best_per_gt) & (best_per_gt > 0)
                   & gt_mask[..., :, None])
        out = torch.where(is_best.any(dim=-2), matches, out)
    no_gt = ~gt_mask.any(dim=-1, keepdim=True)
    return torch.where(no_gt, torch.full_like(out, BELOW_LOW_QUALITY), out)


def _pick(mask: torch.Tensor, uniform: torch.Tensor, k: torch.Tensor
          ) -> torch.Tensor:
    """The ``min(k, mask.sum())`` entries of ``mask`` with the largest
    ``uniform`` (a uniformly random subset), per row."""
    scores = torch.where(mask, uniform, torch.full_like(uniform, -1.0))
    order = torch.argsort(-scores, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)
    avail = mask.sum(dim=-1, keepdim=True)
    return mask & (rank < torch.minimum(k, avail))


def balanced_sample(labels: torch.Tensor, valid: torch.Tensor,
                    batch_size_per_image: int, positive_fraction: float,
                    generator: Optional[torch.Generator] = None,
                    uniform: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``int(batch_size_per_image * positive_fraction)`` positives
    (labels > 0) and the rest of ``batch_size_per_image`` negatives
    (labels == 0) of each row [..., P], drawn without replacement. The
    draw is ``uniform`` [..., 2, P] (positives', negatives') or else from
    ``generator``. Returns the (pos, neg) masks."""
    if uniform is None:
        uniform = torch.rand((*labels.shape[:-1], 2, labels.shape[-1]),
                             generator=generator, device=labels.device)
    is_pos = (labels > 0) & valid
    is_neg = (labels == 0) & valid
    k_pos = torch.full_like(labels[..., :1],
                            int(batch_size_per_image * positive_fraction))
    pos = _pick(is_pos, uniform[..., 0, :], k_pos)
    neg = _pick(is_neg, uniform[..., 1, :],
                batch_size_per_image - pos.sum(dim=-1, keepdim=True))
    return pos, neg
