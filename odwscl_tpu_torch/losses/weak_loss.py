"""WSDDN / OICR / OD loss terms, batched and masked.

Counterpart of ``odwscl_tpu/losses/weak_loss.py``: scores [B, P, C] with a
[B, P] proposal mask; column 0 of the image labels is the background.
"""

from __future__ import annotations

import torch

from ..ops.losses import (binary_cross_entropy, cross_entropy_with_logits,
                          smooth_l1_loss)


def wsddn_final_score(cls_logit: torch.Tensor, det_logit: torch.Tensor,
                      box_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over classes times the masked softmax over proposals:
    [B, P, C] raw logits -> [B, P, C] f32, pads 0."""
    cls = torch.softmax(cls_logit.to(torch.float32), dim=-1)
    m3 = box_mask[..., None]
    det = torch.where(m3, det_logit.to(torch.float32), float("-inf"))
    m = det.amax(dim=-2, keepdim=True)
    e = torch.where(m3, torch.exp(det - m), 0.0)
    return cls * (e / e.sum(dim=-2, keepdim=True).clamp(min=1e-20))


def mil_loss(final_score: torch.Tensor, labels_img: torch.Tensor,
             epsilon: float = 1e-8) -> torch.Tensor:
    """Image-level MIL BCE: final_score [B, P, C], labels_img [B, C]."""
    img_score = final_score.sum(dim=1).clamp(epsilon, 1.0 - epsilon)
    bce = binary_cross_entropy(img_score, labels_img.clamp(0.0, 1.0))
    return bce.mean(dim=-1).mean()


def refinement_cls_loss(ref_logit: torch.Tensor, pseudo_labels: torch.Tensor,
                        weights: torch.Tensor,
                        box_mask: torch.Tensor) -> torch.Tensor:
    """Per-branch weighted CE: masked mean over each image's real
    proposals, then the mean over images."""
    ce = cross_entropy_with_logits(ref_logit.to(torch.float32), pseudo_labels)
    per = torch.where(box_mask, ce * weights.detach(), 0.0)
    denom = box_mask.sum(dim=-1).clamp(min=1)
    return (per.sum(dim=-1) / denom).mean()


def refinement_reg_loss(bbox_pred: torch.Tensor, pseudo_labels: torch.Tensor,
                        weights: torch.Tensor, reg_targets: torch.Tensor,
                        box_mask: torch.Tensor,
                        cls_agnostic: bool = False) -> torch.Tensor:
    """Smooth-L1 on the positives' own class columns, weighted by the
    pseudo-label scores, summed and divided by the real proposals."""
    b, p, _ = bbox_pred.shape
    pred = bbox_pred.to(torch.float32).reshape(b, p, -1, 4)
    if cls_agnostic:
        picked = pred[:, :, -1, :]
    else:
        idx = pseudo_labels.long().clamp(min=0)[:, :, None, None]
        picked = torch.gather(pred, 2, idx.expand(b, p, 1, 4))[:, :, 0, :]
    pos = (pseudo_labels > 0) & box_mask
    l1 = smooth_l1_loss(picked, reg_targets.detach(), beta=1.0)
    per = torch.where(pos[..., None], l1 * weights.detach()[..., None], 0.0)
    denom = box_mask.sum(dim=-1).clamp(min=1)
    return (per.sum(dim=(1, 2)) / denom).mean()


def avg_image_accuracy(labels: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Accuracy of the top-k classes by score, k = the number of labelled
    classes; labels / scores [B, C]. Ties keep class order (stable sort)."""
    c = labels.shape[-1]
    k = labels.sum(dim=-1).to(torch.int64).clamp(min=1)
    order = torch.argsort(-scores, dim=-1, stable=True)
    picked = torch.gather(labels, -1, order)
    rank_ok = torch.arange(c, device=labels.device)[None, :] < k[:, None]
    acc = torch.where(rank_ok, picked, 0.0).sum(dim=-1) / k
    return acc.mean()
