"""The OD, OICR and MIST pseudo-label layers, batched.

Counterpart of ``odwscl_tpu/losses/pseudo_labels.py`` (``od_layer``,
``oicr_layer`` and ``mist_layer`` on ``_sequential_gt_scan`` and
``_assign``): build a pseudo-GT set per positive class (od: the
contrastive miner's set, or the top proposal when that set is empty; oicr:
the top proposal; mist: a diverse subset of the top ``portion`` of the
proposals), assign each proposal to its best pseudo-GT by IoU (+1
convention, first maximum), background at IoU <= fg_iou (mist: < fg_iou),
weight = the assigned pseudo-GT's score, regression targets by the box
coder.

Kept as in the reference: the per-class row zeroing leaks into later
classes; the argmaxes take the first maximum; pseudo-GTs are ordered by
(class asc, score desc, proposal asc) before the IoU argmax, so its ties
resolve as the reference's concatenation order does; MIST's top-k puts
the lower proposal index first among equal scores, as ``jax.lax.top_k``
does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..structures.boxes import box_iou, encode_boxes
from .compact import first_true


class PseudoLabels(NamedTuple):
    labels: torch.Tensor       # [B, P] int64; 0 = background
    weights: torch.Tensor      # [B, P] f32
    reg_targets: torch.Tensor  # [B, P, 4]
    overflow: torch.Tensor     # scalar: GT candidates dropped by the cap


def _sequential_gt_scan(fg_scores: torch.Tensor, box_mask: torch.Tensor,
                        labels_fg: torch.Tensor,
                        pgt_instance: Optional[torch.Tensor]):
    """fg_scores [B, P, C-1]; pgt_instance [B, C-1, P] or None. Returns
    gt_mask and gt_score [B, C-1, P], the scores read after the earlier
    classes' row zeroing."""
    c1 = fg_scores.shape[2]
    cur = fg_scores
    gt_masks, gt_scores = [], []
    for c in range(c1):
        active = labels_fg[:, c]                                  # [B]
        col = torch.where(box_mask, cur[:, :, c], float("-inf"))
        onehot = torch.zeros_like(box_mask).scatter_(
            1, col.argmax(dim=-1, keepdim=True), True)
        if pgt_instance is not None:
            pi = pgt_instance[:, c, :]
            gt_c = torch.where(pi.any(dim=-1, keepdim=True), pi, onehot)
        else:
            gt_c = onehot
        gt_c = gt_c & active[:, None] & box_mask
        gt_masks.append(gt_c)
        gt_scores.append(torch.where(gt_c, cur[:, :, c], 0.0))
        # zero the max row across ALL classes, leaking into later classes
        zero_row = onehot & active[:, None]
        cur = torch.where(zero_row[:, :, None], 0.0, cur)
    return torch.stack(gt_masks, dim=1), torch.stack(gt_scores, dim=1)


def _assign(boxes: torch.Tensor, box_mask: torch.Tensor,
            gt_mask: torch.Tensor, gt_score: torch.Tensor, fg_iou: float,
            bg_strict_less: bool, gt_cap: int, reg_weights) -> PseudoLabels:
    """Compact each image's GT candidates to ``gt_cap`` slots, order them,
    IoU-assign every proposal."""
    b, c1, p = gt_mask.shape
    flat = gt_mask.reshape(b, c1 * p)
    gflat, count = first_true(flat, gt_cap)                       # [B, G]
    gvalid = gflat >= 0
    safe = gflat.clamp(min=0)
    gc = torch.where(gvalid, safe // p, 0)
    gp = torch.where(gvalid, safe % p, 0)
    gs = torch.gather(gt_score.reshape(b, -1), 1, safe)

    # rank within the class: (score desc, proposal asc); [B, i, j]
    better = ((gs[:, None, :] > gs[:, :, None])
              | ((gs[:, None, :] == gs[:, :, None])
                 & (gp[:, None, :] < gp[:, :, None])))
    srank = ((gc[:, None, :] == gc[:, :, None]) & better
             & gvalid[:, None, :]).sum(dim=2)
    key = torch.where(gvalid, gc * (gt_cap + 1) + srank, torch.iinfo(
        torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)
    gc, gp, gs, gvalid = (torch.gather(t, 1, order)
                          for t in (gc, gp, gs, gvalid))

    gt_boxes = torch.gather(boxes, 1, gp[..., None].expand(b, gt_cap, 4))
    iou = torch.where(gvalid[:, None, :], box_iou(boxes, gt_boxes), -1.0)
    assign = iou.argmax(dim=-1)                                   # [B, P]
    max_ov = torch.gather(iou, 2, assign[..., None])[..., 0]
    any_gt = gvalid.any(dim=-1, keepdim=True)
    fg = (max_ov >= fg_iou) if bg_strict_less else (max_ov > fg_iou)
    live = box_mask & any_gt
    lab = torch.where(fg & live, torch.gather(gc, 1, assign) + 1, 0)
    wgt = torch.where(live, torch.gather(gs, 1, assign), 0.0)
    matched = torch.gather(gt_boxes, 1, assign[..., None].expand(b, p, 4))
    reg = torch.where(live[..., None],
                      encode_boxes(matched, boxes, reg_weights), 0.0)
    overflow = (count - gvalid.sum(dim=-1)).clamp(min=0).sum()
    return PseudoLabels(lab, wgt, reg, overflow)


def od_layer(boxes: torch.Tensor, box_mask: torch.Tensor,
             fg_scores: torch.Tensor, labels_fg: torch.Tensor,
             pgt_instance: torch.Tensor, fg_iou: float = 0.5,
             gt_cap: int = 128,
             reg_weights=(10.0, 10.0, 5.0, 5.0)) -> PseudoLabels:
    """The paper's od_layer: pseudo-GT sets from the miner's pgt_instance
    [B, C-1, P], falling back to the top proposal; background where the max
    IoU <= fg_iou."""
    gt_mask, gt_score = _sequential_gt_scan(fg_scores, box_mask, labels_fg,
                                            pgt_instance)
    return _assign(boxes, box_mask, gt_mask, gt_score, fg_iou,
                   bg_strict_less=False, gt_cap=gt_cap,
                   reg_weights=reg_weights)


def oicr_layer(boxes: torch.Tensor, box_mask: torch.Tensor,
               fg_scores: torch.Tensor, labels_fg: torch.Tensor,
               fg_iou: float = 0.5, gt_cap: int = 32,
               reg_weights=(10.0, 10.0, 5.0, 5.0)) -> PseudoLabels:
    """OICR: the top proposal of each positive class is its pseudo-GT;
    background where the max IoU <= fg_iou."""
    gt_mask, gt_score = _sequential_gt_scan(fg_scores, box_mask, labels_fg,
                                            None)
    return _assign(boxes, box_mask, gt_mask, gt_score, fg_iou,
                   bg_strict_less=False, gt_cap=gt_cap,
                   reg_weights=reg_weights)


def mist_layer(boxes: torch.Tensor, box_mask: torch.Tensor,
               fg_scores: torch.Tensor, labels_fg: torch.Tensor,
               portion: float = 0.15, iou_div: float = 0.2,
               fg_iou: float = 0.5, gt_cap: int = 512,
               reg_weights=(10.0, 10.0, 5.0, 5.0)) -> PseudoLabels:
    """MIST: per positive class take the top ``portion`` of the image's
    real proposals and keep each whose IoU to every higher-ranked one is
    below ``iou_div``; background where the max IoU < fg_iou (strict)."""
    b, p, c1 = fg_scores.shape
    k = max(int(p * portion), 1)
    masked = torch.where(box_mask[:, :, None], fg_scores, float("-inf"))
    # the per-image k, floor(real proposals * portion): an f32 product (a
    # Python scalar multiplies an f32 tensor in f32), as the JAX package
    # takes it
    num_real = box_mask.sum(dim=-1).to(torch.float32)
    k_real = torch.floor(num_real * portion).long()
    # top-k by a stable descending sort: ties keep the lower index first
    topv, topi = torch.sort(masked.transpose(1, 2), dim=-1, descending=True,
                            stable=True)
    topv, topi = topv[..., :k], topi[..., :k]                # [B, C-1, k]
    ranks = torch.arange(k, device=boxes.device)
    valid_top = ((ranks < k_real[:, None, None]) & (topv > float("-inf"))
                 & labels_fg[:, :, None])
    top_boxes = torch.gather(boxes[:, None].expand(b, c1, p, 4), 2,
                             topi[..., None].expand(b, c1, k, 4))
    iou_kk = box_iou(top_boxes, top_boxes)                   # [B,C-1,k,k]
    lower = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).tril(-1)
    max_prev = torch.where(lower, iou_kk, -1.0).amax(dim=-1)
    keep_k = ((max_prev < iou_div) | (ranks == 0)) & valid_top
    # topi is unique within a class, so a scatter of the ranks is exact
    gt_mask = torch.zeros((b, c1, p), dtype=torch.bool,
                          device=boxes.device).scatter_(2, topi, keep_k)
    gt_score = torch.zeros((b, c1, p), dtype=torch.float32,
                           device=boxes.device).scatter_(
        2, topi, torch.where(keep_k, topv.to(torch.float32), 0.0))
    return _assign(boxes, box_mask, gt_mask, gt_score, fg_iou,
                   bg_strict_less=True, gt_cap=gt_cap,
                   reg_weights=reg_weights)
