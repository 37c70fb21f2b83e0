"""Masked greedy NMS over padded boxes, in plain torch.

Counterpart of ``odwscl_tpu/ops/nms.py`` (XLA there, not Pallas, so plain
torch is the port). torchvision's convention: the IoU has NO +1 offset and
suppresses strictly greater overlaps, unlike the +1 box code elsewhere.

Same algorithm as the reference: sort by score, build the [P, P]
upper-triangular suppression matrix once, then iterate the antitone
fixpoint ``keep <- valid & ~any(sup & keep)``. Suppression flows only from
higher to lower scores, so the iteration reaches the exact greedy result in
(chain depth + 1) sweeps. Each sweep's convergence test reads one bool back
to the host.
"""

from __future__ import annotations

import torch

# [rows, P, P] elements of IoU built at once; bounds the temporaries of the
# suppression matrix at eval shapes (168 rows of 2048 x 2048 at batch 8).
_IOU_CHUNK_ELEMS = 1 << 27


def _iou_no_offset(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with torchvision conventions (no +1)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     mask: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over any number of leading batch axes.

    boxes [..., P, 4], scores [..., P], mask [..., P] bool -> keep [..., P]
    in the original order. Masked entries are never kept and suppress
    nothing.
    """
    batch_shape = scores.shape[:-1]
    p = scores.shape[-1]
    boxes = boxes.reshape(-1, p, 4)
    scores = scores.reshape(-1, p)
    mask = mask.reshape(-1, p)
    n = scores.shape[0]

    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(mask, scores, neg_inf), dim=-1,
                          stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(n, p, 4))
    valid = torch.gather(mask, 1, order)

    upper = torch.ones(p, p, dtype=torch.bool, device=scores.device).triu(1)
    sup = torch.empty((n, p, p), dtype=torch.bool, device=scores.device)
    rows = max(1, _IOU_CHUNK_ELEMS // max(p * p, 1))
    for s in range(0, n, rows):
        e = min(s + rows, n)
        # sup[j, i]: kept j (earlier in score order) would suppress i
        sup[s:e] = ((_iou_no_offset(b[s:e], b[s:e]) > iou_threshold) & upper
                    & valid[s:e, :, None] & valid[s:e, None, :])

    keep = valid
    while True:
        suppressed = (sup & keep[:, :, None]).any(dim=1)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    out = torch.zeros_like(mask)
    out.scatter_(1, order, keep)
    return out.reshape(*batch_shape, p)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS of one set: boxes [P, 4], scores [P], mask [P] -> keep [P]."""
    return batched_nms_mask(boxes[None], scores[None], mask[None],
                            iou_threshold)[0]
