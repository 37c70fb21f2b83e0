"""Detection post-processing: score threshold -> per-class NMS -> top-K.

Counterpart of ``odwscl_tpu/engine/postprocess.py``. NMS and the top-K run
on the batch's device; the ragged per-image lists are assembled on the
host from a [B, K] transfer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.nms import batched_nms_mask


def per_class_nms_keep(boxes: torch.Tensor, scores: torch.Tensor,
                       box_mask: torch.Tensor, nms_thresh: float,
                       score_thresh: float) -> torch.Tensor:
    """boxes [B, P, C, 4] (per class) or [B, P, 4] (shared); scores
    [B, P, C] with background column 0; box_mask [B, P] ->
    keep [B, C, P] (background never kept)."""
    b, p, c = scores.shape
    boxes_c = (boxes[:, :, None, :].expand(b, p, c, 4) if boxes.dim() == 3
               else boxes)
    boxes_t = boxes_c.permute(0, 2, 1, 3)                  # [B, C, P, 4]
    scores_t = scores.permute(0, 2, 1)                     # [B, C, P]
    mask = box_mask[:, None, :] & (scores_t > score_thresh)
    mask[:, 0, :] = False                                  # skip background
    return batched_nms_mask(boxes_t, scores_t, mask, nms_thresh)


def finalize_detections_device(boxes: torch.Tensor, scores: torch.Tensor,
                               box_mask: torch.Tensor, nms_thresh: float,
                               score_thresh: float, k: int = 100):
    """Per-class NMS + global top-K. Returns (boxes [B,K,4], scores [B,K],
    labels [B,K], valid [B,K]). The top-K keeps exactly K, ties broken
    towards the lower (class, proposal) index, as ``lax.top_k`` does; the
    reference's kthvalue cap may keep more than K on ties."""
    keep = per_class_nms_keep(boxes, scores, box_mask, nms_thresh,
                              score_thresh)                # [B, C, P]
    b, c, p = keep.shape
    boxes_c = (boxes[:, :, None, :].expand(b, p, c, 4) if boxes.dim() == 3
               else boxes.reshape(b, p, c, 4))
    scores_t = scores.permute(0, 2, 1)
    boxes_t = boxes_c.permute(0, 2, 1, 3).reshape(b, c * p, 4)
    flat = torch.where(keep, scores_t,
                       torch.full((), -1.0, device=scores.device,
                                  dtype=scores.dtype)).reshape(b, c * p)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_labels = torch.div(top_idx, p, rounding_mode="floor")
    top_boxes = torch.gather(boxes_t, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, top_labels, top_scores > 0.0


def detections_to_host(top_boxes, top_scores, top_labels, valid
                       ) -> List[Dict[str, np.ndarray]]:
    """[B, K, ...] detections -> per-image dicts of numpy arrays."""
    tb = top_boxes.to("cpu", torch.float32).numpy()
    ts = top_scores.to("cpu", torch.float32).numpy()
    tl = top_labels.to("cpu", torch.int64).numpy()
    tv = valid.cpu().numpy()
    return [{"boxes": tb[i][tv[i]], "scores": ts[i][tv[i]],
             "labels": tl[i][tv[i]]} for i in range(tb.shape[0])]


def resize_detections(dets: Dict[str, np.ndarray], from_wh, to_wh
                      ) -> Dict[str, np.ndarray]:
    """Rescale detection boxes between image sizes (BoxList.resize)."""
    rw = to_wh[0] / from_wh[0]
    rh = to_wh[1] / from_wh[1]
    boxes = dets["boxes"].copy()
    boxes[:, 0::2] *= rw
    boxes[:, 1::2] *= rh
    return {**dets, "boxes": boxes}
