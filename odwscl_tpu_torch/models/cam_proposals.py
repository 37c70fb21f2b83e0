"""CAM-attention proposals: the ``MODEL.FASTER_RCNN True`` path.

Counterpart of ``odwscl_tpu/models/cam_proposals.py`` (``_anchors``,
``cam_to_proposals``). Dense anchors over the feature grid (5 sizes x 3
ratios per cell) are clipped to each image, anchors under ``min_size``
dropped, and each scored by the sigmoid of the mean attention logit over
the feature cells it covers, taken exactly from a 2-D integral image. The
top ``pre_nms`` go through greedy NMS at ``nms_thresh`` (ops/nms.py), and
the top ``out_p`` of the survivors, padded to that count, are the image's
proposals.

Both top-k steps are stable descending sorts, so equal objectness keeps
the lower anchor index first, as ``jax.lax.top_k`` does: anchors clipped
to the same box tie exactly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nms import batched_nms_mask

TO_REMOVE = 1.0  # the reference's box-width convention


@functools.lru_cache(maxsize=8)
def _anchors(fh: int, fw: int, stride: int,
             sizes=(32, 64, 128, 256, 512),
             ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """[fh*fw*A, 4] xyxy anchors centred on each cell, cells row-major."""
    base = []
    for s in sizes:
        for r in ratios:
            w = s * np.sqrt(1.0 / r)
            h = s * np.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)                    # [A, 4]
    cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
    cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
    shifts = np.stack(np.broadcast_arrays(
        cx[None, :, None], cy[:, None, None]), -1).reshape(-1, 1, 2)
    ctr = np.concatenate([shifts, shifts], -1)             # [fh*fw, 1, 4]
    return (ctr + base[None]).reshape(-1, 4)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis; ties keep the lower index first."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def cam_to_proposals(atten: torch.Tensor, image_sizes: torch.Tensor,
                     stride: int, out_p: int = 512, pre_nms: int = 2048,
                     nms_thresh: float = 0.7, min_size: float = 20.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """atten [B, fh, fw] (the mean attention logit), image_sizes [B, 2]
    (h, w) -> (boxes [B, out_p, 4], mask [B, out_p], objectness [B, out_p],
    0 where masked)."""
    b, fh, fw = atten.shape
    dev = atten.device
    anchors = torch.from_numpy(_anchors(fh, fw, stride)).to(dev)   # [N, 4]
    n = anchors.shape[0]

    hw = image_sizes.to(torch.float32)
    zero = torch.zeros((), device=dev)

    def clip(col, hi):
        return torch.minimum(torch.maximum(anchors[None, :, col], zero), hi)

    x1, x2 = clip(0, hw[:, 1:2] - 1), clip(2, hw[:, 1:2] - 1)
    y1, y2 = clip(1, hw[:, 0:1] - 1), clip(3, hw[:, 0:1] - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1)                      # [B, N, 4]
    valid = (((x2 - x1 + TO_REMOVE) >= min_size)
             & ((y2 - y1 + TO_REMOVE) >= min_size))

    # the exact box mean of atten over each anchor's cells
    ii = F.pad(atten.to(torch.float32).cumsum(1).cumsum(2), (1, 0, 1, 0))
    cx1 = torch.clamp(torch.floor(x1 / stride), 0, fw - 1).long()
    cy1 = torch.clamp(torch.floor(y1 / stride), 0, fh - 1).long()
    cx2 = torch.minimum(torch.maximum(torch.ceil((x2 + 1) / stride).long(),
                                      cx1 + 1), torch.tensor(fw, device=dev))
    cy2 = torch.minimum(torch.maximum(torch.ceil((y2 + 1) / stride).long(),
                                      cy1 + 1), torch.tensor(fh, device=dev))
    flat = ii.reshape(b, -1)

    def at(yy, xx):
        return torch.gather(flat, 1, yy * (fw + 1) + xx)

    total = at(cy2, cx2) - at(cy1, cx2) - at(cy2, cx1) + at(cy1, cx1)
    area = ((cy2 - cy1) * (cx2 - cx1)).to(torch.float32)
    obj = torch.sigmoid(total / area.clamp(min=1.0))
    obj = torch.where(valid, obj, -1.0)

    # pre-NMS top-k, masked greedy NMS, then the top out_p survivors
    k = min(pre_nms, n)
    top_obj, top_idx = _top_k(obj, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
    keep = batched_nms_mask(top_boxes, top_obj, top_obj > 0, nms_thresh)
    out_score, sel = _top_k(torch.where(keep, top_obj, -1.0), min(out_p, k))
    out_boxes = torch.gather(top_boxes, 1,
                             sel[..., None].expand(*sel.shape, 4))
    out_mask = out_score > 0
    if out_p > k:
        pad = out_p - k
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_score = F.pad(out_score, (0, pad), value=-1.0)
        out_mask = torch.cat([out_mask, out_mask.new_zeros((b, pad))], 1)
    return out_boxes, out_mask, torch.where(out_mask, out_score, 0.0)
