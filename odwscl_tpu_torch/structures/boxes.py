"""Box geometry on padded ``[..., P, 4]`` xyxy tensors.

Counterpart of ``odwscl_tpu/structures/boxes.py``: the Detectron "+1" pixel
convention (width = x2 - x1 + 1) everywhere, so box coding and IoU match the
reference bit-for-bit up to float rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

TO_REMOVE = 1.0  # Detectron pixel convention: width = x2 - x1 + 1
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area with the +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, +1 convention. [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def box_iou_async(boxes1: torch.Tensor, boxes2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise intersection over the area of ``boxes1`` (+1 convention).
    [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + 1e-10)


def masked_iou(boxes1: torch.Tensor, mask1: torch.Tensor,
               boxes2: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """``box_iou`` with the pairs of an invalid box zeroed."""
    valid = mask1[..., :, None] & mask2[..., None, :]
    return torch.where(valid, box_iou(boxes1, boxes2), 0.0)


def clip_to_image(boxes: torch.Tensor, image_size_hw: torch.Tensor
                  ) -> torch.Tensor:
    """Clip xyxy boxes to [0, size-1]; ``image_size_hw`` broadcasts against
    the boxes' batch dims (shape ``boxes.shape[:-1] + (2,)`` or a prefix)."""
    h = image_size_hw[..., 0]
    w = image_size_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w - TO_REMOVE)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h - TO_REMOVE)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w - TO_REMOVE)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def flip_boxes_horizontal(boxes: torch.Tensor, image_width) -> torch.Tensor:
    """Horizontal flip: new_x1 = W - 1 - x2, new_x2 = W - 1 - x1."""
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    return torch.stack([image_width - TO_REMOVE - x2, y1,
                        image_width - TO_REMOVE - x1, y2], dim=-1)


def resize_boxes(boxes: torch.Tensor, ratio_w, ratio_h) -> torch.Tensor:
    """Scale boxes by independent x/y ratios."""
    return torch.stack([boxes[..., 0] * ratio_w, boxes[..., 1] * ratio_h,
                        boxes[..., 2] * ratio_w, boxes[..., 3] * ratio_h],
                       dim=-1)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                               5.0, 5.0)
                 ) -> torch.Tensor:
    """(dx, dy, dw, dh) regression targets of ``reference_boxes`` relative to
    ``proposals``, both [..., 4] xyxy."""
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    wx, wy, ww, wh = weights
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                               5.0, 5.0)
                 ) -> torch.Tensor:
    """rel_codes [..., P, 4*K], boxes [..., P, 4] -> [..., P, 4*K]; the
    x2/y2 '-1' asymmetry follows the reference box coder."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    shape = rel_codes.shape
    codes = rel_codes.reshape(*shape[:-1], -1, 4)  # [..., P, K, 4]
    wx, wy, ww, wh = weights
    dx = codes[..., 0] / wx
    dy = codes[..., 1] / wy
    dw = (codes[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (codes[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack([
        pred_cx - 0.5 * pred_w,
        pred_cy - 0.5 * pred_h,
        pred_cx + 0.5 * pred_w - 1.0,
        pred_cy + 0.5 * pred_h - 1.0,
    ], dim=-1)
    return out.reshape(shape)
