"""Mask R-CNN's mask head: conv tower, deconv predictor, targets, loss and
the Masker.

Counterpart of ``odwscl_tpu/models/mask_head.py``: ``MaskFeatureExtractor``
(N 3x3 conv + ReLU), ``MaskPredictor`` (a 2x2 stride-2 transposed conv,
ReLU, a 1x1 per-class conv), ``MaskConv1x1Predictor``, ``MaskHead``,
``crop_resize_bitmasks``, ``mask_rcnn_loss``, ``mask_head_targets``,
``select_class_masks``, ``paste_mask_in_image`` and ``Masker``.

The head maps pooled rois [N, r, r, C] (NHWC) to logits [N, 2r, 2r,
classes]. Mask targets are bilinear crops (align_corners False, edge
clamp) of the collator's GT rasters, gathered on the device.

The Masker pastes on the host. The JAX package resizes each mask with
``cv2.resize(INTER_LINEAR)``; the port resizes with
``F.interpolate(bilinear, align_corners=False)`` in f32 (half-pixel
centres, edge clamp, no antialias: the same rule), so a pasted pixel may
differ only where the resized probability lies within float drift of the
threshold.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..structures.boxes import masked_iou
from ..structures.masks import resize_bilinear
from .fpn import conv_nchw
from .matcher import match_proposals


@torch.no_grad()
def kaiming_normal_fan_out(m: nn.Module, generator: torch.Generator,
                           fan_out: int) -> None:
    """flax ``variance_scaling(2, fan_out, truncated_normal)``: a normal of
    std sqrt(2 / fan_out) / 0.8796 truncated at two std; bias 0."""
    std = (2.0 / fan_out) ** 0.5 / 0.87962566103423978
    w = torch.randn(m.weight.shape, generator=generator)
    while True:
        bad = w.abs() > 2.0
        if not bad.any():
            break
        w[bad] = torch.randn(int(bad.sum()), generator=generator)
    m.weight.copy_(w * std)
    m.bias.zero_()


class MaskFeatureExtractor(nn.Module):
    """``mask_fcn{i}``: 3x3 convs (dilation ``dilation``) + ReLU, on the
    NCHW view."""

    def __init__(self, in_channels: int,
                 conv_layers: Sequence[int] = (256, 256, 256, 256),
                 dilation: int = 1):
        super().__init__()
        self.n = len(conv_layers)
        cin = in_channels
        for i, ch in enumerate(conv_layers, 1):
            setattr(self, f"mask_fcn{i}", nn.Conv2d(
                cin, ch, 3, padding=dilation, dilation=dilation))
            cin = ch

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(1, self.n + 1):
            m = getattr(self, f"mask_fcn{i}")
            kaiming_normal_fan_out(m, generator, m.out_channels * 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = F.relu(conv_nchw(getattr(self, f"mask_fcn{i}"), x))
        return x


class MaskPredictor(nn.Module):
    """``conv5_mask`` (2x2 stride-2 transposed conv) + ReLU +
    ``mask_fcn_logits`` (1x1): NCHW [N, D, r, r] -> [N, classes, 2r, 2r]
    f32. The transposed conv's weight is [in, out, 2, 2]; flax's kernel
    [2, 2, in, out] is its spatial flip (utils/from_jax.py)."""

    def __init__(self, in_channels: int, num_classes: int,
                 dim_reduced: int = 256):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, dim_reduced, 2,
                                             stride=2)
        self.mask_fcn_logits = nn.Conv2d(dim_reduced, num_classes, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        kaiming_normal_fan_out(self.conv5_mask, generator,
                               self.conv5_mask.out_channels * 4)
        kaiming_normal_fan_out(self.mask_fcn_logits, generator,
                               self.mask_fcn_logits.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv5_mask
        x = F.relu(F.conv_transpose2d(x, c.weight.to(x.dtype),
                                      c.bias.to(x.dtype), stride=2))
        return conv_nchw(self.mask_fcn_logits, x).to(torch.float32)


class MaskConv1x1Predictor(nn.Module):
    """``mask_fcn_logits`` (1x1) at the input resolution."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.mask_fcn_logits = nn.Conv2d(in_channels, num_classes, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        kaiming_normal_fan_out(self.mask_fcn_logits, generator,
                               self.mask_fcn_logits.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nchw(self.mask_fcn_logits, x).to(torch.float32)


class MaskHead(nn.Module):
    """extractor + predictor: pooled [N, r, r, C] -> logits [N, 2r, 2r,
    num_classes] (an NHWC view), f32."""

    def __init__(self, in_channels: int, num_classes: int,
                 conv_layers: Sequence[int] = (256, 256, 256, 256),
                 dilation: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.extractor = MaskFeatureExtractor(in_channels, conv_layers,
                                              dilation)
        self.predictor = MaskPredictor(conv_layers[-1], num_classes,
                                       conv_layers[-1])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.extractor.reset_parameters(generator)
        self.predictor.reset_parameters(generator)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.to(self.compute_dtype).permute(0, 3, 1, 2)
        return self.predictor(self.extractor(x)).permute(0, 2, 3, 1)


def crop_resize_bitmasks(bitmasks: torch.Tensor, gt_idx: torch.Tensor,
                         boxes: torch.Tensor, m: int) -> torch.Tensor:
    """bitmasks [G, H, W] f32, gt_idx [N] (each roi's instance), boxes
    [N, 4] xyxy in the raster's frame -> [N, m, m] in [0, 1]: cell (i, j)
    samples y = y1 + (i + .5) (y2 - y1) / m - .5 (x alike) bilinearly with
    the edges clamped, the box first clamped into the raster (at least one
    pixel wide)."""
    h, w = bitmasks.shape[1], bitmasks.shape[2]
    x1 = boxes[:, 0].clamp(0, w - 1)
    y1 = boxes[:, 1].clamp(0, h - 1)
    x2 = torch.maximum(boxes[:, 2].clamp(0, w), x1 + 1)
    y2 = torch.maximum(boxes[:, 3].clamp(0, h), y1 + 1)
    k = torch.arange(m, dtype=torch.float32, device=boxes.device)
    ys = y1[:, None] + (k + 0.5) * (y2 - y1)[:, None] / m - 0.5
    xs = x1[:, None] + (k + 0.5) * (x2 - x1)[:, None] / m - 0.5
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    fy = (ys - y0).clamp(0.0, 1.0)[:, :, None]
    fx = (xs - x0).clamp(0.0, 1.0)[:, None, :]
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    g = gt_idx.clamp(min=0)[:, None, None]

    def at(yi, xi):
        return bitmasks[g, yi[:, :, None], xi[:, None, :]]

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x1i) * fx
    bot = at(y1i, x0i) * (1 - fx) + at(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def mask_rcnn_loss(mask_logits: torch.Tensor, labels: torch.Tensor,
                   mask_targets: torch.Tensor,
                   pos_weights: torch.Tensor) -> torch.Tensor:
    """BCE with logits at each roi's label channel, averaged over the
    positives' pixels (0 without positives). mask_logits [N, M, M, C] f32,
    labels [N], targets [N, M, M], pos_weights [N] in {0, 1}."""
    n = mask_logits.shape[0]
    lg = mask_logits[torch.arange(n, device=labels.device), :, :,
                     labels.clamp(min=0)]
    # the JAX package's subgradients at a logit of exactly 0 (a pixel whose
    # features are all 0): jnp.maximum splits the tie (0.5, as
    # torch.maximum; clamp gives 1) and jnp.abs has slope 1 at 0 (the
    # where; torch's abs has 0), so the pixel's gradient is -t there
    per_pix = (torch.maximum(lg, torch.zeros_like(lg)) - lg * mask_targets
               + torch.log1p(torch.exp(-torch.where(lg >= 0, lg, -lg))))
    per_roi = per_pix.sum(dim=(1, 2))
    denom = torch.clamp(pos_weights.sum() * lg.shape[1] * lg.shape[2],
                        min=1.0)
    return (per_roi * pos_weights).sum() / denom


def mask_head_targets(proposals: torch.Tensor, prop_mask: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                      gt_mask: torch.Tensor, gt_bitmasks: torch.Tensor,
                      m: int, fg_iou: float, bg_iou: float,
                      raster_stride: float = 1.0):
    """One image: proposals [P, 4] + mask [P]; gt [G, ...], rasters
    gt_bitmasks [G, H, W] at 1/raster_stride of the canvas -> (labels [P],
    targets [P, m, m], pos_weights [P]). Matching uses the image-frame
    boxes, the crop the raster frame."""
    iou = masked_iou(gt_boxes, gt_mask, proposals, prop_mask)   # [G, P]
    matched = match_proposals(iou, gt_mask, fg_iou, bg_iou)
    safe = matched.clamp(min=0)
    labels = torch.where(matched >= 0, gt_labels.long()[safe], 0)
    labels = torch.where(prop_mask, labels, 0)
    pos = (labels > 0) & prop_mask
    targets = crop_resize_bitmasks(gt_bitmasks, safe,
                                   proposals / raster_stride, m)
    targets = torch.where(pos[:, None, None], targets, 0.0)
    return labels, targets, pos.to(torch.float32)


def select_class_masks(mask_probs: np.ndarray,
                       labels: np.ndarray) -> np.ndarray:
    """Each roi's predicted-class channel: [N, M, M, C], [N] -> [N, M,
    M]."""
    return mask_probs[np.arange(mask_probs.shape[0]), :, :, labels]


def _expand_box(box: np.ndarray, scale: float) -> np.ndarray:
    wh = (box[2:] - box[:2]) * 0.5
    c = (box[2:] + box[:2]) * 0.5
    return np.concatenate([c - wh * scale, c + wh * scale])


def paste_mask_in_image(mask: np.ndarray, box: np.ndarray, im_h: int,
                        im_w: int, thresh: float = 0.5,
                        padding: int = 1) -> np.ndarray:
    """mask [M, M] probabilities, box xyxy -> bool [im_h, im_w]: the mask,
    padded by ``padding`` zeros and its box expanded to match, resized to
    the box (+1 convention, integer corners) and thresholded."""
    mm = mask.shape[-1]
    padded = np.zeros((mm + 2 * padding, mm + 2 * padding), np.float32)
    padded[padding:padding + mm, padding:padding + mm] = mask
    scale = float(mm + 2 * padding) / mm
    box = _expand_box(np.asarray(box, np.float32), scale).astype(np.int32)
    w = max(int(box[2] - box[0] + 1), 1)
    h = max(int(box[3] - box[1] + 1), 1)
    bin_mask = resize_bilinear(padded, w, h) > thresh
    im_mask = np.zeros((im_h, im_w), bool)
    x0, x1 = max(box[0], 0), min(box[2] + 1, im_w)
    y0, y1 = max(box[1], 0), min(box[3] + 1, im_h)
    if x1 > x0 and y1 > y0:
        im_mask[y0:y1, x0:x1] = bin_mask[y0 - box[1]:y1 - box[1],
                                         x0 - box[0]:x1 - box[0]]
    return im_mask


class Masker:
    """Per-roi mask probabilities -> full-image binary masks."""

    def __init__(self, threshold: float = 0.5, padding: int = 1):
        self.threshold = threshold
        self.padding = padding

    def __call__(self, masks: np.ndarray, boxes: np.ndarray, im_h: int,
                 im_w: int) -> np.ndarray:
        """masks [N, M, M], boxes [N, 4] -> bool [N, im_h, im_w]."""
        if masks.shape[0] == 0:
            return np.zeros((0, im_h, im_w), bool)
        return np.stack([paste_mask_in_image(m, b, im_h, im_w,
                                             self.threshold, self.padding)
                         for m, b in zip(masks, boxes)])
