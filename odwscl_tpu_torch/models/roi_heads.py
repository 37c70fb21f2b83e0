"""The supervised box, mask and keypoint heads over pooled rois.

Counterpart of ``odwscl_tpu/models/roi_heads.py`` (``FastRCNNPredictor``,
``CombinedROIHeads``). The caller owns the backbone and the pooler; the
heads take pooled features [B, P, r, r, C] and the padded GT.

Eval gives the softmax scores [B, P, C] and the per-class decoded boxes
[B, P, 4C] (not clipped, as in the JAX package); the engine runs the NMS,
and the mask and keypoint heads then run on the kept detections
(``mask_probs``, ``kp_heatmaps``). Training gives the reference's loss
names ``loss_classifier``, ``loss_box_reg`` and, with masks, ``loss_mask``,
with keypoints ``loss_kp``: each roi's matched GT keypoints projected
into its heatmap, counted where the box sampler drew the roi as a
positive.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

# the module, not its names: it imports models.matcher, which may run
# this file first
from ..losses import fast_rcnn
from ..structures.boxes import decode_boxes, masked_iou
from ..structures.keypoints import keypoints_to_heatmap
from .keypoint_head import KeypointHead, keypoint_rcnn_loss
from .mask_head import MaskHead, mask_head_targets, mask_rcnn_loss
from .matcher import match_proposals
from .vgg16 import VGGRoINeck


class FastRCNNPredictor(nn.Module):
    """``cls_score`` (std 0.01) and ``bbox_pred`` (std 0.001, 4 per class
    or 8 class-agnostic) linears, f32 outputs."""

    def __init__(self, in_dim: int, num_classes: int,
                 cls_agnostic: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cls_score = nn.Linear(in_dim, num_classes)
        self.bbox_pred = nn.Linear(in_dim, 8 if cls_agnostic
                                   else 4 * num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc, std in ((self.cls_score, 0.01), (self.bbox_pred, 0.001)):
            fc.weight.normal_(0.0, std, generator=generator)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        dt = self.compute_dtype
        x = x.to(dt)
        return tuple(nn.functional.linear(x, fc.weight.to(dt),
                                          fc.bias.to(dt)).to(torch.float32)
                     for fc in (self.cls_score, self.bbox_pred))


class CombinedROIHeads(nn.Module):
    """The neck (``VGGRoINeck``, ``ResNetRoINeck`` or ``FPN2MLPExtractor``),
    the box predictor ``box``, with ``mask_on`` the mask head ``mask`` and
    with ``keypoint_on`` the keypoint head ``keypoint``."""

    def __init__(self, num_classes: int, neck: nn.Module, neck_dim: int,
                 pooled_channels: int, mask_on: bool = False,
                 keypoint_on: bool = False, num_keypoints: int = 17,
                 mask_resolution: int = 14,
                 mask_conv_layers: Sequence[int] = (256, 256, 256, 256),
                 mask_dilation: int = 1, mask_raster_stride: float = 1.0,
                 fg_iou: float = 0.5, bg_iou: float = 0.5,
                 batch_size_per_image: int = 512,
                 positive_fraction: float = 0.25, cls_agnostic: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.mask_on = mask_on
        self.keypoint_on = keypoint_on
        self.mask_resolution = mask_resolution
        self.mask_raster_stride = mask_raster_stride
        self.fg_iou, self.bg_iou = fg_iou, bg_iou
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.cls_agnostic = cls_agnostic
        self.neck = neck
        self.box = FastRCNNPredictor(neck_dim, num_classes, cls_agnostic,
                                     compute_dtype)
        self.mask = (MaskHead(pooled_channels, num_classes, mask_conv_layers,
                              mask_dilation, compute_dtype)
                     if mask_on else None)
        self.keypoint = (KeypointHead(pooled_channels, num_keypoints,
                                      compute_dtype=compute_dtype)
                         if keypoint_on else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.neck, self.box, self.mask, self.keypoint):
            if m is not None:
                m.reset_parameters(generator)

    def mask_probs(self, pooled_flat: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """The detections' mask pass: pooled [N, r, r, C], labels [N] ->
        sigmoid of each label's channel [N, M, M]."""
        mlog = self.mask(pooled_flat)
        n = mlog.shape[0]
        return torch.sigmoid(mlog[torch.arange(n, device=mlog.device), :, :,
                                  labels.clamp(min=0)])

    def kp_heatmaps(self, pooled_flat: torch.Tensor) -> torch.Tensor:
        """The detections' keypoint pass: pooled [N, r, r, C] -> logits
        [N, H, H, K] (decoded by ``keypoint_head.heatmaps_to_keypoints``)."""
        return self.keypoint(pooled_flat)

    def _neck(self, flat: torch.Tensor, generator, train: bool):
        keep = None
        if train and isinstance(self.neck, VGGRoINeck):
            keep = self.neck.draw_keep(flat.shape[0], generator, flat.device)
        return self.neck(flat, keep)

    def forward_eval(self, pooled: torch.Tensor, boxes: torch.Tensor,
                     include_aux: bool = False) -> Dict[str, torch.Tensor]:
        """{"scores" [B, P, C], "boxes" [B, P, 4C]}: the box pass (the
        mask and keypoint heads run on the kept detections, ``mask_probs``
        and ``kp_heatmaps``). ``include_aux`` adds every roi's
        "mask_logits" [B, P, M, M, C] and "kp_logits" [B, P, H, H, K] of
        the heads that are on."""
        b, p = pooled.shape[:2]
        flat = pooled.reshape(b * p, *pooled.shape[2:])
        cls, reg = self.box(self._neck(flat, None, False).reshape(b, p, -1))
        if self.cls_agnostic:
            reg = reg[..., 4:].repeat(1, 1, self.num_classes)
        out = {"scores": torch.softmax(cls, dim=-1),
               "boxes": decode_boxes(reg, boxes)}
        if include_aux:
            for key, head in (("mask_logits", self.mask),
                              ("kp_logits", self.keypoint)):
                if head is not None:
                    aux = head(flat)
                    out[key] = aux.reshape(b, p, *aux.shape[1:])
        return out

    def forward_train(self, pooled: torch.Tensor, boxes: torch.Tensor,
                      box_mask: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                      gt_bitmasks: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      uniform: Optional[torch.Tensor] = None,
                      gt_keypoints: Optional[torch.Tensor] = None):
        """(losses, metrics). ``uniform`` [B, 2, P]: the sampler's draw
        (else from ``generator``). ``gt_keypoints`` [B, G, K, 3]: the
        keypoint head's GT."""
        b, p = pooled.shape[:2]
        flat = pooled.reshape(b * p, *pooled.shape[2:])
        cls, reg = self.box(self._neck(flat, generator, True).reshape(b, p,
                                                                      -1))
        tgt = fast_rcnn.prepare_fast_rcnn_targets(
            boxes, box_mask, gt_boxes, gt_labels, gt_mask, self.fg_iou,
            self.bg_iou, self.batch_size_per_image, self.positive_fraction,
            generator=generator, uniform=uniform)
        cls_loss, box_loss, acc = fast_rcnn.fast_rcnn_loss(
            cls, reg, tgt, self.cls_agnostic)
        losses = {"loss_classifier": cls_loss, "loss_box_reg": box_loss}
        metrics = {"accuracy_cls": acc}
        if self.mask_on:
            if gt_bitmasks is None:
                raise ValueError("mask training needs the batch's GT "
                                 "bitmasks (the collator rasterizes them "
                                 "when the dataset loads masks)")
            m = self.mask_resolution
            mlog = self.mask(flat)                      # [B*P, M, M, C]
            if mlog.shape[1] != m:
                raise ValueError(f"mask logits {mlog.shape[1]} != "
                                 f"RESOLUTION {m}: the resolution must be "
                                 "twice the pooler's")
            parts = [mask_head_targets(
                boxes[i], box_mask[i], gt_boxes[i], gt_labels[i], gt_mask[i],
                gt_bitmasks[i], m, self.fg_iou, self.bg_iou,
                self.mask_raster_stride) for i in range(b)]
            labels, targets, pos = (torch.cat(t) for t in zip(*parts))
            losses["loss_mask"] = mask_rcnn_loss(mlog, labels, targets, pos)
        if self.keypoint_on:
            if gt_keypoints is None:
                raise ValueError("keypoint training needs the batch's GT "
                                 "keypoints (the dataset's load_keypoints)")
            kp_log = self.keypoint(flat)                # [B*P, H, H, K]
            hms, valids = [], []
            for i in range(b):
                # each roi's matched GT keypoints, projected into its
                # heatmap; only the sampler's positives count
                iou = masked_iou(gt_boxes[i], gt_mask[i], boxes[i],
                                 box_mask[i])
                matched = match_proposals(iou, gt_mask[i], self.fg_iou,
                                          self.bg_iou)
                kp_roi = gt_keypoints[i][matched.clamp(min=0)]
                hm, valid = keypoints_to_heatmap(kp_roi, boxes[i],
                                                 kp_log.shape[1])
                fg = (matched >= 0) & box_mask[i] & tgt.pos_mask[i]
                hms.append(hm)
                valids.append(valid * fg.to(valid.dtype)[:, None])
            losses["loss_kp"] = keypoint_rcnn_loss(kp_log, torch.cat(hms),
                                                   torch.cat(valids))
        return losses, metrics
