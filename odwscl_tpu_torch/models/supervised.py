"""The fully supervised detector: backbone -> pool -> CombinedROIHeads.

Counterpart of ``odwscl_tpu/models/supervised.py`` (``FPN2MLPExtractor``,
``SupervisedRCNN``, ``supervised_from_cfg``): Fast, Mask and Keypoint
R-CNN over the batch's precomputed proposals (``MODEL.WSOD_ON False``),
on a VGG16, R-*-C4/C5, R-*-FPN or FBNet body (``FBNet-<arch>``, "default"
when no arch follows: one stride-16 feature, pooled at
``POOLER_SCALES[0]``, with the FPN's MLP neck).

Pooling: ``POOLER_METHOD`` ROIPool (7x7) goes through
``RoIPoolFunction``, so on the card every call is the hand-written kernel
(the training forward with its argmax when a gradient is needed, and its
backward); ROIAlign is plain torch (``ops/roi_align.py``). An FPN body
pools P2-P5 with ``multilevel_roi_pool``: four calls, one per level, each
at that level's scale with the other levels' rois masked.

``eval_forward`` returns the box pass ({"scores", "boxes"}) and the
pyramid under "features"; the engine runs the NMS and then
``predict_masks`` on the kept detections, with those features (four more
pooling calls on an FPN body); ``predict_kp_heatmaps`` is the keypoint
head's pass on them, alike.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import roi_align
from ..ops.roi_pool import RoIPoolFunction
from .fbnet import FBNetTrunk
from .fpn import ResNetFPNBackbone, kaiming_uniform_a1, multilevel_roi_pool
from .resnet import ResNetBackbone, ResNetRoINeck
from .roi_heads import CombinedROIHeads
from .vgg16 import VGGBackbone, VGGRoINeck

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FPN_SCALES = (0.25, 0.125, 0.0625, 0.03125)      # P2..P5


class FPN2MLPExtractor(nn.Module):
    """Pooled [N, r, r, C] flattened in (h, w, c) order -> fc6 -> ReLU ->
    fc7 -> ReLU (``out_dim`` wide), kaiming-uniform(a=1) init. No
    dropout; ``keep`` is accepted for the neck protocol."""

    def __init__(self, in_dim: int, out_dim: int = 1024,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc6 = nn.Linear(in_dim, out_dim)
        self.fc7 = nn.Linear(out_dim, out_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        kaiming_uniform_a1(self.fc6, generator)
        kaiming_uniform_a1(self.fc7, generator)

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        for fc in (self.fc6, self.fc7):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        return x


class SupervisedRCNN(nn.Module):
    """Constructor fields mirror the JAX module's (``supervised_from_cfg``
    maps the config keys). ``freeze_at`` (``FREEZE_CONV_BODY_AT``) reaches
    the VGG16 and C4/C5 bodies as in the WSOD detector; the FPN and FBNet
    bodies keep only their norms frozen, as the JAX package's labels do."""

    def __init__(self, num_classes: int = 81, backbone_arch: str = "R-50-FPN",
                 mask_on: bool = False, keypoint_on: bool = False,
                 num_keypoints: int = 17, mask_resolution: int = 14,
                 mask_conv_layers: Sequence[int] = (256, 256, 256, 256),
                 mask_dilation: int = 1, pooler_method: str = "ROIPool",
                 pooler_resolution: int = 7, pooler_scale: float = 0.0625,
                 pooler_sampling: int = 2, mlp_dim: int = 1024,
                 fg_iou: float = 0.5, bg_iou: float = 0.5,
                 roi_batch_size: int = 512, roi_pos_fraction: float = 0.25,
                 cls_agnostic_bbox_reg: bool = False,
                 mask_raster_stride: float = 4.0, freeze_at: int = 0,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        if pooler_method not in ("ROIPool", "ROIAlign"):
            raise ValueError(f"unknown POOLER_METHOD {pooler_method!r}")
        if pooler_method == "ROIPool" and pooler_resolution != 7:
            raise NotImplementedError(
                "ROIPool is ported at 7x7, the kernel's resolution; use "
                "ROIAlign for another POOLER_RESOLUTION")
        dtype = _DTYPES[compute_dtype]
        self.num_classes = num_classes
        self.mask_on = mask_on
        self.keypoint_on = keypoint_on
        self.pooler_method = pooler_method
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.pooler_sampling = pooler_sampling
        arch = backbone_arch
        self.is_fpn = arch.endswith("-FPN")
        r2 = pooler_resolution ** 2
        if arch.startswith("VGG16"):
            self.backbone = VGGBackbone(arch, dtype, freeze_at)
            channels = 512
            neck = VGGRoINeck(channels * r2, mlp_dim, dtype)
        elif self.is_fpn and arch.startswith("R-"):
            depth = "-".join(arch.split("-")[:2])
            self.backbone = ResNetFPNBackbone(depth, 256, dtype)
            channels = 256
            neck = FPN2MLPExtractor(channels * r2, mlp_dim, dtype)
        elif arch.startswith("R-") and arch[-2:] in ("C4", "C5"):
            depth = "-".join(arch.split("-")[:2])
            self.backbone = ResNetBackbone(depth, 5 if arch.endswith("C5")
                                           else 4, dtype, freeze_at)
            channels = self.backbone.out_channels
            neck = ResNetRoINeck(channels * r2, 2048, mlp_dim, dtype)
        elif arch.startswith("FBNet"):
            name = arch.split("-", 1)[1] if "-" in arch else "default"
            self.backbone = FBNetTrunk(name, compute_dtype=dtype)
            channels = self.backbone.out_channels
            neck = FPN2MLPExtractor(channels * r2, mlp_dim, dtype)
        else:
            raise ValueError(f"unknown backbone {arch!r}")
        self.roi_heads = CombinedROIHeads(
            num_classes, neck, mlp_dim, channels, mask_on=mask_on,
            keypoint_on=keypoint_on, num_keypoints=num_keypoints,
            mask_resolution=mask_resolution,
            mask_conv_layers=tuple(mask_conv_layers),
            mask_dilation=mask_dilation,
            mask_raster_stride=mask_raster_stride, fg_iou=fg_iou,
            bg_iou=bg_iou, batch_size_per_image=roi_batch_size,
            positive_fraction=roi_pos_fraction,
            cls_agnostic=cls_agnostic_bbox_reg, compute_dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.roi_heads.reset_parameters(generator)

    def pool(self, feats: torch.Tensor, boxes: torch.Tensor,
             mask: torch.Tensor, scale: float,
             level: Optional[str] = None) -> torch.Tensor:
        """One level: the ROIPool kernel (plain version on the CPU) or
        plain ROIAlign -> [B, P, r, r, C], masked rois 0."""
        if self.pooler_method == "ROIPool":
            return RoIPoolFunction.apply(feats, boxes, mask, scale, level)
        return roi_align(feats, boxes, mask, scale, self.pooler_resolution,
                         self.pooler_sampling)

    def pooled(self, feats, boxes: torch.Tensor,
               box_mask: torch.Tensor) -> torch.Tensor:
        if self.is_fpn:
            return multilevel_roi_pool(self.pool, feats[:4], FPN_SCALES,
                                       boxes, box_mask)
        return self.pool(feats, boxes, box_mask, self.pooler_scale)

    @torch.no_grad()
    def eval_forward(self, batch) -> Dict[str, torch.Tensor]:
        """The box pass: {"scores" [B, P, C], "boxes" [B, P, 4C],
        "features"}."""
        feats = self.backbone(batch.images)
        out = self.roi_heads.forward_eval(
            self.pooled(feats, batch.boxes, batch.box_mask), batch.boxes)
        out["features"] = feats
        return out

    def _pooled_detections(self, batch, det_boxes: torch.Tensor, features):
        """[B * K, r, r, C] pooled at the detections det_boxes [B, K, 4]
        (``features``: the eval pass's, else recomputed)."""
        b, k = det_boxes.shape[:2]
        feats = self.backbone(batch.images) if features is None else features
        dmask = torch.ones((b, k), dtype=torch.bool, device=det_boxes.device)
        pooled = self.pooled(feats, det_boxes.contiguous(), dmask)
        return pooled.reshape(b * k, *pooled.shape[2:])

    @torch.no_grad()
    def predict_masks(self, batch, det_boxes: torch.Tensor,
                      det_labels: torch.Tensor, features=None
                      ) -> torch.Tensor:
        """The detections' mask pass: det_boxes [B, K, 4] (the batch's
        frame), det_labels [B, K] -> probabilities [B, K, M, M]."""
        b, k = det_boxes.shape[:2]
        probs = self.roi_heads.mask_probs(
            self._pooled_detections(batch, det_boxes, features),
            det_labels.reshape(-1))
        return probs.reshape(b, k, *probs.shape[1:])

    @torch.no_grad()
    def predict_kp_heatmaps(self, batch, det_boxes: torch.Tensor,
                            features=None) -> torch.Tensor:
        """The detections' keypoint pass: det_boxes [B, K, 4] (the batch's
        frame) -> logits [B, K, H, H, Knum] (decoded by
        ``keypoint_head.heatmaps_to_keypoints``)."""
        b, k = det_boxes.shape[:2]
        hm = self.roi_heads.kp_heatmaps(
            self._pooled_detections(batch, det_boxes, features))
        return hm.reshape(b, k, *hm.shape[1:])

    def train_forward(self, batch, generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      trace=None):
        """(losses, metrics). ``draws`` may hand in the sampler's uniforms
        ``fast_rcnn`` [B, 2, P] (else drawn from ``generator``, which also
        draws the VGG16 neck's dropout); the mask and keypoint losses count
        the rois that draw samples as positives."""
        if batch.gt_boxes is None:
            raise ValueError("supervised training needs the batch's GT "
                             "(the collator's include_gt, WSOD_ON False)")
        draws = draws or {}
        pooled = self.pooled(self.backbone(batch.images), batch.boxes,
                             batch.box_mask)
        return self.roi_heads.forward_train(
            pooled, batch.boxes, batch.box_mask, batch.gt_boxes,
            batch.gt_labels, batch.gt_mask, batch.gt_bitmasks, generator,
            draws.get("fast_rcnn"), batch.gt_keypoints)


def supervised_from_cfg(cfg) -> SupervisedRCNN:
    mask_res = cfg.MODEL.ROI_MASK_HEAD.RESOLUTION
    pool_res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    if cfg.MODEL.MASK_ON and mask_res != 2 * pool_res:
        raise ValueError(
            f"ROI_MASK_HEAD.RESOLUTION={mask_res} must equal 2x "
            f"ROI_BOX_HEAD.POOLER_RESOLUTION={pool_res} (the mask head "
            "shares the box pooler; its deconv doubles the side)")
    return SupervisedRCNN(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        backbone_arch=cfg.MODEL.BACKBONE.CONV_BODY,
        mask_on=cfg.MODEL.MASK_ON, keypoint_on=cfg.MODEL.KEYPOINT_ON,
        num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES,
        mask_resolution=mask_res,
        mask_conv_layers=tuple(cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS),
        mask_dilation=cfg.MODEL.ROI_MASK_HEAD.DILATION,
        pooler_method=cfg.MODEL.ROI_BOX_HEAD.POOLER_METHOD,
        pooler_resolution=pool_res,
        pooler_scale=cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
        pooler_sampling=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        mlp_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
        fg_iou=cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD,
        bg_iou=cfg.MODEL.ROI_HEADS.BG_IOU_THRESHOLD,
        roi_batch_size=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_pos_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        cls_agnostic_bbox_reg=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
        mask_raster_stride=float(cfg.TPU.MASK_RASTER_STRIDE),
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE)
