"""The WSOD detector, eval path: backbone -> RoI pool -> neck -> heads.

Counterpart of ``odwscl_tpu/models/detector.py`` (``Batch``,
``WSODDetector.pool`` / ``eval_forward``, ``detector_from_cfg``). The
training forward comes with the training slice.

Static padded layout as in the JAX package: images [B, H, W, 3] NHWC,
proposals [B, P, 4] with a [B, P] mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.roi_pool import roi_pool
from ..structures.boxes import clip_to_image, decode_boxes
from .predictors import MISTPredictor
from .sim_net import SimNet
from .vgg16 import VGGBackbone, VGGRoINeck

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Batch:
    """One padded eval batch (image-level fields)."""

    images: torch.Tensor       # [B, H, W, 3] normalized (BGR*255 - mean)
    image_sizes: torch.Tensor  # [B, 2] (h, w) before padding, f32
    boxes: torch.Tensor        # [B, P, 4] xyxy proposals, f32
    box_mask: torch.Tensor     # [B, P] bool
    labels: Optional[torch.Tensor] = None  # [B, C] image-level, col 0 = 0

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Batch":
        return Batch(**{f.name: (None if getattr(self, f.name) is None
                                 else getattr(self, f.name).to(device))
                        for f in dataclasses.fields(self)})


class WSODDetector(nn.Module):
    """The flagship model; constructor fields mirror the JAX module's."""

    def __init__(self, num_classes: int = 21,
                 backbone_arch: str = "VGG16-OICR",
                 predictor: str = "MISTPredictor", num_refs: int = 3,
                 pooler_method: str = "ROIPool", pooler_resolution: int = 7,
                 pooler_scale: float = 0.125, mlp_dim: int = 4096,
                 cls_agnostic_bbox_reg: bool = False, regress_on: bool = True,
                 regress_heur: str = "AVG",
                 reg_weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                                  5.0, 5.0),
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        if not backbone_arch.startswith("VGG16"):
            raise NotImplementedError(f"backbone {backbone_arch!r} is not "
                                      "ported yet (VGG16 only)")
        if predictor != "MISTPredictor":
            raise NotImplementedError(f"predictor {predictor!r} is not "
                                      "ported yet (MISTPredictor only)")
        if pooler_method != "ROIPool" or pooler_resolution != 7:
            raise NotImplementedError("only the 7x7 ROIPool pooler is ported")
        if regress_heur not in ("WSDDN", "CLS-AVG", "UNION", "AVG"):
            raise ValueError(f"unknown REGRESS_HEUR {regress_heur!r}")
        self.num_classes = num_classes
        self.pooler_scale = pooler_scale
        self.cls_agnostic_bbox_reg = cls_agnostic_bbox_reg
        self.regress_on = regress_on
        self.regress_heur = regress_heur
        self.reg_weights = tuple(reg_weights)
        dtype = _DTYPES[compute_dtype]
        self.compute_dtype = dtype
        self.backbone = VGGBackbone(backbone_arch, dtype)
        self.neck = VGGRoINeck(512 * pooler_resolution ** 2, mlp_dim, dtype)
        self.sim_net = SimNet(mlp_dim, compute_dtype=dtype)
        self.pred = MISTPredictor(mlp_dim, num_classes, num_refs,
                                  cls_agnostic_bbox_reg, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init with the JAX package's distributions."""
        for m in (self.backbone, self.neck, self.sim_net, self.pred):
            m.reset_parameters(generator)

    def pool(self, feats: torch.Tensor, boxes: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """7x7 ROIPool: the CUDA kernel for CUDA tensors, the plain version
        for CPU tensors (ops/roi_pool.py). Every map size is accepted."""
        return roi_pool(feats, boxes, mask, self.pooler_scale)

    @torch.no_grad()
    def eval_forward(self, batch: Batch):
        """(scores [B,P,C], boxes) per REGRESS_HEUR: AVG gives decoded
        per-class boxes [B,P,4C] clipped to the image; UNION gives one copy
        per refinement branch ([B,R*P,C], [B,R*P,4C]); WSDDN and CLS-AVG
        give the raw proposals [B,P,4]."""
        feats = self.backbone(batch.images)
        pooled = self.pool(feats, batch.boxes, batch.box_mask)
        b, p = pooled.shape[:2]
        clean = self.neck(pooled.reshape(b * p, -1)).reshape(b, p, -1)
        cls, det, refs, bbox = self.pred(clean, batch.box_mask)

        if self.regress_heur == "WSDDN":
            return cls * det, batch.boxes
        if self.regress_heur == "CLS-AVG" or not self.regress_on:
            return torch.stack(refs).mean(dim=0), batch.boxes
        if self.regress_heur == "UNION":
            scores = torch.cat(refs, dim=1)                   # [B, RP, C]
            deltas = torch.cat(bbox, dim=1).to(torch.float32)
            boxes = torch.cat([batch.boxes] * len(refs), dim=1)
        else:  # AVG, the default of every shipped config
            scores = torch.stack(refs).mean(dim=0)            # [B, P, C]
            deltas = torch.stack(bbox).mean(dim=0).to(torch.float32)
            boxes = batch.boxes
        if self.cls_agnostic_bbox_reg:
            deltas = deltas[..., -4:]
        dec = decode_boxes(deltas, boxes, self.reg_weights)
        rp = dec.shape[1]
        dec = dec.reshape(b, rp, -1, 4)
        dec = clip_to_image(dec, batch.image_sizes[:, None, None, :])
        if self.cls_agnostic_bbox_reg:
            dec = dec.expand(b, rp, self.num_classes, 4)
        return scores, dec.reshape(b, rp, -1)


def detector_from_cfg(cfg) -> WSODDetector:
    """Build the eval detector from a CfgNode."""
    return WSODDetector(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        backbone_arch=cfg.MODEL.BACKBONE.CONV_BODY,
        predictor=cfg.MODEL.ROI_WEAK_HEAD.PREDICTOR,
        num_refs=cfg.MODEL.ROI_WEAK_HEAD.NUM_REFS,
        pooler_method=cfg.MODEL.ROI_BOX_HEAD.POOLER_METHOD,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        pooler_scale=cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
        mlp_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
        cls_agnostic_bbox_reg=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
        regress_on=cfg.MODEL.ROI_WEAK_HEAD.REGRESS_ON,
        regress_heur=cfg.MODEL.ROI_WEAK_HEAD.REGRESS_HEUR,
        reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
    )
