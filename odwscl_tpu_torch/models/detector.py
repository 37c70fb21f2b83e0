"""The WSOD detector: backbone -> RoI pool -> neck -> heads (+ the loss).

Counterpart of ``odwscl_tpu/models/detector.py`` (``Batch``,
``WSODDetector.pool`` / ``eval_forward`` / ``train_forward``,
``detector_from_cfg``). Predictors: WSDDN, OICR and MIST
(``MODEL.ROI_WEAK_HEAD.PREDICTOR``). ``train_forward`` covers every WSOD
recipe: the augmented view by DropBlock, Concrete
DropBlock or none (``DB.METHOD``); contrastive mining with SupCon and
``od_layer`` pseudo-labels (``SOLVER.CONTRA``), or else the ``oicr_layer``
(``OICR_P`` 0) or the ``mist_layer`` (``OICR_P`` > 0); WSDDN alone trains
the MIL loss only; ``MODEL.FASTER_RCNN`` replaces the proposals by CAM
attention proposals and adds the CAM loss; partial labels
(``ROI_WEAK_HEAD.PARTIAL_LABELS`` point / scribble, with the batch's
clicks or scribbles) subsample the proposals to a balanced FG/BG set
before pooling and, with ``ROI_LOSS_REFINE``, filter the pseudo labels.
Backbones: VGG16
(``VGG16-OICR``, stride 8) and ResNet (``R-{18,50,101}-C{4,5}``, stride
16, with the ``ResNetRoINeck`` r*r*C -> 2048 -> ``mlp_dim``).

Pooling (``MODEL.ROI_BOX_HEAD``): ``POOLER_METHOD`` ROIPool at any
``POOLER_RESOLUTION`` r goes through ``RoIPoolFunction`` (on the card the
hand-written kernels, r <= 16; on the CPU their plain versions), ROIAlign
through plain torch ``ops/roi_align.py`` with ``POOLER_SAMPLING_RATIO``;
the necks take r*r*C inputs.

int8 serving (``TPU.INT8_EVAL`` for fc6/fc7, ``INT8_EVAL_CONVS``,
``INT8_STATIC``, ``INT8_BF16_LAYERS`` for the convs; ``eval_forward``
only, ``models/vgg16.py``): VGG16 only. As in the JAX package, a ResNet
backbone ignores the four keys; the port logs a warning when one is set.

Static padded layout as in the JAX package: images [B, H, W, 3] NHWC,
proposals [B, P, 4] with a [B, P] mask.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..losses import (assemble_bank, avg_image_accuracy, mil_loss,
                      mist_layer, od_layer, oicr_layer, refinement_cls_loss,
                      refinement_reg_loss, stage_a, stage_b, supcon_loss,
                      supcon_v2_loss, wsddn_final_score)
# the module, not its names: it imports models.matcher, which may run
# this file first
from ..losses import partial_labels as partial_filters
from ..ops.dropblock import dropblock_2d, noise_augment
from ..ops.roi_align import roi_align
from ..ops.roi_pool import RoIPoolFunction
from ..structures.boxes import clip_to_image, decode_boxes
from .cam import CAMModule
from .cam_proposals import cam_to_proposals
from .cdb import ConvConcreteDB
from .predictors import PREDICTORS
from .resnet import ResNetBackbone, ResNetRoINeck
from .roi_sampler import (match_labels_point, match_labels_scribble,
                          subsample_proposals)
from .sim_net import SimNet
from .vgg16 import VGGBackbone, VGGRoINeck

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

logger = logging.getLogger("odwscl_tpu_torch.detector")


@dataclasses.dataclass
class Batch:
    """One padded batch: image-level fields; with partial labels, the
    padded clicks and scribbles; for the supervised families the padded
    instance GT and, with masks, the GT rasters at 1/MASK_RASTER_STRIDE of
    the padded canvas (None when the batch has none)."""

    images: torch.Tensor       # [B, H, W, 3] normalized (BGR*255 - mean)
    image_sizes: torch.Tensor  # [B, 2] (h, w) before padding, f32
    boxes: torch.Tensor        # [B, P, 4] xyxy proposals, f32
    box_mask: torch.Tensor     # [B, P] bool
    labels: Optional[torch.Tensor] = None  # [B, C] image-level, col 0 = 0
    clicks: Optional[torch.Tensor] = None           # [B, K, 2] (x, y) f32
    click_labels: Optional[torch.Tensor] = None     # [B, K] int64
    click_mask: Optional[torch.Tensor] = None       # [B, K] bool
    scribbles: Optional[torch.Tensor] = None        # [B, S, 4] xyxy f32
    scribble_labels: Optional[torch.Tensor] = None  # [B, S] int64
    scribble_mask: Optional[torch.Tensor] = None    # [B, S] bool
    gt_boxes: Optional[torch.Tensor] = None         # [B, G, 4] xyxy f32
    gt_labels: Optional[torch.Tensor] = None        # [B, G] int64
    gt_mask: Optional[torch.Tensor] = None          # [B, G] bool
    gt_bitmasks: Optional[torch.Tensor] = None      # [B, G, Hr, Wr] f32
    # KEYPOINT_ON: (x, y, visibility) per instance keypoint
    gt_keypoints: Optional[torch.Tensor] = None     # [B, G, K, 3] f32

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
                 pooler_scale: float = 0.125, pooler_sampling: int = 2,
                 mlp_dim: int = 4096,
                 cls_agnostic_bbox_reg: bool = False, regress_on: bool = True,
                 regress_heur: str = "AVG",
                 reg_weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                                  5.0, 5.0),
                 compute_dtype: str = "bfloat16",
                 db_method: str = "dropblock", db_size: int = 3,
                 db_prob: float = 0.3, contra: bool = True,
                 oicr_p: float = 0.0,
                 partial_labels: str = "none", roi_refine: bool = False,
                 faster_rcnn: bool = False, rpn_post_nms: int = 512,
                 p_thres: float = 0.5,
                 mining_nms: float = 0.1, lmda: float = 0.1,
                 temperature: float = 0.2, loss_type: str = "supconv2",
                 fg_iou: float = 0.5, bg_iou: float = 0.5,
                 roi_batch_size: int = 512, roi_pos_fraction: float = 0.25,
                 cap_a: int = 768, cap_b: int = 256,
                 gt_cap: int = 128, neck_dropout: float = 0.5,
                 freeze_at: int = 2, int8_eval: bool = False,
                 int8_eval_convs: bool = False, int8_static: bool = False,
                 int8_bf16_layers: Tuple[int, ...] = ()):
        """``freeze_at`` is ``FREEZE_CONV_BODY_AT``; each backbone reads it
        (VGG: the first ``FREEZE_CONV_COUNTS[at - 1]`` convolutions;
        ResNet: the stem and layer1 when it is > 0). The ``int8_*`` fields
        are ``TPU.INT8_EVAL``, ``INT8_EVAL_CONVS``, ``INT8_STATIC`` and
        ``INT8_BF16_LAYERS`` (VGG16 only). ``partial_labels`` (none, point,
        scribble), ``roi_refine``, ``bg_iou``, ``roi_batch_size`` and
        ``roi_pos_fraction`` are ``ROI_WEAK_HEAD.PARTIAL_LABELS``,
        ``ROI_LOSS_REFINE`` and ``ROI_HEADS.BG_IOU_THRESHOLD``,
        ``BATCH_SIZE_PER_IMAGE``, ``POSITIVE_FRACTION``."""
        super().__init__()
        if predictor not in PREDICTORS:
            raise ValueError(f"unknown PREDICTOR {predictor!r}")
        if db_method not in ("none", "dropblock", "concrete"):
            raise ValueError(f"unknown DB.METHOD {db_method!r} (none, "
                             "dropblock, concrete)")
        if pooler_method not in ("ROIPool", "ROIAlign"):
            raise ValueError(f"unknown POOLER_METHOD {pooler_method!r} "
                             "(ROIPool, ROIAlign)")
        if regress_heur not in ("WSDDN", "CLS-AVG", "UNION", "AVG"):
            raise ValueError(f"unknown REGRESS_HEUR {regress_heur!r}")
        if partial_labels not in ("none", "point", "scribble"):
            raise ValueError(f"unknown PARTIAL_LABELS {partial_labels!r} "
                             "(none, point, scribble)")
        self.num_classes = num_classes
        self.predictor = predictor
        self.pooler_method = pooler_method
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.pooler_sampling = pooler_sampling
        self.cls_agnostic_bbox_reg = cls_agnostic_bbox_reg
        self.regress_on = regress_on
        self.regress_heur = regress_heur
        self.reg_weights = tuple(reg_weights)
        self.num_refs = num_refs
        self.db_method, self.db_size, self.db_prob = db_method, db_size, db_prob
        self.contra, self.oicr_p = contra, oicr_p
        self.partial_labels, self.faster_rcnn = partial_labels, faster_rcnn
        self.roi_refine, self.bg_iou = roi_refine, bg_iou
        self.roi_batch_size = roi_batch_size
        self.roi_pos_fraction = roi_pos_fraction
        self.rpn_post_nms = rpn_post_nms
        self.p_thres, self.mining_nms = p_thres, mining_nms
        self.lmda, self.temperature = lmda, temperature
        self.loss_type, self.fg_iou = loss_type, fg_iou
        self.cap_a, self.cap_b, self.gt_cap = cap_a, cap_b, gt_cap
        dtype = _DTYPES[compute_dtype]
        self.compute_dtype = dtype
        if backbone_arch.startswith("VGG16"):
            self.backbone = VGGBackbone(backbone_arch, dtype, freeze_at,
                                        int8_eval_convs, int8_static,
                                        int8_bf16_layers)
            channels = self.backbone.out_channels
            self.neck = VGGRoINeck(channels * pooler_resolution ** 2,
                                   mlp_dim, dtype, neck_dropout,
                                   int8_eval=int8_eval)
        elif backbone_arch.startswith("R-"):
            if int8_eval or int8_eval_convs or int8_static:
                logger.warning(
                    "TPU.INT8_EVAL / INT8_EVAL_CONVS / INT8_STATIC are "
                    "ignored for the %s backbone: int8 serving covers VGG16 "
                    "only (as in the JAX package); this model evaluates in "
                    "%s", backbone_arch, compute_dtype)
            depth = "-".join(backbone_arch.split("-")[:2])
            stages_out = 5 if backbone_arch.endswith("C5") else 4
            self.backbone = ResNetBackbone(depth, stages_out, dtype, freeze_at)
            channels = self.backbone.out_channels
            self.neck = ResNetRoINeck(channels * pooler_resolution ** 2, 2048,
                                      mlp_dim, dtype, neck_dropout)
        else:
            raise ValueError(f"unknown backbone {backbone_arch!r}")
        self.sim_net = SimNet(mlp_dim, compute_dtype=dtype)
        kwargs = dict(compute_dtype=dtype)
        if predictor != "WSDDNPredictor":
            kwargs["num_refs"] = num_refs
        if predictor == "MISTPredictor":
            kwargs["cls_agnostic_bbox_reg"] = cls_agnostic_bbox_reg
        self.pred = PREDICTORS[predictor](mlp_dim, num_classes, **kwargs)
        self.cam = (CAMModule(channels, num_classes, dtype) if faster_rcnn
                    else None)
        self.cdb = (ConvConcreteDB(channels, db_size)
                    if db_method == "concrete" else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init with the JAX package's distributions."""
        for m in (self.backbone, self.neck, self.sim_net, self.pred,
                  self.cam, self.cdb):
            if m is not None:
                m.reset_parameters(generator)

    def pool(self, feats: torch.Tensor, boxes: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """Differentiable r x r pooling -> [B, P, r, r, C], masked rois 0:
        ROIPool through the CUDA kernels for CUDA tensors and the plain
        versions for CPU tensors (ops/roi_pool.py; every map size), or
        plain ROIAlign (ops/roi_align.py)."""
        if self.pooler_method == "ROIPool":
            return RoIPoolFunction.apply(feats, boxes, mask,
                                         self.pooler_scale, None,
                                         self.pooler_resolution)
        return roi_align(feats, boxes, mask, self.pooler_scale,
                         self.pooler_resolution, self.pooler_sampling)

    @torch.no_grad()
    def eval_forward(self, batch: Batch, calibrate: bool = False):
        """(scores [B,P,C], boxes) per REGRESS_HEUR: AVG gives decoded
        per-class boxes [B,P,4C] clipped to the image; UNION gives one copy
        per refinement branch ([B,R*P,C], [B,R*P,4C]); WSDDN and CLS-AVG
        give the raw proposals [B,P,4]. A WSDDN predictor takes the WSDDN
        branch whatever REGRESS_HEUR says. Without box deltas (OICR) AVG
        and UNION raise, unless REGRESS_ON is False (CLS-AVG).

        The int8 serving paths apply here: the VGG16 convs with
        ``int8_eval_convs`` (``calibrate`` runs them in the compute dtype
        and records their activation scales) and fc6/fc7 with
        ``int8_eval``."""
        vgg = isinstance(self.backbone, VGGBackbone)
        feats = (self.backbone(batch.images, fast_eval=True,
                               calibrate=calibrate)
                 if vgg else self.backbone(batch.images))
        pooled = self.pool(feats, batch.boxes, batch.box_mask)
        b, p = pooled.shape[:2]
        flat = pooled.reshape(b * p, -1)
        clean = (self.neck(flat, fast_eval=True) if vgg
                 else self.neck(flat)).reshape(b, p, -1)
        cls, det, refs, bbox = self.pred(clean, batch.box_mask)

        if self.predictor == "WSDDNPredictor" or self.regress_heur == "WSDDN":
            return cls * det, batch.boxes
        if self.regress_heur == "CLS-AVG" or not self.regress_on:
            return torch.stack(refs).mean(dim=0), batch.boxes
        if bbox is None:
            raise ValueError(f"REGRESS_HEUR {self.regress_heur} with "
                             f"REGRESS_ON True needs box deltas, which "
                             f"{self.predictor} has not: set "
                             "MODEL.ROI_WEAK_HEAD.REGRESS_ON False")
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


    def train_features(self, images: torch.Tensor) -> torch.Tensor:
        """The batch-separable prefix of ``train_forward``: the backbone,
        image by image independent (parallel/mesh.py runs it on each
        rank's images)."""
        return self.backbone(images)

    def train_forward(self, batch: Batch,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      trace: Optional[Callable[[str], None]] = None,
                      features: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
        """(losses, metrics) of one training batch, as scalar tensors.

        ``generator`` (on the batch's device) draws the dropout masks, the
        DropBlock centers, the Concrete DropBlock's gumbel noise, the
        noise view and the partial-label subsample. ``draws`` may hand in
        (r the pooler's resolution) the DropBlock uniforms ``dropblock``
        [B*P, r, r] and ``sim_drop`` [capA, r, r], the Concrete
        DropBlock's uniforms ``cdb_gumbel`` [B*P, r, r, 2], the ``noise``
        normals [capA, r, r, C] and the
        subsample's uniforms ``subsample`` [B, 2, P0] instead (P0 the
        batch's proposals; P those that the subsample keeps).
        ``trace(stage)`` is called as each stage has been enqueued.
        ``features``, when given, are ``train_features(batch.images)``
        computed elsewhere (the data-parallel step's gathered maps);
        ``batch.images`` is then not read.

        Under ``contra`` the all-RoI clean pass is the mining view only and
        runs without gradient; the loss reaches the clean neck through the
        mined bank rows alone, recomputed with gradient and with the same
        rows' dropout masks.
        """
        draws = draws or {}
        trace = trace or (lambda stage: None)
        boxes, mask, labels = batch.boxes, batch.box_mask, batch.labels
        dev = boxes.device
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        plab = None
        if self.partial_labels == "point" and batch.clicks is not None:
            plab = match_labels_point(boxes, batch.clicks, batch.click_labels,
                                      batch.click_mask)
        elif (self.partial_labels == "scribble"
              and batch.scribbles is not None):
            plab = match_labels_scribble(
                boxes, batch.scribbles, batch.scribble_labels,
                batch.scribble_mask, self.fg_iou, self.bg_iou)
        if plab is not None:
            # a balanced FG/BG subset of the proposals, before pooling
            boxes, mask, _ = subsample_proposals(
                boxes, mask, plab, self.roi_batch_size,
                self.roi_pos_fraction, generator, draws.get("subsample"))
            trace("subsample")
        feats = (self.train_features(batch.images) if features is None
                 else features)
        trace("backbone")
        if self.faster_rcnn:
            cam_maps, losses["loss_cam"] = self.cam(feats, labels)
            # the mean attention logit over the foreground classes
            with torch.no_grad():
                atten = cam_maps.to(torch.float32)[..., 1:].mean(dim=-1)
                boxes, mask, _ = cam_to_proposals(
                    atten, batch.image_sizes, round(1 / self.pooler_scale),
                    out_p=self.rpn_post_nms)
            trace("cam_proposals")
        pooled = self.pool(feats, boxes, mask)                    # [B,P,r,r,C]
        trace("roi_pool")
        b, p = pooled.shape[:2]
        flat_pooled = pooled.reshape(b * p, *pooled.shape[2:])

        if self.contra:
            clean_keep = self.neck.draw_keep(b * p, generator, dev)
            with torch.no_grad():
                z_clean = self.sim_net(self.neck(flat_pooled, clean_keep)
                                       ).reshape(b, p, -1)
            trace("clean_pass")

        if self.db_method == "dropblock":
            aug_pooled = dropblock_2d(flat_pooled, self.db_prob, self.db_size,
                                      valid=mask.reshape(-1),
                                      generator=generator,
                                      uniform=draws.get("dropblock"))
        elif self.db_method == "concrete":
            aug_pooled = self.cdb(flat_pooled, mask.reshape(-1), generator,
                                  draws.get("cdb_gumbel"))
        else:
            aug_pooled = flat_pooled
        aug = self.neck(aug_pooled, self.neck.draw_keep(b * p, generator, dev))
        cls, det, refs, bbox = self.pred(aug.reshape(b, p, -1), mask,
                                         train=True)
        final = wsddn_final_score(cls, det, mask)                 # [B,P,C] f32
        losses["loss_img"] = mil_loss(final, labels)
        metrics["acc_img"] = avg_image_accuracy(
            labels.clamp(0, 1), final.sum(dim=1).clamp(1e-8, 1 - 1e-8))
        trace("aug_pass_heads")
        if refs is None:
            # WSDDN alone: the MIL loss, no refinement and no mining
            return losses, metrics
        ref_softmax = torch.stack([torch.softmax(r.to(torch.float32), dim=-1)
                                   for r in refs])
        labels_fg = labels[:, 1:] > 0
        final_ng, ref_ng = final.detach(), ref_softmax.detach()

        if self.contra:
            a = stage_a(boxes, mask, labels_fg, final_ng, ref_ng,
                        self.p_thres, self.cap_a)
            slot_pooled = pooled[a.slot_b.clamp(min=0), a.slot_p]
            dropped = dropblock_2d(slot_pooled, 0.3, 1, valid=a.slot_valid,
                                   generator=generator,
                                   uniform=draws.get("sim_drop"))
            z_drop = self.sim_net(self.neck(dropped, self.neck.draw_keep(
                self.cap_a, generator, dev)))
            noised = noise_augment(slot_pooled, generator, draws.get("noise"))
            z_noise = self.sim_net(self.neck(noised, self.neck.draw_keep(
                self.cap_a, generator, dev)))
            trace("stage_a_views")

            sb = stage_b(boxes, mask, labels_fg, final_ng, ref_ng, z_clean,
                         z_drop.detach(), z_noise.detach(), a,
                         self.mining_nms, self.cap_b)
            trace("stage_b")
            rows = torch.cat([a.slot_b.clamp(min=0) * p + a.slot_p,
                              sb.slot_b.clamp(min=0) * p + sb.slot_p])
            bank_keep = (None if clean_keep is None
                         else tuple(k[rows] for k in clean_keep))
            z_bank = self.sim_net(self.neck(flat_pooled[rows], bank_keep))
            feats_e, labels_e, hard_e, valid_e = assemble_bank(
                a, sb, z_clean, z_drop, z_noise,
                z_a_clean=z_bank[:self.cap_a], z_b_clean=z_bank[self.cap_a:])
            if self.loss_type == "supconv2":
                sim = supcon_v2_loss(feats_e, labels_e, hard_e, valid_e,
                                     self.temperature)
            else:
                sim = supcon_loss(feats_e, labels_e, valid_e,
                                  self.temperature)
            losses["loss_sim"] = self.lmda * sim
            metrics["bank_overflow"] = (a.overflow + sb.overflow).float()
            metrics["n_bank"] = valid_e.sum().float()
            metrics["n_mined"] = sb.pgt_instance.sum().float()
            pgt_instance = sb.pgt_instance
            trace("bank_supcon")

        for i in range(self.num_refs):
            src = final_ng if i == 0 else ref_ng[i - 1]
            if self.contra:
                pl = od_layer(boxes, mask, src[..., 1:], labels_fg,
                              pgt_instance[i], self.fg_iou, self.gt_cap,
                              self.reg_weights)
            elif self.oicr_p == 0.0:
                pl = oicr_layer(boxes, mask, src[..., 1:], labels_fg,
                                self.fg_iou, reg_weights=self.reg_weights)
            else:
                pl = mist_layer(boxes, mask, src[..., 1:], labels_fg,
                                portion=self.oicr_p, fg_iou=self.fg_iou,
                                reg_weights=self.reg_weights)
            if (self.roi_refine and self.partial_labels == "point"
                    and batch.clicks is not None):
                pl = pl._replace(
                    labels=partial_filters.filter_pseudo_labels_point(
                        pl.labels, boxes, batch.clicks, batch.click_labels,
                        batch.click_mask))
            elif (self.roi_refine and self.partial_labels == "scribble"
                    and batch.scribbles is not None):
                pl = pl._replace(
                    labels=partial_filters.filter_pseudo_labels_scribble(
                        pl.labels, boxes, batch.scribbles,
                        batch.scribble_labels, batch.scribble_mask))
            lam = 3.0 if i == 0 else 1.0
            losses[f"loss_ref_cls{i}"] = lam * refinement_cls_loss(
                refs[i], pl.labels, pl.weights, mask)
            if self.regress_on and bbox is not None:
                losses[f"loss_ref_reg{i}"] = lam * refinement_reg_loss(
                    bbox[i], pl.labels, pl.weights, pl.reg_targets, mask,
                    self.cls_agnostic_bbox_reg)
            metrics[f"pgt_overflow{i}"] = pl.overflow.float()
            metrics[f"n_pos{i}"] = ((pl.labels > 0) & mask).sum().float()
        for i in range(self.num_refs):
            ref_sum = torch.where(mask[..., None], refs[i].to(torch.float32),
                                  0.0).sum(dim=1)
            metrics[f"acc_ref{i}"] = avg_image_accuracy(
                labels[:, 1:].clamp(0, 1), ref_sum[:, 1:])
        trace("refinement")
        return losses, metrics

def detector_from_cfg(cfg) -> WSODDetector:
    """Build the detector from a CfgNode. As in the JAX package, ``gt_cap``
    (128), ``neck_dropout`` (0.5), ``db_prob`` (0.3) and the Concrete
    DropBlock's drop probability and temperature (models/cdb.py; not
    ``DB.TAU``) have no config key; ``cap_b`` is a quarter of the bank
    capacity, at least 64."""
    return WSODDetector(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        backbone_arch=cfg.MODEL.BACKBONE.CONV_BODY,
        predictor=cfg.MODEL.ROI_WEAK_HEAD.PREDICTOR,
        num_refs=cfg.MODEL.ROI_WEAK_HEAD.NUM_REFS,
        pooler_method=cfg.MODEL.ROI_BOX_HEAD.POOLER_METHOD,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        pooler_scale=cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES[0],
        pooler_sampling=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        mlp_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
        cls_agnostic_bbox_reg=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
        regress_on=cfg.MODEL.ROI_WEAK_HEAD.REGRESS_ON,
        regress_heur=cfg.MODEL.ROI_WEAK_HEAD.REGRESS_HEUR,
        reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        db_method=cfg.DB.METHOD,
        db_size=cfg.DB.SIZE,
        contra=cfg.SOLVER.CONTRA,
        oicr_p=cfg.MODEL.ROI_WEAK_HEAD.OICR_P,
        partial_labels=cfg.MODEL.ROI_WEAK_HEAD.PARTIAL_LABELS,
        roi_refine=cfg.MODEL.ROI_WEAK_HEAD.ROI_LOSS_REFINE,
        faster_rcnn=cfg.MODEL.FASTER_RCNN,
        rpn_post_nms=cfg.TPU.RPN_POST_NMS,
        p_thres=cfg.thres,
        mining_nms=cfg.nms,
        lmda=cfg.lmda,
        temperature=cfg.temp,
        loss_type=cfg.loss,
        fg_iou=cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD,
        bg_iou=cfg.MODEL.ROI_HEADS.BG_IOU_THRESHOLD,
        roi_batch_size=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_pos_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        cap_a=cfg.TPU.BANK_CAPACITY,
        cap_b=max(cfg.TPU.BANK_CAPACITY // 4, 64),
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        int8_eval=cfg.TPU.INT8_EVAL,
        int8_eval_convs=cfg.TPU.INT8_EVAL_CONVS,
        int8_static=cfg.TPU.INT8_STATIC,
        int8_bf16_layers=tuple(cfg.TPU.INT8_BF16_LAYERS),
    )
