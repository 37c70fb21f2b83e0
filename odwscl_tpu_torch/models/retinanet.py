"""RetinaNet: the dense anchor head over the FPN P3-P7 pyramid.

Counterpart of ``odwscl_tpu/models/retinanet.py``: the anchors with
Detectron's rounding (``cell_anchors``, ``grid_anchors``,
``pyramid_anchors``), ``RetinaNetHead`` (towers shared across levels, the
prior-probability bias), ``flatten_head_outputs``, ``retinanet_targets``,
``retinanet_loss``, ``retinanet_decode``, ``RetinaNetDetector`` and
``retinanet_from_cfg``. Nothing here pools, so RetinaNet launches no
ROIPool kernel; its convolutions and the focal loss are torch ops.

Anchor order, as in the JAX package: levels in order, then the grid
row-major, the anchor minor, the class innermost. The head's NCHW outputs
are permuted to NHWC before the reshape that flattens them.

``retinanet_decode`` takes the top ``pre_nms_top_n`` (anchor, class)
scores of each image with ties broken towards the lower flat index, as
``lax.top_k`` does: the sort key is the score's f32 bit pattern (scores
are >= 0, so it orders as the score) above the flat index's complement.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import sigmoid_focal_loss
from ..structures.boxes import decode_boxes, encode_boxes, masked_iou
from .fpn import ResNetFPNP3P7Backbone, conv_nchw
from .matcher import BETWEEN_THRESHOLDS, match_proposals

REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def cell_anchors(stride: int, size: float, aspect_ratios: Sequence[float],
                 octave: float = 2.0, scales_per_octave: int = 3
                 ) -> np.ndarray:
    """Per-cell anchors [A, 4] of one level, ratio-major: Detectron's
    rounded widths and heights around (0, 0, stride - 1, stride - 1), then
    the octave scales."""
    scales = np.array([size * octave ** (i / scales_per_octave)
                       for i in range(scales_per_octave)]) / stride
    anchor = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])

    w, h, xc, yc = whctrs(anchor)
    size_ratios = (w * h) / np.asarray(aspect_ratios, float)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(aspect_ratios, float))
    out = []
    for ra in mk(ws, hs, xc, yc):
        w, h, xc, yc = whctrs(ra)
        out.append(mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def grid_anchors(cell: np.ndarray, stride: int, gh: int, gw: int,
                 device=None) -> torch.Tensor:
    """The dense grid of one level: [gh * gw * A, 4], row-major cells,
    anchor minor."""
    sx = torch.arange(gw, dtype=torch.float32, device=device) * stride
    sy = torch.arange(gh, dtype=torch.float32, device=device) * stride
    shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([shift_x.reshape(-1), shift_y.reshape(-1),
                          shift_x.reshape(-1), shift_y.reshape(-1)], dim=1)
    cell_t = torch.as_tensor(cell, device=device)
    return (shifts[:, None, :] + cell_t[None, :, :]).reshape(-1, 4)


def pyramid_anchors(grid_sizes: Sequence[Tuple[int, int]],
                    strides: Sequence[int] = (8, 16, 32, 64, 128),
                    sizes: Sequence[float] = (32, 64, 128, 256, 512),
                    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                    octave: float = 2.0, scales_per_octave: int = 3,
                    device=None) -> List[torch.Tensor]:
    return [grid_anchors(cell_anchors(st, sz, aspect_ratios, octave,
                                      scales_per_octave), st, gh, gw, device)
            for (gh, gw), st, sz in zip(grid_sizes, strides, sizes)]


class RetinaNetHead(nn.Module):
    """``num_convs`` 3x3 + ReLU per tower (cls and bbox, shared across
    levels), then the 3x3 logits (A * (num_classes - 1), bias
    -log((1 - p) / p)) and box deltas (A * 4). Per level NHWC features in,
    per level NCHW f32 outputs out."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_anchors: int = 9, num_convs: int = 4,
                 prior_prob: float = 0.01,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_convs = num_convs
        self.prior_prob = prior_prob
        self.compute_dtype = compute_dtype
        c = in_channels
        for i in range(num_convs):
            setattr(self, f"cls_tower{i}", nn.Conv2d(c, c, 3, padding=1))
            setattr(self, f"bbox_tower{i}", nn.Conv2d(c, c, 3, padding=1))
        self.cls_logits = nn.Conv2d(c, num_anchors * (num_classes - 1), 3,
                                    padding=1)
        self.bbox_pred = nn.Conv2d(c, num_anchors * 4, 3, padding=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
        self.cls_logits.bias.fill_(
            -math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, features: Sequence[torch.Tensor]):
        logits, bbox = [], []
        for f in features:
            x = f.to(self.compute_dtype).permute(0, 3, 1, 2)
            for kind, head, out in (("cls", self.cls_logits, logits),
                                    ("bbox", self.bbox_pred, bbox)):
                y = x
                for i in range(self.num_convs):
                    y = F.relu(conv_nchw(getattr(self, f"{kind}_tower{i}"), y))
                out.append(conv_nchw(head, y).to(torch.float32))
        return logits, bbox


def flatten_head_outputs(logits: Sequence[torch.Tensor],
                         bbox: Sequence[torch.Tensor], num_classes_fg: int):
    """Per level NCHW [N, A*C', H, W] -> ([N, sum HWA, C'], [N, sum HWA,
    4]) in ``pyramid_anchors``' order."""
    ls, bs = [], []
    for lg, bb in zip(logits, bbox):
        n = lg.shape[0]
        ls.append(lg.permute(0, 2, 3, 1).reshape(n, -1, num_classes_fg))
        bs.append(bb.permute(0, 2, 3, 1).reshape(n, -1, 4))
    return torch.cat(ls, dim=1), torch.cat(bs, dim=1)


def retinanet_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                      fg_iou: float = 0.5, bg_iou: float = 0.4):
    """Anchor targets of a batch: anchors [P, 4], gt [B, G, ...] ->
    (labels [B, P] int64, -1 between the thresholds; reg targets [B, P,
    4]). Low-quality matches are kept, as in the reference matcher."""
    b = gt_boxes.shape[0]
    amask = torch.ones(anchors.shape[0], dtype=torch.bool,
                       device=anchors.device)
    iou = masked_iou(gt_boxes, gt_mask, anchors.expand(b, -1, -1),
                     amask.expand(b, -1))                       # [B, G, P]
    matched = match_proposals(iou, gt_mask, fg_iou, bg_iou,
                              allow_low_quality_matches=True)   # [B, P]
    safe = matched.clamp(min=0)
    labels = torch.where(matched >= 0,
                         torch.gather(gt_labels.long(), 1, safe), 0)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    matched_boxes = torch.gather(gt_boxes, 1, safe[..., None].expand(
        -1, -1, 4))
    reg = encode_boxes(matched_boxes, anchors.expand(b, -1, -1), REG_WEIGHTS)
    return labels, reg


def retinanet_loss(logits: torch.Tensor, bbox: torch.Tensor,
                   labels: torch.Tensor, reg_targets: torch.Tensor,
                   beta: float = 0.11, reg_norm: float = 4.0,
                   gamma: float = 2.0, alpha: float = 0.25):
    """(cls, reg): the focal loss summed over the anchors not discarded /
    (positives + images); smooth-L1 (beta) summed over the positives /
    max(positives * reg_norm, 1)."""
    b = logits.shape[0]
    fl = sigmoid_focal_loss(logits.reshape(-1, logits.shape[-1]),
                            labels.reshape(-1), gamma, alpha)
    pos = (labels > 0).to(torch.float32)
    npos = pos.sum()
    cls_loss = fl.sum() / (npos + b)
    d = (bbox - reg_targets).abs()
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    reg_loss = (sl1.sum(-1) * pos).sum() / torch.clamp(npos * reg_norm,
                                                       min=1.0)
    return cls_loss, reg_loss


def topk_lower_index(values: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row of ``values`` [B, N]
    (f32, >= 0, N < 2^31), ties towards the lower index."""
    n = values.shape[-1]
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    idx = torch.arange(n, device=values.device, dtype=torch.int64)
    _, order = torch.topk((bits << 31) | ((n - 1) - idx), k, dim=-1)
    return torch.gather(values, -1, order), order


def retinanet_decode(anchors: torch.Tensor, logits: torch.Tensor,
                     bbox: torch.Tensor, image_sizes_wh: torch.Tensor,
                     score_thresh: float = 0.05, pre_nms_top_n: int = 1000):
    """anchors [P, 4], logits [B, P, C'], bbox [B, P, 4], image sizes
    [B, 2] (w, h) -> (boxes [B, K, 4], scores [B, K], labels [B, K] in
    1..C', valid [B, K]), K = min(pre_nms_top_n, P * C'): one global top-K
    of the sigmoid scores above ``score_thresh`` (others count as 0) over
    every (anchor, class) pair of an image, boxes clipped to the image."""
    b, p, cf = logits.shape
    flat = torch.sigmoid(logits).reshape(b, p * cf)
    vals = torch.where(flat > score_thresh, flat, 0.0)
    k = min(pre_nms_top_n, p * cf)
    scores, idx = topk_lower_index(vals, k)
    anchor_i = torch.div(idx, cf, rounding_mode="floor")
    label = idx % cf + 1
    sel_anchors = anchors[anchor_i]                          # [B, K, 4]
    sel_reg = torch.gather(bbox, 1, anchor_i[..., None].expand(-1, -1, 4))
    boxes = decode_boxes(sel_reg, sel_anchors, REG_WEIGHTS)
    w = image_sizes_wh[:, 0][:, None]
    h = image_sizes_wh[:, 1][:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w - 1),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h - 1),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w - 1),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h - 1)], dim=-1)
    return boxes, scores, label, scores > score_thresh


class RetinaNetDetector(nn.Module):
    """P3-P7 FPN backbone + the shared-tower head; ``train_forward`` gives
    (losses, metrics), ``eval_forward`` the decoded top-K dict (the engine
    runs the per-class NMS)."""

    def __init__(self, num_classes: int = 81, depth: str = "R-50",
                 use_c5: bool = True,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 octave: float = 2.0, scales_per_octave: int = 3,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 fg_iou: float = 0.5, bg_iou: float = 0.4,
                 loss_gamma: float = 2.0, loss_alpha: float = 0.25,
                 reg_beta: float = 0.11, reg_norm: float = 4.0,
                 score_thresh: float = 0.05, pre_nms_top_n: int = 1000,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[compute_dtype]
        self.num_classes = num_classes
        self.anchor_args = (tuple(anchor_strides), tuple(anchor_sizes),
                            tuple(aspect_ratios), octave, scales_per_octave)
        self.fg_iou, self.bg_iou = fg_iou, bg_iou
        self.loss_args = (reg_beta, reg_norm, loss_gamma, loss_alpha)
        self.score_thresh = score_thresh
        self.pre_nms_top_n = pre_nms_top_n
        self.backbone = ResNetFPNP3P7Backbone(depth, 256, use_c5, dtype)
        self.head = RetinaNetHead(num_classes, 256,
                                  len(aspect_ratios) * scales_per_octave,
                                  num_convs, prior_prob, dtype)
        # anchors per (grid sizes, device): building them takes ~40 small
        # launches and 5 synchronizing uploads a forward
        self._anchors: Dict[tuple, torch.Tensor] = {}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def train_features(self, images: torch.Tensor):
        """The batch-separable prefix of ``train_forward``: the body and
        the FPN levels."""
        return self.backbone(images)

    def dense(self, feats):
        """(anchors [P, 4] of every level, logits [B, P, C'], deltas
        [B, P, 4]) from the FPN levels ``feats``."""
        logits, bbox = flatten_head_outputs(*self.head(feats),
                                            self.num_classes - 1)
        key = (tuple((f.shape[1], f.shape[2]) for f in feats),
               str(feats[0].device))
        if key not in self._anchors:
            self._anchors[key] = torch.cat(pyramid_anchors(
                key[0], *self.anchor_args, device=feats[0].device))
        return self._anchors[key], logits, bbox

    @torch.no_grad()
    def eval_forward(self, batch) -> Dict[str, torch.Tensor]:
        anchors, logits, bbox = self.dense(self.backbone(batch.images))
        boxes, scores, labels, valid = retinanet_decode(
            anchors, logits, bbox, batch.image_sizes.flip(-1),
            self.score_thresh, self.pre_nms_top_n)
        return {"boxes": boxes, "scores": scores, "labels": labels,
                "valid": valid}

    def train_forward(self, batch, generator: Optional[torch.Generator] = None,
                      draws=None, trace=None, features=None):
        """(losses, metrics); draws nothing (``generator`` and ``draws``
        are accepted for the trainer's protocol). ``features``, when
        given, stand for ``train_features(batch.images)``."""
        if batch.gt_boxes is None:
            raise ValueError("RetinaNet training needs the batch's GT boxes "
                             "(the collator's include_gt)")
        anchors, logits, bbox = self.dense(
            self.train_features(batch.images) if features is None
            else features)
        labels, reg = retinanet_targets(anchors, batch.gt_boxes,
                                        batch.gt_labels, batch.gt_mask,
                                        self.fg_iou, self.bg_iou)
        cls_loss, reg_loss = retinanet_loss(logits, bbox, labels, reg,
                                            *self.loss_args)
        return ({"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss},
                {"n_pos_anchors": (labels > 0).sum().to(torch.float32)})


def retinanet_from_cfg(cfg) -> RetinaNetDetector:
    """MODEL.RETINANET's keys; the depth from CONV_BODY (``R-50-FPN-
    RETINANET`` or a bare ``R-50``), R-50 otherwise."""
    r = cfg.MODEL.RETINANET
    body = cfg.MODEL.BACKBONE.CONV_BODY
    depth = "-".join(body.split("-")[:2]) if body.startswith("R-") else "R-50"
    return RetinaNetDetector(
        num_classes=r.NUM_CLASSES, depth=depth, use_c5=r.USE_C5,
        anchor_sizes=tuple(r.ANCHOR_SIZES),
        anchor_strides=tuple(r.ANCHOR_STRIDES),
        aspect_ratios=tuple(r.ASPECT_RATIOS), octave=r.OCTAVE,
        scales_per_octave=r.SCALES_PER_OCTAVE, num_convs=r.NUM_CONVS,
        prior_prob=r.PRIOR_PROB, fg_iou=r.FG_IOU_THRESHOLD,
        bg_iou=r.BG_IOU_THRESHOLD, loss_gamma=r.LOSS_GAMMA,
        loss_alpha=r.LOSS_ALPHA, reg_beta=r.BBOX_REG_BETA,
        reg_norm=r.BBOX_REG_WEIGHT, score_thresh=r.INFERENCE_TH,
        pre_nms_top_n=r.PRE_NMS_TOP_N, compute_dtype=cfg.TPU.COMPUTE_DTYPE)
