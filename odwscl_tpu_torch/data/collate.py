"""Batch collation to static padded shapes (image-level and partial-label
fields).

Counterpart of ``odwscl_tpu/data/collate.py:BatchCollator``: images pad to
the batch's largest size rounded up to ``SIZE_DIVISIBILITY`` and then to
``IMAGE_PAD_MULTIPLE``; proposals pad to the smallest ``PROPOSAL_BUCKETS``
size that holds them (the largest bucket truncates). Clicks and scribbles,
when any sample has them, pad to ``PARTIAL_CAP`` slots with a mask (the
first ``PARTIAL_CAP`` of an image are kept). With ``include_gt`` (the
supervised families: ``WSOD_ON False`` or ``RETINANET_ON``) the instance
GT pads to ``GT_PAD`` slots, the GT masks, when any sample has them,
are rasterized at 1/``MASK_RASTER_STRIDE`` of the padded canvas
(``gt_bitmasks``), and the GT keypoints, when any sample has them, pad to
[B, GT_PAD, K, 3] (K the batch's largest; ``gt_keypoints``). The batch is
built on the CPU; the caller moves it to its device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.detector import Batch
from .transforms import Sample

# clicks / scribbles per image in a batch (the JAX package's cap)
PARTIAL_CAP = 32


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return sorted(buckets)[-1]


def image_labels(gt_labels: Optional[np.ndarray], num_classes: int
                 ) -> np.ndarray:
    """Multi-hot image labels, column 0 (background) zeroed."""
    lab = np.zeros((num_classes,), np.float32)
    if gt_labels is not None and len(gt_labels):
        lab[np.unique(gt_labels).astype(np.int64)] = 1.0
    lab[0] = 0.0
    return lab


class BatchCollator:
    """list[Sample] (images already numpy HWC float32) -> Batch."""

    def __init__(self, num_classes: int, size_divisibility: int = 32,
                 image_pad_multiple: int = 128,
                 proposal_buckets: Sequence[int] = (512, 1024, 2048, 4096),
                 include_gt: bool = False, gt_pad: int = 32,
                 mask_raster_stride: int = 4):
        self.num_classes = num_classes
        self.size_div = size_divisibility
        self.image_pad_multiple = image_pad_multiple
        self.proposal_buckets = tuple(proposal_buckets)
        self.include_gt = include_gt
        self.gt_pad = gt_pad
        self.mask_raster_stride = mask_raster_stride

    def widths(self, samples: List[Sample]) -> Dict[str, int]:
        """The padded widths that ``samples`` need: the canvas, the largest
        proposal count, whether any sample has clicks, scribbles or GT
        masks, and the largest keypoint count (0 without keypoints)."""
        def has(name):
            return int(any(getattr(s, name) is not None
                           and len(getattr(s, name)) for s in samples))

        return {
            "h": _round_up(_round_up(max(s.image.shape[0] for s in samples),
                                     self.size_div), self.image_pad_multiple),
            "w": _round_up(_round_up(max(s.image.shape[1] for s in samples),
                                     self.size_div), self.image_pad_multiple),
            "rois": max(0 if s.rois is None else len(s.rois)
                        for s in samples),
            "clicks": has("clicks"), "scribbles": has("scribbles"),
            "masks": int(any(s.gt_masks is not None for s in samples)),
            "keypoints": max(s.gt_keypoints.keypoints.shape[1]
                             if s.gt_keypoints is not None else 0
                             for s in samples)}

    def __call__(self, samples: List[Sample],
                 agree: Optional[Callable[[Dict[str, int]],
                                          Dict[str, int]]] = None) -> Batch:
        """``agree`` maps these samples' ``widths`` to the ones to pad to
        (the data-parallel loader's: the largest over the ranks, so that
        each rank's share is padded as the global batch is)."""
        b = len(samples)
        wd = self.widths(samples)
        if agree is not None:
            wd = agree(wd)
        ph, pw = wd["h"], wd["w"]
        images = np.zeros((b, ph, pw, 3), np.float32)
        sizes = np.zeros((b, 2), np.float32)
        for i, s in enumerate(samples):
            h, w = s.image.shape[:2]
            images[i, :h, :w] = s.image
            sizes[i] = (h, w)

        p = pick_bucket(max(wd["rois"], 1), self.proposal_buckets)
        boxes = np.zeros((b, p, 4), np.float32)
        mask = np.zeros((b, p), bool)
        for i, s in enumerate(samples):
            if s.rois is None:
                continue
            n = min(len(s.rois), p)
            boxes[i, :n] = s.rois[:n]
            mask[i, :n] = True
        labels = np.stack([image_labels(s.gt_labels, self.num_classes)
                           for s in samples])
        extra = {}
        for name, width in (("click", 2), ("scribble", 4)):
            if wd[name + "s"]:
                extra.update(_pad_partial(samples, name, width))
        if self.include_gt:
            extra.update(self._pad_gt(samples, ph, pw, wd["masks"],
                                      wd["keypoints"]))
        return Batch(images=torch.from_numpy(images),
                     image_sizes=torch.from_numpy(sizes),
                     boxes=torch.from_numpy(boxes),
                     box_mask=torch.from_numpy(mask),
                     labels=torch.from_numpy(labels), **extra)

    def _pad_gt(self, samples: List[Sample], ph: int, pw: int,
                masks: bool, k: int) -> dict:
        """``gt_boxes`` [B, G, 4], ``gt_labels`` [B, G] int64, ``gt_mask``
        [B, G]; with ``masks`` (some sample has them), ``gt_bitmasks``
        [B, G, ph // s, pw // s]: each sample's masks resized to its
        image's size // s, thresholded, in the raster's top-left corner
        (where the image lies on the canvas); with ``k`` > 0 keypoints,
        ``gt_keypoints`` [B, G, k, 3]."""
        b, g = len(samples), self.gt_pad
        boxes = np.zeros((b, g, 4), np.float32)
        labels = np.zeros((b, g), np.int64)
        valid = np.zeros((b, g), bool)
        for i, s in enumerate(samples):
            if s.gt_boxes is None or not len(s.gt_boxes):
                continue
            n = min(len(s.gt_boxes), g)
            boxes[i, :n], labels[i, :n], valid[i, :n] = \
                s.gt_boxes[:n], s.gt_labels[:n], True
        out = {"gt_boxes": torch.from_numpy(boxes),
               "gt_labels": torch.from_numpy(labels),
               "gt_mask": torch.from_numpy(valid)}
        if masks:
            st = self.mask_raster_stride
            bit = np.zeros((b, g, ph // st, pw // st), np.float32)
            for i, s in enumerate(samples):
                if s.gt_masks is None or not len(s.gt_masks):
                    continue
                raster = s.gt_masks.resize(
                    (s.image.shape[1] // st, s.image.shape[0] // st)
                ).to_bitmasks().astype(np.float32)
                n = min(len(raster), g)
                bit[i, :n, :raster.shape[1], :raster.shape[2]] = raster[:n]
            out["gt_bitmasks"] = torch.from_numpy(bit)
        if k:
            kp = np.zeros((b, g, k, 3), np.float32)
            for i, s in enumerate(samples):
                if s.gt_keypoints is None or not len(s.gt_keypoints):
                    continue
                arr = s.gt_keypoints.keypoints
                n = min(len(arr), g)
                kp[i, :n, :arr.shape[1]] = arr[:n]
            out["gt_keypoints"] = torch.from_numpy(kp)
        return out


def _pad_partial(samples: List[Sample], name: str, width: int) -> dict:
    """``{name}s`` [B, PARTIAL_CAP, width] f32, ``{name}_labels`` [B, cap]
    int64 and ``{name}_mask`` [B, cap] bool from the samples' fields."""
    b, k = len(samples), PARTIAL_CAP
    pts = np.zeros((b, k, width), np.float32)
    lab = np.zeros((b, k), np.int64)
    valid = np.zeros((b, k), bool)
    for i, s in enumerate(samples):
        v, v_lab = getattr(s, name + "s"), getattr(s, name + "_labels")
        if v is None or not len(v):
            continue
        n = min(len(v), k)
        pts[i, :n], lab[i, :n], valid[i, :n] = v[:n], v_lab[:n], True
    return {name + "s": torch.from_numpy(pts),
            name + "_labels": torch.from_numpy(lab),
            name + "_mask": torch.from_numpy(valid)}


def collator_from_cfg(cfg) -> BatchCollator:
    return BatchCollator(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        size_divisibility=cfg.DATALOADER.SIZE_DIVISIBILITY,
        image_pad_multiple=cfg.TPU.IMAGE_PAD_MULTIPLE,
        proposal_buckets=tuple(cfg.TPU.PROPOSAL_BUCKETS),
        include_gt=(not cfg.MODEL.WSOD_ON) or cfg.MODEL.RETINANET_ON,
        gt_pad=cfg.TPU.GT_PAD,
        mask_raster_stride=cfg.TPU.MASK_RASTER_STRIDE,
    )
