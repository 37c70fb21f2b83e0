"""Batch collation to static padded shapes (image-level fields).

Counterpart of ``odwscl_tpu/data/collate.py:BatchCollator``: images pad to
the batch's largest size rounded up to ``SIZE_DIVISIBILITY`` and then to
``IMAGE_PAD_MULTIPLE``; proposals pad to the smallest ``PROPOSAL_BUCKETS``
size that holds them (the largest bucket truncates). The batch is built on
the CPU; the caller moves it to its device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.detector import Batch
from .transforms import Sample


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
                 proposal_buckets: Sequence[int] = (512, 1024, 2048, 4096)):
        self.num_classes = num_classes
        self.size_div = size_divisibility
        self.image_pad_multiple = image_pad_multiple
        self.proposal_buckets = tuple(proposal_buckets)

    def __call__(self, samples: List[Sample]) -> Batch:
        b = len(samples)
        ph = _round_up(_round_up(max(s.image.shape[0] for s in samples),
                                 self.size_div), self.image_pad_multiple)
        pw = _round_up(_round_up(max(s.image.shape[1] for s in samples),
                                 self.size_div), self.image_pad_multiple)
        images = np.zeros((b, ph, pw, 3), np.float32)
        sizes = np.zeros((b, 2), np.float32)
        for i, s in enumerate(samples):
            h, w = s.image.shape[:2]
            images[i, :h, :w] = s.image
            sizes[i] = (h, w)

        counts = [0 if s.rois is None else len(s.rois) for s in samples]
        p = pick_bucket(max(max(counts), 1), self.proposal_buckets)
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
        return Batch(images=torch.from_numpy(images),
                     image_sizes=torch.from_numpy(sizes),
                     boxes=torch.from_numpy(boxes),
                     box_mask=torch.from_numpy(mask),
                     labels=torch.from_numpy(labels))


def collator_from_cfg(cfg) -> BatchCollator:
    return BatchCollator(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
        size_divisibility=cfg.DATALOADER.SIZE_DIVISIBILITY,
        image_pad_multiple=cfg.TPU.IMAGE_PAD_MULTIPLE,
        proposal_buckets=tuple(cfg.TPU.PROPOSAL_BUCKETS),
    )
