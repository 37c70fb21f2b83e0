"""Host-side (CPU) eval transforms: PIL resize, flip, normalize.

Counterpart of the eval part of ``odwscl_tpu/data/transforms.py``. Images
are PIL images until ``to_array``, then numpy HWC float32; boxes are numpy
[N, 4] xyxy. PIL is imported inside the functions that use it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    """One image with its (optional) GT boxes and proposals, all in the
    current image's coordinate frame."""

    image: Any                            # PIL.Image.Image or np.ndarray
    size: Tuple[int, int]                 # (w, h) current
    gt_boxes: Optional[np.ndarray] = None
    gt_labels: Optional[np.ndarray] = None
    gt_difficult: Optional[np.ndarray] = None
    rois: Optional[np.ndarray] = None
    image_id: Optional[object] = None


def get_resize_size(size_wh: Tuple[int, int], min_size: int,
                    max_size: Optional[int]) -> Tuple[int, int]:
    """(oh, ow) shortest-side resize with a cap on the longest side."""
    w, h = size_wh
    size = min_size
    if max_size is not None:
        min_orig, max_orig = float(min(w, h)), float(max(w, h))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return (oh, ow)


def resize(sample: Sample, min_size: int, max_size: Optional[int]) -> Sample:
    """PIL BILINEAR resize of the image; boxes scale with it."""
    from PIL import Image

    oh, ow = get_resize_size(sample.size, int(min_size), max_size)
    w, h = sample.size
    img = sample.image
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img.astype(np.uint8))
    img = img.resize((ow, oh), Image.BILINEAR)
    rw, rh = ow / w, oh / h

    def scale(b):
        if b is None or len(b) == 0:
            return b
        out = b.astype(np.float32).copy()
        out[:, 0::2] *= rw
        out[:, 1::2] *= rh
        return out

    return dataclasses.replace(sample, image=img, size=(ow, oh),
                               gt_boxes=scale(sample.gt_boxes),
                               rois=scale(sample.rois))


def hflip(sample: Sample) -> Sample:
    """Horizontal flip with the +1 box convention (x' = W - 1 - x)."""
    img = sample.image
    if isinstance(img, np.ndarray):
        img = img[:, ::-1]
    else:
        from PIL import Image
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    w = sample.size[0]

    def flip(b):
        if b is None or len(b) == 0:
            return b
        out = b.copy()
        out[:, 0] = w - b[:, 2] - 1
        out[:, 2] = w - b[:, 0] - 1
        return out

    return dataclasses.replace(sample, image=img,
                               gt_boxes=flip(sample.gt_boxes),
                               rois=flip(sample.rois))


def to_array(sample: Sample) -> Sample:
    """PIL -> float32 HWC RGB in [0, 1] (F.to_tensor semantics)."""
    img = sample.image
    if not isinstance(img, np.ndarray):
        img = np.asarray(img, np.float32) / 255.0
    elif img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return dataclasses.replace(sample, image=img.astype(np.float32))


def normalize(sample: Sample, mean: Sequence[float], std: Sequence[float],
              to_bgr255: bool = True) -> Sample:
    img = sample.image
    if to_bgr255:
        img = img[..., ::-1] * 255.0
    img = (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return dataclasses.replace(sample,
                               image=np.ascontiguousarray(img, np.float32))


@dataclasses.dataclass
class EvalTransform:
    min_size: int
    max_size: int
    pixel_mean: Sequence[float] = (102.9801, 115.9465, 122.7717)
    pixel_std: Sequence[float] = (1.0, 1.0, 1.0)
    to_bgr255: bool = True
    flip: bool = False

    def __call__(self, sample: Sample) -> Sample:
        sample = resize(sample, self.min_size, self.max_size)
        if self.flip:
            sample = hflip(sample)
        sample = to_array(sample)
        return normalize(sample, self.pixel_mean, self.pixel_std,
                         self.to_bgr255)
