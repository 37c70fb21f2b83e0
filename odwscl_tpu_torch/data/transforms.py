"""Host-side (CPU) transforms: colour jitter, PIL resize, flip, PCA
lighting, normalize.

Counterpart of ``odwscl_tpu/data/transforms.py`` (the WSOD,
partial-label, instance-mask and keypoint fields). GT masks
(``structures/masks.py``) and GT keypoints (``structures/keypoints.py``)
resize and flip with the image; a vertical flip of a sample with
keypoints raises, as in the JAX package (only the horizontal flip is
defined for them). Images
are PIL images until ``to_array``, then numpy HWC float32; boxes are numpy
[N, 4] xyxy. The train transform draws from a per-sample
``np.random.RandomState`` in the JAX package's order, so the same seed
gives the same arrays. PIL is imported inside the functions that use it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from ..structures.masks import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM


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
    # partial-label supervision (COCO ``point`` clicks and ``scribble``
    # boxes); the labels are contiguous class ids
    clicks: Optional[np.ndarray] = None           # [K, 2] (x, y)
    click_labels: Optional[np.ndarray] = None     # [K]
    scribbles: Optional[np.ndarray] = None        # [S, 4] xyxy
    scribble_labels: Optional[np.ndarray] = None  # [S]
    # supervised instance GT, one per GT box: structures.masks.Masks and
    # structures.keypoints.PersonKeypoints
    gt_masks: Optional[Any] = None
    gt_keypoints: Optional[Any] = None


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


IMAGENET_PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
IMAGENET_PCA_EIGVEC = np.array([
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
], np.float32)


def resize(sample: Sample, min_size, max_size: Optional[int],
           rng: Optional[np.random.RandomState] = None) -> Sample:
    """PIL BILINEAR resize of the image; boxes, clicks, scribbles, masks
    and keypoints scale with it. A sequence of ``min_size`` values picks
    one with ``rng``."""
    from PIL import Image

    if isinstance(min_size, (list, tuple)):
        min_size = min_size[rng.randint(len(min_size))]
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
                               rois=scale(sample.rois),
                               clicks=scale(sample.clicks),
                               scribbles=scale(sample.scribbles),
                               gt_masks=(None if sample.gt_masks is None
                                         else sample.gt_masks.resize(
                                             (ow, oh))),
                               gt_keypoints=(
                                   None if sample.gt_keypoints is None
                                   else sample.gt_keypoints.resize((ow, oh))))


def _flip_points(pts: Optional[np.ndarray], axis: int, extent: int):
    """Points [K, 2] mirrored along x (axis 0) or y (axis 1) of an image
    ``extent`` pixels wide or tall (+1 convention)."""
    if pts is None or len(pts) == 0:
        return pts
    out = pts.copy()
    out[:, axis] = extent - pts[:, axis] - 1
    return out


def _flip_masks(masks, method):
    return None if masks is None else masks.transpose(method)


def hflip(sample: Sample) -> Sample:
    """Horizontal flip with the +1 box convention (x' = W - 1 - x), for
    boxes, scribbles, clicks, masks and keypoints (left and right points
    swap)."""
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
                               rois=flip(sample.rois),
                               clicks=_flip_points(sample.clicks, 0, w),
                               scribbles=flip(sample.scribbles),
                               gt_masks=_flip_masks(sample.gt_masks,
                                                    FLIP_LEFT_RIGHT),
                               gt_keypoints=_flip_masks(sample.gt_keypoints,
                                                        FLIP_LEFT_RIGHT))


def to_array(sample: Sample) -> Sample:
    """PIL -> float32 HWC RGB in [0, 1] (F.to_tensor semantics)."""
    img = sample.image
    if not isinstance(img, np.ndarray):
        img = np.asarray(img, np.float32) / 255.0
    elif img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return dataclasses.replace(sample, image=img.astype(np.float32))


def color_jitter(sample: Sample, rng: np.random.RandomState,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0) -> Sample:
    """ColorJitter on PIL images in a random order; all-zero factors (the
    shipped default) make it a no-op that draws nothing."""
    if brightness == contrast == saturation == hue == 0.0:
        return sample
    from PIL import Image, ImageEnhance

    img = sample.image
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img.astype(np.uint8))
    ops = []
    for factor, enhancer in ((brightness, ImageEnhance.Brightness),
                             (contrast, ImageEnhance.Contrast),
                             (saturation, ImageEnhance.Color)):
        if factor > 0:
            f = rng.uniform(max(0, 1 - factor), 1 + factor)
            ops.append(lambda im, f=f, e=enhancer: e(im).enhance(f))
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def _hue(im, shift=shift):
            hsv = np.array(im.convert("HSV"), np.uint8)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                           + int(shift * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")

        ops.append(_hue)
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return dataclasses.replace(sample, image=img)


def vflip(sample: Sample) -> Sample:
    """Vertical flip with the +1 box convention (y' = H - 1 - y), for
    boxes, scribbles, clicks and masks. Raises with GT keypoints (their
    flip is defined left-right only)."""
    if sample.gt_keypoints is not None:
        raise NotImplementedError("vflip with gt_keypoints is undefined")
    img = sample.image
    if isinstance(img, np.ndarray):
        img = img[::-1]
    else:
        from PIL import Image
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    h = sample.size[1]

    def flip(b):
        if b is None or len(b) == 0:
            return b
        out = b.copy()
        out[:, 1] = h - b[:, 3] - 1
        out[:, 3] = h - b[:, 1] - 1
        return out

    return dataclasses.replace(sample, image=img,
                               gt_boxes=flip(sample.gt_boxes),
                               rois=flip(sample.rois),
                               clicks=_flip_points(sample.clicks, 1, h),
                               scribbles=flip(sample.scribbles),
                               gt_masks=_flip_masks(sample.gt_masks,
                                                    FLIP_TOP_BOTTOM))


def pca_lighting(sample: Sample, rng: np.random.RandomState,
                 alphastd: float = 0.1) -> Sample:
    """AlexNet-style PCA lighting noise on the RGB [0, 1] array."""
    if alphastd == 0:
        return sample
    alpha = rng.normal(0, alphastd, 3).astype(np.float32)
    rgb = (IMAGENET_PCA_EIGVEC * alpha[None, :]
           * IMAGENET_PCA_EIGVAL[None, :]).sum(axis=1)
    return dataclasses.replace(sample, image=sample.image + rgb[None, None, :])


def normalize(sample: Sample, mean: Sequence[float], std: Sequence[float],
              to_bgr255: bool = True) -> Sample:
    img = sample.image
    if to_bgr255:
        img = img[..., ::-1] * 255.0
    img = (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return dataclasses.replace(sample,
                               image=np.ascontiguousarray(img, np.float32))


@dataclasses.dataclass
class TrainTransform:
    """The train pipeline: colour jitter -> random-scale resize -> flips ->
    to-array -> PCA lighting (``INPUT.PCA``) -> normalize."""

    min_sizes: Sequence[int]
    max_size: int
    hflip_prob: float = 0.5
    vflip_prob: float = 0.0
    pixel_mean: Sequence[float] = (102.9801, 115.9465, 122.7717)
    pixel_std: Sequence[float] = (1.0, 1.0, 1.0)
    to_bgr255: bool = True
    pca: bool = True
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0

    def __call__(self, sample: Sample, rng: np.random.RandomState) -> Sample:
        sample = color_jitter(sample, rng, self.brightness, self.contrast,
                              self.saturation, self.hue)
        sample = resize(sample, tuple(self.min_sizes), self.max_size, rng)
        if rng.random_sample() < self.hflip_prob:
            sample = hflip(sample)
        if self.vflip_prob and rng.random_sample() < self.vflip_prob:
            sample = vflip(sample)
        sample = to_array(sample)
        if self.pca:
            sample = pca_lighting(sample, rng, 0.1)
        return normalize(sample, self.pixel_mean, self.pixel_std,
                         self.to_bgr255)


def build_train_transform(cfg) -> TrainTransform:
    sizes = cfg.INPUT.MIN_SIZE_TRAIN
    return TrainTransform(
        min_sizes=tuple(sizes) if isinstance(sizes, (tuple, list))
        else (sizes,),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN,
        hflip_prob=cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN,
        vflip_prob=cfg.INPUT.VERTICAL_FLIP_PROB_TRAIN,
        pixel_mean=tuple(cfg.INPUT.PIXEL_MEAN),
        pixel_std=tuple(cfg.INPUT.PIXEL_STD),
        to_bgr255=cfg.INPUT.TO_BGR255,
        pca=cfg.INPUT.PCA,
        brightness=cfg.INPUT.BRIGHTNESS,
        contrast=cfg.INPUT.CONTRAST,
        saturation=cfg.INPUT.SATURATION,
        hue=cfg.INPUT.HUE,
    )


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
