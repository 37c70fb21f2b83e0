"""Instance masks on the host: polygons and binary rasters.

Counterpart of ``odwscl_tpu/structures/masks.py``: ``rasterize_polygons``,
``PolygonInstance``, ``BinaryMasks``, ``PolygonMasks`` and the ``Masks``
facade ("poly" or "mask" mode), each with transpose (flips, +1
convention), crop (clamped to the image, at least one pixel) and resize.
Only their rasters reach the device (the collator's ``gt_bitmasks``).

Polygons fill with PIL's even-odd ``ImageDraw.polygon`` (outline and fill
1), as in the JAX package, so rasters are identical; an instance's
polygon groups are unioned. ``BinaryMasks.resize`` is bilinear with
half-pixel centres and clamped edges, kept float until ``to_bitmasks``
thresholds at 0.5: the JAX package calls ``cv2.resize(INTER_LINEAR)``, the
port ``F.interpolate(bilinear, align_corners=False)`` on f32
(``resize_bilinear``, which the Masker uses too). RLE entries decode with
``structures/rle.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """f32 [H0, W0] -> [h, w]: half-pixel centres, edge clamp, no
    antialias (the rule of cv2's INTER_LINEAR)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None, None]
    return F.interpolate(t, size=(h, w), mode="bilinear",
                         align_corners=False)[0, 0].numpy()


def _clip_crop_box(box, width, height):
    """Clamp into the image, then force at least 1 px of extent."""
    xmin, ymin, xmax, ymax = map(float, box)
    if not (xmin <= xmax and ymin <= ymax):
        raise ValueError(f"malformed crop box {box}")
    xmin = min(max(xmin, 0), width - 1)
    ymin = min(max(ymin, 0), height - 1)
    xmax = min(max(xmax, 0), width)
    ymax = min(max(ymax, 0), height)
    return xmin, ymin, max(xmax, xmin + 1), max(ymax, ymin + 1)


def rasterize_polygons(polygons: Sequence[np.ndarray], height: int,
                       width: int) -> np.ndarray:
    """Union of filled polygons (flat [x0, y0, x1, y1, ...], COCO's) ->
    uint8 [H, W]; fewer than 3 points are skipped."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (max(int(width), 1), max(int(height), 1)), 0)
    draw = ImageDraw.Draw(img)
    for p in polygons:
        p = np.asarray(p, np.float64)
        if p.size < 6:
            continue
        draw.polygon([tuple(xy) for xy in p.reshape(-1, 2)], outline=1,
                     fill=1)
    return np.asarray(img, np.uint8)


class PolygonInstance:
    """One instance as a list of polygons (f32, at least a triangle each)
    on an image of ``size`` (w, h)."""

    def __init__(self, polygons, size):
        if isinstance(polygons, PolygonInstance):
            polygons = [p.copy() for p in polygons.polygons]
        else:
            polygons = [p for p in (np.asarray(q, np.float32).reshape(-1)
                                    for q in polygons) if p.size >= 6]
        self.polygons: List[np.ndarray] = polygons
        self.size = tuple(size)

    def transpose(self, method):
        if method not in (FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM):
            raise NotImplementedError(
                "Only FLIP_LEFT_RIGHT and FLIP_TOP_BOTTOM implemented")
        width, height = self.size
        dim, idx = ((width, 0) if method == FLIP_LEFT_RIGHT
                    else (height, 1))
        out = []
        for poly in self.polygons:
            p = poly.copy()
            p[idx::2] = dim - poly[idx::2] - 1
            out.append(p)
        return PolygonInstance(out, self.size)

    def crop(self, box):
        xmin, ymin, xmax, ymax = _clip_crop_box(box, *self.size)
        out = []
        for poly in self.polygons:
            p = poly.copy()          # the points themselves stay unclamped
            p[0::2] = p[0::2] - xmin
            p[1::2] = p[1::2] - ymin
            out.append(p)
        return PolygonInstance(out, (xmax - xmin, ymax - ymin))

    def resize(self, size):
        ratio_w = float(size[0]) / float(self.size[0])
        ratio_h = float(size[1]) / float(self.size[1])
        out = []
        for poly in self.polygons:
            p = poly.copy()
            p[0::2] *= ratio_w
            p[1::2] *= ratio_h
            out.append(p)
        return PolygonInstance(out, tuple(size))

    def to_bitmask(self) -> np.ndarray:
        w, h = self.size
        return rasterize_polygons(self.polygons, int(round(h)),
                                  int(round(w)))

    def __len__(self):
        return len(self.polygons)


class BinaryMasks:
    """[N, H, W] masks on an image of ``size`` (w, h); list entries may be
    COCO RLE dicts."""

    def __init__(self, masks: Union[np.ndarray, list], size):
        if isinstance(masks, BinaryMasks):
            masks = masks.masks.copy()
        elif isinstance(masks, (list, tuple)):
            from .rle import is_rle, rle_decode
            masks = [rle_decode(m) if is_rle(m) else np.asarray(m)
                     for m in masks]
            masks = (np.stack(masks) if masks
                     else np.zeros((0, size[1], size[0])))
        masks = np.asarray(masks)
        if masks.ndim == 2:
            masks = masks[None]
        if masks.ndim != 3 or masks.shape[1:] != (size[1], size[0]):
            raise ValueError(f"masks {masks.shape} do not fit size {size}")
        self.masks = masks
        self.size = tuple(size)

    def transpose(self, method):
        axis = 1 if method == FLIP_TOP_BOTTOM else 2
        return BinaryMasks(np.flip(self.masks, axis).copy(), self.size)

    def crop(self, box):
        """The box rounded, then clamped."""
        xmin, ymin, xmax, ymax = [int(v) for v in _clip_crop_box(
            [round(float(b)) for b in box], *self.size)]
        return BinaryMasks(self.masks[:, ymin:ymax, xmin:xmax],
                           (xmax - xmin, ymax - ymin))

    def resize(self, size):
        width, height = int(size[0]), int(size[1])
        if width <= 0 or height <= 0:
            raise ValueError(f"resize to {size}")
        if self.masks.shape[0] == 0:
            return BinaryMasks(np.zeros((0, height, width),
                                        self.masks.dtype), (width, height))
        out = np.stack([resize_bilinear(m.astype(np.float32), width, height)
                        for m in self.masks])
        return BinaryMasks(out, (width, height))

    def to_bitmasks(self) -> np.ndarray:
        return (np.asarray(self.masks, np.float32) > 0.5).astype(np.uint8)

    def __len__(self):
        return self.masks.shape[0]

    def __getitem__(self, index):
        sel = (self.masks[index]
               if isinstance(index, (slice, list, np.ndarray))
               else self.masks[np.asarray(index).reshape(-1)])
        return BinaryMasks(sel.reshape((-1,) + self.masks.shape[1:]),
                           self.size)


def _cropped_size(box, size):
    xmin, ymin, xmax, ymax = _clip_crop_box(box, size[0], size[1])
    return (xmax - xmin, ymax - ymin)


class PolygonMasks:
    """Every instance of one image as polygons."""

    def __init__(self, instances, size):
        self.instances: List[PolygonInstance] = [
            i if isinstance(i, PolygonInstance) else PolygonInstance(i, size)
            for i in instances]
        self.size = tuple(size)

    def transpose(self, method):
        return PolygonMasks([i.transpose(method) for i in self.instances],
                            self.size)

    def crop(self, box):
        out = [i.crop(box) for i in self.instances]
        return PolygonMasks(out, out[0].size if out
                            else _cropped_size(box, self.size))

    def resize(self, size):
        return PolygonMasks([i.resize(size) for i in self.instances],
                            tuple(size))

    def to_bitmasks(self) -> np.ndarray:
        w, h = self.size
        if not self.instances:
            return np.zeros((0, int(h), int(w)), np.uint8)
        return np.stack([i.to_bitmask() for i in self.instances])

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            sel = [self.instances[int(index)]]
        elif isinstance(index, slice):
            sel = self.instances[index]
        else:
            idx = np.asarray(index)
            if idx.dtype == bool:
                idx = np.nonzero(idx)[0]
            sel = [self.instances[int(i)] for i in idx]
        return PolygonMasks(sel, self.size)

    def __iter__(self):
        return iter(self.instances)


class Masks:
    """Polygon ("poly") or raster ("mask") instances behind one transpose /
    crop / resize / getitem surface."""

    def __init__(self, instances, size, mode: str = "poly"):
        if mode == "poly":
            inner = (instances if isinstance(instances, PolygonMasks)
                     else PolygonMasks(instances, size))
        elif mode == "mask":
            inner = (instances if isinstance(instances, BinaryMasks)
                     else BinaryMasks(instances, size))
        else:
            raise ValueError(f"unknown mask mode {mode!r}")
        self.inner, self.mode, self.size = inner, mode, tuple(size)

    def _wrap(self, inner):
        return Masks(inner, inner.size, self.mode)

    def transpose(self, method):
        return self._wrap(self.inner.transpose(method))

    def crop(self, box):
        return self._wrap(self.inner.crop(box))

    def resize(self, size):
        return self._wrap(self.inner.resize(size))

    def to_bitmasks(self) -> np.ndarray:
        return self.inner.to_bitmasks()

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index):
        return self._wrap(self.inner[index])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
