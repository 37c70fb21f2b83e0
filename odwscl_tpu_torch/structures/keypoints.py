"""Keypoint structures and the heatmap projection.

Counterpart of ``odwscl_tpu/structures/keypoints.py``: ``Keypoints``
(resize, horizontal flip), ``PersonKeypoints`` (COCO's 17 names and the
left/right flip map), ``Click`` (unordered points) and
``keypoints_to_heatmap``. The containers are host numpy (the data
pipeline); ``keypoints_to_heatmap`` runs on the tensors' device.

The projection casts floats to int32 as XLA does: saturating, NaN to 0.
A torch cast of NaN, an infinity or an out-of-range float is
implementation-defined (INT_MIN on the CPU), and such values occur: a
padded roi of zeros has an infinite scale, a keypoint far off its roi
overflows. ``saturating_int32`` gives the CPU and the card XLA's values,
so ``lin_ind`` and ``valid`` equal the JAX package's everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


class Keypoints:
    """[N, K, 3] (x, y, visibility) keypoints of one image of ``size`` (w,
    h)."""

    FLIP_INDS: np.ndarray = None  # subclasses define

    def __init__(self, keypoints, size, mode=None):
        kp = np.asarray(keypoints, np.float32)
        if kp.size == 0:
            kp = kp.reshape(0, 0, 3)
        self.keypoints = kp
        self.size = tuple(size)
        self.mode = mode
        self.extra_fields = {}

    def _like(self, data, size=None) -> "Keypoints":
        out = type(self)(data, size or self.size, self.mode)
        out.extra_fields = dict(self.extra_fields)
        return out

    def resize(self, size) -> "Keypoints":
        data = self.keypoints.copy()
        data[..., 0] *= float(size[0]) / float(self.size[0])
        data[..., 1] *= float(size[1]) / float(self.size[1])
        return self._like(data, size)

    def transpose(self, method) -> "Keypoints":
        """The horizontal flip: the left/right points swap (``FLIP_INDS``),
        x' = W - x - 1, and invisible points become (0, 0, 0)."""
        if method != FLIP_LEFT_RIGHT:
            raise NotImplementedError("Only FLIP_LEFT_RIGHT implemented")
        data = self.keypoints[:, type(self).FLIP_INDS].copy()
        data[..., 0] = self.size[0] - data[..., 0] - 1
        data[data[..., 2] == 0] = 0
        return self._like(data)

    def add_field(self, field, data):
        self.extra_fields[field] = data

    def get_field(self, field):
        return self.extra_fields[field]

    def __getitem__(self, item) -> "Keypoints":
        out = type(self)(self.keypoints[item], self.size, self.mode)
        for k, v in self.extra_fields.items():
            out.add_field(k, v[item])
        return out

    def __len__(self):
        return self.keypoints.shape[0]


def _create_flip_indices(names, flip_map):
    full = dict(flip_map)
    full.update({v: k for k, v in flip_map.items()})
    return np.asarray([names.index(full.get(n, n)) for n in names])


class PersonKeypoints(Keypoints):
    NAMES = [
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip",
        "left_knee", "right_knee", "left_ankle", "right_ankle",
    ]
    FLIP_MAP = {
        "left_eye": "right_eye", "left_ear": "right_ear",
        "left_shoulder": "right_shoulder", "left_elbow": "right_elbow",
        "left_wrist": "right_wrist", "left_hip": "right_hip",
        "left_knee": "right_knee", "left_ankle": "right_ankle",
    }


PersonKeypoints.FLIP_INDS = _create_flip_indices(PersonKeypoints.NAMES,
                                                 PersonKeypoints.FLIP_MAP)


class Click(Keypoints):
    """Point supervision (x, y, 1) per annotation: the flip mirrors x and
    keeps the order and the visibility (clicks are unordered)."""

    def transpose(self, method) -> "Click":
        if method != FLIP_LEFT_RIGHT:
            raise NotImplementedError("Only FLIP_LEFT_RIGHT implemented")
        data = self.keypoints.copy()
        data[..., 0] = self.size[0] - data[..., 0] - 1
        return self._like(data)


def saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 cast: truncation toward zero, out-of-range
    values and infinities saturate, NaN gives 0 (exact for every f32, in
    f64)."""
    return (x.double().nan_to_num(0.0, _INT32_MAX, _INT32_MIN)
            .clamp(_INT32_MIN, _INT32_MAX).to(torch.int32))


def keypoints_to_heatmap(keypoints: torch.Tensor, rois: torch.Tensor,
                         heatmap_size: int):
    """keypoints [N, K, 3] and rois [N, 4] -> (lin_ind [N, K] int32, the
    flat heatmap cell, 0 where invalid; valid [N, K] int32): a point
    exactly on the roi's right (bottom) edge goes to the last cell, points
    outside the roi or invisible are invalid."""
    offset_x = rois[:, 0:1]
    offset_y = rois[:, 1:2]
    scale_x = heatmap_size / (rois[:, 2:3] - rois[:, 0:1])
    scale_y = heatmap_size / (rois[:, 3:4] - rois[:, 1:2])
    x = keypoints[..., 0]
    y = keypoints[..., 1]
    xi = saturating_int32(torch.floor((x - offset_x) * scale_x))
    yi = saturating_int32(torch.floor((y - offset_y) * scale_y))
    last = torch.tensor(heatmap_size - 1, dtype=torch.int32,
                        device=keypoints.device)
    xi = torch.where(x == rois[:, 2:3], last, xi)
    yi = torch.where(y == rois[:, 3:4], last, yi)
    valid = ((xi >= 0) & (yi >= 0) & (xi < heatmap_size)
             & (yi < heatmap_size) & (keypoints[..., 2] > 0)).to(torch.int32)
    # invalid entries may hold saturated values: zero them before the
    # arithmetic (XLA's int32 wraps to the same 0 after the product)
    lin = torch.where(valid.bool(), yi * heatmap_size + xi, 0)
    return lin.to(torch.int32), valid
