"""The reference's input path: the training sampler's order, the train and
eval transforms, collation, and the eval's device resize.

Frozen copies of the port's ``data/samplers.py`` (an epoch's
aspect-grouped batches), ``data/transforms.py`` (the random-scale PIL
resize, flip, PCA lighting, normalize, each drawn from the per-sample
``RandomState`` in the same order), ``data/collate.py`` (padding to
``SIZE_DIVISIBILITY`` then ``IMAGE_PAD_MULTIPLE``, proposals to their
bucket), ``data/proposals.py`` (the numpy proposal cleaning) and
``ops/device_resize.py`` (PIL's triangle filter as two f32 products).
Samples are dicts: ``image`` (PIL image or float32 HWC array), ``size``
(w, h), ``rois`` [N, 4].
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

PIXEL_MEAN = (102.9801, 115.9465, 122.7717)
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)


def epoch_batches(n: int, batch_size: int, groups: np.ndarray, epoch: int
                  ) -> List[np.ndarray]:
    """One epoch's batches of dataset indices, each within one aspect
    group, shuffled with ``RandomState(epoch)``."""
    rng = np.random.RandomState(epoch)
    order = rng.permutation(n)
    total = int(np.ceil(n / batch_size)) * batch_size
    order = np.concatenate([order, order[: total - n]])
    batches = []
    for g in np.unique(groups):
        sel = order[groups[order] == g]
        for k in range(0, len(sel) - batch_size + 1, batch_size):
            batches.append(sel[k:k + batch_size])
    rng.shuffle(batches)
    return batches


def first_batches(n: int, batch_size: int, groups: np.ndarray, count: int
                  ) -> List[np.ndarray]:
    """The dataset indices of iterations 0 .. count-1."""
    out, epoch = [], 0
    while len(out) < count:
        out += epoch_batches(n, batch_size, groups, epoch)
        epoch += 1
    return out[:count]


def clean_proposals(boxes: np.ndarray, w: int, h: int, min_size: float
                    ) -> np.ndarray:
    """Dedup (coordinates hashed), clip to the image, drop small boxes."""
    boxes = np.asarray(boxes, np.float64)
    hashes = np.round(boxes).dot(np.array([1, 1e3, 1e6, 1e9]))
    _, index = np.unique(hashes, return_index=True)
    rois = boxes[np.sort(index)].astype(np.float32)
    rois[:, 0::2] = rois[:, 0::2].clip(0, w - 1)
    rois[:, 1::2] = rois[:, 1::2].clip(0, h - 1)
    rois = rois[(rois[:, 2] > rois[:, 0]) & (rois[:, 3] > rois[:, 1])]
    ws = rois[:, 2] - rois[:, 0] + 1
    hs = rois[:, 3] - rois[:, 1] + 1
    return rois[(ws >= min_size) & (hs >= min_size)]


def resize_size(size_wh, min_size: int, max_size: int):
    """(oh, ow) of the shortest-side resize capped at ``max_size``."""
    w, h = size_wh
    size = min_size
    min_orig, max_orig = float(min(w, h)), float(max(w, h))
    if max_orig / min_orig * size > max_size:
        size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        return (int(size * h / w), size)
    return (size, int(size * w / h))


def _resize(sample: dict, min_size: int, max_size: int) -> dict:
    from PIL import Image

    oh, ow = resize_size(sample["size"], min_size, max_size)
    w, h = sample["size"]
    rois = sample["rois"].astype(np.float32).copy()
    rois[:, 0::2] *= ow / w
    rois[:, 1::2] *= oh / h
    return {**sample, "image": sample["image"].resize((ow, oh),
                                                      Image.BILINEAR),
            "size": (ow, oh), "rois": rois}


def _hflip(sample: dict) -> dict:
    from PIL import Image

    w = sample["size"][0]
    b = sample["rois"]
    out = b.copy()
    out[:, 0] = w - b[:, 2] - 1
    out[:, 2] = w - b[:, 0] - 1
    return {**sample, "image": sample["image"].transpose(
        Image.FLIP_LEFT_RIGHT), "rois": out}


def normalize(img: np.ndarray) -> np.ndarray:
    """RGB [0, 1] HWC -> BGR * 255 - mean."""
    img = img[..., ::-1] * 255.0
    return np.ascontiguousarray(img - np.asarray(PIXEL_MEAN, np.float32),
                                np.float32)


def to_array(image) -> np.ndarray:
    return np.asarray(image, np.float32) / 255.0


def train_transform(sample: dict, rng: np.random.RandomState,
                    min_sizes: Sequence[int], max_size: int) -> dict:
    """Random scale, flip with probability 0.5, PCA lighting, normalize."""
    sample = _resize(sample, min_sizes[rng.randint(len(min_sizes))],
                     max_size)
    if rng.random_sample() < 0.5:
        sample = _hflip(sample)
    img = to_array(sample["image"])
    alpha = rng.normal(0, 0.1, 3).astype(np.float32)
    img = img + (PCA_EIGVEC * alpha[None, :]
                 * PCA_EIGVAL[None, :]).sum(axis=1)[None, None, :]
    return {**sample, "image": normalize(img)}


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def collate(samples: List[dict], labels: np.ndarray, size_div: int,
            pad_multiple: int, buckets: Sequence[int], device) -> dict:
    """Padded batch tensors on ``device``: images [B, H, W, 3],
    image_sizes [B, 2] (h, w), boxes [B, P, 4], box_mask, labels."""
    b = len(samples)
    ph = _round_up(_round_up(max(s["image"].shape[0] for s in samples),
                             size_div), pad_multiple)
    pw = _round_up(_round_up(max(s["image"].shape[1] for s in samples),
                             size_div), pad_multiple)
    n = max(len(s["rois"]) for s in samples)
    p = next((k for k in sorted(buckets) if n <= k), max(buckets))
    images = np.zeros((b, ph, pw, 3), np.float32)
    sizes = np.zeros((b, 2), np.float32)
    boxes = np.zeros((b, p, 4), np.float32)
    mask = np.zeros((b, p), bool)
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[i, :h, :w] = s["image"]
        sizes[i] = (h, w)
        k = min(len(s["rois"]), p)
        boxes[i, :k] = s["rois"][:k]
        mask[i, :k] = True
    out = {"images": images, "image_sizes": sizes, "boxes": boxes,
           "box_mask": mask, "labels": labels.astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def image_labels(classes: np.ndarray, num_classes: int) -> np.ndarray:
    lab = np.zeros((num_classes,), np.float32)
    lab[np.unique(classes).astype(np.int64)] = 1.0
    lab[0] = 0.0
    return lab


# -- the device resize of the eval's TTA scales ---------------------------
def triangle_weights(out_pad: int, in_pad: int, valid_in, valid_out):
    valid_in = valid_in.to(torch.float32)[..., None, None]
    valid_out = valid_out.to(torch.float32)[..., None, None]
    dev = valid_in.device
    scale = valid_in / torch.clamp(valid_out, min=1.0)
    fs = torch.clamp(scale, min=1.0)
    i = torch.arange(out_pad, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(in_pad, dtype=torch.float32, device=dev)[None, :]
    center = (i + 0.5) * scale
    w = torch.clamp(1.0 - torch.abs(j + 0.5 - center) / fs, min=0.0)
    w = torch.where(j < valid_in, w, 0.0)
    w = torch.where(i < valid_out, w, 0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)


def resize_image_batch(images, in_sizes, out_sizes, out_hw):
    """[B, H0, W0, C] -> [B, H1, W1, C]: each valid region resized to its
    target (h, w), zero beyond."""
    h1, w1 = out_hw
    b, h0, w0, c = images.shape
    ry = triangle_weights(h1, h0, in_sizes[:, 0], out_sizes[:, 0])
    rx = triangle_weights(w1, w0, in_sizes[:, 1], out_sizes[:, 1])
    t = torch.bmm(ry, images.to(torch.float32).reshape(b, h0, w0 * c))
    t = t.reshape(b, h1, w0, c).transpose(1, 2).reshape(b, w0, h1 * c)
    out = torch.bmm(rx, t).reshape(b, w1, h1, c).transpose(1, 2)
    return out.contiguous()


def scale_boxes_batch(boxes, in_sizes, out_sizes):
    r = out_sizes.to(torch.float32) / torch.clamp(in_sizes.to(torch.float32),
                                                  min=1.0)
    rh, rw = r[:, 0:1], r[:, 1:2]
    return torch.stack([boxes[..., 0] * rw, boxes[..., 1] * rh,
                        boxes[..., 2] * rw, boxes[..., 3] * rh], dim=-1)
