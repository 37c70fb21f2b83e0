"""Synthetic datasets for the benchmark, written from ``--seed``.

A frozen, resized copy of the VOC and COCO writers of the port
(``odwscl_tpu_torch/data/synthetic.py``): the same on-disk layouts that
``data/build.py:build_dataset`` reads (JPEGs, VOC XML or COCO JSON
annotations, proposal pickles), at the sizes a configuration's
``dataset`` block states. Kept here so that the yardstick does not move
when the program's writer changes.

Every seed gets the same image sizes in the same order (the configuration
fixes them per index): the seed draws the pixels, the objects and their
classes, and the proposals. The records returned hold what was written, so
that the reference can read the same files and know their labels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import List, Tuple

import numpy as np

VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")

# COCO's 80 category ids (1-90 with COCO's gaps); the names do not matter
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91) if i not in (
    12, 26, 29, 30, 45, 66, 68, 69, 71, 83))

_VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""
_VOC_OBJ = """<object>
    <name>{name}</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""


@dataclasses.dataclass
class ImageRecord:
    """One written image: its file, size (w, h), contiguous class labels
    (1..C-1) and proposals [P, 4] (xyxy, in the image's pixels, as written
    to the pickle)."""

    path: str
    size: Tuple[int, int]
    labels: np.ndarray
    proposals: np.ndarray


def image_sizes(shape: dict, n: int) -> List[Tuple[int, int]]:
    """(w, h) of image 0..n-1: the long side ``long_side``, the short side
    cycling through ``short_sides``, every ``portrait_every``-th image
    portrait. The same for every seed."""
    long_side = int(shape["long_side"])
    shorts = [int(s) for s in shape["short_sides"]]
    every = int(shape["portrait_every"])
    out = []
    for i in range(n):
        short = shorts[i % len(shorts)]
        portrait = every > 0 and i % every == every - 1
        out.append((short, long_side) if portrait else (long_side, short))
    return out


def draw_proposals(rng: np.random.Generator, w: int, h: int, n: int
                   ) -> np.ndarray:
    """``n`` distinct integer boxes drawn as the port's
    ``tools/profile_train.py:synthetic_batch`` draws them (corner uniform
    in [0, size - 40), width and height uniform in [20, 0.6 x the short
    side), cut at the image), each at least 20 px wide and tall, so that
    the dataset's proposal cleaning keeps all of them."""
    boxes = np.zeros((0, 4), np.float32)
    while len(boxes) < n:
        m = 2 * (n - len(boxes))
        xy = np.floor(rng.uniform(0, [w - 40, h - 40], (m, 2)))
        wh = np.floor(rng.uniform(20, 0.6 * min(h, w), (m, 2)))
        new = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1)
        allb = np.concatenate([boxes, new.astype(np.float32)])
        _, first = np.unique(allb, axis=0, return_index=True)
        boxes = allb[np.sort(first)]
    return boxes[:n]


def _draw_image(rng: np.random.Generator, w: int, h: int, k: int,
                num_fg: int, obj_frac=(0.15, 0.6)):
    """Background noise with ``k`` coloured rectangles of distinct classes;
    returns (uint8 image, classes 1..num_fg, GT boxes)."""
    img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
    classes = rng.choice(np.arange(1, num_fg + 1), k, replace=False)
    boxes = []
    for c in classes:
        ow = int(rng.uniform(*obj_frac) * w)
        oh = int(rng.uniform(*obj_frac) * h)
        x1 = int(rng.integers(0, w - ow))
        y1 = int(rng.integers(0, h - oh))
        img[y1:y1 + oh, x1:x1 + ow] = ((c * 37) % 255, (c * 91) % 255,
                                       (c * 151) % 255)
        boxes.append((x1, y1, x1 + ow - 1, y1 + oh - 1))
    return img, classes.astype(np.int64), np.asarray(boxes, np.float32)


def _write_pickle(path: str, boxes, ids) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"boxes": [np.asarray(b) for b in boxes],
                     "indexes": [int(i) for i in ids]}, f)


def write_split(root: str, dataset: str, proposal_file: str, shape: dict,
                seed: int) -> List[ImageRecord]:
    """Write ``dataset`` (a VOC07 or COCO14 catalog name) with its
    proposal pickle under ``root``; returns the records in dataset order."""
    from PIL import Image

    n = int(shape["images_per_split"])
    lo, hi = shape["labels_per_image"]
    n_props = int(shape["proposals"])
    rng = np.random.default_rng([seed, sum(map(ord, dataset))])
    voc = dataset.startswith("voc_")
    if voc:
        split = dataset.rsplit("_", 1)[1]
        base = os.path.join(root, "voc", "VOC2007")
        for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        num_fg = len(VOC_CLASSES)
    else:
        year_split = dataset.split("_", 1)[1]          # "2014_train"
        year, split = year_split.split("_", 1)
        img_dir = os.path.join(root, "coco", f"{split}{year}")
        os.makedirs(img_dir, exist_ok=True)
        num_fg = len(COCO_CATEGORY_IDS)
    records, images, anns, ids = [], [], [], []
    for i, (w, h) in enumerate(image_sizes(shape, n)):
        k = int(rng.integers(lo, hi + 1))
        img, classes, gt = _draw_image(rng, w, h, k, num_fg)
        props = draw_proposals(rng, w, h, n_props)
        if voc:
            img_id = f"{i + 1:06d}"
            path = os.path.join(base, "JPEGImages", f"{img_id}.jpg")
            objects = "\n  ".join(_VOC_OBJ.format(
                name=VOC_CLASSES[c - 1], x1=int(b[0]) + 1, y1=int(b[1]) + 1,
                x2=int(b[2]) + 1, y2=int(b[3]) + 1)
                for c, b in zip(classes, gt))
            with open(os.path.join(base, "Annotations", f"{img_id}.xml"),
                      "w") as f:
                f.write(_VOC_XML.format(w=w, h=h, objects=objects))
            ids.append(i + 1)
        else:
            img_id = i + 1
            path = os.path.join(img_dir, f"{img_id:012d}.jpg")
            images.append({"id": img_id, "file_name": f"{img_id:012d}.jpg",
                           "height": h, "width": w})
            for c, b in zip(classes, gt):
                bw, bh = float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)
                anns.append({"id": len(anns) + 1, "image_id": img_id,
                             "category_id": COCO_CATEGORY_IDS[c - 1],
                             "bbox": [float(b[0]), float(b[1]), bw, bh],
                             "area": bw * bh, "iscrowd": 0,
                             "segmentation": [[float(b[0]), float(b[1]),
                                               float(b[2]), float(b[1]),
                                               float(b[2]), float(b[3]),
                                               float(b[0]), float(b[3])]]})
            ids.append(img_id)
        Image.fromarray(img).save(path, quality=90)
        records.append(ImageRecord(path, (w, h), classes, props))
    if voc:
        with open(os.path.join(base, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(f"{i:06d}" for i in ids) + "\n")
    else:
        ann_dir = os.path.join(root, "coco", "annotations")
        os.makedirs(ann_dir, exist_ok=True)
        with open(os.path.join(ann_dir, f"instances_{split}{year}.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": str(c)}
                                      for c in COCO_CATEGORY_IDS]}, f)
    _write_pickle(os.path.join(root, proposal_file),
                  [r.proposals for r in records], ids)
    return records
