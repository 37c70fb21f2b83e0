"""COCO dataset with precomputed proposals.

Counterpart of ``odwscl_tpu/data/coco_dataset.py`` (``MiniCOCO``,
``COCODataset``), without pycocotools: a json-backed index of images,
annotations and categories. Category ids map to contiguous class ids
1..C-1 in the order of the json ids (COCO's ids run 1-90 with gaps).
GT boxes convert from COCO's xywh to xyxy with the +1 convention
(x2 = x + w - 1); crowd annotations are left out of the GT and of the
partial labels. Proposals are cleaned as VOC's, with ``min_size`` 2. The
``point`` / ``scribble`` fields of the annotations become the samples'
clicks and scribble boxes (an empty scribble becomes the box [1, 2, 3, 4],
as in the reference). Host-side numpy; PIL is imported where images are
read.

``load_masks`` (``MODEL.MASK_ON``) gives each sample the non-crowd
annotations' ``segmentation`` as ``structures/masks.py`` ``Masks``: polygon
mode, or raster mode with every instance decoded when any of the image's
segmentations is RLE. ``load_keypoints`` (``MODEL.KEYPOINT_ON``) gives it
their ``keypoints`` as ``structures/keypoints.py`` ``PersonKeypoints``
[N, K, 3], K the longest annotation's count (17 when none has any),
shorter ones zero-padded.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

import numpy as np

from .proposals import ProposalStore
from .transforms import Sample


class MiniCOCO:
    """The parts of the pycocotools COCO API the pipeline uses."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {im["id"]: im for im in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        self.anns = {}
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def getImgIds(self):
        return sorted(self.imgs.keys())

    def getCatIds(self):
        return sorted(self.cats.keys())

    def loadImgs(self, ids):
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]


class COCODataset:
    """A COCO json split with its image directory and proposal file.
    ``remove_images_without_annotations`` (training) keeps only images
    with a non-crowd annotation. ``id_to_img_map`` maps dataset indices to
    json image ids."""

    def __init__(self, ann_file: str, img_dir: str,
                 remove_images_without_annotations: bool = True,
                 proposal_file: Optional[str] = None, min_size: float = 2.0,
                 load_masks: bool = False, load_keypoints: bool = False):
        self.load_masks = load_masks
        self.load_keypoints = load_keypoints
        self.coco = MiniCOCO(ann_file)
        self.root = img_dir
        ids = self.coco.getImgIds()
        if remove_images_without_annotations:
            ids = [i for i in ids if any(
                a.get("iscrowd", 0) == 0 for a in self.coco.img_to_anns[i])]
        self.ids = ids
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(self.coco.getCatIds())}
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()}
        self.id_to_img_map = dict(enumerate(self.ids))
        self.categories = {c["id"]: c["name"] for c in self.coco.cats.values()}
        self.proposals = (ProposalStore(proposal_file, min_size=min_size)
                          if proposal_file else None)

    def __len__(self):
        return len(self.ids)

    def get_origin_id(self, index):
        return self.ids[index]

    def get_img_info(self, index):
        im = self.coco.imgs[self.ids[index]]
        return {"height": im["height"], "width": im["width"],
                "file_name": im["file_name"]}

    def _annotations(self, index):
        return [a for a in self.coco.img_to_anns[self.ids[index]]
                if a.get("iscrowd", 0) == 0]

    def get_groundtruth(self, index):
        """boxes [N, 4] xyxy (+1 convention), contiguous labels [N],
        difficult [N] (all False), of the non-crowd annotations."""
        boxes, labels = [], []
        for a in self._annotations(index):
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + max(w - 1, 0), y + max(h - 1, 0)])
            labels.append(
                self.json_category_id_to_contiguous_id[a["category_id"]])
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int64),
                np.zeros(len(labels), bool))

    def _partial_labels(self, anns):
        """(clicks [K, 2], click labels, scribble boxes [S, 4], scribble
        labels), None where the annotations carry no such field (read from
        the first annotation, as the reference does)."""
        clicks = click_labels = scribbles = scribble_labels = None
        if not anns or not ("point" in anns[0] or "scribble" in anns[0]):
            return clicks, click_labels, scribbles, scribble_labels
        cls = np.asarray([self.json_category_id_to_contiguous_id[
            a["category_id"]] for a in anns], np.int64)
        if "point" in anns[0]:
            clicks = np.asarray([a["point"][:2] for a in anns],
                                np.float32).reshape(-1, 2)
            click_labels = cls
        if "scribble" in anns[0]:
            boxes = []
            for a in anns:
                xs, ys = a["scribble"][0], a["scribble"][1]
                boxes.append([1.0, 2.0, 3.0, 4.0] if len(xs) == 0 else
                             [min(xs), min(ys), max(xs), max(ys)])
            scribbles = np.asarray(boxes, np.float32).reshape(-1, 4)
            scribble_labels = cls
        return clicks, click_labels, scribbles, scribble_labels

    def __getitem__(self, index) -> Sample:
        from PIL import Image

        img_id = self.ids[index]
        info = self.coco.imgs[img_id]
        img = Image.open(os.path.join(self.root, info["file_name"])
                         ).convert("RGB")
        gt_boxes, gt_labels, gt_diff = self.get_groundtruth(index)
        w, h = img.size
        gt_boxes[:, 0::2] = gt_boxes[:, 0::2].clip(0, w - 1)
        gt_boxes[:, 1::2] = gt_boxes[:, 1::2].clip(0, h - 1)
        rois = (self.proposals.get(int(img_id), img.size)
                if self.proposals is not None else None)
        anns = self._annotations(index)
        clicks, click_labels, scribbles, scribble_labels = \
            self._partial_labels(anns)
        return Sample(image=img, size=img.size, gt_boxes=gt_boxes,
                      gt_labels=gt_labels, gt_difficult=gt_diff, rois=rois,
                      image_id=index, clicks=clicks,
                      click_labels=click_labels, scribbles=scribbles,
                      scribble_labels=scribble_labels,
                      gt_masks=(self._masks(anns, w, h) if self.load_masks
                                else None),
                      gt_keypoints=(self._keypoints(anns, w, h)
                                    if self.load_keypoints else None))

    @staticmethod
    def _keypoints(anns, w: int, h: int):
        """The annotations' ``keypoints`` (flat x, y, v triples) as one
        ``PersonKeypoints`` [N, K, 3]."""
        from ..structures.keypoints import PersonKeypoints

        kps = [a.get("keypoints", []) for a in anns]
        k = max((len(x) // 3 for x in kps), default=17) or 17
        arr = np.zeros((len(kps), k, 3), np.float32)
        for i, x in enumerate(kps):
            if x:
                pts = np.asarray(x, np.float32).reshape(-1, 3)[:k]
                arr[i, :len(pts)] = pts
        return PersonKeypoints(arr, (w, h))

    @staticmethod
    def _masks(anns, w: int, h: int):
        """The annotations' segmentations as one ``Masks``."""
        from ..structures.masks import Masks, rasterize_polygons
        from ..structures.rle import is_rle, rle_decode

        segs = [a.get("segmentation") or [] for a in anns]
        if not any(is_rle(s) for s in segs):
            return Masks(segs, (w, h), mode="poly")
        bit = [rle_decode(s) if is_rle(s) else rasterize_polygons(
            [np.asarray(p, np.float64) for p in s], h, w) for s in segs]
        return Masks(np.stack(bit) if bit else np.zeros((0, h, w)), (w, h),
                     mode="mask")

    def map_class_id_to_class_name(self, class_id):
        json_id = self.contiguous_category_id_to_json_id.get(class_id)
        return self.categories.get(json_id, str(class_id))
