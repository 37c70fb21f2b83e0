"""PASCAL VOC dataset: ImageSets split, XML annotations, proposal pickle.

Counterpart of ``odwscl_tpu/data/voc.py``. GT boxes are 0-based (XML - 1).
Host-side numpy only; padding happens in the collator.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from .proposals import ProposalStore
from .transforms import Sample

VOC_CLASSES = (
    "__background__ ", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


class PascalVOCDataset:
    CLASSES = VOC_CLASSES

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False,
                 proposal_file: Optional[str] = None, min_size: float = 20.0):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult
        self._annopath = os.path.join(self.root, "Annotations", "%s.xml")
        self._imgpath = os.path.join(self.root, "JPEGImages", "%s.jpg")
        self._imgsetpath = os.path.join(self.root, "ImageSets", "Main",
                                        "%s.txt")
        with open(self._imgsetpath % split) as f:
            self.ids = [x.strip() for x in f.readlines()]
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.proposals = (ProposalStore(proposal_file, min_size=min_size)
                          if proposal_file else None)

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index):
        img_id = self.ids[index]
        if os.path.exists(self._annopath % img_id):
            size = ET.parse(self._annopath % img_id).getroot().find("size")
            return {"height": int(size.find("height").text),
                    "width": int(size.find("width").text),
                    "file_name": f"JPEGImages/{img_id}.jpg"}
        from PIL import Image
        with Image.open(self._imgpath % img_id) as im:
            return {"height": im.size[1], "width": im.size[0],
                    "file_name": f"JPEGImages/{img_id}.jpg"}

    def get_groundtruth(self, index):
        """boxes [N,4] (0-based xyxy), labels [N], difficult [N] bool."""
        img_id = self.ids[index]
        anno = ET.parse(self._annopath % img_id).getroot()
        boxes, labels, difficult = [], [], []
        for obj in anno.iter("object"):
            is_difficult = int(obj.find("difficult").text) == 1
            if not self.keep_difficult and is_difficult:
                continue
            bb = obj.find("bndbox")
            boxes.append([int(bb.find(k).text) - 1
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(
                self.class_to_ind[obj.find("name").text.lower().strip()])
            difficult.append(is_difficult)
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int64),
                np.asarray(difficult, bool))

    def __getitem__(self, index) -> Sample:
        from PIL import Image

        img_id = self.ids[index]
        img = Image.open(self._imgpath % img_id).convert("RGB")
        if os.path.exists(self._annopath % img_id):
            gt_boxes, gt_labels, gt_diff = self.get_groundtruth(index)
            w, h = img.size
            gt_boxes[:, 0::2] = gt_boxes[:, 0::2].clip(0, w - 1)
            gt_boxes[:, 1::2] = gt_boxes[:, 1::2].clip(0, h - 1)
            keep = ((gt_boxes[:, 2] > gt_boxes[:, 0])
                    & (gt_boxes[:, 3] > gt_boxes[:, 1]))
            gt_boxes, gt_labels, gt_diff = (gt_boxes[keep], gt_labels[keep],
                                            gt_diff[keep])
        else:
            gt_boxes = gt_labels = gt_diff = None
        rois = (self.proposals.get(int(img_id), img.size)
                if self.proposals is not None else None)
        return Sample(image=img, size=img.size, gt_boxes=gt_boxes,
                      gt_labels=gt_labels, gt_difficult=gt_diff, rois=rois,
                      image_id=index)

    def map_class_id_to_class_name(self, class_id):
        return VOC_CLASSES[class_id]
