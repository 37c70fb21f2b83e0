"""Web images with image-level labels only (no boxes).

Counterpart of ``odwscl_tpu/data/flickr.py`` (``WebDataset``), for the
web-data experiments. The json holds ``{"images": [{"id", "file_name",
"labels": [class ids], "height"?, "width"?}], "categories": [...]}``; the
labels are contiguous class ids. PIL is imported where images are read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .proposals import ProposalStore
from .transforms import Sample


class WebDataset:
    def __init__(self, ann_file: str, img_dir: str,
                 proposal_file: Optional[str] = None, min_size: float = 2.0,
                 **_):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = data["images"]
        self.root = img_dir
        self.categories = {c["id"]: c["name"]
                           for c in data.get("categories", [])}
        self.ids = [im["id"] for im in self.images]
        self.id_to_img_map = dict(enumerate(self.ids))
        self.proposals = (ProposalStore(proposal_file, min_size=min_size)
                          if proposal_file else None)

    def __len__(self):
        return len(self.images)

    def get_origin_id(self, index):
        return self.ids[index]

    def get_img_info(self, index):
        im = self.images[index]
        if "height" in im:
            return {"height": im["height"], "width": im["width"],
                    "file_name": im["file_name"]}
        from PIL import Image
        with Image.open(os.path.join(self.root, im["file_name"])) as img:
            return {"height": img.size[1], "width": img.size[0],
                    "file_name": im["file_name"]}

    def __getitem__(self, index) -> Sample:
        from PIL import Image

        im = self.images[index]
        img = Image.open(os.path.join(self.root, im["file_name"])
                         ).convert("RGB")
        rois = (self.proposals.get(int(im["id"]), img.size)
                if self.proposals is not None else None)
        return Sample(image=img, size=img.size,
                      gt_boxes=np.zeros((0, 4), np.float32),
                      gt_labels=np.asarray(im.get("labels", []), np.int64),
                      gt_difficult=np.zeros(0, bool), rois=rois,
                      image_id=index)

    def map_class_id_to_class_name(self, class_id):
        return self.categories.get(class_id, str(class_id))
