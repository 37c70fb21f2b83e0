"""Precomputed proposal pickles (Selective Search / MCG format).

Counterpart of ``odwscl_tpu/data/proposals.py``: the pickle holds
``{'boxes': [N_i x 4 arrays], 'indexes'|'ids': [image ids]}``. Per image the
proposals are deduplicated by coordinate hashing, clipped to the image and
boxes smaller than ``min_size`` are dropped.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def unique_boxes(boxes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Indices of unique boxes, original order."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def clean_proposals(boxes: np.ndarray, img_w: float, img_h: float,
                    min_size: float) -> np.ndarray:
    """Dedup + clip to the image + drop empty and small boxes."""
    boxes = np.asarray(boxes, np.float64)
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float32)
    rois = boxes[unique_boxes(boxes)].astype(np.float32)
    rois[:, 0::2] = rois[:, 0::2].clip(0, img_w - 1)
    rois[:, 1::2] = rois[:, 1::2].clip(0, img_h - 1)
    rois = rois[(rois[:, 2] > rois[:, 0]) & (rois[:, 3] > rois[:, 1])]
    if min_size > 0:
        ws = rois[:, 2] - rois[:, 0] + 1
        hs = rois[:, 3] - rois[:, 1] + 1
        rois = rois[(ws >= min_size) & (hs >= min_size)]
    return rois


class ProposalStore:
    """Loads a proposal pickle once and serves per-image cleaned proposals.

    The pickle is a file this program or the reference's tools wrote;
    unpickling runs code, so only load trusted files."""

    def __init__(self, proposal_file: str, min_size: float = 20.0):
        with open(proposal_file, "rb") as f:
            self.data = pickle.load(f, encoding="latin1")
        id_field = "indexes" if "indexes" in self.data else "ids"
        self.index_of = {int(i): k for k, i in enumerate(self.data[id_field])}
        self.min_size = min_size

    def get(self, image_id: int, image_size_wh) -> np.ndarray:
        idx = self.index_of[int(image_id)]
        w, h = image_size_wh
        return clean_proposals(self.data["boxes"][idx], w, h, self.min_size)


def write_proposal_pickle(path: str, boxes_list, ids_list, scores_list=None):
    """Write the reference pickle format."""
    data: Dict[str, object] = {
        "boxes": [np.asarray(b) for b in boxes_list],
        "indexes": [int(i) for i in ids_list],
    }
    if scores_list is not None:
        data["scores"] = [np.asarray(s) for s in scores_list]
    with open(path, "wb") as f:
        pickle.dump(data, f)
