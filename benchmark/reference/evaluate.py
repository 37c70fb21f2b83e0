"""The reference's 14-transform TTA for one batch of images.

A frozen copy of the port's device-resize TTA (``engine/inference.py``:
``prep_base``, ``_device_resize_batches``, ``_flip_batch``,
``_unflip_boxes``, ``_rescale_boxes``, the AVG merge) and its
post-process (``engine/postprocess.py``: per-class NMS, the global top-K,
the boxes taken back to the original image's frame).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import data as D
from .ops import batched_nms_mask
from .precision import no_tf32


def tta_transforms(s: dict):
    """[(min_size, max_size, flip)] in the program's order: the test scale
    and its flip, then each TTA scale and its flip."""
    out = [(s["test_min"], s["test_max"], False),
           (s["test_min"], s["test_max"], True)]
    for m in s["tta_scales"]:
        out += [(m, s["tta_max"], False), (m, s["tta_max"], True)]
    return out


def _flip(batch: dict) -> dict:
    images, boxes = batch["images"], batch["boxes"]
    b, hh, ww, c = images.shape
    w = batch["image_sizes"][:, 1]
    idx = (w[:, None].to(torch.int64) - 1
           - torch.arange(ww, device=images.device)[None, :]) % ww
    flipped = torch.gather(images, 2,
                           idx[:, None, :, None].expand(b, hh, ww, c))
    wf = w[:, None]
    fboxes = torch.stack([wf - 1.0 - boxes[..., 2], boxes[..., 1],
                          wf - 1.0 - boxes[..., 0], boxes[..., 3]], -1)
    fboxes = torch.where(batch["box_mask"][..., None], fboxes, boxes)
    return {**batch, "images": flipped, "boxes": fboxes}


def _unflip(boxes, widths):
    b, p, k4 = boxes.shape
    bx = boxes.reshape(b, p, -1, 4)
    w = widths[:, None, None]
    return torch.stack([w - 1.0 - bx[..., 2], bx[..., 1],
                        w - 1.0 - bx[..., 0], bx[..., 3]], -1
                       ).reshape(b, p, k4)


def _rescale(boxes, rw, rh):
    b, p, k4 = boxes.shape
    bx = boxes.reshape(b, p, -1, 4)
    rw, rh = rw[:, None, None], rh[:, None, None]
    return torch.stack([bx[..., 0] * rw, bx[..., 1] * rh, bx[..., 2] * rw,
                        bx[..., 3] * rh], -1).reshape(b, p, k4)


def merged_outputs(det, samples: List[dict], s: dict, device):
    """AVG of the 14 forwards: (scores [B, P, C], boxes [B, P, 4C]) in the
    test scale's frame, the proposal mask, and each image's test-scale
    (w, h)."""
    base = D.collate([{**x, "image": D.normalize(D.to_array(x["image"]))}
                      for x in samples], np.zeros((len(samples), 1)),
                     s["size_div"], s["pad_multiple"], s["buckets"], device)
    in_hw = torch.tensor([[x["size"][1], x["size"][0]] for x in samples],
                         dtype=torch.float32, device=device)
    sum_scores = sum_boxes = ref_wh = None
    transforms = tta_transforms(s)
    for min_size, max_size, flip in transforms:
        tgt = torch.tensor([D.resize_size(x["size"], min_size, max_size)
                            for x in samples], dtype=torch.float32)
        m = s["pad_multiple"]
        canvas = (int(math.ceil(tgt[:, 0].max().item() / m) * m),
                  int(math.ceil(tgt[:, 1].max().item() / m) * m))
        tgt = tgt.to(device)
        batch = {**base,
                 "images": D.resize_image_batch(base["images"], in_hw, tgt,
                                                canvas),
                 "boxes": D.scale_boxes_batch(base["boxes"], in_hw, tgt),
                 "image_sizes": tgt}
        wh = tgt.flip(1)
        if flip:
            batch = _flip(batch)
        scores, boxes = det.eval_forward(batch)
        if flip:
            boxes = _unflip(boxes, wh[:, 0])
        if ref_wh is None:
            ref_wh, sum_scores, sum_boxes = wh, scores, boxes
        else:
            boxes = _rescale(boxes, ref_wh[:, 0] / wh[:, 0],
                             ref_wh[:, 1] / wh[:, 1])
            sum_scores, sum_boxes = sum_scores + scores, sum_boxes + boxes
    n = len(transforms)
    return sum_scores / n, sum_boxes / n, base["box_mask"], ref_wh


def finalize(boxes, scores, box_mask, nms_thresh: float,
             score_thresh: float, k: int):
    """Per-class NMS and the global top-K: [B, K] boxes, scores, labels,
    valid."""
    b, p, c = scores.shape
    boxes_c = boxes.reshape(b, p, c, 4)
    boxes_t = boxes_c.permute(0, 2, 1, 3)
    scores_t = scores.permute(0, 2, 1)
    mask = box_mask[:, None, :] & (scores_t > score_thresh)
    mask[:, 0, :] = False
    keep = batched_nms_mask(boxes_t, scores_t, mask, nms_thresh)
    flat = torch.where(keep, scores_t, torch.full((), -1.0,
                                                  device=scores.device)
                       ).reshape(b, c * p)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_labels = torch.div(top_idx, p, rounding_mode="floor")
    top_boxes = torch.gather(boxes_t.reshape(b, c * p, 4), 1,
                             top_idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, top_labels, top_scores > 0.0


def predict(det, samples: List[dict], s: dict, device
            ) -> Dict[str, list]:
    """Per image, in the original image's frame: the merged scores [P, C]
    and boxes [P, C, 4] (numpy), and the final detections."""
    with no_tf32():
        scores, boxes, mask, ref_wh = merged_outputs(det, samples, s, device)
    tb, ts, tl, tv = finalize(boxes, scores, mask, s["nms"],
                              s["score_thresh"], s["detections"])
    out = {"scores": [], "boxes": [], "mask": [], "dets": []}
    b, p, c = scores.shape
    for i, x in enumerate(samples):
        ow, oh = ref_wh[i].tolist()
        w, h = x["size"]
        ratio = np.array([w / ow, h / oh, w / ow, h / oh], np.float32)
        bx = boxes[i].reshape(p, c, 4).cpu().numpy() * ratio
        valid = tv[i].cpu().numpy()
        out["scores"].append(scores[i].cpu().numpy())
        out["boxes"].append(bx)
        out["mask"].append(mask[i].cpu().numpy())
        out["dets"].append({
            "boxes": tb[i].cpu().numpy()[valid] * ratio,
            "scores": ts[i].cpu().numpy()[valid],
            "labels": tl[i].cpu().numpy()[valid]})
    return out
