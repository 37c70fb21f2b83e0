"""VOC detection mAP and CorLoc evaluation (numpy, host-side).

Reference: wetectron/data/datasets/evaluation/voc/voc_eval.py (chainercv-
style 11-point VOC07 mAP, difficult-aware greedy matching, integer-box +1
adjustment at :179-183) and voc_eval_old.py:252-411 (dis_eval CorLoc:
per image/class top-1 box, hit if IoU > 0.5 with any GT of the class).

Predictions are per-image dicts {"boxes" [N,4] (in original image coords),
"scores" [N], "labels" [N]}.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger("odwscl_tpu_torch.eval")


def _iou_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] -> [N,M] IoU with the +1 convention."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def calc_detection_voc_prec_rec(gt_list, pred_list, iou_thresh: float = 0.5):
    """gt_list: per image (boxes, labels, difficult); pred_list: per image
    dict. Greedy matching per class (voc_eval.py:126-231)."""
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)

    for (gt_bbox, gt_label, gt_diff), pred in zip(gt_list, pred_list):
        pred_bbox = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        pred_label = np.asarray(pred["labels"], np.int64)
        pred_score = np.asarray(pred["scores"], np.float64)
        gt_bbox = np.asarray(gt_bbox, np.float64).reshape(-1, 4)
        gt_label = np.asarray(gt_label, np.int64)
        gt_diff = np.asarray(gt_diff, bool)

        for l in np.unique(np.concatenate((pred_label, gt_label)).astype(int)):
            pm = pred_label == l
            pb, ps = pred_bbox[pm], pred_score[pm]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]

            gm = gt_label == l
            gb, gd = gt_bbox[gm], gt_diff[gm]
            n_pos[l] += int(np.logical_not(gd).sum())
            score[l].extend(ps)

            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend((0,) * pb.shape[0])
                continue

            # VOC uses integer boxes: +1 on the max corner (voc_eval.py:179-183)
            pb = pb.copy()
            pb[:, 2:] += 1
            gb = gb.copy()
            gb[:, 2:] += 1

            iou = _iou_plus1(pb, gb)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(gb.shape[0], bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd[gi]:
                        match[l].append(-1)
                    else:
                        match[l].append(1 if not selec[gi] else 0)
                    selec[gi] = True
                else:
                    match[l].append(0)

    n_fg_class = max(n_pos.keys()) + 1 if n_pos else 0
    prec = [None] * n_fg_class
    rec = [None] * n_fg_class
    for l in n_pos.keys():
        score_l = np.array(score[l])
        match_l = np.array(match[l], np.int8)
        order = score_l.argsort()[::-1]
        match_l = match_l[order]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[l] = tp / (fp + tp)
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def calc_detection_voc_ap(prec, rec, use_07_metric: bool = False) -> np.ndarray:
    """11-point (VOC07) or area-under-PR AP (voc_eval.py:231-287)."""
    n_fg_class = len(prec)
    ap = np.empty(n_fg_class)
    for l in range(n_fg_class):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            ap[l] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                ap[l] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def eval_detection_voc(pred_list, gt_list, iou_thresh: float = 0.5,
                       use_07_metric: bool = True) -> Dict:
    prec, rec = calc_detection_voc_prec_rec(gt_list, pred_list, iou_thresh)
    ap = calc_detection_voc_ap(prec, rec, use_07_metric)
    return {"ap": ap, "map": float(np.nanmean(ap))}


def do_voc_evaluation(dataset, predictions: List[Dict], output_folder=None,
                      use_07_metric: bool = True) -> Dict:
    """Predictions must already be in original image coordinates."""
    gt_list = [dataset.get_groundtruth(i) for i in range(len(predictions))]
    result = eval_detection_voc(predictions, gt_list, 0.5, use_07_metric)
    lines = ["mAP: {:.4f}".format(result["map"])]
    for i, ap in enumerate(result["ap"]):
        if i == 0:
            continue
        lines.append("{:<16}: {:.4f}".format(
            dataset.map_class_id_to_class_name(i), ap))
    result_str = "\n".join(lines) + "\n"
    logger.info(result_str)
    if output_folder:
        with open(os.path.join(output_folder, "result.txt"), "w") as f:
            f.write(result_str)
    return result


def do_corloc_evaluation(dataset, predictions: List[Dict], output_folder=None,
                         iou_thresh: float = 0.5) -> Dict:
    """CorLoc (voc_eval_old.py:252-411): per (image, class) take the single
    highest-scored detection; it's correct if IoU > thresh with any GT box
    of that class; CorLoc_c = hits / #images containing class c. Needs
    the dataset's ``CLASSES`` (VOC): another dataset raises a ValueError
    (the JAX package fails on it with an AttributeError)."""
    if not hasattr(dataset, "CLASSES"):
        raise ValueError(f"CorLoc reads the dataset's CLASSES, which "
                         f"{type(dataset).__name__} has not (VOC only)")
    num_classes = len(dataset.CLASSES)
    hits = np.zeros(num_classes)
    nimgs = np.zeros(num_classes)
    for idx in range(len(predictions)):
        gt_boxes, gt_labels, _ = dataset.get_groundtruth(idx)
        pred = predictions[idx]
        labels = np.asarray(pred["labels"], np.int64)
        scores = np.asarray(pred["scores"], np.float64)
        boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        for c in np.unique(gt_labels):
            gb = gt_boxes[gt_labels == c]
            if len(gb) == 0:
                continue
            nimgs[c] += 1
            sel = labels == c
            if not sel.any():
                continue
            top = np.argmax(scores[sel])
            bb = boxes[sel][top]
            ov = _iou_plus1(bb[None], gb).max()
            if ov > iou_thresh:
                hits[c] += 1
    with np.errstate(divide="ignore", invalid="ignore"):
        corloc = np.where(nimgs > 0, hits / np.maximum(nimgs, 1), np.nan)
    mean_corloc = float(np.nanmean(corloc[1:])) if num_classes > 1 else 0.0
    lines = ["Mean CorLoc = {:.4f}".format(mean_corloc)]
    for c in range(1, num_classes):
        if nimgs[c] > 0:
            lines.append("CorLoc for {} = {:.4f}".format(
                dataset.map_class_id_to_class_name(c), corloc[c]))
    result_str = "\n".join(lines) + "\n"
    logger.info(result_str)
    if output_folder:
        with open(os.path.join(output_folder, "corloc_result.txt"), "w") as f:
            f.write(result_str)
    return {"corloc": corloc, "mean_corloc": mean_corloc}
