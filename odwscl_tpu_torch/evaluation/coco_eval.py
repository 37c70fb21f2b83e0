"""COCO-style box AP in numpy (no pycocotools), the bbox task.

Counterpart of ``odwscl_tpu/evaluation/coco_eval.py``, which follows
pycocotools' COCOeval: 10 IoU thresholds .5:.95, precision interpolated
at 101 recall points, the area ranges all / small / medium / large (by
the annotation's ``area``, else w * h), at most 100 detections an image
and category, crowd GT matched by intersection over the detection's area
and neither a true nor a false positive. Detections are in xyxy with the
+1 convention (x2 = x + w - 1) and GT boxes in COCO's continuous xywh, so
each detection's x2, y2 gain 1 before matching. ``do_coco_evaluation``
returns AP, AP50, AP75, AP_s, AP_m, AP_l and AR (over all areas);
``check_expected_results`` checks ``TEST.EXPECTED_RESULTS``.

``iou_types`` ("bbox", "segm") adds the segm task (keys ``segm_AP`` ...):
the same protocol with the mask IoU of full-image instance masks (crowd GT
by intersection over the detection's area, pycocotools' ``maskUtils.iou``
rule). Each prediction then carries ``masks`` [N, H, W] bool at the
original size (the Masker's output); the GT rasterizes from the
annotations' polygons or RLE (``structures/rle.py``).
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

logger = logging.getLogger("odwscl_tpu_torch.eval")

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_xyxy(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray
              ) -> np.ndarray:
    """[D, 4] x [G, 4] -> [D, G]; crowd GT uses intersection / det area."""
    area_d = (np.clip(det[:, 2] - det[:, 0], 0, None)
              * np.clip(det[:, 3] - det[:, 1], 0, None))
    area_g = (np.clip(gt[:, 2] - gt[:, 0], 0, None)
              * np.clip(gt[:, 3] - gt[:, 1], 0, None))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(iscrowd[None, :], area_d[:, None],
                     area_d[:, None] + area_g[None, :] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _mask_iou(det_masks, gt_masks, iscrowd) -> np.ndarray:
    """[D][H, W] x [G][H, W] bool -> [D, G]; crowd GT uses intersection /
    det area."""
    d, g = len(det_masks), len(gt_masks)
    out = np.zeros((d, g))
    areas_d = [int(m.sum()) for m in det_masks]
    areas_g = [int(m.sum()) for m in gt_masks]
    for di in range(d):
        for gi in range(g):
            inter = int((det_masks[di] & gt_masks[gi]).sum())
            union = (areas_d[di] if iscrowd[gi]
                     else areas_d[di] + areas_g[gi] - inter)
            out[di, gi] = inter / union if union > 0 else 0.0
    return out


def _match_image(det_boxes, det_scores, gt_boxes, gt_crowd, gt_ignore_area,
                 det_masks=None, gt_masks=None):
    """COCOeval's greedy matching for one (image, category): the top
    MAX_DETS detections by score (stable), GT sorted non-ignored first;
    by mask IoU when ``det_masks`` and ``gt_masks`` (lists of [H, W]
    bool) are given, else by box IoU. Returns (detection order, [T, D]
    matched GT index or -1, [T, D] ignored flags, number of non-ignored
    GT)."""
    order = np.argsort(-det_scores, kind="mergesort")[:MAX_DETS]
    det_boxes = det_boxes[order]
    d, g = len(det_boxes), len(gt_boxes)
    gt_ignore = gt_crowd | gt_ignore_area
    gt_order = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[gt_order]
    gt_ig = gt_ignore[gt_order]
    crowd = gt_crowd[gt_order]
    if not (d and g):
        ious = np.zeros((d, g))
    elif det_masks is not None:
        ious = _mask_iou([det_masks[i] for i in order],
                         [gt_masks[i] for i in gt_order], crowd)
    else:
        ious = _iou_xyxy(det_boxes, gt_boxes, crowd)

    t = len(IOU_THRS)
    dt_m = -np.ones((t, d), int)
    gt_m = -np.ones((t, g), int)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi in range(g):
                if gt_m[ti, gi] >= 0 and not crowd[gi]:
                    continue
                if best >= 0 and not gt_ig[best] and gt_ig[gi]:
                    break   # an ignored GT cannot beat a non-ignored match
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best >= 0:
                dt_m[ti, di] = best
                gt_m[ti, best] = di
    dt_ig = np.zeros((t, d), bool)
    if g:
        for ti in range(t):
            m = dt_m[ti]
            dt_ig[ti] = (m >= 0) & gt_ig[np.clip(m, 0, None)]
    return order, dt_m, dt_ig, int((~gt_ig).sum())


def evaluate_coco_bbox(gt_by_img_cat, det_by_img_cat, cat_ids, img_ids,
                       area_name: str = "all") -> Dict[str, float]:
    """AP, AP50, AP75, AR and the [T, R, K] precisions of one area range.
    ``gt_by_img_cat[(img, cat)]`` = (boxes xyxy continuous, iscrowd,
    areas[, masks]); ``det_by_img_cat[(img, cat)]`` = (boxes xyxy
    continuous, scores[, masks]): with masks, matching is by mask IoU."""
    lo, hi = AREA_RANGES[area_name]
    t = len(IOU_THRS)
    precisions = -np.ones((t, len(RECALL_THRS), len(cat_ids)))
    recalls = -np.ones((t, len(cat_ids)))

    for ki, cat in enumerate(cat_ids):
        scores_all, matched_all, ignored_all = [], [], []
        npig = 0
        for img in img_ids:
            gt_boxes, gt_crowd, gt_areas, *gt_masks = gt_by_img_cat.get(
                (img, cat), (np.zeros((0, 4)), np.zeros(0, bool), np.zeros(0)))
            det_boxes, det_scores, *det_masks = det_by_img_cat.get(
                (img, cat), (np.zeros((0, 4)), np.zeros(0)))
            gt_ignore_area = (gt_areas < lo) | (gt_areas > hi)
            masks = ((det_masks[0], gt_masks[0]) if det_masks and gt_masks
                     else (None, None))
            order, dt_m, dt_ig, n_pig = _match_image(
                det_boxes, det_scores, gt_boxes, gt_crowd, gt_ignore_area,
                *masks)
            npig += n_pig
            if len(order):
                det_area = ((det_boxes[order][:, 2] - det_boxes[order][:, 0])
                            * (det_boxes[order][:, 3]
                               - det_boxes[order][:, 1]))
                area_out = (det_area < lo) | (det_area > hi)
                # unmatched detections outside the range are ignored
                dt_ig = dt_ig | ((dt_m < 0) & area_out[None, :])
                scores_all.append(det_scores[order])
                matched_all.append(dt_m >= 0)
                ignored_all.append(dt_ig)
        if npig == 0:
            continue
        if not scores_all:
            recalls[:, ki] = 0.0
            precisions[:, :, ki] = 0.0
            continue
        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind="mergesort")
        matched = np.concatenate(matched_all, axis=1)[:, order]
        ignored = np.concatenate(ignored_all, axis=1)[:, order]
        tp_cum = np.cumsum(matched & ~ignored, axis=1).astype(float)
        fp_cum = np.cumsum(~matched & ~ignored, axis=1).astype(float)
        for ti in range(t):
            tp, fp = tp_cum[ti], fp_cum[ti]
            rc = tp / npig
            pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
            recalls[ti, ki] = rc[-1] if len(rc) else 0.0
            pr = pr.tolist()              # the precision envelope
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_THRS, side="left")
            q = np.zeros(len(RECALL_THRS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precisions[ti, :, ki] = q

    def _ap(sel):
        p = precisions[sel] if sel is not None else precisions
        p = p[p > -1]
        return float(p.mean()) if p.size else -1.0

    r = recalls[recalls > -1]
    return {"AP": _ap(None), "AP50": _ap(np.isclose(IOU_THRS, 0.5)),
            "AP75": _ap(np.isclose(IOU_THRS, 0.75)),
            "AR": float(r.mean()) if r.size else -1.0,
            "precisions": precisions}


def do_coco_evaluation(dataset, predictions: List[Dict], output_folder=None,
                       expected_results=None, sigma_tol: float = 4.0,
                       iou_types=("bbox",)) -> Dict:
    """``predictions[i]`` (boxes in the original image's coordinates,
    contiguous labels; with "segm" also ``masks``) belongs to dataset
    index ``i``, whose json image id is ``dataset.id_to_img_map[i]``.
    Every annotation of the image counts, crowds included. Returns the
    metrics dict; writes ``coco_results.txt`` to ``output_folder``."""
    from ..structures.rle import rasterize_segmentation

    do_segm = "segm" in iou_types
    gt_by, det_by, gt_segm, det_segm = {}, {}, {}, {}
    img_ids = []
    for idx, pred in enumerate(predictions):
        img_id = dataset.id_to_img_map[idx]
        img_ids.append(img_id)
        if do_segm:
            if "masks" not in pred:
                raise ValueError(f"the segm task needs each prediction's "
                                 f"'masks' (image index {idx} has none)")
            info = dataset.get_img_info(idx)
        by_cat = defaultdict(lambda: ([], [], [], []))
        for a in dataset.coco.img_to_anns[img_id]:
            x, y, w, h = a["bbox"]
            c = dataset.json_category_id_to_contiguous_id[a["category_id"]]
            bl, cl, al, ml = by_cat[c]
            bl.append([x, y, x + w, y + h])
            cl.append(bool(a.get("iscrowd", 0)))
            al.append(a.get("area", w * h))
            if do_segm:
                ml.append(rasterize_segmentation(
                    a.get("segmentation") or [], info["height"],
                    info["width"]).astype(bool))
        for c, (bl, cl, al, ml) in by_cat.items():
            gt_by[(img_id, c)] = (np.asarray(bl, float),
                                  np.asarray(cl, bool), np.asarray(al, float))
            if do_segm:
                gt_segm[(img_id, c)] = gt_by[(img_id, c)] + (ml,)
        boxes = np.asarray(pred["boxes"], float).reshape(-1, 4)
        labels = np.asarray(pred["labels"], int)
        scores = np.asarray(pred["scores"], float)
        for c in np.unique(labels):
            sel = labels == c
            bb = boxes[sel].copy()
            bb[:, 2:] += 1.0      # +1 convention -> continuous xywh extent
            det_by[(img_id, int(c))] = (bb, scores[sel])
            if do_segm:
                det_segm[(img_id, int(c))] = (
                    bb, scores[sel],
                    [m.astype(bool) for m in np.asarray(pred["masks"])[sel]])

    cat_ids = sorted({c for (_, c) in list(gt_by) + list(det_by)})
    results = {}
    tasks = [("", gt_by, det_by)] + ([("segm_", gt_segm, det_segm)]
                                     if do_segm else [])
    for prefix, g_by, d_by in tasks:
        for area in ("all", "small", "medium", "large"):
            r = evaluate_coco_bbox(g_by, d_by, cat_ids, img_ids, area)
            if area == "all":
                results.update({prefix + k: r[k]
                                for k in ("AP", "AP50", "AP75", "AR")})
            else:
                results[f"{prefix}AP_{area[0]}"] = r["AP"]
    line = "\n".join(
        (("segm: " if prefix else "") + "AP {AP:.4f} | AP50 {AP50:.4f} | "
         "AP75 {AP75:.4f} | APs {AP_s:.4f} | APm {AP_m:.4f} | "
         "APl {AP_l:.4f}").format(**{k[len(prefix):]: v
                                     for k, v in results.items()
                                     if k.startswith(prefix)})
        for prefix, _, _ in tasks)
    logger.info(line)
    if output_folder:
        with open(os.path.join(output_folder, "coco_results.txt"), "w") as f:
            f.write(line + "\n")
    check_expected_results(results, expected_results or [], sigma_tol)
    return results


def check_expected_results(results: Dict, expected, sigma_tol: float):
    """Log PASS / FAIL for each ``(task, metric, mean, std)`` of
    ``expected``: the metric within mean +- sigma_tol * std."""
    for task, metric, mean, std in expected:
        actual = results.get(metric)
        if actual is None:
            continue
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        msg = (f"{task} {metric}: {actual:.4f} vs expected "
               f"{mean:.4f} +/- {sigma_tol}x{std:.4f}")
        if not (lo < actual < hi):
            logger.error("FAIL: %s", msg)
        else:
            logger.info("PASS: %s", msg)
