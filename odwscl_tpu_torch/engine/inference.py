"""Inference engine: per-image detection with multi-transform TTA.

Counterpart of ``odwscl_tpu/engine/inference.py``, host-resize path. Each
TTA scale is resized on the host with PIL and collated; its h-flip twin is
derived on the device (``_flip_batch``: mirroring the valid region of the
normalized image commutes with the pixelwise normalization). Every
(scale, flip) forward runs the same model; its boxes are unflipped and
rescaled to the identity transform's frame, then merged by AVG (mean of
scores and boxes, the shipped default) or UNION (concatenation). One
per-class NMS pass finishes each batch. A worker thread prepares the next
scale while the device runs the current one.

Not ported here: the int8 calibration, the device-resize serving path
(``TPU.EVAL_DEVICE_RESIZE``) and the multi-process gather.
"""

from __future__ import annotations

import concurrent.futures as futures
import logging
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.collate import collator_from_cfg
from ..data.transforms import EvalTransform, Sample, get_resize_size
from ..evaluation.voc_eval import do_corloc_evaluation, do_voc_evaluation
from ..models.detector import Batch
from ..utils.device import resolve_device
from .postprocess import (detections_to_host, finalize_detections_device,
                          resize_detections)

logger = logging.getLogger("odwscl_tpu_torch.inference")


class TTAConfig:
    def __init__(self, cfg):
        self.enabled = cfg.TEST.BBOX_AUG.ENABLED
        self.h_flip = cfg.TEST.BBOX_AUG.H_FLIP
        self.scales = tuple(cfg.TEST.BBOX_AUG.SCALES)
        self.max_size = cfg.TEST.BBOX_AUG.MAX_SIZE
        self.scale_h_flip = cfg.TEST.BBOX_AUG.SCALE_H_FLIP
        self.heur = cfg.TEST.BBOX_AUG.HEUR
        self.base_min = cfg.INPUT.MIN_SIZE_TEST
        self.base_max = cfg.INPUT.MAX_SIZE_TEST
        self.pixel_mean = tuple(cfg.INPUT.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.INPUT.PIXEL_STD)
        self.to_bgr255 = cfg.INPUT.TO_BGR255

    def transforms(self) -> List[EvalTransform]:
        """The (scale, flip) list in reference order: identity, its flip,
        then each extra scale followed by its flip."""
        def tr(min_size, max_size, flip):
            return EvalTransform(min_size, max_size, self.pixel_mean,
                                 self.pixel_std, self.to_bgr255, flip=flip)

        out = [tr(self.base_min, self.base_max, False)]
        if self.h_flip:
            out.append(tr(self.base_min, self.base_max, True))
        for s in self.scales:
            out.append(tr(s, self.max_size, False))
            if self.scale_h_flip:
                out.append(tr(s, self.max_size, True))
        return out


def _tta_groups(transforms):
    """Pair each unflipped scale with its immediately following flip twin,
    which is then derived on the device."""
    groups, i = [], 0
    while i < len(transforms):
        tr = transforms[i]
        nxt = transforms[i + 1] if i + 1 < len(transforms) else None
        if (not tr.flip and nxt is not None and nxt.flip
                and nxt.min_size == tr.min_size
                and nxt.max_size == tr.max_size):
            groups.append((tr, True))
            i += 2
        else:
            groups.append((tr, False))
            i += 1
    return groups


def _unflip_boxes(boxes: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """boxes [B, P, 4K]; widths [B]. BoxList.transpose(0) semantics."""
    b, p, k4 = boxes.shape
    bx = boxes.reshape(b, p, -1, 4)
    w = widths[:, None, None]
    x1 = w - 1.0 - bx[..., 2]
    x2 = w - 1.0 - bx[..., 0]
    return torch.stack([x1, bx[..., 1], x2, bx[..., 3]], -1).reshape(b, p, k4)


def _flip_batch(batch: Batch) -> Batch:
    """The h-flip TTA twin of a collated batch: mirror each image's valid
    region (width from image_sizes; the zero padding stays in place) and
    flip the proposals. Bit-exact against collating the host-flipped
    transform."""
    images, boxes = batch.images, batch.boxes
    b, hh, ww, c = images.shape
    w = batch.image_sizes[:, 1]                            # (h, w) order
    idx = (w[:, None].to(torch.int64) - 1
           - torch.arange(ww, device=images.device)[None, :]) % ww
    flipped = torch.gather(images, 2,
                           idx[:, None, :, None].expand(b, hh, ww, c))
    wf = w[:, None]
    fboxes = torch.stack([wf - 1.0 - boxes[..., 2], boxes[..., 1],
                          wf - 1.0 - boxes[..., 0], boxes[..., 3]], -1)
    fboxes = torch.where(batch.box_mask[..., None], fboxes, boxes)
    return batch.replace(images=flipped, boxes=fboxes)


def _rescale_boxes(boxes: torch.Tensor, rw: torch.Tensor, rh: torch.Tensor
                   ) -> torch.Tensor:
    b, p, k4 = boxes.shape
    bx = boxes.reshape(b, p, -1, 4)
    rw = rw[:, None, None]
    rh = rh[:, None, None]
    out = torch.stack([bx[..., 0] * rw, bx[..., 1] * rh,
                       bx[..., 2] * rw, bx[..., 3] * rh], -1)
    return out.reshape(b, p, k4)


def _match_mask(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """REGRESS_HEUR=UNION returns R*P rows per image; tile the mask."""
    k = scores.shape[1] // mask.shape[1]
    return mask.repeat(1, k) if k > 1 else mask


class Inferencer:
    """Runs eval forwards (with TTA) and post-processing for one model.

    ``timings`` accumulates wall seconds per stage: ``prep_wait_s`` (the
    device loop waiting on host resize + collate + upload), ``forward_s``
    (forwards, flips and the merge, synchronized per batch) and
    ``finalize_s`` (per-class NMS, top-K and the transfer to the host).
    """

    def __init__(self, model, cfg, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tta = TTAConfig(cfg)
        self.nms_thresh = cfg.MODEL.ROI_HEADS.NMS
        self.score_thresh = cfg.MODEL.ROI_HEADS.SCORE_THRESH
        self.det_per_img = cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
        self.collator = collator_from_cfg(cfg)
        self.timings = {"prep_wait_s": 0.0, "forward_s": 0.0,
                        "finalize_s": 0.0}
        self.n_forwards = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward_batch(self, batch: Batch):
        self.n_forwards += 1
        return self.model.eval_forward(batch)

    def _prep_scale(self, tr, samples):
        """Host work for one TTA scale: PIL resize + collate + upload."""
        t_samples = [tr(s) for s in samples]
        batch = self.collator(t_samples).to(self.device)
        sizes = torch.tensor([ts.size for ts in t_samples], dtype=torch.float32,
                             device=self.device)               # (w, h)
        return batch, sizes

    def _host_prep_batches(self, groups, samples):
        with futures.ThreadPoolExecutor(1) as pool:
            futs = [pool.submit(self._prep_scale, tr, samples)
                    for tr, _ in groups]
            for fut in futs:
                t0 = time.perf_counter()
                item = fut.result()
                self.timings["prep_wait_s"] += time.perf_counter() - t0
                yield item

    def predict_samples(self, samples: List[Sample]
                        ) -> List[Dict[str, np.ndarray]]:
        """samples: untransformed Samples with rois -> final per-image
        detections in the first (identity) transform's frame."""
        if not self.tta.enabled:
            return self.predict_batch(self.collator(samples).to(self.device))
        transforms = self.tta.transforms()
        groups = _tta_groups(transforms)
        union = self.tta.heur == "UNION"
        sum_scores = sum_boxes = ref_sizes = mask0 = None
        union_scores, union_boxes = [], []
        t_i = 0
        t0 = time.perf_counter()
        wait0 = self.timings["prep_wait_s"]
        for (tr, has_flip), (batch, sizes) in zip(
                groups, self._host_prep_batches(groups, samples)):
            per_group = [(self.forward_batch(batch), tr.flip)]
            if has_flip:
                per_group.append((self.forward_batch(_flip_batch(batch)),
                                  True))
            for (scores, boxes), flipped in per_group:
                if flipped:
                    boxes = _unflip_boxes(boxes, sizes[:, 0])
                if t_i == 0:
                    ref_sizes = sizes
                    mask0 = _match_mask(scores, batch.box_mask)
                    sum_scores, sum_boxes = scores, boxes
                else:
                    boxes = _rescale_boxes(boxes, ref_sizes[:, 0] / sizes[:, 0],
                                           ref_sizes[:, 1] / sizes[:, 1])
                    if not union:
                        sum_scores = sum_scores + scores
                        sum_boxes = sum_boxes + boxes
                if union:
                    union_scores.append(scores)
                    union_boxes.append(boxes)
                t_i += 1
        n = len(transforms)
        if union:
            scores, boxes = (torch.cat(union_scores, dim=1),
                             torch.cat(union_boxes, dim=1))
            mask = torch.cat([mask0] * n, dim=1)
        else:
            scores, boxes, mask = sum_scores / n, sum_boxes / n, mask0
        self._sync()
        self.timings["forward_s"] += (time.perf_counter() - t0
                                      - (self.timings["prep_wait_s"] - wait0))
        return self._finalize(scores, boxes, mask)

    def predict_batch(self, batch: Batch) -> List[Dict[str, np.ndarray]]:
        """Non-TTA batch -> per-image detections."""
        t0 = time.perf_counter()
        scores, boxes = self.forward_batch(batch)
        self._sync()
        self.timings["forward_s"] += time.perf_counter() - t0
        return self._finalize(scores, boxes,
                              _match_mask(scores, batch.box_mask))

    def _finalize(self, scores, boxes, box_mask):
        t0 = time.perf_counter()
        b, p = scores.shape[:2]
        boxes_pc = boxes.reshape(b, p, -1, 4) if boxes.shape[-1] != 4 else boxes
        out = finalize_detections_device(boxes_pc, scores, box_mask,
                                         self.nms_thresh, self.score_thresh,
                                         self.det_per_img)
        dets = detections_to_host(*out)
        self.timings["finalize_s"] += time.perf_counter() - t0
        return dets


def inference(model, cfg, eval_loader, dataset, output_folder=None,
              task: str = "det", use_cached: bool = True, device="cuda",
              timing_out: Optional[dict] = None):
    """Full dataset inference + VOC evaluation (``det`` mAP or ``corloc``).

    Predictions are cached in ``output_folder/predictions.pkl`` and reused
    when ``use_cached``. ``timing_out``, when given, receives
    ``n_images``, ``n_forwards``, ``wall_s`` (the prediction loop),
    ``load_wait_s`` (waiting on image decode), the Inferencer's stage times
    and ``eval_s``.
    """
    pred_path = (os.path.join(output_folder, "predictions.pkl")
                 if output_folder else None)
    timing = {}
    if pred_path and use_cached and os.path.exists(pred_path):
        with open(pred_path, "rb") as f:   # written by this function below
            predictions = pickle.load(f)
        logger.info("Loaded cached predictions from %s", pred_path)
    else:
        inferencer = Inferencer(model, cfg, device)
        tr0 = inferencer.tta.transforms()[0]
        predictions = {}
        n_images, load_wait = 0, 0.0
        t0 = time.perf_counter()
        it = iter(eval_loader)
        while True:
            tl = time.perf_counter()
            item = next(it, None)
            load_wait += time.perf_counter() - tl
            if item is None:
                break
            batch, samples, idxs = item
            if cfg.TEST.BBOX_AUG.ENABLED:
                dets = inferencer.predict_samples(samples)
            else:
                dets = inferencer.predict_batch(batch.to(inferencer.device))
            for d, s, idx in zip(dets, samples, idxs):
                if cfg.TEST.BBOX_AUG.ENABLED:
                    # identity frame -> original frame (the resize rule)
                    oh, ow = get_resize_size(s.size, tr0.min_size,
                                             tr0.max_size)
                    from_wh = (ow, oh)
                else:
                    from_wh = s.size
                info = dataset.get_img_info(int(idx))
                predictions[int(idx)] = resize_detections(
                    d, from_wh, (info["width"], info["height"]))
            n_images += len(samples)
        wall = time.perf_counter() - t0
        logger.info("Inference: %d images in %.1fs (%.4f s/img)", n_images,
                    wall, wall / max(n_images, 1))
        timing.update(n_images=n_images, n_forwards=inferencer.n_forwards,
                      wall_s=wall, load_wait_s=load_wait,
                      **inferencer.timings)
        predictions = [predictions[i] for i in sorted(predictions)]
        if pred_path:
            with open(pred_path, "wb") as f:
                pickle.dump(predictions, f)

    t0 = time.perf_counter()
    if task == "corloc":
        result = do_corloc_evaluation(dataset, predictions, output_folder)
    else:
        result = do_voc_evaluation(dataset, predictions, output_folder)
    timing["eval_s"] = time.perf_counter() - t0
    if timing_out is not None:
        timing_out.update(timing)
    return result
