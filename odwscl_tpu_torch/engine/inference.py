"""Inference engine: per-image detection with multi-transform TTA.

Counterpart of ``odwscl_tpu/engine/inference.py``. Two ways to make each
TTA scale:
- the host path (default): each scale is resized on the host with PIL and
  collated, and a worker thread prepares the next scale while the device
  runs the current one;
- ``TPU.EVAL_DEVICE_RESIZE True``: the normalized original images are
  uploaded once per batch (as bf16 when ``TPU.EVAL_TRANSFER_BF16`` and the
  model computes in bf16) and every scale is resized on the device
  (``ops/device_resize.py``); a worker thread prepares the next batch's
  upload.
Either way each scale's h-flip twin is derived on the device
(``_flip_batch``: mirroring the valid region of the normalized image
commutes with the pixelwise normalization). Every (scale, flip) forward
runs the same model; its boxes are unflipped and rescaled to the identity
transform's frame, then merged in the transforms' order by AVG (mean of
scores and boxes, the shipped default) or UNION (concatenation). One
per-class NMS pass finishes each batch.

int8 serving (``models/vgg16.py``): with ``TPU.INT8_STATIC`` and
``TPU.INT8_EVAL_CONVS`` the conv scales are calibrated before serving,
over the first ``TPU.INT8_CALIB_BATCHES`` batches and every TTA transform
(host resize), or loaded from ``OUTPUT_DIR/int8_scales.npz``, a file the JAX
package reads and writes too (``save_int8_scales``, ``load_int8_scales``).

Several processes (``torch.distributed`` initialized, one eval shard a
rank): each rank writes its predictions to a shard file in the output
folder and rank 0 merges them (``gather_predictions``) and evaluates.

The supervised families (``models.build_model``) return a dict from
``eval_forward`` and take the non-TTA path: RetinaNet's decoded top-K
goes through the per-class NMS with ``MODEL.RETINANET.NMS_TH`` and
``INFERENCE_TH``; the Fast / Mask R-CNN's softmax scores and per-class
boxes through the ``ROI_HEADS`` NMS, after which a ``MASK_ON`` model runs
``predict_masks`` on the kept detections and the Masker pastes the
probabilities at the original image size; COCO then scores bbox and
segm.
"""

from __future__ import annotations

import concurrent.futures as futures
import logging
import math
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.collate import collator_from_cfg
from ..data.transforms import (EvalTransform, Sample, get_resize_size,
                               normalize, to_array)
from ..data.voc import PascalVOCDataset
from ..evaluation.coco_eval import do_coco_evaluation
from ..evaluation.voc_eval import do_corloc_evaluation, do_voc_evaluation
from ..models.detector import Batch
from ..models.mask_head import Masker
from ..models.retinanet import RetinaNetDetector
from ..models.supervised import SupervisedRCNN
from ..ops.device_resize import resize_image_batch, scale_boxes_batch
from ..utils.device import resolve_device
from ..utils.dist import process_count_and_index
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


def gather_predictions(predictions: Dict[int, dict], dataset_len: int,
                       output_folder: Optional[str],
                       process_count: Optional[int] = None,
                       process_index: Optional[int] = None,
                       timeout_s: float = 600.0):
    """Merge the per-process prediction shards {image index: detections}
    into one list in image order, on process 0; other processes return
    None. ``process_count`` and ``process_index`` default to
    ``torch.distributed``'s world size and rank when it is initialized.

    One process returns its sorted list and writes nothing. Otherwise each
    process writes ``predictions_shard_{i}.pkl`` in ``output_folder``
    atomically (a temporary file, then a rename); process 0 polls for the
    others' shards until ``timeout_s`` (then ``TimeoutError``), raises on
    image indices that two shards share and on a merged count other than
    ``dataset_len``."""
    pc, pi = process_count_and_index(process_count, process_index)
    if pc <= 1:
        return [predictions[i] for i in sorted(predictions)]
    if not output_folder:
        raise ValueError("multi-process eval needs a shared output_folder "
                         "to gather prediction shards")
    shard = os.path.join(output_folder, f"predictions_shard_{pi}.pkl")
    with open(shard + ".tmp", "wb") as f:
        pickle.dump(predictions, f)
    os.replace(shard + ".tmp", shard)
    if pi != 0:
        return None
    merged = dict(predictions)
    deadline = time.time() + timeout_s
    for other in range(1, pc):
        path = os.path.join(output_folder, f"predictions_shard_{other}.pkl")
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"eval shard {other} never appeared at "
                                   f"{path}")
            time.sleep(0.2)
        with open(path, "rb") as f:   # written by another rank, above
            part = pickle.load(f)
        overlap = set(merged) & set(part)
        if overlap:
            raise RuntimeError(f"prediction shards overlap on image ids "
                               f"{sorted(overlap)[:5]}...")
        merged.update(part)
    if len(merged) != dataset_len:
        raise RuntimeError(f"gathered {len(merged)} predictions for a "
                           f"{dataset_len}-image dataset (missing shards?)")
    return [merged[i] for i in sorted(merged)]


def save_int8_scales(path: str, model) -> None:
    """The backbone's calibrated activation scales as an ``.npz`` with the
    keys of the JAX package's "quant" collection (``backbone/conv<i>_act``)."""
    np.savez(path, **{f"backbone/conv{i}_act": a.detach().cpu().numpy()
                      for i, a in sorted(model.backbone.act_amax.items())})


def load_int8_scales(path: str) -> Dict[int, torch.Tensor]:
    """{conv index: abs-max tensor} from an ``.npz`` of either package: a
    [Cin] vector each, or a 0-d scalar from an older file."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            head, _, name = key.rpartition("/")
            if head != "backbone" or not (name.startswith("conv")
                                          and name.endswith("_act")):
                raise ValueError(f"{path}: unexpected int8 scale {key!r}")
            out[int(name[4:-4])] = torch.from_numpy(
                np.asarray(z[key], np.float32))
    return out


class Inferencer:
    """Runs eval forwards (with TTA) and post-processing for one model.

    ``timings`` accumulates wall seconds per stage: ``prep_wait_s`` (the
    device loop waiting on host resize + collate + upload, or with
    ``TPU.EVAL_DEVICE_RESIZE`` on the base upload), ``forward_s``
    (resizes, forwards, flips and the merge, synchronized per batch) and
    ``finalize_s`` (per-class NMS, top-K and the transfer to the host)
    and ``calib_s`` (the int8 calibration forwards, synchronized).

    With ``TPU.INT8_STATIC`` and ``TPU.INT8_EVAL_CONVS`` on (the model's
    backbone's ``int8_static`` and ``int8_eval``) and no scales yet,
    ``calibrate`` sweeps a loader first; ``forward_batch`` calibrates on
    its own batch when nobody did.
    """

    def __init__(self, model, cfg, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tta = TTAConfig(cfg)
        self.nms_thresh = cfg.MODEL.ROI_HEADS.NMS
        self.score_thresh = cfg.MODEL.ROI_HEADS.SCORE_THRESH
        self.det_per_img = cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
        self.retinanet = isinstance(model, RetinaNetDetector)
        self.supervised = isinstance(model, (RetinaNetDetector,
                                             SupervisedRCNN))
        if self.retinanet:
            self.nms_thresh = cfg.MODEL.RETINANET.NMS_TH
            self.score_thresh = cfg.MODEL.RETINANET.INFERENCE_TH
        self.mask_on = bool(getattr(model, "mask_on", False))
        self.collator = collator_from_cfg(cfg)
        self.device_resize = bool(cfg.TPU.EVAL_DEVICE_RESIZE)
        self._pad_multiple = cfg.TPU.IMAGE_PAD_MULTIPLE
        # exact: the backbone casts the images to bf16 at its first conv
        self._base_dtype = (torch.bfloat16 if cfg.TPU.EVAL_TRANSFER_BF16
                            and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                            else torch.float32)
        self.timings = {"prep_wait_s": 0.0, "forward_s": 0.0,
                        "finalize_s": 0.0, "calib_s": 0.0}
        self.n_forwards = self.n_calib_forwards = 0
        # a ResNet backbone, or a model without one, has no int8 serving
        bb = getattr(model, "backbone", None)
        self.needs_calib = bool(getattr(bb, "int8_static", False)
                                and getattr(bb, "int8_eval", False)
                                and not bb.act_amax)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _calib_step(self, batch: Batch) -> None:
        """One calibration forward: the running abs-maxes take this batch."""
        t0 = time.perf_counter()
        self.n_calib_forwards += 1
        self.model.eval_forward(batch, calibrate=True)
        self._sync()
        self.timings["calib_s"] += time.perf_counter() - t0

    def calibrate(self, eval_loader, n_batches: int) -> None:
        """The static-int8 calibration sweep: calibration forwards over the
        first ``n_batches`` items ``(batch, samples, _)`` of the loader,
        across every TTA transform when TTA is on (host resize), so the
        scales cover the largest serving scale."""
        if not self.needs_calib:
            return
        transforms = self.tta.transforms() if self.tta.enabled else None
        n_done = 0
        for batch, samples, _ in eval_loader:
            if transforms is None:
                self._calib_step(batch.to(self.device))
            else:
                for tr in transforms:
                    self._calib_step(self.collator(
                        [tr(s) for s in samples]).to(self.device))
            n_done += 1
            if n_done >= n_batches:
                break
        self.needs_calib = False
        logger.info("int8 static calibration: %d batches swept", n_done)

    def forward_batch(self, batch: Batch):
        if self.needs_calib:
            self._calib_step(batch)
            self.needs_calib = False
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

    def prep_base(self, samples):
        """The device-resize path's one upload per batch: the normalized
        original images collated (zero padded), with the original rois, and
        their (h, w) sizes."""
        base = self.collator([normalize(to_array(s), self.tta.pixel_mean,
                                        self.tta.pixel_std,
                                        self.tta.to_bgr255)
                              for s in samples])
        base = base.replace(images=base.images.to(self._base_dtype))
        in_hw = torch.tensor([[s.size[1], s.size[0]] for s in samples],
                             dtype=torch.float32)
        return base.to(self.device), in_hw.to(self.device)

    def _scale_targets(self, tr, samples):
        """Each image's (h, w) target at one TTA scale, and the padded
        canvas by the collator's rounding."""
        tgt = torch.tensor([get_resize_size(s.size, tr.min_size, tr.max_size)
                            for s in samples], dtype=torch.float32)
        m = self._pad_multiple
        canvas = (int(math.ceil(tgt[:, 0].max().item() / m) * m),
                  int(math.ceil(tgt[:, 1].max().item() / m) * m))
        return tgt.to(self.device), canvas

    def _device_resize_batches(self, groups, samples, prepped):
        """(batch, sizes (w, h)) per TTA group, each scale resized on the
        device from the one base upload."""
        t0 = time.perf_counter()
        base, in_hw = (self.prep_base(samples) if prepped is None
                       else prepped.result())
        self.timings["prep_wait_s"] += time.perf_counter() - t0
        for tr, _ in groups:
            tgt, canvas = self._scale_targets(tr, samples)
            batch = base.replace(
                images=resize_image_batch(base.images, in_hw, tgt, canvas),
                boxes=scale_boxes_batch(base.boxes, in_hw, tgt),
                image_sizes=tgt)
            yield batch, tgt.flip(1)

    def predict_samples(self, samples: List[Sample],
                        prepped: Optional[futures.Future] = None
                        ) -> List[Dict[str, np.ndarray]]:
        """samples: untransformed Samples with rois -> final per-image
        detections in the first (identity) transform's frame. ``prepped``:
        a future of ``prep_base(samples)`` for the device-resize path."""
        if not self.tta.enabled:
            return self.predict_batch(self.collator(samples).to(self.device))
        if self.supervised:
            raise NotImplementedError(
                "TEST.BBOX_AUG (TTA) covers the WSOD detector only, as in "
                "the JAX package; evaluate the supervised families without "
                "it")
        transforms = self.tta.transforms()
        groups = _tta_groups(transforms)
        union = self.tta.heur == "UNION"
        if self.device_resize and not union and self.needs_calib:
            # the int8 calibration sweeps the host path once
            self.calibrate([(None, samples, None)], 1)
        sum_scores = sum_boxes = ref_sizes = mask0 = None
        union_scores, union_boxes = [], []
        t_i = 0
        t0 = time.perf_counter()
        wait0 = self.timings["prep_wait_s"]
        batches = (self._device_resize_batches(groups, samples, prepped)
                   if self.device_resize
                   else self._host_prep_batches(groups, samples))
        for (tr, has_flip), (batch, sizes) in zip(groups, batches):
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
        """Non-TTA batch -> per-image detections, by the family's eval
        output: (scores, boxes) of the WSOD detector; RetinaNet's decoded
        dict (with "valid"); the supervised R-CNN's dict, whose mask pass
        adds each detection's ``mask_probs`` [M, M] (the batch's frame)."""
        t0 = time.perf_counter()
        out = self.forward_batch(batch)
        self._sync()
        self.timings["forward_s"] += time.perf_counter() - t0
        if not isinstance(out, dict):
            scores, boxes = out
            return self._finalize(scores, boxes,
                                  _match_mask(scores, batch.box_mask))
        if self.retinanet:
            # each kept (anchor, class) as a one-class score row
            b, k = out["scores"].shape
            scores = torch.zeros((b, k, self.model.num_classes),
                                 dtype=torch.float32, device=self.device)
            scores.scatter_(2, out["labels"][..., None],
                            torch.where(out["valid"], out["scores"],
                                        0.0)[..., None])
            return self._finalize(scores, out["boxes"], out["valid"])
        t0 = time.perf_counter()
        b, p = out["scores"].shape[:2]
        tb, ts, tl, tv = finalize_detections_device(
            out["boxes"].reshape(b, p, -1, 4), out["scores"],
            batch.box_mask, self.nms_thresh, self.score_thresh,
            self.det_per_img)
        dets = detections_to_host(tb, ts, tl, tv)
        self.timings["finalize_s"] += time.perf_counter() - t0
        if self.mask_on:
            probs = self.model.predict_masks(batch, tb, tl, out["features"])
            probs = probs.to("cpu", torch.float32).numpy()
            tvn = tv.cpu().numpy()
            for i, d in enumerate(dets):
                d["mask_probs"] = probs[i][tvn[i]]
        return dets

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


def _lookahead(items, pool, prep):
    """Each (batch, samples, idxs) with a future of ``prep(samples)``,
    submitted one item ahead so that the next batch's preparation overlaps
    this one's device work."""
    prev = None
    for item in items:
        fut = pool.submit(prep, item[1])
        if prev is not None:
            yield prev
        prev = (*item, fut)
    if prev is not None:
        yield prev


def _int8_scales(inferencer, model, cfg, eval_loader) -> None:
    """Load the static int8 scales from ``OUTPUT_DIR/int8_scales.npz``, or
    calibrate and write that file (rank 0)."""
    path = os.path.join(cfg.OUTPUT_DIR, "int8_scales.npz")
    if os.path.exists(path):
        model.backbone.act_amax = {
            i: a.to(inferencer.device) for i, a in load_int8_scales(path).items()}
        inferencer.needs_calib = False
        logger.info("Loaded int8 scales from %s", path)
        return
    inferencer.calibrate(eval_loader, cfg.TPU.INT8_CALIB_BATCHES)
    if process_count_and_index()[1] == 0 and os.path.isdir(cfg.OUTPUT_DIR):
        save_int8_scales(path, model)
        logger.info("Saved int8 scales to %s", path)


def inference(model, cfg, eval_loader, dataset, output_folder=None,
              task: str = "det", use_cached: bool = True, device="cuda",
              timing_out: Optional[dict] = None, vis: bool = False,
              vis_limit: int = 20):
    """Full dataset inference + evaluation: CorLoc for ``task`` corloc,
    else VOC mAP on a VOC dataset and COCO AP (bbox) on any other.

    Predictions are cached in ``output_folder/predictions.pkl`` and reused
    when ``use_cached``. ``timing_out``, when given, receives
    ``n_images``, ``n_forwards``, ``n_calib_forwards``, ``wall_s`` (the
    prediction loop), ``load_wait_s`` (waiting on image decode), the
    Inferencer's stage times and ``eval_s``.

    Static int8 serving loads ``cfg.OUTPUT_DIR/int8_scales.npz`` when it
    exists, else calibrates (before the loop, not counted in ``wall_s``)
    and writes it on rank 0. With several processes (``torch.distributed``
    initialized, the loader sharded by rank) rank 0 merges the shards and
    evaluates; the other ranks return None. ``vis`` draws the first
    ``vis_limit`` images' detections into ``output_folder/vis``
    (``utils/visualize.py``).
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
        if inferencer.needs_calib:
            _int8_scales(inferencer, model, cfg, eval_loader)
        tr0 = inferencer.tta.transforms()[0]
        prefetch = (cfg.TEST.BBOX_AUG.ENABLED and inferencer.device_resize
                    and not inferencer.needs_calib)
        predictions = {}
        n_images, load_wait = 0, 0.0

        def loader_items():
            nonlocal load_wait
            it = iter(eval_loader)
            while True:
                tl = time.perf_counter()
                item = next(it, None)
                load_wait += time.perf_counter() - tl
                if item is None:
                    return
                yield item

        t0 = time.perf_counter()
        with futures.ThreadPoolExecutor(1) as pool:
            items = (_lookahead(loader_items(), pool, inferencer.prep_base)
                     if prefetch else ((*item, None)
                                       for item in loader_items()))
            for batch, samples, idxs, prepped in items:
                if cfg.TEST.BBOX_AUG.ENABLED:
                    dets = inferencer.predict_samples(samples, prepped)
                else:
                    dets = inferencer.predict_batch(
                        batch.to(inferencer.device))
                for d, s, idx in zip(dets, samples, idxs):
                    if cfg.TEST.BBOX_AUG.ENABLED:
                        # identity frame -> original frame (the resize rule)
                        oh, ow = get_resize_size(s.size, tr0.min_size,
                                                 tr0.max_size)
                        from_wh = (ow, oh)
                    else:
                        from_wh = s.size
                    info = dataset.get_img_info(int(idx))
                    d = resize_detections(d, from_wh,
                                          (info["width"], info["height"]))
                    if "mask_probs" in d:
                        # full-image masks at the original size
                        d["masks"] = Masker()(d.pop("mask_probs"),
                                              d["boxes"], info["height"],
                                              info["width"])
                    predictions[int(idx)] = d
                n_images += len(samples)
        wall = time.perf_counter() - t0
        logger.info("Inference: %d images in %.1fs (%.4f s/img)", n_images,
                    wall, wall / max(n_images, 1))
        timing.update(n_images=n_images, n_forwards=inferencer.n_forwards,
                      n_calib_forwards=inferencer.n_calib_forwards,
                      wall_s=wall, load_wait_s=load_wait,
                      **inferencer.timings)
        predictions = gather_predictions(predictions, len(dataset),
                                         output_folder)
        if predictions is None:          # another rank evaluates
            if timing_out is not None:
                timing_out.update(timing)
            return None
        if pred_path:
            with open(pred_path, "wb") as f:
                pickle.dump(predictions, f)

    if vis and output_folder:
        _vis(dataset, predictions, os.path.join(output_folder, "vis"),
             vis_limit)
    t0 = time.perf_counter()
    if task == "corloc":
        result = do_corloc_evaluation(dataset, predictions, output_folder)
    elif isinstance(dataset, PascalVOCDataset):
        result = do_voc_evaluation(dataset, predictions, output_folder)
    else:       # COCO AP; predictions[i] is dataset index i's
        result = do_coco_evaluation(
            dataset, predictions, output_folder,
            iou_types=("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",))
    timing["eval_s"] = time.perf_counter() - t0
    if timing_out is not None:
        timing_out.update(timing)
    return result


def _vis(dataset, predictions, out_dir: str, limit: int) -> None:
    """The first ``limit`` images with their detections, as jpgs."""
    from PIL import Image

    from ..utils.visualize import vis_results

    imgs, dets = [], []
    for i in range(min(limit, len(predictions))):
        path = os.path.join(getattr(dataset, "root", ""),
                            dataset.get_img_info(i)["file_name"])
        if os.path.exists(path):
            with Image.open(path) as img:
                imgs.append(np.asarray(img.convert("RGB")))
            dets.append(predictions[i])
    if imgs:
        vis_results(dets, imgs, out_dir,
                    class_names=getattr(dataset, "CLASSES", None))
