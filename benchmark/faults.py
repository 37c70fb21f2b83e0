"""Faults planted in the program underneath a run, for the checks that
have to read ``correct`` false (the CPU tests of every fault a cell can
have, and ``calibrate.py --faults`` on the card at the cell's size).

    with faults.plant("nms_skipped"):
        ...   # the port's eval path keeps every box of every class

Each fault patches one function of the port and is undone on exit. One
card: no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

TRAIN = ("unchanged_state", "train_half_batch", "train_altered_loss",
         "lr_scaled", "pool_grad_mirror")
EVAL = ("eval_half_batch", "eval_altered_answer", "nms_skipped",
        "nms_threshold", "topk_unsorted")

# the planted LR is off by this factor, the planted NMS threshold by this
LR_FACTOR = 1.3
NMS_STEP = 0.1


def _train_step_without_update(model, optimizer, batch, generator=None,
                               draws=None, dp=None):
    losses, metrics = model.train_forward(batch, generator, draws)
    optimizer.zero_grad(set_to_none=True)
    return {"loss": torch.stack(list(losses.values())).sum().detach(),
            **{k: v.detach() for k, v in losses.items()}, **metrics}


def _half(batch):
    b = batch.images.shape[0] // 2
    return batch.replace(**{k: getattr(batch, k)[:b] for k in (
        "images", "image_sizes", "boxes", "box_mask", "labels")})


def _topk_unsorted(boxes, scores, box_mask, nms_thresh, score_thresh,
                   k=100):
    """``finalize_detections_device`` with the top-K taken in (class,
    proposal) order instead of by score: the first K boxes NMS kept."""
    from odwscl_tpu_torch.engine.postprocess import per_class_nms_keep

    keep = per_class_nms_keep(boxes, scores, box_mask, nms_thresh,
                              score_thresh)
    b, c, p = keep.shape
    boxes_t = (boxes.reshape(b, p, c, 4).permute(0, 2, 1, 3)
               .reshape(b, c * p, 4))
    flat_keep = keep.reshape(b, c * p)
    order = torch.argsort(flat_keep.to(torch.int8), dim=1, descending=True,
                          stable=True)[:, :k]
    top_scores = torch.gather(scores.permute(0, 2, 1).reshape(b, c * p), 1,
                              order)
    valid = torch.gather(flat_keep, 1, order)
    top_boxes = torch.gather(boxes_t, 1, order[..., None].expand(-1, -1, 4))
    return (top_boxes, torch.where(valid, top_scores, -1.0),
            torch.div(order, p, rounding_mode="floor"), valid)


@contextlib.contextmanager
def plant(fault: str):
    """The port with ``fault`` planted, for the length of the block."""
    from odwscl_tpu_torch.engine import inference, postprocess, trainer
    from odwscl_tpu_torch.models.detector import WSODDetector
    from odwscl_tpu_torch.ops.roi_pool import RoIPoolFunction
    from odwscl_tpu_torch.solver import build as solver_build

    forward = WSODDetector.train_forward
    if fault == "unchanged_state":
        patch = mock.patch.object(trainer, "train_step",
                                  _train_step_without_update)
    elif fault == "train_half_batch":
        patch = mock.patch.object(
            WSODDetector, "train_forward",
            lambda self, batch, *a, **k: forward(self, _half(batch), *a, **k))
    elif fault == "train_altered_loss":
        def altered(self, *a, **k):
            losses, metrics = forward(self, *a, **k)
            losses["loss_img"] = losses["loss_img"] * 1.5
            return losses, metrics
        patch = mock.patch.object(WSODDetector, "train_forward", altered)
    elif fault == "lr_scaled":
        schedule = solver_build.warmup_multistep_schedule

        def scaled(*a, **k):
            inner = schedule(*a, **k)
            return lambda count: inner(count) * LR_FACTOR
        patch = mock.patch.object(solver_build, "warmup_multistep_schedule",
                                  scaled)
    elif fault.startswith("pool_grad_"):
        from .reference.model import MISROUTES

        backward, route = RoIPoolFunction.backward, MISROUTES[fault[10:]]

        def misrouted(ctx, grad):
            dfeat, *rest = backward(ctx, grad)
            return (route(dfeat), *rest)
        patch = mock.patch.object(RoIPoolFunction, "backward",
                                  staticmethod(misrouted))
    elif fault == "eval_half_batch":
        predict = inference.Inferencer.predict_samples

        def half(self, samples, prepped=None):
            n = len(samples) // 2
            empty = {"boxes": np.zeros((0, 4), np.float32),
                     "scores": np.zeros(0, np.float32),
                     "labels": np.zeros(0, np.int64)}
            return predict(self, samples[:n]) + [dict(empty)] * (
                len(samples) - n)
        patch = mock.patch.object(inference.Inferencer, "predict_samples",
                                  half)
    elif fault == "eval_altered_answer":
        to_host = inference.detections_to_host

        def altered_host(*a):
            dets = to_host(*a)
            dets[0]["labels"][0] = dets[0]["labels"][0] % 20 + 1
            return dets
        patch = mock.patch.object(inference, "detections_to_host",
                                  altered_host)
    elif fault == "nms_skipped":
        patch = mock.patch.object(postprocess, "batched_nms_mask",
                                  lambda boxes, scores, mask, thresh: mask)
    elif fault == "nms_threshold":
        nms = postprocess.batched_nms_mask
        patch = mock.patch.object(
            postprocess, "batched_nms_mask",
            lambda boxes, scores, mask, thresh: nms(boxes, scores, mask,
                                                    thresh + NMS_STEP))
    elif fault == "topk_unsorted":
        patch = mock.patch.object(inference, "finalize_detections_device",
                                  _topk_unsorted)
    else:
        raise ValueError(f"no fault {fault!r}: {TRAIN + EVAL}")
    with patch:
        yield
