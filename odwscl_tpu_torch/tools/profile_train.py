"""Where the time of a train step goes on the card.

    python -m odwscl_tpu_torch.tools.profile_train [--scale 1200] [--iters 5]

One bf16 train step of configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml at
full width (VGG16-OICR, batch 8, 2048 proposals per image, random init) on
random images of 375x500 resized to the train scale ``--scale`` (padded as
the collator pads):

1. the step's wall time (median of ``--iters`` steps after a warm-up) and
   the device's idle share over as many more steps, traced with
   torch.profiler (device activity only);
2. the forward split into its stages by CUDA events recorded as each
   stage is enqueued (``train_forward``'s ``trace``): backbone, ROIPool
   kernel, the no-grad clean pass, the DropBlock pass with the heads,
   stage A with its two views, stage B, the bank recompute with SupCon,
   the pseudo-labels and refinement losses. An event pair measures device
   time plus any wait on the host in between; the host syncs are counted
   per stage (``torch.cuda.set_sync_debug_mode``);
3. the backward and the optimizer step, timed the same way; the backbone's
   backward and the two ROIPool kernels (the training forward with its
   argmax, then the backward from it) also timed alone at the step's
   shapes, so the neck and heads' backward is the remainder.

Prints one JSON line per part with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import warnings

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "voc",
    "voc07_contra_db_b8_lr0.01_mcg.yaml")


def _events_ms(fn, iters=5, warmup=True):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if warmup:
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def synthetic_batch(cfg, scale: int, rng: np.random.RandomState, device):
    """A batch of 8 random 375x500 images resized to ``scale`` (as
    get_resize_size would), with 2048 proposals and 1-3 labels each."""
    from odwscl_tpu_torch.data.collate import _round_up
    from odwscl_tpu_torch.data.transforms import get_resize_size
    from odwscl_tpu_torch.models.detector import Batch

    b, p = cfg.SOLVER.IMS_PER_BATCH, 2048
    h, w = get_resize_size((500, 375), scale, cfg.INPUT.MAX_SIZE_TRAIN)
    ph = _round_up(_round_up(h, cfg.DATALOADER.SIZE_DIVISIBILITY),
                   cfg.TPU.IMAGE_PAD_MULTIPLE)
    pw = _round_up(_round_up(w, cfg.DATALOADER.SIZE_DIVISIBILITY),
                   cfg.TPU.IMAGE_PAD_MULTIPLE)
    images = np.zeros((b, ph, pw, 3), np.float32)
    images[:, :h, :w] = rng.uniform(-120, 130, (b, h, w, 3))
    xy = rng.uniform(0, [w - 40, h - 40], (b, p, 2))
    wh = rng.uniform(20, 0.6 * min(h, w), (b, p, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1)
    labels = np.zeros((b, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES), np.float32)
    for i in range(b):
        labels[i, rng.choice(np.arange(1, labels.shape[1]),
                             rng.randint(1, 4), replace=False)] = 1.0
    return Batch(torch.from_numpy(images),
                 torch.tensor([[h, w]] * b, dtype=torch.float32),
                 torch.from_numpy(boxes.astype(np.float32)),
                 torch.ones((b, p), dtype=torch.bool),
                 torch.from_numpy(labels)).to(device)


def forward_stages(model, batch, generator):
    """Device ms per forward stage and host syncs per stage, backward and
    optimizer ms, of one step."""
    marks, syncs = [], []
    start = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            start.record()

            def trace(stage):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((stage, ev))
                syncs.append(sum("synchroniz" in str(w.message)
                                 for w in caught))

            losses, _ = model.train_forward(batch, generator, trace=trace)
            total = torch.stack(list(losses.values())).sum()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    bwd_end = torch.cuda.Event(enable_timing=True)
    total.backward()
    bwd_end.record()
    torch.cuda.synchronize()
    ms, n_syncs, prev, prev_s = {}, {}, start, 0
    for (stage, ev), s in zip(marks, syncs):
        ms[stage] = prev.elapsed_time(ev)
        n_syncs[stage] = s - prev_s
        prev, prev_s = ev, s
    ms["backward"] = prev.elapsed_time(bwd_end)
    return ms, n_syncs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.engine.trainer import train_step
    from odwscl_tpu_torch.models.detector import detector_from_cfg
    from odwscl_tpu_torch.ops.roi_pool import (roi_pool_argmax,
                                               roi_pool_backward)
    from odwscl_tpu_torch.solver import make_optimizer
    from odwscl_tpu_torch.utils.device import resolve_device
    from odwscl_tpu_torch.utils.profiling import (card_name_and_limit,
                                                  device_busy_seconds)

    dev = resolve_device("cuda")
    card = card_name_and_limit()
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["MODEL.WEIGHT", ""])
    cfg.freeze()
    model = detector_from_cfg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    model.to(dev).train()
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.SEED)
    batch = synthetic_batch(cfg, args.scale, np.random.RandomState(0), dev)
    b, hp, wp, _ = batch.images.shape
    shape = {"batch": b, "padded_hw": [hp, wp], "proposals": 2048,
             "scale": args.scale, "dtype": "bfloat16"}

    for _ in range(2):                                   # warm-up
        train_step(model, optimizer, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        train_step(model, optimizer, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        for _ in range(args.iters):
            train_step(model, optimizer, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
    busy = device_busy_seconds(prof)
    print(json.dumps({"part": "train_step", "card": card, **shape,
                      "step_ms_median": statistics.median(step_s) * 1e3,
                      "step_ms": [s * 1e3 for s in step_s],
                      "images_per_s": b / statistics.median(step_s),
                      "device_busy_s": busy, "wall_s": wall,
                      "device_idle_share": 1.0 - busy / wall,
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated(dev) / 1e9}))

    ms, syncs = forward_stages(model, batch, gen)
    opt_ms, _ = _events_ms(lambda: optimizer.step(), iters=1, warmup=False)
    optimizer.zero_grad(set_to_none=True)

    # the backbone's backward and the ROIPool kernels alone, same shapes
    feats = model.backbone(batch.images)
    g = torch.randn_like(feats)
    bb_fwd_ms, _ = _events_ms(lambda: model.backbone(batch.images))
    bb_bwd = []
    for _ in range(3):
        out = model.backbone(batch.images)
        bb_bwd.append(_events_ms(lambda: torch.autograd.backward(out, g),
                                 iters=1, warmup=False)[0])
    bb_bwd_ms = statistics.median(bb_bwd)
    optimizer.zero_grad(set_to_none=True)
    feats = feats.detach()
    pool_ms, (pooled, argmax) = _events_ms(lambda: roi_pool_argmax(
        feats, batch.boxes, batch.box_mask, model.pooler_scale))
    gp = torch.randn_like(pooled)
    pool_bwd_ms, _ = _events_ms(lambda: roi_pool_backward(
        argmax, batch.boxes, batch.box_mask, gp, model.pooler_scale,
        tuple(feats.shape[1:3])))
    print(json.dumps({"part": "stages_ms", "card": card, **shape,
                      "forward": ms, "host_syncs": syncs,
                      "optimizer": opt_ms,
                      "alone": {"backbone_forward": bb_fwd_ms,
                                "backbone_backward": bb_bwd_ms,
                                "roi_pool_fwd_argmax_kernel": pool_ms,
                                "roi_pool_bwd_kernel": pool_bwd_ms,
                                "roi_pool_pair": pool_ms + pool_bwd_ms},
                      "neck_heads_backward": ms["backward"] - bb_bwd_ms
                      - pool_bwd_ms}))


if __name__ == "__main__":
    main()
