"""Where the eval time goes on the card: per-stage device time of one
forward, and the device's busy share over one 14-transform TTA batch.

    python -m odwscl_tpu_torch.tools.profile_eval [--batch 8] [--iters 5]

1. One ``eval_forward`` at the main-path shape (bf16, B images of
   832x1344, 2048 proposals each), split into its stages (backbone, ROIPool
   kernel, fc6/fc7 neck, heads + decode), each timed with CUDA events over
   ``--iters`` runs after a warm-up.
2. One TTA batch of the shipped VOC config (the Inferencer's host-resize
   path: PIL resize + collate per scale, forwards, AVG merge, NMS) on
   synthetic 375x500 images, traced with torch.profiler: the summed
   device time of all kernels against the wall time gives the busy share.

Random weights (seeded); prints one JSON line per part. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "voc",
    "voc07_contra_db_b8_lr0.01_mcg.yaml")


def _events_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def backbone_flops(spec, h, w, cin=3):
    """Multiply-adds x 2 of the 3x3 convs of a VGG spec on one h x w image
    (padded convs keep the size; 'M' halves it)."""
    flops = 0
    for v in spec:
        if v == "M":
            h, w = h // 2, w // 2
        elif v != "I":
            ch = int(str(v).split("-")[0])
            flops += 2 * h * w * cin * ch * 9
            cin = ch
    return flops


def conv_outputs_channels_last(backbone, images):
    """Whether every conv of the backbone writes channels_last memory (then
    its NHWC output is a free view)."""
    import torch.nn.functional as F
    from unittest import mock

    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        y = conv2d(*args, **kwargs)
        seen.append(y.is_contiguous(memory_format=torch.channels_last))
        return y

    with mock.patch.object(F, "conv2d", spy), torch.no_grad():
        backbone(images)
    return bool(seen) and all(seen)


def forward_stages(model, batch, iters):
    """Device ms per stage of ``eval_forward`` at the batch's shape."""
    from odwscl_tpu_torch.ops.roi_pool import roi_pool

    with torch.no_grad():
        model.eval_forward(batch)                       # warm-up
        torch.cuda.synchronize()
        b, p = batch.boxes.shape[:2]
        ms = {}
        ms["backbone"], feats = _events_ms(
            lambda: model.backbone(batch.images), iters)
        ms["roi_pool"], pooled = _events_ms(
            lambda: roi_pool(feats, batch.boxes, batch.box_mask,
                             model.pooler_scale), iters)
        ms["neck_fc6_fc7"], clean = _events_ms(
            lambda: model.neck(pooled.reshape(b * p, -1)), iters)
        ms["heads"], _ = _events_ms(
            lambda: model.pred(clean.reshape(b, p, -1), batch.box_mask), iters)
        ms["eval_forward"], _ = _events_ms(
            lambda: model.eval_forward(batch), iters)
    return ms


def tta_busy_share(model, cfg, samples):
    """Wall seconds of one TTA batch and the device's busy share in it."""
    from torch.profiler import ProfilerActivity, profile

    from odwscl_tpu_torch.engine.inference import Inferencer
    from odwscl_tpu_torch.utils.profiling import device_busy_seconds

    inf = Inferencer(model, cfg, "cuda")
    inf.predict_samples(samples)                        # warm-up
    torch.cuda.synchronize()
    inf.timings = dict.fromkeys(inf.timings, 0.0)
    inf.n_forwards = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inf.predict_samples(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "stage_s": inf.timings, "n_forwards": inf.n_forwards}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import subprocess

    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.transforms import Sample
    from odwscl_tpu_torch.models import Batch
    from odwscl_tpu_torch.models.detector import detector_from_cfg
    from odwscl_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    model = detector_from_cfg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(cfg.SEED))
    model.to(dev).eval()

    rng = np.random.RandomState(0)
    b, h, w, p = args.batch, 832, 1344, 2048
    x1y1 = rng.uniform(0, 1000, (b, p, 2))
    wh = rng.uniform(16, 300, (b, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, [1332, 799])], -1)
    batch = Batch(torch.from_numpy(rng.randn(b, h, w, 3).astype(np.float32)),
                  torch.tensor([[800.0, 1333.0]] * b),
                  torch.from_numpy(boxes.astype(np.float32)),
                  torch.ones((b, p), dtype=torch.bool)).to(dev)
    ms = forward_stages(model, batch, args.iters)
    conv_flop = b * backbone_flops(model.backbone.spec, h, w)
    print(json.dumps({"part": "forward_stages_ms", "card": card,
                      "shape": [b, h, w, p], "dtype": "bfloat16", **ms,
                      "images_per_s": b / ms["eval_forward"] * 1e3,
                      "backbone_tflop": conv_flop / 1e12,
                      "backbone_tflop_per_s":
                          conv_flop / ms["backbone"] / 1e9,
                      "backbone_channels_last": conv_outputs_channels_last(
                          model.backbone, batch.images)}))

    from PIL import Image
    samples = []
    for i in range(args.batch):
        img = rng.randint(0, 255, (375, 500, 3), np.uint8)
        xy = rng.uniform(0, 300, (p, 2))
        rois = np.concatenate([xy, xy + rng.uniform(20, 200, (p, 2))], -1)
        rois = np.minimum(rois, [499, 374, 499, 374]).astype(np.float32)
        samples.append(Sample(image=Image.fromarray(img), size=(500, 375),
                              rois=rois, image_id=i))
    print(json.dumps({"part": "tta_batch", "card": card,
                      "images": len(samples), "image_wh": [500, 375],
                      "proposals": p, **tta_busy_share(model, cfg, samples)}))


if __name__ == "__main__":
    main()
