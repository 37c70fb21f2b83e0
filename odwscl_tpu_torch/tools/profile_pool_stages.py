"""Where the ROIPool forward's time goes on the card: kernel #1 beside the
five stages of the stage profiler.

    python -m odwscl_tpu_torch.tools.profile_pool_stages [--pooled R]
    python -m odwscl_tpu_torch.tools.profile_pool_stages --device cpu \\
        --shape 1 24 40 8 16

One entry point for the JAX package's two TPU stage tools:
``tools/profile_pool_stages.py`` (write, rows, cols, full) and
``tools/profile_pool.py``, whose two variants are ``rows_col0`` and
``cols`` here (``ops/roi_pool_stages.py`` defines every stage).
``tools/profile_pool.py`` is stale against the v5 kernel module and cannot
run: it calls ``_prep`` without ``bwd`` and unpacks 7 of its 9 values, and
it calls ``_rowbins`` and ``_ct``, which no longer exist.

Inputs as ``tools/profile_pool_stages.py`` makes them: seed 0, feat [B, H,
W, C] = [8, 104, 168, 512] in bf16 from a normal draw, P = 2048 live rois
per image with x1, y1 uniform in [0, 1000) and width and height uniform in
[16, 300), clipped to (1332, 799); spatial scale 1/8.

On the card (the default) it times kernel #1 (``roi_pool``) and the five
stage kernels (``roi_pool_stage``, one plan for all) with CUDA events,
and beside them ``torch.zeros`` of the output's shape, the one PyTorch
call that computes a stage (``write``): 20 launches after a warm-up, in
turns (A B ... B A), twice. Each stage is #1's own kernel
(``csrc/roi_pool_fwd.cu``) with the same launch shape, its loop run over
another rectangle per output bin, so the deltas read as cuts of #1:

- ``write``: the launch and the store path alone, no roi read;
- ``row_walk`` = rows_col0 - write: walking each bin's rows, one load per
  row (the chain of dependent row loads and folds);
- ``row_strip`` = rows - write: the same rows, 8 columns each;
- ``column_reduction`` = cols - write: one row per row bin, reduced
  across the bin's columns;
- ``per_roi_work`` = full - write: all of #1's work past its stores.

``--pooled R`` (1 to 16; 7 by default) pools kernel #1 at R x R, beside
the stages, which cut #1's R = 7 instantiation and stay 7x7; its share of
#1 is then the stages' share of another kernel.

It prints each time with its bound (``stage_work``: the map cells it
needs and the output, over the card's published rate) and share of that
bound, its share of #1's time, the deltas, the block shape, the card's
name and power limit, and last one JSON line with all of it. With
``--device cpu`` it runs each plain version once at ``--shape`` and
prints its host time as "plain (cpu)".
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import time

import numpy as np
import torch

from ..ops.roi_pool import POOLED, roi_pool
from ..ops.roi_pool_stages import (STAGES, block_shape, roi_pool_stage,
                                   stage_bound, stage_plan)
from ..utils.device import resolve_device
from ..utils.profiling import card_name_and_limit

SCALE = 0.125
BENCH_SHAPE = (8, 104, 168, 512, 2048)     # B, H, W, C, P
ITERS = 20                                 # launches between two events
NAMES = ("roi_pool",) + STAGES


def make_inputs(b, h, w, c, p, seed=0):
    """feat [B, H, W, C] f32, rois [B, P, 4] f32, mask [B, P] (all live),
    numpy, drawn as tools/profile_pool_stages.py draws them."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1y1 = rng.uniform(0, 1000, (b, p, 2))
    wh = rng.uniform(16, 300, (b, p, 2))
    rois = np.concatenate([x1y1, np.minimum(x1y1 + wh, [1332, 799])],
                          -1).astype(np.float32)
    return feat, rois, np.ones((b, p), bool)


def time_in_turns(fns, iters, rounds=2):
    """{name: [ms per call, ...]}: each function called ``iters`` times
    between two CUDA events, after one warm-up call each; the functions
    taken in turns, forward then backward (A B ... B A), ``rounds`` times."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns) + list(reversed(fns))
    for _ in range(rounds):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return times


def _run_cpu(feat, rois, mask, pooled=POOLED):
    ms = {}
    for name in NAMES:
        t0 = time.perf_counter()
        if name == "roi_pool":
            roi_pool(feat, rois, mask, SCALE, pooled)
        else:
            roi_pool_stage(feat, rois, mask, SCALE, name)
        ms[name] = (time.perf_counter() - t0) * 1e3
        print(f"{name:10s} plain (cpu) {ms[name]:10.3f} ms")
    result = {"device": "cpu", "shape": list(feat.shape) + [rois.shape[1]],
              "pooled": pooled, "plain_cpu_ms": ms}
    print(json.dumps(result))
    return result


def profile(feat, rois, mask, pooled=POOLED):
    """Times kernel #1 at ``pooled``, the five stage kernels and
    ``torch.zeros`` (the library call of ``write``) on these card tensors,
    prints the table and returns it as a dict."""
    card = card_name_and_limit()
    name = torch.cuda.get_device_name(feat.device)
    plan = stage_plan(feat, rois, mask, SCALE)
    b, _, _, c = feat.shape
    fns = {"roi_pool": functools.partial(roi_pool, feat, rois, mask, SCALE,
                                         pooled)}
    for stage in STAGES:
        fns[stage] = functools.partial(roi_pool_stage, feat, rois, mask,
                                       SCALE, stage, plan)
    fns["torch.zeros"] = functools.partial(
        torch.zeros, (b, rois.shape[1], POOLED, POOLED, c), dtype=feat.dtype,
        device=feat.device)
    times = time_in_turns(fns, ITERS)
    block = block_shape(feat.dtype)
    print(card)
    print(f"feat {list(feat.shape)} {str(feat.dtype)[6:]}, "
          f"P={rois.shape[1]}; blocks of {block['channel_tile']} channels x "
          f"{block['rois_per_block']} rois, {block['threads']} threads; "
          f"{ITERS} launches x {len(times['roi_pool'])} readings each")
    variants = {}
    base = statistics.mean(times["roi_pool"])
    for key in NAMES:
        ms = statistics.mean(times[key])
        bound_ms, by, nbytes, ops = stage_bound(
            key, feat, rois, mask, SCALE, name,
            pooled if key == "roi_pool" else POOLED)
        variants[key] = {"ms": ms, "readings_ms": times[key],
                         "bound_ms": bound_ms, "bound_by": by,
                         "bytes": nbytes, "comparisons": ops,
                         "share_of_bound": bound_ms / ms,
                         "share_of_roi_pool": ms / base}
        print(f"{key:10s} {ms:8.4f} ms (readings {min(times[key]):.4f}-"
              f"{max(times[key]):.4f}); bound {bound_ms:.4f} ms ({by}, "
              f"{nbytes / 1e6:.1f} MB) = {bound_ms / ms:6.1%} of bound; "
              f"{ms / base:6.1%} of roi_pool")
    library_ms = {"write": statistics.mean(times["torch.zeros"])}
    print(f"library    {library_ms['write']:8.4f} ms (torch.zeros of the "
          f"output, the library call of write; readings "
          f"{min(times['torch.zeros']):.4f}-{max(times['torch.zeros']):.4f})")
    ms = {k: v["ms"] for k, v in variants.items()}
    deltas = {"row_walk": ms["rows_col0"] - ms["write"],
              "row_strip": ms["rows"] - ms["write"],
              "column_reduction": ms["cols"] - ms["write"],
              "per_roi_work": ms["full"] - ms["write"]}
    print("stage deltas: " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in deltas.items()))
    result = {"card": card, "device": name,
              "shape": list(feat.shape) + [rois.shape[1]],
              "dtype": str(feat.dtype)[6:], "pooled": pooled, "block": block,
              "iters": ITERS, "variants": variants,
              "library_ms": library_ms, "deltas_ms": deltas}
    print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) times the kernels; cpu runs "
                         "the plain versions once each")
    ap.add_argument("--shape", type=int, nargs=5, default=list(BENCH_SHAPE),
                    metavar=("B", "H", "W", "C", "P"))
    ap.add_argument("--pooled", type=int, default=POOLED,
                    help="kernel #1's resolution R (the stages pool 7x7)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    feat_np, rois_np, mask_np = make_inputs(*args.shape)
    feat = torch.from_numpy(feat_np).to(dev, torch.bfloat16)
    rois = torch.from_numpy(rois_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    del feat_np
    if dev.type == "cpu":
        return _run_cpu(feat, rois, mask, args.pooled)
    return profile(feat, rois, mask, args.pooled)


if __name__ == "__main__":
    main()
