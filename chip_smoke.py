#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
1. Print the card's name and power limit; build the ROIPool forward kernel
   (odwscl_tpu_torch/csrc/roi_pool_fwd.cu) with nvcc for sm_90a.
2. Hold the kernel against its plain PyTorch version on the card,
   bit-exactly (atol 0) in f32 and bf16: a size grid of rois (1 cell up to
   the full map, malformed, off-map, masked, empty bins) and the main-path
   shape feat [8, 104, 168, 512], P = 2048. Time both at the main-path shape.
3. Run ``eval_forward`` at full width in f32 (TF32 off) on the card and on
   the CPU with the same seeded weights and inputs; compare.
4. Drive the main path: ``odwscl_tpu_torch.tools.test_net`` with
   configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml (VGG16-OICR, bf16,
   14-transform TTA, AVG) on a synthetic VOC test split of 16 images with
   2048 proposals each, tasks det and corloc. Every forward must have gone
   through the kernel.

Prints a ``{"kernels": [...]}`` line and, last, a one-line JSON result.
Needs no network; exits non-zero without a CUDA card or outside the repo.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "voc",
                      "voc07_contra_db_b8_lr0.01_mcg.yaml")

# Peak device-memory rate by card (NVIDIA data sheets) and the f32 rate
# outside the tensor cores, for the comparisons of the pooling kernel.
MEM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100": 3.35e12, "H200": 4.8e12}
F32_OPS_PER_S = {"H100 PCIe": 51.0e12, "H100": 67.0e12, "H200": 67.0e12}

# phase 3: f32 card vs CPU. Both run the same f32 algorithm; the card sums
# convolutions and GEMMs in another order (cuDNN/cuBLAS tiling, no TF32).
# Through 13 convs and 2 fc layers that drifts by ~1e-5 relative, so the
# softmax scores (in [0, 1]) may move by 1e-3 at most and the decoded boxes
# (up to ~320 px) by 5e-2 px at most.
SCORE_ATOL = 1e-3
BOX_ATOL_PX = 5e-2


def card_rate(name, table):
    for key in sorted(table, key=len, reverse=True):
        if key in name:
            return table[key]
    raise RuntimeError(f"no published rate for card {name!r}")


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bin_cells(rois, mask, h, w, scale=0.125, pooled=7):
    """Cells scanned by the pooling of these rois (sum over bins), from
    the same integer bin edges as the kernel."""
    cells = np.floor(rois.astype(np.float32) * np.float32(scale)
                     + np.float32(0.5)).astype(np.int64)
    x1, y1, x2, y2 = (cells[..., i] for i in range(4))
    rw = np.maximum(x2 - x1 + 1, 1)[..., None]
    rh = np.maximum(y2 - y1 + 1, 1)[..., None]
    k = np.arange(pooled)
    hs = np.clip(k * rh // pooled + y1[..., None], 0, h)
    he = np.clip(-(-(k + 1) * rh // pooled) + y1[..., None], 0, h)
    ws = np.clip(k * rw // pooled + x1[..., None], 0, w)
    we = np.clip(-(-(k + 1) * rw // pooled) + x1[..., None], 0, w)
    per_roi = (he - hs).sum(-1) * (we - ws).sum(-1)
    return int((per_roi * mask).sum())


def grid_inputs(rng, c):
    """Size grid of the JAX package's Pallas tests: sweep rois (every size
    class, degenerate and off-map) plus a dense extent grid 1..259 cells."""
    h, w = 200, 260
    sweep = [[16, 8, 100, 90], [40, 40, 47.9, 47.9], [3, 5, 30, 100],
             [0, 0, 8, 8], [10, 10, 130, 120], [5, 5, 230, 110],
             [5, 5, 60, 500], [0, 0, 255, 191], [0, 0, 1990, 1480],
             [300, 200, 1999, 1501], [-50, -30, 100, 80],
             [1400, 1100, 2300, 1900], [130, 90, 120, 80],  # malformed
             [56, 56, 56, 56], [0, 0, 447, 447], [8, 8, 119, 119],
             [3000, 3000, 3100, 3100],                       # all bins empty
             [0, 0, 2079, 1599]]                             # the full map
    sizes = [1, 2, 3, 7, 9, 15, 16, 17, 18, 33, 34, 64, 100, 160, 259]
    for i, sy in enumerate(sizes):
        sx = sizes[(i * 7 + 3) % len(sizes)]
        y0 = (i * 13) % max(h - sy, 1)
        x0 = (i * 29) % max(w - sx, 1)
        sweep.append([x0 * 8.0, y0 * 8.0, (x0 + sx) * 8.0 - 1,
                      (y0 + sy) * 8.0 - 1])
    rois = np.asarray(sweep, np.float32)
    rois = np.stack([rois, rois[::-1].copy()])
    mask = np.ones(rois.shape[:2], bool)
    mask[0, 2] = mask[1, 5] = False                          # masked rois
    feat = rng.randn(2, h, w, c).astype(np.float32)
    return feat, rois, mask


def main_path_inputs(rng, b=8, h=104, w=168, c=512, p=2048):
    """The bench shape: 832x1344 images (stride 8), rois 16-300 px."""
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1y1 = rng.uniform(0, 1000, (b, p, 2))
    wh = rng.uniform(16, 300, (b, p, 2))
    rois = np.concatenate([x1y1, np.minimum(x1y1 + wh, [1332, 799])],
                          -1).astype(np.float32)
    return feat, rois, np.ones((b, p), bool)


def phase_kernel(dev, rp):
    import torch

    rng = np.random.RandomState(0)
    checks = {}
    for label, (feat, rois, mask) in (("grid", grid_inputs(rng, 64)),
                                      ("main", main_path_inputs(rng))):
        r = torch.from_numpy(rois).to(dev)
        m = torch.from_numpy(mask).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            f = torch.from_numpy(feat).to(dev, dtype)
            got = rp.roi_pool(f, r, m, 0.125)
            want = rp.roi_pool_plain(f, r, m, 0.125)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"roi_pool kernel != plain ({label}, "
                                     f"{dtype}): max |diff| {err}")
            checks[f"{label}/{str(dtype)[6:]}"] = err
            print(f"[kernel] {label} {str(dtype)[6:]} feat "
                  f"{list(f.shape)} P={r.shape[1]}: bit-exact vs plain")
    # timing at the main-path shape, bf16 (the config's compute dtype)
    f = torch.from_numpy(feat).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: rp.roi_pool(f, r, m, 0.125), iters=20)
    plain_ms = cuda_ms(lambda: rp.roi_pool_plain(f, r, m, 0.125), iters=3,
                       warmup=1)
    b, h, w, c = f.shape
    p = r.shape[1]
    name = torch.cuda.get_device_name(dev)
    nbytes = (f.numel() + b * p * 49 * c) * f.element_size() \
        + r.numel() * 4 + m.numel()
    bytes_ms = nbytes / card_rate(name, MEM_BYTES_PER_S) * 1e3
    ops = bin_cells(rois, mask, h, w) * c
    ops_ms = ops / card_rate(name, F32_OPS_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[kernel] main shape bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.3f} GB; {ops / 1e9:.2f} G comparisons = "
          f"{ops_ms:.4f} ms)")
    return {"max_abs_err": max(checks.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_card_vs_cpu(dev):
    import torch
    from odwscl_tpu_torch.models import Batch, WSODDetector

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(1)
    b, h, w, p = 2, 256, 320, 256
    sizes = np.array([[256, 320], [240, 300]], np.float32)
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    x1y1 = rng.uniform(0, 200, (b, p, 2))
    wh = rng.uniform(16, 200, (b, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, sizes[:, None, ::-1]
                                             - 1)], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.1
    batch = Batch(*(torch.from_numpy(a) for a in (images, sizes, boxes, mask)))
    model = WSODDetector(compute_dtype="float32")
    model.reset_parameters(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    s_cpu, b_cpu = model.eval_forward(batch)
    t_cpu = time.perf_counter() - t0
    model.to(dev)
    t0 = time.perf_counter()
    s_gpu, b_gpu = model.eval_forward(batch.to(dev))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ds = (s_gpu.cpu() - s_cpu).abs().max().item()
    db = (b_gpu.cpu() - b_cpu).abs().max().item()
    print(f"[slice] f32 eval_forward card vs CPU, B={b} {h}x{w} P={p}: "
          f"max |d score| {ds:.3e} (tol {SCORE_ATOL}), max |d box| "
          f"{db:.3e} px (tol {BOX_ATOL_PX}); score range "
          f"[{s_cpu.min().item():.4f}, {s_cpu.max().item():.4f}]; "
          f"CPU {t_cpu:.2f} s, card {t_gpu:.2f} s (first call)")
    if not (torch.isfinite(s_gpu).all() and torch.isfinite(b_gpu).all()):
        raise AssertionError("non-finite eval_forward output on the card")
    if ds > SCORE_ATOL or db > BOX_ATOL_PX:
        raise AssertionError("card and CPU eval_forward disagree")


def phase_main_path(rp):
    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
    from odwscl_tpu_torch.tools import test_net

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    tmp = tempfile.mkdtemp(prefix="odwscl_smoke_")
    try:
        t0 = time.perf_counter()
        n_images = 16
        write_synthetic_voc(tmp, n_test=n_images, seed=0, img_hw=(375, 500),
                            n_props=2048, prop_size=(20, 300),
                            obj_size=(40, 200),
                            test_proposal_file=cfg.PROPOSAL_FILES.TEST[0])
        print(f"[main] synthetic VOC test split: {n_images} images 375x500, "
              f"2048 proposals each, written in "
              f"{time.perf_counter() - t0:.2f} s")
        n_batches = math.ceil(n_images / cfg.TEST.IMS_PER_BATCH)
        n_tta = 2 * (1 + len(cfg.TEST.BBOX_AUG.SCALES))
        results = {}
        rp.roi_pool.launches = 0
        for task in ("det", "corloc"):
            timing = {}
            t0 = time.perf_counter()
            res = test_net.main(["--config-file", CONFIG, "--data-root", tmp,
                                 "--task", task, "--device", "cuda",
                                 "OUTPUT_DIR", os.path.join(tmp, task)],
                                timing_out=timing)
            wall = time.perf_counter() - t0
            (t,) = timing.values()
            (r,) = res.values()
            results[task] = (r, t, wall)
        launches = rp.roi_pool.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for task, (r, t, wall) in results.items():
        metric = r["map"] if task == "det" else r["mean_corloc"]
        if not math.isfinite(metric):
            raise AssertionError(f"{task}: non-finite result {metric}")
        if t["n_forwards"] != n_batches * n_tta:
            raise AssertionError(f"{task}: {t['n_forwards']} forwards, "
                                 f"expected {n_batches} x {n_tta}")
        print(f"[main] {task}: {'mAP' if task == 'det' else 'CorLoc'} "
              f"{metric:.4f} (random weights); {t['n_images']} images in "
              f"{t['wall_s']:.2f} s = {t['n_images'] / t['wall_s']:.2f} "
              f"images/s; {t['n_forwards']} forwards; stage s: load wait "
              f"{t['load_wait_s']:.2f}, host prep wait "
              f"{t['prep_wait_s']:.2f}, forward+merge {t['forward_s']:.2f}, "
              f"NMS+top-K+to-host {t['finalize_s']:.2f}, eval "
              f"{t['eval_s']:.3f}; CLI wall {wall:.2f} s")
    total = sum(t["n_forwards"] for _, t, _ in results.values())
    if launches != total:
        raise AssertionError(f"roi_pool kernel launched {launches} times for "
                             f"{total} forwards")
    print(f"[main] roi_pool kernel launches {launches} = forwards {total} "
          f"({n_tta} per batch)")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odwscl_tpu_torch.ops import roi_pool as rp

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    rp.KERNEL.get()
    print(f"[build] roi_pool_fwd.cu in {time.perf_counter() - t0:.2f} s")
    for line in rp.KERNEL.compile_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    kern = phase_kernel(dev, rp)
    print(f"[phase] kernel checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_card_vs_cpu(dev)
    print(f"[phase] card vs CPU {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_main_path(rp)
    print(f"[phase] main path {time.perf_counter() - t0:.1f} s")

    entry = {"name": "roi_pool_fwd", "route": "cuda",
             "source": "odwscl_tpu_torch/csrc/roi_pool_fwd.cu",
             "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:245 _fwd_kernel",
             "launches": launches, **kern, "library_ms": None}
    entry["max_abs_diff_vs_plain"] = entry["max_abs_err"]
    entry["kernel_ms"] = entry["ms"]
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
