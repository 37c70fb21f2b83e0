#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
1. Print the card's name and power limit; build the ROIPool forward and
   backward kernels (odwscl_tpu_torch/csrc/roi_pool_{fwd,bwd}.cu) with
   nvcc for sm_90a, both at once.
2. Hold the forward kernel against its plain PyTorch version on the card,
   bit-exactly (atol 0) in f32 and bf16: a size grid of rois (1 cell up to
   the full map, malformed, off-map, masked, empty bins) and the eval
   shape feat [8, 104, 168, 512], P = 2048. Time both at the eval shape.
3. Hold the backward kernel against ``roi_pool_backward_plain`` on the
   card in f32 and bf16: the size grid, a bf16 ties case and the training
   shape feat [8, 160, 208, 512] (a padded 1200-scale batch), P = 2048.
   Routing exact, values within the atomics' reordering bound. Time both
   at the training shape.
4. Run ``eval_forward`` at full width in f32 (TF32 off) on the card and on
   the CPU with the same seeded weights and inputs; compare.
5. Run one f32 train step (TF32 off) at full width on a small input on
   the card and on the CPU with the same weights and the same DropBlock
   and noise draws; compare the mining decisions, losses and gradients.
6. Drive the training path: ``odwscl_tpu_torch.tools.train_net`` with
   configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml (VGG16-OICR, bf16, batch
   8, scales 480-1200, random init) for 20 iterations on a synthetic VOC
   trainval split of 32 images of 375x500 with 2048 proposals each. Every
   step must have launched both kernels once; every loss must be finite.
7. Drive the eval path: ``odwscl_tpu_torch.tools.test_net`` (14-transform
   TTA, AVG) on the checkpoint that training wrote, on a synthetic test
   split of 16 images, tasks det and corloc. Every forward must have gone
   through the forward kernel.

Prints a ``{"kernels": [...]}`` line and, last, a one-line JSON result.
Needs no network; exits non-zero without a CUDA card or outside the repo.
"""

import json
import math
import os
import shutil
import statistics
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

# phase 5: f32 train step card vs CPU, same drift source. Losses 1e-3
# relative; gradients of the heads, neck and SimNet 1e-2 of each tensor's
# largest magnitude (the drift of ~1e-5 at the features, amplified by the
# scaled heads, the softmaxes and the supcon exponentials); the backbone is
# left out (a ReLU unit within the drift of 0 flips its sign between the two
# devices and moves a weight gradient by up to ~1%).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL = 1e-2
# score heads scaled so that the argmaxes of the mining are well apart; at
# the full 4096 width a larger factor saturates the softmaxes to exactly 1
# (and the BCE's log1p(-1) then has a NaN gradient in both packages)
HEAD_SCALE = 30.0
TRAIN_STEPS = 20


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


def main_path_inputs(rng, b=8, h=104, w=168, c=512, p=2048, xy_max=1000,
                     limit=(1332, 799)):
    """The eval bench shape by default: 832x1344 images (stride 8), rois
    16-300 px starting below ``xy_max``, clipped to ``limit`` (x, y)."""
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1y1 = rng.uniform(0, xy_max, (b, p, 2))
    wh = rng.uniform(16, 300, (b, p, 2))
    rois = np.concatenate([x1y1, np.minimum(x1y1 + wh, limit)],
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


def bwd_bound(feat, rois, mask, g, name):
    """(bound ms, by): feat and g read once, d feat written once in the
    feature dtype; the comparisons of the argmax scan at the f32 rate."""
    b, h, w, c = feat.shape
    nbytes = (2 * feat.numel() + g.numel()) * feat.element_size() \
        + rois.numel() * 4 + mask.numel()
    bytes_ms = nbytes / card_rate(name, MEM_BYTES_PER_S) * 1e3
    ops = bin_cells(rois.cpu().numpy(), mask.cpu().numpy(), h, w) * c
    ops_ms = ops / card_rate(name, F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                    else "operations"), nbytes


def phase_bwd_kernel(dev, rp):
    """Kernel vs plain backward: routing exact (strictly positive g, so
    both are non-zero on the same cells); values within the reordering of
    the f32 atomics, |d| <= n * 2^-23 * sum|g| per cell (n = the bins that
    route to the cell); after the cast to bf16 at most one bf16 ulp."""
    import torch

    rng = np.random.RandomState(2)
    feat_grid, rois_grid, mask_grid = grid_inputs(rng, 64)
    ties = np.round(feat_grid * 1.5).astype(np.float32)     # a few values
    # a 1200-scale batch of 375x500 images: 1200x1600, padded 1280x1664
    train = main_path_inputs(rng, h=160, w=208, xy_max=1200,
                             limit=(1599, 1199))
    worst = 0.0
    for label, (feat, rois, mask), dtypes in (
            ("grid", (feat_grid, rois_grid, mask_grid),
             (torch.float32, torch.bfloat16)),
            ("ties", (ties, rois_grid, mask_grid), (torch.bfloat16,)),
            ("train", train, (torch.float32, torch.bfloat16))):
        r = torch.from_numpy(rois).to(dev)
        m = torch.from_numpy(mask).to(dev)
        for dtype in dtypes:
            f = torch.from_numpy(feat).to(dev, dtype)
            g = (torch.rand(r.shape[:2] + (7, 7, f.shape[3]), device=dev)
                 + 0.05).to(dtype)
            got = rp.roi_pool_backward(f, r, m, g, 0.125).float()
            want = rp.roi_pool_backward_plain(f, r, m, g, 0.125).float()
            torch.cuda.synchronize()
            if not torch.equal(got != 0, want != 0):
                raise AssertionError(f"roi_pool_bwd routes differently from "
                                     f"plain ({label}, {dtype})")
            err = (got - want).abs()
            if dtype == torch.float32:
                count = rp.roi_pool_backward_plain(
                    f, r, m, torch.ones_like(g), 0.125)
                bound = count * 2.0 ** -23 * want.abs() + 1e-30
            else:
                bound = 2.0 ** -7 * want.abs()
            if (err > bound).any():
                raise AssertionError(f"roi_pool_bwd != plain ({label}, "
                                     f"{dtype}): max |diff| "
                                     f"{err.max().item()}")
            worst = max(worst, err.max().item())
            print(f"[bwd] {label} {str(dtype)[6:]} feat {list(f.shape)} "
                  f"P={r.shape[1]}: same cells as plain, max |diff| "
                  f"{err.max().item():.3e} (within the bound), "
                  f"{int((want != 0).sum())} cells routed")
    f = torch.from_numpy(train[0]).to(dev, torch.bfloat16)
    g = torch.rand(r.shape[:2] + (7, 7, f.shape[3]), device=dev).to(
        torch.bfloat16)
    ms = cuda_ms(lambda: rp.roi_pool_backward(f, r, m, g, 0.125), iters=10)
    plain_ms = cuda_ms(lambda: rp.roi_pool_backward_plain(f, r, m, g, 0.125),
                       iters=2, warmup=1)
    name = torch.cuda.get_device_name(dev)
    bound_ms, by, nbytes = bwd_bound(f, r, m, g, name)
    print(f"[bwd] train shape bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}; "
          f"{nbytes / 1e9:.3f} GB)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by}


def phase_train_card_vs_cpu(dev):
    """One f32 train step on the card and on the CPU: same weights, batch
    and draws; neck dropout 0 (its masks come from each device's own
    generator). One positive class per image, so stage B's chain compares
    no rows of other classes (it compares 1.0 with a self-similarity that
    rounds to either side of 1 with the summation order)."""
    import torch
    from odwscl_tpu_torch.models import Batch, WSODDetector

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    b, h, w, p = 2, 128, 160, 128
    sizes = np.array([[128, 160], [120, 150]], np.float32)
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    x1y1 = rng.uniform(0, 100, (b, p, 2))
    wh = rng.uniform(16, 100, (b, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, sizes[:, None, ::-1]
                                             - 1)], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.1
    labels = np.zeros((b, 21), np.float32)
    labels[0, 7] = labels[1, 15] = 1.0
    batch = Batch(*(torch.from_numpy(a) for a in (images, sizes, boxes, mask,
                                                  labels)))
    model = WSODDetector(compute_dtype="float32", neck_dropout=0.0,
                         cap_a=1024, cap_b=256)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, _ in model.pred.heads:
            if not name.startswith("bbox_pred"):
                getattr(model.pred, name).weight.mul_(HEAD_SCALE)
    draws = {"dropblock": torch.from_numpy(rng.uniform(
                 size=(b * p, 7, 7)).astype(np.float32)),
             "sim_drop": torch.from_numpy(rng.uniform(
                 size=(1024, 7, 7)).astype(np.float32)),
             "noise": torch.from_numpy(rng.randn(1024, 7, 7, 512).astype(
                 np.float32))}
    watch = ("neck.fc7.weight", "pred.ref1.weight", "pred.bbox_pred1.weight",
             "pred.cls_score.weight", "sim_net.mlp1.weight")

    def step(device):
        model.to(device).zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        losses, metrics = model.train_forward(
            batch.to(device), draws={k: v.to(device) for k, v in
                                     draws.items()})
        torch.stack(list(losses.values())).sum().backward()
        grads = {k: model.get_parameter(k).grad.detach().cpu().clone()
                 for k in watch}
        if not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError(f"non-finite gradients on {device}")
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: float(v) for k, v in metrics.items()}, grads,
                time.perf_counter() - t0)

    l_cpu, m_cpu, g_cpu, t_cpu = step("cpu")
    l_gpu, m_gpu, g_gpu, t_gpu = step(dev)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ints = [k for k in m_cpu if k.startswith(("n_", "bank_", "pgt_"))]
    bad = [k for k in ints if m_cpu[k] != m_gpu[k]]
    if bad:
        raise AssertionError(f"mining decisions differ card vs CPU: "
                             f"{[(k, m_cpu[k], m_gpu[k]) for k in bad]}")
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                   for k in l_cpu)
    grad_err = max(((g_gpu[k] - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max().clamp(min=1e-12)).item()
                   for k in watch)
    if not all(math.isfinite(v) for v in l_gpu.values()):
        raise AssertionError(f"non-finite train losses on the card: {l_gpu}")
    print(f"[train] f32 train step card vs CPU, B={b} {h}x{w} P={p}: mining "
          f"decisions equal ({', '.join(f'{k} {m_cpu[k]:g}' for k in ints)});"
          f" max loss rel diff {loss_err:.3e} (tol {TRAIN_LOSS_RTOL}), max "
          f"grad diff {grad_err:.3e} of the largest (tol {TRAIN_GRAD_REL}, "
          f"{len(watch)} tensors); CPU {t_cpu:.2f} s, card {t_gpu:.2f} s "
          "(first call)")
    if m_cpu["n_bank"] == 0 or m_cpu["n_mined"] == 0:
        raise AssertionError("the mining found nothing to compare")
    if loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_REL:
        raise AssertionError("card and CPU train steps disagree")


def write_data(tmp, cfg):
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    t0 = time.perf_counter()
    write_synthetic_voc(tmp, n_test=16, seed=0, img_hw=(375, 500),
                        n_props=2048, prop_size=(20, 300), obj_size=(40, 200),
                        test_proposal_file=cfg.PROPOSAL_FILES.TEST[0],
                        n_trainval=32,
                        train_proposal_file=cfg.PROPOSAL_FILES.TRAIN[0])
    print(f"[data] synthetic VOC: 32 trainval + 16 test images 375x500, "
          f"2048 proposals each, written in {time.perf_counter() - t0:.2f} s")


def phase_train(rp, tmp):
    import torch
    from odwscl_tpu_torch.tools import train_net

    out = os.path.join(tmp, "train")
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    rp.roi_pool.launches = rp.roi_pool_backward.launches = 0
    t0 = time.perf_counter()
    train_net.main(["--config-file", CONFIG, "--data-root", tmp,
                    "--device", "cuda", "--skip-test", "OUTPUT_DIR", out,
                    "MODEL.WEIGHT", "", "SOLVER.MAX_ITER", str(TRAIN_STEPS),
                    "SOLVER.CHECKPOINT_PERIOD", "10"], timing_out=timing)
    wall = time.perf_counter() - t0
    launches = (rp.roi_pool.launches, rp.roi_pool_backward.launches)
    steps = timing["train"]["steps"]
    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} train steps, not {TRAIN_STEPS}")
    for s in steps:
        bad = [k for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"iteration {s['iter']}: non-finite {bad}")
    if launches != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"kernel launches (fwd, bwd) {launches} for "
                             f"{TRAIN_STEPS} steps")
    window = steps[4:]
    med = statistics.median(s["step_s"] for s in window)
    data_wait = sum(s["data_s"] for s in window)
    t = timing["train"]
    print(f"[train] {TRAIN_STEPS} steps, batch 8, bf16: median step "
          f"{med * 1e3:.1f} ms over steps 5-{TRAIN_STEPS} = "
          f"{8 / med:.2f} images/s; host data wait {data_wait:.2f} s of "
          f"{sum(s['step_s'] for s in window):.2f} s; device idle share "
          f"{t['device_idle_share']:.3f} (busy {t['device_busy_s']:.2f} s of "
          f"{t['profile_wall_s']:.2f} s, traced); max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; CLI wall "
          f"{wall:.2f} s")
    print("[train] losses step 1 -> 20: " + ", ".join(
        f"{k} {steps[0][k]:.4f} -> {steps[-1][k]:.4f}"
        for k in ("loss", "loss_img", "loss_sim", "loss_ref_cls0")))
    print(f"[train] kernel launches: roi_pool_fwd {launches[0]}, "
          f"roi_pool_bwd {launches[1]} = steps {TRAIN_STEPS}")
    for name in ("model_0000010.pt", "model_0000020.pt", "model_final.pt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"checkpoint {name} missing")
    return launches, os.path.join(out, "model_final.pt")


def phase_eval(rp, tmp, weights):
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.tools import test_net

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    n_images = 16
    n_batches = math.ceil(n_images / cfg.TEST.IMS_PER_BATCH)
    n_tta = 2 * (1 + len(cfg.TEST.BBOX_AUG.SCALES))
    results = {}
    rp.roi_pool.launches = rp.roi_pool_backward.launches = 0
    for task in ("det", "corloc"):
        timing = {}
        t0 = time.perf_counter()
        res = test_net.main(["--config-file", CONFIG, "--data-root", tmp,
                             "--task", task, "--device", "cuda",
                             "--weights", weights,
                             "OUTPUT_DIR", os.path.join(tmp, task)],
                            timing_out=timing)
        wall = time.perf_counter() - t0
        (t,) = timing.values()
        (r,) = res.values()
        results[task] = (r, t, wall)
    launches = rp.roi_pool.launches

    for task, (r, t, wall) in results.items():
        metric = r["map"] if task == "det" else r["mean_corloc"]
        if not math.isfinite(metric):
            raise AssertionError(f"{task}: non-finite result {metric}")
        if t["n_forwards"] != n_batches * n_tta:
            raise AssertionError(f"{task}: {t['n_forwards']} forwards, "
                                 f"expected {n_batches} x {n_tta}")
        print(f"[eval] {task}: {'mAP' if task == 'det' else 'CorLoc'} "
              f"{metric:.4f} (the 20-step checkpoint); {t['n_images']} "
              f"images in {t['wall_s']:.2f} s = "
              f"{t['n_images'] / t['wall_s']:.2f} images/s; "
              f"{t['n_forwards']} forwards; stage s: load wait "
              f"{t['load_wait_s']:.2f}, host prep wait "
              f"{t['prep_wait_s']:.2f}, forward+merge {t['forward_s']:.2f}, "
              f"NMS+top-K+to-host {t['finalize_s']:.2f}, eval "
              f"{t['eval_s']:.3f}; CLI wall {wall:.2f} s")
    total = sum(t["n_forwards"] for _, t, _ in results.values())
    if launches != total or rp.roi_pool_backward.launches:
        raise AssertionError(f"roi_pool kernel launched {launches} times for "
                             f"{total} forwards")
    print(f"[eval] roi_pool kernel launches {launches} = forwards {total} "
          f"({n_tta} per batch)")
    return launches


def build(rp):
    """Build both kernels, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(k.get) for k in (rp.KERNEL, rp.BWD_KERNEL)]:
            fut.result()
    print(f"[build] roi_pool_fwd.cu, roi_pool_bwd.cu in "
          f"{time.perf_counter() - t0:.2f} s")
    for k in (rp.KERNEL, rp.BWD_KERNEL):
        for line in k.compile_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.name}: {line.strip()}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.ops import roi_pool as rp

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build(rp)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {label} {time.perf_counter() - t0:.1f} s")
        return out

    fwd = timed("forward kernel checks", phase_kernel, dev, rp)
    bwd = timed("backward kernel checks", phase_bwd_kernel, dev, rp)
    timed("eval card vs CPU", phase_card_vs_cpu, dev)
    timed("train card vs CPU", phase_train_card_vs_cpu, dev)
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    tmp = tempfile.mkdtemp(prefix="odwscl_smoke_")
    try:
        write_data(tmp, cfg)
        (train_fwd, train_bwd), ckpt = timed("train main path", phase_train,
                                             rp, tmp)
        eval_fwd = timed("eval main path", phase_eval, rp, tmp, ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = "odwscl_tpu_torch/csrc/"
    no_lib = ("no single PyTorch call computes ROIPool; torchvision is not "
              "installed")
    kernels = [
        {"name": "roi_pool_fwd", "route": "cuda",
         "source": src + "roi_pool_fwd.cu",
         "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:245 _fwd_kernel",
         "launches": train_fwd + eval_fwd, **fwd, "library_ms": None,
         "library_note": no_lib},
        {"name": "roi_pool_bwd", "route": "cuda",
         "source": src + "roi_pool_bwd.cu",
         "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:292 _bwd_kernel",
         "launches": train_bwd, **bwd, "library_ms": None,
         "library_note": no_lib}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
