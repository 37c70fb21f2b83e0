#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
1. Print the card's name and power limit; build the ROIPool forward
   kernel, with the stage profiler's instantiations, the backward kernel
   (odwscl_tpu_torch/csrc/roi_pool_{fwd,bwd}.cu), the int8 conv kernel
   (csrc/conv_int8.cu) and the int8 quantize kernel (csrc/quant_int8.cu)
   with nvcc for sm_90a, all at once.
2. Hold both instantiations of the forward kernel against their plain
   PyTorch versions on the card, bit-exactly (atol 0) in f32 and bf16: the
   output against ``roi_pool_plain`` and the training forward's int16
   argmax codes against ``roi_pool_argmax_plain``'s, on a size grid of
   rois (1 cell up to the full map, malformed, off-map, masked, empty
   bins), the eval shape feat [8, 104, 168, 512] and the training shape
   feat [8, 160, 208, 512] (a padded 1200-scale batch), P = 2048.
3. Hold the backward kernel, fed by the forward kernel's argmax, against
   the map-rescan ``roi_pool_backward_plain`` on the card in f32 and bf16:
   the size grid, a bf16 ties case and the training shape. Routing exact,
   values within the f32 reordering bound. Then time, in turns in one
   run: #1 at the eval shape, the training forward at the training shape,
   #2 and its yardstick (``index_add_`` of g at the cells decoded from the
   stored argmax); and each plain version once.
4. The same three kernels at the R-50-C5 shape (C = 2048, stride 16):
   checked as in 2 and 3 on a 1200-scale image, feat [2, 75, 100, 2048],
   P = 256, rois 16-720 px, f32 and bf16; then checked again, f32 and
   bf16, and timed in turns (bf16) at a padded 1200-scale batch, feat
   [8, 80, 104, 2048], P = 2048, with their byte bounds and #2's
   ``index_add_`` yardstick (indices from the stored argmax, int32, built
   one image at a time), routed as #2. At that shape
   the plain versions run per image on chunks of rois sorted by size
   (they are per roi, so the chunks are exact): both forward
   instantiations and their argmax codes bit-exact against
   ``roi_pool_argmax_plain``; the backward, from the kernel's codes,
   against the f32 sums of ``roi_pool_backward_argmax_plain`` over the
   plain codes, routing exact, values within the bounds of 3.
5. Hold the stage profiler's kernel (the forward kernel of
   csrc/roi_pool_fwd.cu cut by stage), each of its five stages (write,
   rows, rows_col0, cols, full), against ``roi_pool_stage_plain`` on the
   card, bit-exactly (atol 0): the size grid on the 200x260 map and on a
   13x6 map (the rows stage's columns reach the zero pad) in f32 and bf16,
   and the bench shape feat [8, 104, 168, 512] bf16, P = 2048; ``full``
   also against the forward kernel. A C that is not a multiple of 8 must
   raise. Then drive the profiler
   (``odwscl_tpu_torch.tools.profile_pool_stages``) at the bench shape:
   kernel #1, the five stages and ``torch.zeros`` (the library call of
   ``write``) timed in turns, with their bounds and the stage deltas.
6. For VGG16-OICR and for R-18-C5: run ``eval_forward`` at full width in
   f32 (TF32 off) on the card and on the CPU with the same seeded weights
   and inputs, then one f32 train step on a small input with the same
   DropBlock and noise draws; compare the outputs, the mining decisions,
   the losses and the gradients. Then the same train step for each
   training variant of ``VARIANT_STEPS`` (WSDDN; OICR and MIST OICR_P 0.15
   without contrastive mining; OICR with it; Concrete DropBlock; CAM
   proposals), VGG16 at full width; the Concrete DropBlock's step runs
   again on the card with cuDNN's TF32, and its gap is printed; and the
   main step again with the COCO configs' 81-class heads. Phase 26's
   study runs in a process of its own beside phases 6, 15 and 19.
7. Drive the training path: ``odwscl_tpu_torch.tools.train_net`` with
   configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml (VGG16-OICR, bf16, batch
   8, scales 480-1200, random init) for 20 iterations on a synthetic VOC
   trainval split of 32 images of 375x500 with 2048 proposals each. Every
   step must have launched the training forward (with the argmax) and the
   backward once, and the eval forward never; every loss must be finite.
8. Hold the device resize against the host path on the card: at each
   TTA scale, each test image's valid region of ``resize_image_batch``
   (from the f32 normalized originals) against the host path's collated
   image (PIL's uint8 resize, then the normalization), within the CPU
   test's bound (1.01 BGR-255 units per pixel, 0.35 on average), the
   canvases equal and zero beyond each target. Then drive the eval path:
   ``odwscl_tpu_torch.tools.test_net`` (14-transform TTA, AVG) on the
   checkpoint that training wrote, on a synthetic test split of 16
   images: det and corloc with the host resize, det with
   ``TPU.EVAL_DEVICE_RESIZE True``. Every forward must have gone through
   the forward kernel without the argmax, and nothing else; the two
   modes' merged scores must agree within the bound of
   tests/test_torch_device_resize.py, the boxes within 0.1 px.
9. Drive the R-50-C5 configuration
   (configs/voc/voc07_r50_c5_contra_db_b8_lr0.02_ss.yaml at full width:
   C5 at stride 16, neck 100352 -> 2048 -> 4096, bf16, batch 8): write a
   Caffe2 detectron ``.pkl`` of random blobs where ``MODEL.WEIGHT``'s
   catalog name resolves, train 6 iterations from it as in 7 (the frozen
   stem, layer1 and norms must still hold the file's values), then
   evaluate the checkpoint in both resize modes as in 8.
10. Drive the main config's training variants at full width, 6 steps
   each as in 7 (``VARIANTS``): (a) ``DB.METHOD concrete``, whose last
   update of the Concrete DropBlock must be the ascent +DB.WEIGHT * lr *
   buf; (b) ``SOLVER.CONTRA False``, ``OICR_P 0.15`` (the MIST layer);
   (c) ``MODEL.FASTER_RCNN True`` (CAM proposals, the OICR layer), each
   image given 1 to ``TPU.RPN_POST_NMS`` proposals; (d) OICR and (e)
   WSDDN heads without regression or mining, each then evaluated with
   the device-resize TTA as in 8. No path launches a stage kernel.
11. (Run after 5.) Hold the int8 conv kernel
   (odwscl_tpu_torch/csrc/conv_int8.cu, built in 1) against its plain
   versions bit for bit on its wgmma + TMA main loop: the int32 ``ACC``
   output of both wgmma tiles against ``conv2d_int8_acc_plain`` (a float64
   convolution of the codes) and its fused dequantize against
   ``dequantize_plain`` (values: -0.0 equals 0.0), at the 11 VGG16 int8
   layer shapes of the 480 scale (B = 8) and at 37x53 (B = 1, 2; both
   dilations; bf16 and f32), each in the three activation-scale modes; and
   its fused next-layer codes against the plain quantize of the plain
   dequantize, per-channel (with power-of-two scales: exact ties) and
   per-tensor scales, pooled and not. Hold the quantize kernel
   (csrc/quant_int8.cu) against its plain versions bit for bit in each
   mode (map per channel and per tensor, dynamic per tensor, dynamic per
   row), with half-way ties, saturated codes, all-zero tensors and rows.
   Then time, at the 11 shapes of the 1200 scale (B = 8, 1280x1664) in
   turns, the conv kernel in the static path's output mode and in the
   other (each beside its bound), its mma.sync main loop, the int8 im2col
   + ``torch._int_mm`` route, cuDNN's bf16 conv, and the plain version
   once; the quantize kernel at each layer's input (static map, dynamic)
   beside its plain versions and PR 8's ``quantize_conv_input``; and the
   neck's row quantize and ``torch._int_mm`` (fc6, fc7 at 16,384 rows)
   beside ``F.linear`` in bf16.
12. (Run after 8.) Serve the checkpoint of 7 in int8 (``TPU.INT8_EVAL``,
   ``INT8_EVAL_CONVS``; device-resize TTA; det) after a bf16 run of the
   same: twice static (``INT8_STATIC``), where the first run calibrates (2
   batches x 14 transforms) and writes ``int8_scales.npz`` and the second
   loads a copy and must give identical predictions, then once dynamic.
   The launches must follow the layer plan: the int8 conv kernel 11 times
   a forward and never while calibrating; the quantize kernel 3 times a
   static forward (conv2's input, the neck's two row sets), 24 a dynamic
   one, 2 a calibration forward; no plain activation quantize on a CUDA
   tensor. On a 1200-scale batch the fused static backbone equals the
   unfused chain bit for bit, and its features stay within 0.25 of bf16's
   largest (the JAX package's bound); the merged detections' gap to bf16
   and each run's images/s are printed.
13. (Run after 10.) Drive the COCO configuration
   (configs/coco/coco14_contra_db_b8_lr0.01_mcg.yaml as shipped: 81
   classes, bf16, batch 8, scales 480-1200, MCG proposal files, random
   init) on a synthetic ``coco14`` layout of COCO's 480x640 images (32
   train, 16 val, 16 valminusminival; 2048 proposals each; point and
   scribble annotations): train 6 steps as in 7, the mining counters
   non-zero; evaluate the checkpoint with the 14-transform TTA and
   ``TPU.EVAL_DEVICE_RESIZE True`` into the 7 COCO stats, all finite, the
   launches as in 8; the COCO evaluator fed the val GT must give AP 1.0,
   and less with the boxes shifted by 8 px. ``SOLVER.CLASS_BATCH`` over
   two datasets must raise a ValueError; then 5 steps each of two
   training datasets (``coco_2014_train``, ``coco_2014_valminusminival``),
   ``SOLVER.CLASS_BATCH``, ``PARTIAL_LABELS point`` and ``scribble``
   (with ``ROI_LOSS_REFINE``) as in 7.
14. (Run after 4; since phase 25, at R = 7 and R = 14 in one pass, bf16.)
   The three ROIPool kernels at the FPN shapes, C = 256, B = 2, P = 1000
   rois of 16-800 px a image routed to P2-P5 by ``assign_levels`` (each
   call pools all P rois under its level's mask, about three quarters
   masked): on the eval pyramid of an 800x1344 canvas (P2-P5 200x336,
   100x168, 50x84, 25x42) #1 bit-exact (atol 0) against
   ``roi_pool_plain`` at each level's scale, and ``roi_pool_argmax`` on
   its P2 (67,200 cells, past the int16 codes' 65,535) runs with int32
   codes, output and codes bit-exact; on the training pyramid of a
   640x1088 canvas (P2 160x272, int16 codes) #1[argmax] bit-exact and #2
   within a bf16 ulp of the plain backward from the same codes. Then, in
   turns: each eval level's #1 and the four-call pool, each training
   level's #1[argmax], #2 and #2's ``index_add_`` yardstick, with their
   byte bounds, and plain ROIAlign at each eval level; the plain versions
   once.
15. (Run after 6.) Card against CPU, f32, TF32 off, at the published
   widths: R-50-FPN Mask R-CNN (81 classes, MLP 1024, mask convs 4x256)
   and R-50 RetinaNet (81 classes), seeded, on a 256x384 canvas with
   P = 512 rois and 8 GT instances with bitmasks: the eval forward (and
   the mask pass), then one train step with the same sampler draws; the
   matches, sampled rois and anchor labels equal, the losses and the
   gradients (outside the ResNet body) within the bounds of 6.
16. (Run after 13.) Drive configs/coco/coco_retinanet_smoke.yaml and
   coco_mask_rcnn_smoke.yaml as shipped (only the paths on the command
   line) on a synthetic ``coco17`` layout with polygon and RLE masks:
   ``train_net`` (5 iterations, the configs' own) and ``test_net`` on its
   checkpoint (bbox; bbox and segm for the Mask R-CNN). Every loss
   finite, the APs in [0, 1]; each Mask R-CNN step launches #1[argmax] 4
   times and #2 4 times, each of its eval batches #1 8 times (4 for the
   boxes, 4 for the mask pass); RetinaNet launches none.
17. The full-size eval forward in bf16 (R-50-FPN Mask R-CNN with 1000
   proposals an image, R-50 RetinaNet; seeded) on an 800x1344 batch of
   2: ms per image, peak memory, the four-level pool's share of the
   forward, the mask pass and the decode / NMS times.
18. (Run after 14.) The int32 argmax codes (maps of more than 65,535
   cells): #1[argmax] and #2 on a 256x257 map (phase 2's grid, plus a roi
   seven times the map so that codes past 65,535 occur) and on the eval
   P2 (200x336), f32 and bf16: output and codes bit-exact, the backward
   within phase 3's bound; the int16 codes still chosen at 255x257 and at
   the training P2 (160x272). Then, bf16, in turns: both instantiations
   of each kernel on the training P2's inputs, and the int32 pair with
   #2's ``index_add_`` yardstick at the eval P2, with byte bounds.
19. (Run after 15.) Card against CPU, f32, TF32 off, with phase 15's
   bounds: R-50-FPN Keypoint R-CNN (2 classes, 17 keypoints, MLP 1024,
   the 8x512 tower) and FBNet-default Fast R-CNN (81 classes) on a
   256x384 canvas with P = 128 rois: the eval box pass, the keypoint pass
   on 2 x 100 rois and its decode, one train step with the same draws;
   then ``deform_conv2d`` v1 / v2 (3x3, 512 channels, 2 deformable
   groups, offsets off the map) and ``deform_psroi_pooling``: outputs and
   gradients.
20. (Run after 17.) COCO size in bf16, B = 2 on 800x1344, 1000 proposals
   an image: R-50-FPN Keypoint R-CNN trains 5 steps (step ms, the
   device's idle share, peak GB; P2 pools with the int32 codes), then its
   eval (box forward, NMS, the keypoint pass on 2 x 100 detections, the
   decode); FBNet-default Fast R-CNN 5 steps and its eval forward.
21. (Run after 16, on its data.) configs/coco/coco_mask_rcnn_smoke.yaml
   with ``MODEL.KEYPOINT_ON True``, and as an FBNet-default Fast R-CNN
   (``CONV_BODY FBNet-default``, ``POOLER_SCALES (0.0625,)``, ``MASK_ON
   False``): ``train_net`` 5 steps, ``test_net`` (bbox, segm with
   masks), launches per step and per batch checked.
22. (Run after 8, on phase 7's data.) Data-parallel training as a user
   launches it: ``train_net --distributed`` in a subprocess with
   ``RANK=0 WORLD_SIZE=1`` (``nccl``), phase 7's config, seed and data,
   6 steps, ``--use-tensorboard`` and ``--profile-dir``
   (iterations 2-6). Its first step's
   losses and mining counters must equal phase 7's first step, the later
   steps' total loss within 0.1 relative, beside the gap of a second
   plain run (run in the phase) to phase 7's (#2's f32 atomics add in
   another order in each run, and two plain bf16 runs part after step 1);
   ``scalars.jsonl`` must hold 6 records and the profile directory a
   trace; each step launches #1[argmax] and #2 once.
   Its step ms, device idle share and peak GB are printed beside phase
   7's. Then ``test_net`` with no ``--weights`` on that ``OUTPUT_DIR``
   (device-resize TTA) must evaluate the checkpoint ``last_checkpoint``
   names, through #1.
23. Tensor- and spatial parallelism at world size 1 (an in-process
   ``nccl`` group): ``tp_neck_apply`` on the full neck (16,384 rows,
   25,088 -> 4,096 -> 4,096, bf16) against ``tp_neck_plain``, and
   ``sp_backbone_apply`` on a 1280x1664 batch of 8 (bf16) against the
   plain backbone, both bit-exact, and timed beside them (the model's
   own neck too, whose bias rides its GEMM: its gap is printed).
24. (Run after 23, on phase 7's data.) The JAX package's Orbax checkpoints:
   import tests/data/orbax_wsod_small (the main config's WSOD detector at
   narrow widths after 3 JAX train steps, written by the JAX package's
   ``Checkpointer.save``) with the native zstd decoder, the OCDBT reader
   and the zarr reader; evaluate it on the card in f32, held to the JAX
   ``eval_forward`` in its ``expected.npz`` within phase 6's bounds, #1
   launched once; then ``train_net`` resumes a copy of it as a JAX
   ``OUTPUT_DIR`` for 3 steps: the first iteration the saved step + 1,
   #1[argmax] and #2 once a step. The import's wall time, the decoder's
   MB/s over the fixture's frames and the card's name and power limit are
   printed.
25. The pooler configurations (the JAX package's ROIAlign and ROIPool at
   any resolution R). (Run after 14.) #1, #1[argmax] with int16 and with
   int32 codes, and #2 from both, at R = 1, 2, 3, 6, 8, 14 and 16 on
   phase 2's size grid in f32, bf16 and bf16 with ties: bit-exact against
   ``roi_pool_argmax_plain``, #2 within phase 3's bound of the map rescan;
   R = 0 and 17 raise. At R = 14 on the eval shape the three kernels once
   each against their plain versions; then, bf16, in turns, each at R = 7
   and 14 (#1 at the eval shape, #1[argmax], #2 and its yardstick at the
   training shape) beside plain ROIAlign (eval forward at both R, the
   training forward and backward at R = 7). (Run after 10, on phase 7's
   data.) The main config through ``train_net`` and ``test_net``
   (device-resize TTA) with ``POOLER_METHOD ROIAlign`` (5 steps; no
   ROIPool kernel may launch), one f32 train step of it card against CPU,
   and with ROIPool at R = 14 (3 steps; every launch at R = 14). (Run
   after 21.) configs/coco/coco_mask_rcnn_smoke.yaml at the published
   R-50-FPN widths, R = 14 and a 28x28 mask, bf16, on 800x1344 canvases:
   5 steps (#1[argmax] and #2 4 times a step at R = 14) and the bbox and
   segm eval (#1 8 times a batch at R = 14).
26. (Started before 6, checked after 19.) The int8 accuracy study
   (``odwscl_tpu_torch.tools.int8_accuracy_study``) at a smoke size
   through its real subprocesses: 1 seed, 30 steps, 8 / 8 synthetic VOC
   images of 192x256 (the JAX tool's generator), ``train_net`` then
   ``test_net --ckpt`` on the trained checkpoint in bf16, int8 and int8
   with conv4-conv6 in bf16. Its JSON must hold the three modes with
   finite mAPs in [0, 1] and the JAX tool's summary keys; each CLI run
   reports its launches: every step #1[argmax] and #2 once, every eval
   batch #1, the int8 conv kernel 11 times a batch in int8 and 8 in
   int8-fb, and the quantize kernel in both.
27. (Run after 23.) Spatial parallelism over the ResNet, FPN and FBNet
   bodies at world size 1 (an in-process ``nccl`` group), bf16:
   ``sp_backbone_apply`` on R-50-FPN at 800x1344 (B = 2), R-50-C5 on a
   1280x1664 batch of 8 and FBNet-default at 800x1344 (B = 2), each level
   bit-exact against the body, and timed beside it; then each body's 4
   bands stitched in one process (``sp_stitch``, the same band
   arithmetic, one thread a band) in f32 with TF32 off, every level of
   every band's output within SP_STITCH_REL of its largest magnitude of
   the unsharded body.
Prints a ``[summary]`` line of the end-to-end numbers, a
``{"kernels": [...]}`` line and, last, a one-line JSON result.
Needs no network; exits non-zero without a CUDA card or outside the repo.
"""

import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "voc",
                      "voc07_contra_db_b8_lr0.01_mcg.yaml")
CONFIG_R50 = os.path.join(ROOT, "configs", "voc",
                          "voc07_r50_c5_contra_db_b8_lr0.02_ss.yaml")
CONFIG_COCO = os.path.join(ROOT, "configs", "coco",
                           "coco14_contra_db_b8_lr0.01_mcg.yaml")

# phase 5: f32 card vs CPU. Both run the same f32 algorithm; the card sums
# convolutions and GEMMs in another order (cuDNN/cuBLAS tiling, no TF32).
# Through 13 convs and 2 fc layers that drifts by ~1e-5 relative, so the
# softmax scores (in [0, 1]) may move by 1e-3 at most and the decoded boxes
# (up to ~320 px) by 5e-2 px at most.
SCORE_ATOL = 1e-3
BOX_ATOL_PX = 5e-2

# phase 6: f32 train step card vs CPU, same drift source. Losses 1e-3
# relative; gradients of the heads, neck and SimNet 1e-2 of each tensor's
# largest magnitude (the drift of ~1e-5 at the features, amplified by the
# scaled heads, the softmaxes and the supcon exponentials); the backbone is
# left out (a ReLU unit within the drift of 0 flips its sign between the two
# devices and moves a weight gradient by up to ~1%).
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL = 1e-2
# score heads scaled so that the argmaxes of the mining are well apart; at
# the full 4096 width a larger factor saturates the softmaxes to exactly 1
# (and the BCE's log1p(-1) then has a NaN gradient in both packages). The
# random R-18-C5's head logits are an order of magnitude above VGG16's, so
# its factor is that much smaller.
HEAD_SCALE = {"VGG16-OICR": 30.0, "R-18-C5": 3.0}
TRAIN_STEPS = 20
# phase 8: device-resize vs host-resize merged boxes. The CPU test's toy
# model regresses nothing (its boxes are the scaled proposals: 1e-2 px);
# here the trained bf16 heads' deltas move with the ~1 BGR-255 unit
# pixel differences of the two resamplers (observed 0.035 px on VGG16's
# 20-step checkpoint, 0.041 px on R-50-C5's), so the bound is 0.1 px. The
# resampled images themselves are held to the CPU test's bound (at most
# 1.01 BGR-255 units per pixel, 0.35 on average per image).
MERGE_BOX_ATOL_PX = 0.1
RESIZE_MAX = 1.01
RESIZE_MEAN = 0.35
# phase 4: the plain versions at the R-50-C5 timed shape run per image on
# chunks of this many rois
C2048_CHUNK = 256
# the end-to-end numbers, printed again as one line near the end
SUMMARY = []
# phase_train's runs by label: the step logs and their median, idle share
# and peak memory (phase 7a compares its distributed run with phase 7's)
TRAIN_RUNS = {}
R50_STEPS = 6


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


def grid_inputs(rng, c, h=200, w=260):
    """Size grid of the JAX package's Pallas tests: sweep rois (every size
    class, degenerate and off-map) plus a dense extent grid 1..259 cells,
    on an [h, w] map."""
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
                     limit=(1332, 799), wh=(16, 300)):
    """The eval bench shape by default: 832x1344 images (stride 8), rois
    16-300 px (``wh``) starting below ``xy_max``, clipped to ``limit``
    (x, y)."""
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1y1 = rng.uniform(0, xy_max, (b, p, 2))
    wh = rng.uniform(*wh, (b, p, 2))
    rois = np.concatenate([x1y1, np.minimum(x1y1 + wh, limit)],
                          -1).astype(np.float32)
    return feat, rois, np.ones((b, p), bool)


def train_shape_inputs(rng):
    """A 1200-scale batch of 375x500 images: 1200x1600, padded 1280x1664,
    feat [8, 160, 208, 512], P = 2048 rois of 16-300 px."""
    return main_path_inputs(rng, h=160, w=208, xy_max=1200, limit=(1599, 1199))


def r50_check_inputs(rng):
    """A 1200-scale image (1200x1600) at stride 16 for R-50-C5: feat
    [2, 75, 100, 2048], P = 256 rois of 16-720 px."""
    return main_path_inputs(rng, b=2, h=75, w=100, c=2048, p=256,
                            xy_max=1200, limit=(1599, 1199), wh=(16, 720))


def r50_train_inputs(rng):
    """A padded 1200-scale training batch at stride 16: feat
    [8, 80, 104, 2048], P = 2048 rois of 16-720 px."""
    return main_path_inputs(rng, h=80, w=104, c=2048, xy_max=1200,
                            limit=(1599, 1199), wh=(16, 720))


def phase_kernel(dev, rp, cases):
    """Both instantiations of the forward kernel against their plain
    versions, bit-exactly (atol 0): the output against ``roi_pool_plain``
    and the argmax codes against ``roi_pool_argmax_plain``'s, for each
    (label, inputs, spatial scale) of ``cases``."""
    import torch

    worst = {"eval": 0.0, "argmax": 0.0}
    for label, (feat, rois, mask), scale in cases:
        r = torch.from_numpy(rois).to(dev)
        m = torch.from_numpy(mask).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            f = torch.from_numpy(feat).to(dev, dtype)
            want, want_codes = rp.roi_pool_argmax_plain(f, r, m, scale)
            if not torch.equal(want, rp.roi_pool_plain(f, r, m, scale)):
                raise AssertionError("roi_pool_argmax_plain's output != "
                                     f"roi_pool_plain ({label}, {dtype})")
            got = rp.roi_pool(f, r, m, scale)
            got_a, codes = rp.roi_pool_argmax(f, r, m, scale)
            torch.cuda.synchronize()
            for name, out in (("eval", got), ("argmax", got_a)):
                err = (out.float() - want.float()).abs().max().item()
                if not torch.equal(out, want):
                    raise AssertionError(f"roi_pool kernel [{name}] != plain "
                                         f"({label}, {dtype}): max |diff| "
                                         f"{err}")
                worst[name] = max(worst[name], err)
            if not torch.equal(codes, want_codes):
                bad = int((codes != want_codes).sum())
                raise AssertionError(f"roi_pool kernel argmax codes != plain "
                                     f"({label}, {dtype}): {bad} differ")
            print(f"[kernel] {label} {str(dtype)[6:]} feat {list(f.shape)} "
                  f"P={r.shape[1]}: both instantiations bit-exact vs plain, "
                  f"argmax codes equal ({int((codes != rp.NO_CELL).sum())} "
                  "routed)")
            del want, want_codes, got, got_a, codes
    return worst


def _detector(arch, **kw):
    """A seeded f32 detector of ``arch`` at full width."""
    import torch
    from odwscl_tpu_torch.models import WSODDetector

    scale = 0.125 if arch.startswith("VGG") else 0.0625
    model = WSODDetector(compute_dtype="float32", backbone_arch=arch,
                         pooler_scale=scale, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def phase_card_vs_cpu(dev, arch="VGG16-OICR"):
    import torch
    from odwscl_tpu_torch.models import Batch

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
    model = _detector(arch)
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
    print(f"[slice] {arch} f32 eval_forward card vs CPU, B={b} {h}x{w} "
          f"P={p}: "
          f"max |d score| {ds:.3e} (tol {SCORE_ATOL}), max |d box| "
          f"{db:.3e} px (tol {BOX_ATOL_PX}); score range "
          f"[{s_cpu.min().item():.4f}, {s_cpu.max().item():.4f}]; "
          f"CPU {t_cpu:.2f} s, card {t_gpu:.2f} s (first call)")
    if not (torch.isfinite(s_gpu).all() and torch.isfinite(b_gpu).all()):
        raise AssertionError("non-finite eval_forward output on the card")
    if ds > SCORE_ATOL or db > BOX_ATOL_PX:
        raise AssertionError("card and CPU eval_forward disagree")


def bwd_bound(feat, rois, mask, g, name, scale=0.125, pooled=7):
    """(bound ms, by): feat and g read once, d feat written once in the
    feature dtype; the comparisons of the argmax scan (``pooled`` x
    ``pooled`` bins) at the f32 rate."""
    from odwscl_tpu_torch.ops.roi_pool_stages import stage_work
    from odwscl_tpu_torch.utils.profiling import (F32_OPS_PER_S,
                                                  MEM_BYTES_PER_S, card_rate)

    nbytes = (2 * feat.numel() + g.numel()) * feat.element_size() \
        + rois.numel() * 4 + mask.numel()
    bytes_ms = nbytes / card_rate(name, MEM_BYTES_PER_S) * 1e3
    ops = stage_work("roi_pool", feat, rois, mask, scale, pooled)[1]
    ops_ms = ops / card_rate(name, F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                    else "operations"), nbytes


def bwd_cases(rng):
    """The backward's cases at C = 512 (stride 8): the size grid, a bf16
    ties case and the training shape."""
    import torch

    feat_grid, rois_grid, mask_grid = grid_inputs(rng, 64)
    ties = np.round(feat_grid * 1.5).astype(np.float32)     # a few values
    both = (torch.float32, torch.bfloat16)
    return [("grid", (feat_grid, rois_grid, mask_grid), both, 0.125),
            ("ties", (ties, rois_grid, mask_grid), (torch.bfloat16,), 0.125),
            ("train", train_shape_inputs(rng), both, 0.125)]


def phase_bwd_kernel(dev, rp, cases):
    """Kernel vs plain backward: the training forward kernel's argmax, then
    the backward kernel from it, against the map-rescan
    ``roi_pool_backward_plain``, for each (label, inputs, dtypes, spatial
    scale) of ``cases``. Routing exact (strictly positive g, so both are
    non-zero on the same cells); values within the reordering of the f32
    sums, |d| <= n * 2^-23 * sum|g| per cell (n = the bins that route to
    the cell); after the cast to bf16 at most one bf16 ulp."""
    import torch

    worst = 0.0
    for label, (feat, rois, mask), dtypes, scale in cases:
        r = torch.from_numpy(rois).to(dev)
        m = torch.from_numpy(mask).to(dev)
        for dtype in dtypes:
            f = torch.from_numpy(feat).to(dev, dtype)
            g = (torch.rand(r.shape[:2] + (7, 7, f.shape[3]), device=dev)
                 + 0.05).to(dtype)
            _, codes = rp.roi_pool_argmax(f, r, m, scale)
            got = rp.roi_pool_backward(codes, r, m, g, scale,
                                       tuple(f.shape[1:3])).float()
            want = rp.roi_pool_backward_plain(f, r, m, g, scale).float()
            torch.cuda.synchronize()
            if not torch.equal(got != 0, want != 0):
                raise AssertionError(f"roi_pool_bwd routes differently from "
                                     f"plain ({label}, {dtype})")
            err = (got - want).abs()
            if dtype == torch.float32:
                count = rp.roi_pool_backward_plain(
                    f, r, m, torch.ones_like(g), scale)
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
            del g, codes, got, want, err, bound
    return worst


def argmax_cells(rp, codes, rois, mask, g, hw, scale=0.125,
                 index_dtype=None):
    """The index_add_ yardstick's inputs, built from the stored argmax one
    image at a time: the flat d feat index of every routed cotangent (in
    ``index_dtype``, int64 by default), and the cotangents in f32."""
    import torch

    b, p, r, _, c = codes.shape
    h, w = hw
    hs, _, ws, we = rp.roi_bin_edges(rois, scale, r, h, w)
    chans = torch.arange(c, device=codes.device)
    cells, vals = [], []
    for i in range(b):
        rows = slice(i * p, (i + 1) * p)
        off = rp.decode_cells(codes[i]).reshape(p, r, r, c).long()
        live = (off != rp.UNSIGNED_NO_CELL[codes.dtype]) \
            & mask[i][:, None, None, None]
        bw = (we[rows] - ws[rows]).clamp(min=1)[:, None, :, None]
        y = hs[rows][:, :, None, None] + off // bw
        x = ws[rows][:, None, :, None] + off % bw
        cell = ((i * h + y) * w + x) * c + chans
        cells.append(cell[live].to(index_dtype or torch.long))
        vals.append(g[i][live].float())
        del off, live, y, x, cell
    return torch.cat(cells), torch.cat(vals)


def phase_timing(dev, rp):
    """#1 at the eval shape, the training forward at the training shape and
    #2 beside its index_add_ yardstick, timed in turns in one run (3
    rounds), with their bounds and each design's own traffic."""
    import torch
    from odwscl_tpu_torch.ops.roi_pool_stages import stage_bound, stage_work
    from odwscl_tpu_torch.utils.profiling import MEM_BYTES_PER_S, card_rate

    name = torch.cuda.get_device_name(dev)
    rate = card_rate(name, MEM_BYTES_PER_S)
    rng = np.random.RandomState(5)
    fe, re_, me = (torch.from_numpy(a).to(dev) for a in main_path_inputs(rng))
    fe = fe.to(torch.bfloat16)
    ft, rt, mt = (torch.from_numpy(a).to(dev)
                  for a in train_shape_inputs(rng))
    ft = ft.to(torch.bfloat16)
    hw = tuple(ft.shape[1:3])
    _, codes = rp.roi_pool_argmax(ft, rt, mt, 0.125)
    g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
    cells, vals = argmax_cells(rp, codes, rt, mt, g, hw)
    n_dfeat = ft.numel()

    def yardstick():
        d = torch.zeros(n_dfeat, dtype=torch.float32, device=dev)
        d.index_add_(0, cells, vals)
        return d.to(torch.bfloat16)

    lib_out = yardstick().reshape(ft.shape)
    got = rp.roi_pool_backward(codes, rt, mt, g, 0.125, hw)
    if not torch.equal(got != 0, lib_out != 0):
        raise AssertionError("roi_pool_bwd and its index_add_ yardstick "
                             "route differently")
    fns = {"fwd": lambda: rp.roi_pool(fe, re_, me, 0.125),
           "fwd_argmax": lambda: rp.roi_pool_argmax(ft, rt, mt, 0.125),
           "bwd": lambda: rp.roi_pool_backward(codes, rt, mt, g, 0.125, hw),
           "bwd_library": yardstick}
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=10))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    plain_ms = {
        "fwd": cuda_ms(lambda: rp.roi_pool_plain(fe, re_, me, 0.125),
                       iters=1, warmup=0),
        "fwd_argmax": cuda_ms(lambda: rp.roi_pool_argmax_plain(
            ft, rt, mt, 0.125), iters=1, warmup=0),
        "bwd": cuda_ms(lambda: rp.roi_pool_backward_argmax_plain(
            codes, rt, mt, g, 0.125, hw), iters=1, warmup=0)}
    fwd_bound, fwd_by, fwd_bytes, _ = stage_bound("roi_pool", fe, re_, me,
                                                  0.125, name)
    # the training forward's own least traffic: #1's plus the argmax
    train_bytes = (stage_work("roi_pool", ft, rt, mt, 0.125)[0]
                   + codes.numel() * codes.element_size())
    bwd_ms, bwd_by, bwd_bytes = bwd_bound(ft, rt, mt, g, name)
    bwd_design = (g.numel() + n_dfeat) * 2 + codes.numel() * 2 \
        + rt.numel() * 4 + mt.numel()
    print(f"[timing] {name}; ms per launch, mean of 3 readings of 10 in "
          "turns: " + ", ".join(f"{k} {v:.4f} ({', '.join(f'{t:.4f}' for t in times[k])})"
                                for k, v in ms.items()))
    print(f"[timing] #1 eval shape bf16: {ms['fwd']:.4f} ms, bound "
          f"{fwd_bound:.4f} ms ({fwd_by}, {fwd_bytes / 1e9:.4f} GB), plain "
          f"{plain_ms['fwd']:.3f} ms")
    print(f"[timing] #1[argmax] train shape bf16: {ms['fwd_argmax']:.4f} ms, "
          f"bound {train_bytes / rate * 1e3:.4f} ms (bytes: map, output and "
          f"argmax, {train_bytes / 1e9:.4f} GB), plain "
          f"{plain_ms['fwd_argmax']:.3f} ms")
    print(f"[timing] #2 train shape bf16: {ms['bwd']:.4f} ms, bound "
          f"{bwd_ms:.4f} ms ({bwd_by}: feat, g and d feat, "
          f"{bwd_bytes / 1e9:.4f} GB); this design's traffic (g, argmax, d "
          f"feat) {bwd_design / 1e9:.4f} GB = "
          f"{bwd_design / rate * 1e3:.4f} ms; index_add_ yardstick "
          f"{ms['bwd_library']:.4f} ms ({cells.numel()} routed cotangents); "
          f"plain {plain_ms['bwd']:.3f} ms")
    return {
        "fwd": {"ms": ms["fwd"], "plain_ms": plain_ms["fwd"],
                "bound_ms": fwd_bound, "bound_by": fwd_by},
        "fwd_argmax": {"ms": ms["fwd_argmax"],
                       "plain_ms": plain_ms["fwd_argmax"],
                       "bound_ms": train_bytes / rate * 1e3,
                       "bound_by": "bytes"},
        "bwd": {"ms": ms["bwd"], "plain_ms": plain_ms["bwd"],
                "bound_ms": bwd_ms, "bound_by": bwd_by,
                "library_ms": ms["bwd_library"]}}


def phase_timing_c2048(dev, rp, inputs):
    """#1, #1[argmax] and #2 at the R-50-C5 training shape (``inputs``:
    feat [8, 80, 104, 2048] as bf16, stride 16, P = 2048, rois 16-720 px),
    and #2's index_add_ yardstick (routed as #2, checked), timed in turns
    (3 rounds of 10), with their byte bounds."""
    import torch
    from odwscl_tpu_torch.ops.roi_pool_stages import stage_bound, stage_work
    from odwscl_tpu_torch.utils.profiling import MEM_BYTES_PER_S, card_rate

    name = torch.cuda.get_device_name(dev)
    rate = card_rate(name, MEM_BYTES_PER_S)
    f, r, m = (torch.from_numpy(a).to(dev) for a in inputs)
    f = f.to(torch.bfloat16)
    hw = tuple(f.shape[1:3])
    _, codes = rp.roi_pool_argmax(f, r, m, 0.0625)
    g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
    # the d feat map (136M cells) fits int32 indices
    cells, vals = argmax_cells(rp, codes, r, m, g, hw, 0.0625, torch.int32)
    n_dfeat = f.numel()

    def yardstick():
        d = torch.zeros(n_dfeat, dtype=torch.float32, device=dev)
        d.index_add_(0, cells, vals)
        return d.to(torch.bfloat16)

    lib_out = yardstick().reshape(f.shape)
    got = rp.roi_pool_backward(codes, r, m, g, 0.0625, hw)
    if not torch.equal(got != 0, lib_out != 0):
        raise AssertionError("roi_pool_bwd and its index_add_ yardstick "
                             "route differently (c2048)")
    del lib_out, got
    fns = {"fwd": lambda: rp.roi_pool(f, r, m, 0.0625),
           "fwd_argmax": lambda: rp.roi_pool_argmax(f, r, m, 0.0625),
           "bwd": lambda: rp.roi_pool_backward(codes, r, m, g, 0.0625, hw),
           "bwd_library": yardstick}
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=10))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    fwd_ms, fwd_by, fwd_bytes, _ = stage_bound("roi_pool", f, r, m, 0.0625,
                                               name)
    arg_bytes = (stage_work("roi_pool", f, r, m, 0.0625)[0]
                 + codes.numel() * codes.element_size())
    bwd_ms, bwd_by, bwd_bytes = bwd_bound(f, r, m, g, name, 0.0625)
    bounds = {"fwd": (fwd_ms, fwd_by, fwd_bytes),
              "fwd_argmax": (arg_bytes / rate * 1e3, "bytes", arg_bytes),
              "bwd": (bwd_ms, bwd_by, bwd_bytes)}
    for k in bounds:
        print(f"[c2048] {k} feat {list(f.shape)} bf16 P={r.shape[1]}: "
              f"{ms[k]:.4f} ms ({', '.join(f'{t:.4f}' for t in times[k])}),"
              f" bound {bounds[k][0]:.4f} ms ({bounds[k][1]}, "
              f"{bounds[k][2] / 1e9:.4f} GB)")
    print(f"[c2048] bwd's index_add_ yardstick: {ms['bwd_library']:.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in times['bwd_library'])}; "
          f"{cells.numel()} routed cotangents, int32 indices)")
    SUMMARY.append("c2048 ms " + ", ".join(f"{k} {ms[k]:.4f}" for k in fns))
    out = {k: {"ms": ms[k], "bound_ms": bounds[k][0],
               "bound_by": bounds[k][1]} for k in bounds}
    out["bwd"]["library_ms"] = ms["bwd_library"]
    return out


def phase_check_c2048(dev, rp, inputs):
    """#1, #1[argmax] and #2 against their plain versions at the R-50-C5
    timed shape (``inputs``: feat [8, 80, 104, 2048], P = 2048), f32 and
    bf16. The plain versions run per image on chunks of C2048_CHUNK rois
    sorted by their larger side in cells, so that each chunk's padded
    window stays close to its rois' (each roi is pooled on its own, so the
    chunks change no value): both forward instantiations and the argmax
    codes bit-exact against ``roi_pool_argmax_plain`` (and, in bf16, #1
    against ``roi_pool_plain``, which is timed); the backward kernel,
    from the kernel's codes and a strictly positive g, against the f32
    sums of ``roi_pool_backward_argmax_plain`` over the plain codes
    (summed over the chunks, then cast), as ``phase_bwd_kernel`` holds it.
    Returns the worst errors and the plain versions' bf16 times over all
    chunks."""
    import torch

    scale = 0.0625
    feat, rois, mask = inputs
    r = torch.from_numpy(rois).to(dev)
    m = torch.from_numpy(mask).to(dev)
    b, p = r.shape[:2]
    hw = feat.shape[1:3]
    hs, he, ws, we = rp.roi_bin_edges(r, scale, 7, *hw)
    side = torch.maximum(he[:, -1] - hs[:, 0], we[:, -1] - ws[:, 0])
    chunks = [(i, idx) for i, order in enumerate(side.reshape(b, p).argsort(1))
              for idx in order.split(C2048_CHUNK)]
    worst = {"eval": 0.0, "argmax": 0.0, "bwd": 0.0}
    plain_ms = {}

    def timed_plain(key, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        plain_ms[key] = plain_ms.get(key, 0.0) + start.elapsed_time(end)
        return out

    for dtype in (torch.float32, torch.bfloat16):
        plain_ms.clear()
        f = torch.from_numpy(feat).to(dev, dtype)
        got = rp.roi_pool(f, r, m, scale)
        got_a, codes = rp.roi_pool_argmax(f, r, m, scale)
        g = (torch.rand(codes.shape, device=dev) + 0.05).to(dtype)
        d_got = rp.roi_pool_backward(codes, r, m, g, scale, hw).float()
        want = torch.zeros(f.shape, dtype=torch.float32, device=dev)
        count = torch.zeros_like(want) if dtype == torch.float32 else None
        for i, idx in chunks:
            ri, mi, gi = r[i:i + 1, idx], m[i:i + 1, idx], g[i:i + 1, idx]
            w_out, w_codes = timed_plain("fwd_argmax", rp.roi_pool_argmax_plain,
                                         f[i:i + 1], ri, mi, scale)
            if dtype == torch.bfloat16:
                w_eval = timed_plain("fwd", rp.roi_pool_plain, f[i:i + 1],
                                     ri, mi, scale)
                if not torch.equal(got[i, idx], w_eval[0]):
                    raise AssertionError(f"roi_pool kernel != roi_pool_plain "
                                         f"(c2048 timed shape, image {i})")
            for name, out in (("eval", got), ("argmax", got_a)):
                err = (out[i, idx].float() - w_out[0].float()).abs().max()
                worst[name] = max(worst[name], err.item())
                if not torch.equal(out[i, idx], w_out[0]):
                    raise AssertionError(
                        f"roi_pool kernel [{name}] != plain (c2048 timed "
                        f"shape, {dtype}, image {i}): max |diff| {err}")
            if not torch.equal(codes[i, idx], w_codes[0]):
                raise AssertionError(f"roi_pool kernel argmax codes != plain "
                                     f"(c2048 timed shape, {dtype}, image {i})")
            want[i:i + 1] += timed_plain(
                "bwd", rp.roi_pool_backward_argmax_plain, w_codes, ri, mi,
                gi.float(), scale, hw)
            if count is not None:
                count[i:i + 1] += rp.roi_pool_backward_argmax_plain(
                    w_codes, ri, mi, torch.ones_like(gi, dtype=torch.float32),
                    scale, hw)
        want = want.to(dtype).float()
        if not torch.equal(d_got != 0, want != 0):
            raise AssertionError(f"roi_pool_bwd routes differently from plain "
                                 f"(c2048 timed shape, {dtype})")
        err = (d_got - want).abs()
        bound = (count * 2.0 ** -23 * want.abs() + 1e-30 if count is not None
                 else 2.0 ** -7 * want.abs())
        if (err > bound).any():
            raise AssertionError(f"roi_pool_bwd != plain (c2048 timed shape, "
                                 f"{dtype}): max |diff| {err.max().item()}")
        worst["bwd"] = max(worst["bwd"], err.max().item())
        print(f"[c2048] {str(dtype)[6:]} feat {list(f.shape)} P={p}: #1 and "
              f"#1[argmax] bit-exact vs plain, argmax codes equal "
              f"({int((codes != rp.NO_CELL).sum())} routed); #2 same cells "
              f"as plain, max |diff| {err.max().item():.3e} (within the "
              f"bound), {int((want != 0).sum())} cells routed; plain over "
              f"{len(chunks)} chunks: argmax forward "
              f"{plain_ms['fwd_argmax']:.1f} ms, backward from the argmax "
              f"{plain_ms['bwd']:.1f} ms"
              + (f", eval forward (roi_pool_plain, held equal to #1) "
                 f"{plain_ms['fwd']:.1f} ms" if "fwd" in plain_ms else ""))
        del f, got, got_a, codes, g, d_got, want, count, err, bound
        torch.cuda.empty_cache()
    return worst, dict(plain_ms)


STAGE_REPLACES = {
    "write": "tools/profile_pool_stages.py:35 make_kernel[write]",
    "rows": "tools/profile_pool_stages.py:35 make_kernel[rows]",
    "rows_col0": "tools/profile_pool.py:61 _fwd_rows_only",
    "cols": "tools/profile_pool.py:89 _fwd_cols_only",
    "full": "tools/profile_pool_stages.py:35 make_kernel[full]"}


def phase_stage_kernels(dev, rp, rs):
    """Each stage kernel bit-exact against its plain version (max only
    selects) and ``full`` against the forward kernel; then the profiler
    driven at the bench shape, its launches counted. Returns the kernels
    line's entries of the five stages."""
    import torch
    from odwscl_tpu_torch.tools import profile_pool_stages as pps

    rng = np.random.RandomState(4)
    worst = dict.fromkeys(rs.STAGES, 0.0)
    plain_ms = {}
    both = (torch.float32, torch.bfloat16)
    for label, (feat, rois, mask), dtypes in (
            ("grid", grid_inputs(rng, 64), both),
            ("narrow", grid_inputs(rng, 64, h=13, w=6), both),
            ("bench", pps.make_inputs(*pps.BENCH_SHAPE), (torch.bfloat16,))):
        r = torch.from_numpy(rois).to(dev)
        m = torch.from_numpy(mask).to(dev)
        for dtype in dtypes:
            f = torch.from_numpy(feat).to(dev, dtype)
            plan = rs.stage_plan(f, r, m, pps.SCALE)
            for stage in rs.STAGES:
                got = rs.roi_pool_stage(f, r, m, pps.SCALE, stage, plan)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                want = rs.roi_pool_stage_plain(f, r, m, pps.SCALE, stage)
                end.record()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(f"roi_pool_stage[{stage}] kernel != "
                                         f"plain ({label}, {dtype}): max "
                                         f"|diff| {err}")
                worst[stage] = max(worst[stage], err)
                if label == "bench":
                    plain_ms[stage] = start.elapsed_time(end)
                if stage == "full" and not torch.equal(
                        got, rp.roi_pool(f, r, m, pps.SCALE)):
                    raise AssertionError(f"roi_pool_stage[full] != roi_pool "
                                         f"kernel ({label}, {dtype})")
            print(f"[stages] {label} {str(dtype)[6:]} feat {list(f.shape)} "
                  f"P={r.shape[1]}: {', '.join(rs.STAGES)} bit-exact vs "
                  "plain; full bit-exact vs the forward kernel")
    try:
        rs.roi_pool_stage(torch.zeros((1, 8, 8, 12), device=dev), r[:1],
                          m[:1], pps.SCALE, "rows")
    except ValueError as e:
        print(f"[stages] C=12 refused: {e}")
    else:
        raise AssertionError("roi_pool_stage took C=12, not a multiple of 8")
    del f, got, want
    print("[stages] plain versions at the bench shape (one call each): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in plain_ms.items()))

    rs.roi_pool_stage.launches = dict.fromkeys(rs.STAGES, 0)
    prof = pps.main([])
    launches = dict(rs.roi_pool_stage.launches)
    if not all(launches.values()):
        raise AssertionError(f"the profiler launched no kernel of some "
                             f"stages: {launches}")
    print(f"[stages] profiler launches per stage: {launches}")
    no_lib = ("no PyTorch call computes this stage of ROIPool; torchvision "
              "is not installed")
    entries = []
    for stage in rs.STAGES:
        v = prof["variants"][stage]
        entries.append({
            "name": f"roi_pool_stage[{stage}]", "route": "cuda",
            "source": "odwscl_tpu_torch/csrc/roi_pool_fwd.cu",
            "replaces": STAGE_REPLACES[stage], "launches": launches[stage],
            "max_abs_err": worst[stage], "ms": v["ms"],
            "plain_ms": plain_ms[stage], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"],
            "library_ms": prof["library_ms"].get(stage),
            "library_note": ("torch.zeros of the output's shape and dtype"
                             if stage in prof["library_ms"] else no_lib)})
    entries[rs.STAGES.index("cols")]["also_replaces"] = (
        "tools/profile_pool_stages.py:35 make_kernel[cols]")
    return entries


# the new paths' f32 card-vs-CPU steps: (label, WSODDetector keywords)
VARIANT_STEPS = [
    ("WSDDN", dict(predictor="WSDDNPredictor", contra=False,
                   regress_on=False)),
    ("OICR", dict(predictor="OICRPredictor", contra=False, regress_on=False)),
    ("MIST OICR_P 0.15", dict(contra=False, oicr_p=0.15)),
    ("OICR contra", dict(predictor="OICRPredictor", regress_on=False)),
    ("DB concrete", dict(db_method="concrete")),
    ("FASTER_RCNN", dict(faster_rcnn=True, contra=False, db_method="none",
                         rpn_post_nms=128)),
]


def phase_train_card_vs_cpu(dev, arch="VGG16-OICR", label=None,
                            num_classes=21, seed=3, **kw):
    """One f32 train step on the card and on the CPU: same weights, batch
    and draws; neck dropout 0 (its masks come from each device's own
    generator). One positive class per image, so stage B's chain compares
    no rows of other classes (it compares 1.0 with a self-similarity that
    rounds to either side of 1 with the summation order). ``kw`` selects a
    training variant (``VARIANT_STEPS``); the watched gradients are the
    tensors that variant trains. With ``DB.METHOD concrete`` the card's
    step is then repeated with cuDNN's TF32 (PyTorch's default, which the
    port keeps for the CDB's convolutions) and its gap to the CPU and the
    drop decisions that moved are printed. ``num_classes`` 81 is the COCO
    configs' head; ``seed`` draws the batch and the draws. Returns the f32
    loss gap."""
    import torch
    from odwscl_tpu_torch.models import Batch
    from odwscl_tpu_torch.models import cdb as tcdb
    from odwscl_tpu_torch.models import detector as tdet

    label = label or arch
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)
    b, h, w, p = 2, 128, 160, 128
    sizes = np.array([[128, 160], [120, 150]], np.float32)
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    x1y1 = rng.uniform(0, 100, (b, p, 2))
    wh = rng.uniform(16, 100, (b, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, sizes[:, None, ::-1]
                                             - 1)], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.1
    labels = np.zeros((b, num_classes), np.float32)
    labels[0, 7] = labels[1, 15] = 1.0
    batch = Batch(*(torch.from_numpy(a) for a in (images, sizes, boxes, mask,
                                                  labels)))
    model = _detector(arch, neck_dropout=0.0, cap_a=1024, cap_b=256,
                      num_classes=num_classes, **kw)
    with torch.no_grad():
        for name, _ in model.pred.heads:
            if not name.startswith("bbox_pred"):
                getattr(model.pred, name).weight.mul_(HEAD_SCALE[arch])
    r = model.pooler_resolution
    draws = {"dropblock": torch.from_numpy(rng.uniform(
                 size=(b * p, r, r)).astype(np.float32)),
             "sim_drop": torch.from_numpy(rng.uniform(
                 size=(1024, r, r)).astype(np.float32)),
             "noise": torch.from_numpy(rng.randn(1024, r, r, 512).astype(
                 np.float32)),
             "cdb_gumbel": torch.from_numpy(rng.uniform(
                 size=(b * p, r, r, 2)).astype(np.float32))}
    heads = [n for n, _ in model.pred.heads]
    watch = ["neck.fc7.weight", "pred.cls_score.weight"]
    watch += [f"pred.{n}.weight" for n in ("ref1", "bbox_pred1")
              if n in heads and (n == "ref1" or model.regress_on)]
    watch += ["sim_net.mlp1.weight"] if model.contra else []
    watch += ["cam.cam_conv.weight"] if model.cam is not None else []
    # the CDB's gradient sums exp(-|d| / tau) over its few unsaturated
    # gumbel cells: a drift in d moves it by a factor exp(drift / tau),
    # 100x the drift at tau 0.01, so it is printed, not bounded
    cdb_watch = ["cdb.conv1.weight"] if model.cdb is not None else []
    seen = {}

    def record_drops(*args, **kwargs):
        out = gumbel(*args, **kwargs)
        seen["drop"] = out[..., 0].detach().cpu()
        return out

    def record_props(*args, **kwargs):
        out = cam_props(*args, **kwargs)
        seen["props"] = (out[0].cpu(), out[1].cpu())
        return out

    gumbel, cam_props = tcdb.gumbel_softmax, tdet.cam_to_proposals

    def step(device):
        model.to(device).zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        tcdb.gumbel_softmax, tdet.cam_to_proposals = (record_drops,
                                                      record_props)
        try:
            losses, metrics = model.train_forward(
                batch.to(device), draws={k: v.to(device) for k, v in
                                         draws.items()})
        finally:
            tcdb.gumbel_softmax, tdet.cam_to_proposals = gumbel, cam_props
        torch.stack(list(losses.values())).sum().backward()
        grads = {k: model.get_parameter(k).grad.detach().cpu().clone()
                 for k in watch + cdb_watch}
        if not all(torch.isfinite(g).all() for g in grads.values()):
            raise AssertionError(f"non-finite gradients on {device}")
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: float(v) for k, v in metrics.items()}, grads,
                time.perf_counter() - t0, dict(seen))

    def grad_gap(g_a, keys):
        return max([((g_a[k] - g_cpu[k]).abs().max()
                     / g_cpu[k].abs().max().clamp(min=1e-12)).item()
                    for k in keys] or [0.0])

    def gaps(l_a, g_a):
        loss_err = max(abs(l_a[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                       for k in l_cpu)
        return loss_err, grad_gap(g_a, watch)

    try:
        l_cpu, m_cpu, g_cpu, t_cpu, s_cpu = step("cpu")
        l_gpu, m_gpu, g_gpu, t_gpu, s_gpu = step(dev)
        if model.cdb is not None:
            torch.backends.cudnn.allow_tf32 = True
            l_tf, _, g_tf, _, s_tf = step(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ints = [k for k in m_cpu if k.startswith(("n_", "bank_", "pgt_"))]
    bad = [k for k in ints if m_cpu[k] != m_gpu[k]]
    if bad:
        raise AssertionError(f"{label}: mining decisions differ card vs CPU: "
                             f"{[(k, m_cpu[k], m_gpu[k]) for k in bad]}")
    loss_err, grad_err = gaps(l_gpu, g_gpu)
    if not all(math.isfinite(v) for v in l_gpu.values()):
        raise AssertionError(f"non-finite train losses on the card: {l_gpu}")
    extra = ""
    if cdb_watch:
        moved = int(((s_gpu["drop"] > 0.5) != (s_cpu["drop"] > 0.5)).sum())
        extra = (f"; drop decisions that moved {moved} of "
                 f"{s_cpu['drop'].numel()}; CDB conv1 grad diff "
                 f"{grad_gap(g_gpu, cdb_watch):.3e} of the largest "
                 "(unbounded)")
    if "props" in s_cpu:
        (bc, mc), (bg, mg) = s_cpu["props"], s_gpu["props"]
        same = int(((bc == bg).all(-1) & mc & mg).sum())
        extra = (f"; CAM proposals {int(mc.sum())} (CPU) / {int(mg.sum())} "
                 f"(card), {same} identical in place")
    print(f"[train] {label} f32 train step card vs CPU, B={b} {h}x{w} "
          f"P={p}: integer decisions equal ("
          f"{', '.join(f'{k} {m_cpu[k]:g}' for k in ints)}); losses "
          f"{sorted(l_cpu)}; max loss rel diff {loss_err:.3e} (tol "
          f"{TRAIN_LOSS_RTOL}), max grad diff {grad_err:.3e} of the largest "
          f"(tol {TRAIN_GRAD_REL}, {len(watch)} tensors){extra}; CPU "
          f"{t_cpu:.2f} s, card {t_gpu:.2f} s (first call)")
    if model.contra and (m_cpu["n_bank"] == 0 or m_cpu["n_mined"] == 0):
        raise AssertionError("the mining found nothing to compare")
    if loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_REL:
        raise AssertionError(f"{label}: card and CPU train steps disagree")
    if model.cdb is not None:
        moved = int(((s_tf["drop"] > 0.5) != (s_cpu["drop"] > 0.5)).sum())
        tf_loss, tf_grad = gaps(l_tf, g_tf)
        print(f"[train] {label} with cuDNN TF32 (the CDB's convolutions as "
              f"the port runs them) vs the CPU's f32: max loss rel diff "
              f"{tf_loss:.3e}, max grad diff {tf_grad:.3e}, CDB conv1 grad "
              f"diff {grad_gap(g_tf, cdb_watch):.3e}; drop decisions "
              f"that moved {moved} of {s_cpu['drop'].numel()} cells "
              f"({int((s_cpu['drop'] > 0.5).sum())} dropped on the CPU)")
        SUMMARY.append(f"CDB TF32 gap: loss {tf_loss:.2e}, {moved} drop "
                       "cells moved")
    return loss_err


def write_data(tmp, cfg, cfg_r50):
    """The synthetic VOC splits, with their proposal files also under the
    names the R-50 config reads."""
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    t0 = time.perf_counter()
    write_synthetic_voc(tmp, n_test=16, seed=0, img_hw=(375, 500),
                        n_props=2048, prop_size=(20, 300), obj_size=(40, 200),
                        test_proposal_file=cfg.PROPOSAL_FILES.TEST[0],
                        n_trainval=32,
                        train_proposal_file=cfg.PROPOSAL_FILES.TRAIN[0])
    for split in ("TRAIN", "TEST"):
        dst = os.path.join(tmp, cfg_r50.PROPOSAL_FILES[split][0])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy(os.path.join(tmp, cfg.PROPOSAL_FILES[split][0]), dst)
    print(f"[data] synthetic VOC: 32 trainval + 16 test images 375x500, "
          f"2048 proposals each, written in {time.perf_counter() - t0:.2f} s")


def write_r50_weights(tmp):
    """A Caffe2 detectron R-50 ``.pkl`` of random blobs at the catalog's
    basename under ``<tmp>/weights``; returns its blobs."""
    import pickle
    from odwscl_tpu_torch.data.synthetic import detectron_resnet_blobs

    blobs = detectron_resnet_blobs("R-50", 5, seed=0)
    os.makedirs(os.path.join(tmp, "weights"), exist_ok=True)
    with open(os.path.join(tmp, "weights", "R-50.pkl"), "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return blobs


def phase_train(rp, tmp, config, steps, label, opts=(), period=None,
                live=(), per_step=1):
    """``train_net`` with ``config`` for ``steps`` iterations, a checkpoint
    every ``period`` (default ``steps``) and at the end; every step must
    launch the training forward (with the argmax) and the backward
    ``per_step`` times (0 under ROIAlign) and the eval forward never,
    every loss must be finite and each metric of ``live`` (e.g. the
    mining counters) non-zero in some step. Returns the launch counts
    (fwd[argmax], bwd) and the final checkpoint."""
    import torch
    from odwscl_tpu_torch.tools import train_net

    out = os.path.join(tmp, "train_" + label.replace(" ", "_"))
    period = period or steps
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
    rp.roi_pool_backward.launches = 0
    t0 = time.perf_counter()
    train_net.main(["--config-file", config, "--data-root", tmp,
                    "--device", "cuda", "--skip-test", "OUTPUT_DIR", out,
                    "SOLVER.MAX_ITER", str(steps),
                    "SOLVER.CHECKPOINT_PERIOD", str(period), *opts],
                   timing_out=timing)
    wall = time.perf_counter() - t0
    launches = (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                rp.roi_pool_backward.launches)
    steps_log = timing["train"]["steps"]
    if len(steps_log) != steps:
        raise AssertionError(f"{len(steps_log)} train steps, not {steps}")
    for st in steps_log:
        bad = [k for k, v in st.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label} iteration {st['iter']}: "
                                 f"non-finite {bad}")
    if launches != (0, per_step * steps, per_step * steps):
        raise AssertionError(f"{label}: kernel launches (fwd, fwd[argmax], "
                             f"bwd) {launches} for {steps} steps")
    dead = [k for k in live if not any(st[k] for st in steps_log)]
    if dead:
        raise AssertionError(f"{label}: {dead} zero in every step")
    # steps 5 on (the warm-up before), or the last step of a shorter run
    window = steps_log[4:] or steps_log[-1:]
    first = steps - len(window) + 1
    med = statistics.median(st["step_s"] for st in window)
    data_wait = sum(st["data_s"] for st in window)
    t = timing["train"]
    idle = t.get("device_idle_share")
    traced = (f"{idle:.3f} (busy {t['device_busy_s']:.2f} s of "
              f"{t['profile_wall_s']:.2f} s, traced)" if idle is not None
              else "not traced (fewer than 5 steps)")
    print(f"[train] {label}: {steps} steps, batch 8, bf16: median step "
          f"{med * 1e3:.1f} ms over steps {first}-{steps} = {8 / med:.2f} "
          f"images/s; host data wait {data_wait:.2f} s of "
          f"{sum(st['step_s'] for st in window):.2f} s; device idle share "
          f"{traced}; max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; CLI wall "
          f"{wall:.2f} s")
    TRAIN_RUNS[label] = {
        "steps": steps_log, "median_ms": med * 1e3, "idle": idle,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    SUMMARY.append(f"{label} train: median step {med * 1e3:.1f} ms = "
                   f"{8 / med:.2f} images/s, idle "
                   f"{'n/a' if idle is None else f'{idle:.3f}'}, peak "
                   f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[train] {label} losses step 1 -> {steps}: " + ", ".join(
        f"{k} {steps_log[0][k]:.4f} -> {steps_log[-1][k]:.4f}"
        for k in ("loss", "loss_cam", "loss_img", "loss_sim",
                  "loss_ref_cls0") if k in steps_log[0]))
    print(f"[train] {label} kernel launches: roi_pool_fwd[argmax] "
          f"{launches[1]}, roi_pool_bwd {launches[2]} = {per_step} x steps "
          f"{steps}; roi_pool_fwd {launches[0]}")
    if live:
        print(f"[train] {label} " + ", ".join(
            f"{k} {[int(st[k]) for st in steps_log]}" for k in live))
    for name in (f"model_{period:07d}.pt", "model_final.pt"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"checkpoint {name} missing")
    return launches[1:], os.path.join(out, "model_final.pt")


# phase 22: the data-parallel path at world size 1
DIST_STEPS = 6
# steps 2-6 against phase 7's: #2's f32 atomics add in another order in
# each run, so two bf16 runs part by rounding after step 1, and a mining
# counter or pseudo-label that flips moves the losses by percents: four
# plain twins of phase 7's run parted from it by up to 1.9e-2 in the
# total loss (and by 0.56 in a loss of 2e-5), the distributed runs by up
# to 2.5e-2. The total loss is held to 0.1 relative (a run whose updates
# went wrong parts by more: the loss falls from 0.94 to ~0.35 in 10
# steps); the twin's gap is printed beside it
DIST_LOSS_RTOL = 0.1
# train_net as a user launches it, its launches counted in its process
DIST_LAUNCHER = r"""
import json, runpy, sys
from odwscl_tpu_torch.ops import roi_pool as rp
rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
rp.roi_pool_backward.launches = 0
sys.argv = ["train_net"] + sys.argv[1:]
runpy.run_module("odwscl_tpu_torch.tools.train_net", run_name="__main__")
print("LAUNCHES " + json.dumps([rp.roi_pool.launches,
                                 rp.roi_pool_argmax.launches,
                                 rp.roi_pool_backward.launches]))
"""


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_distributed(rp, tmp, config, ref_label):
    """Phase 22 (see the module's docstring). Returns the launches
    (fwd[argmax], bwd) of the training and #1's of the evaluation."""
    import subprocess

    import torch
    from odwscl_tpu_torch.tools import test_net

    ref = TRAIN_RUNS[ref_label]
    phase_train(rp, tmp, config, DIST_STEPS, ref_label + " twin",
                ("MODEL.WEIGHT", ""))
    twin = TRAIN_RUNS[ref_label + " twin"]["steps"]
    out = os.path.join(tmp, "train_distributed")
    prof = os.path.join(out, "profile")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    cmd = [sys.executable, "-c", DIST_LAUNCHER, "--config-file", config,
           "--data-root", tmp, "--device", "cuda", "--distributed",
           "--use-tensorboard", "--profile-dir", prof, "--skip-test",
           "OUTPUT_DIR", out, "SOLVER.MAX_ITER", str(DIST_STEPS),
           "SOLVER.CHECKPOINT_PERIOD", str(DIST_STEPS), "MODEL.WEIGHT", ""]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"train_net --distributed exited "
                             f"{proc.returncode}")
    launches = json.loads(proc.stdout.rsplit("LAUNCHES ", 1)[1]
                          .splitlines()[0])
    if launches != [0, DIST_STEPS, DIST_STEPS]:
        raise AssertionError(f"distributed: kernel launches (fwd, "
                             f"fwd[argmax], bwd) {launches} for "
                             f"{DIST_STEPS} steps")
    with open(os.path.join(out, "logs", "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if [r["iteration"] for r in recs] != list(range(1, DIST_STEPS + 1)):
        raise AssertionError(f"scalars.jsonl iterations "
                             f"{[r['iteration'] for r in recs]}")
    trace = os.path.join(prof, "worker0.pt.trace.json")
    if not os.path.exists(trace) or os.path.getsize(trace) == 0:
        raise AssertionError(f"no profiler trace at {trace}")
    with open(os.path.join(prof, "window_rank0.json")) as f:
        window = json.load(f)
    steps = ref["steps"]
    keys = [k for k in steps[0] if k not in ("iter", "step_s", "data_s")]
    for name, run in (("distributed", recs), ("twin", twin)):
        bad = [(k, run[0][k], steps[0][k]) for k in keys
               if run[0][k] != steps[0][k]]
        if bad:
            raise AssertionError(f"{name} step 1 != phase 7's: {bad}")

    def gaps(run):
        """Per step after the first: the total loss's relative gap to
        phase 7's, and the counters that differ."""
        return [(abs(r["loss"] - st["loss"]) / abs(st["loss"]),
                 [k for k in keys if k.startswith("n_") and r[k] != st[k]])
                for r, st in zip(run[1:], steps[1:])]

    dist_gaps, twin_gaps = gaps(recs), gaps(twin)
    worst = max(g for g, _ in dist_gaps)
    print(f"[train] steps 2-{DIST_STEPS}, total loss rel gap to phase 7 "
          f"(counters that differ): distributed " + ", ".join(
              f"{g:.1e} ({len(c)})" for g, c in dist_gaps) + "; plain twin "
          + ", ".join(f"{g:.1e} ({len(c)})" for g, c in twin_gaps))
    if worst > DIST_LOSS_RTOL:
        raise AssertionError(f"distributed steps 2-{DIST_STEPS}: total loss "
                             f"rel gap {worst:.3e} > {DIST_LOSS_RTOL} (the "
                             f"plain twin's: "
                             f"{max(g for g, _ in twin_gaps):.3e})")
    med = statistics.median(r["time"] for r in recs[4:])
    twin_run = TRAIN_RUNS[ref_label + " twin"]
    print(f"[train] distributed (train_net --distributed, nccl, world 1): "
          f"{DIST_STEPS} steps; step 1's {len(keys)} losses and counters "
          f"equal phase 7's (and the plain twin's); steps 2-{DIST_STEPS}: "
          f"worst total loss gap {worst:.3e} (the twin's "
          f"{max(g for g, _ in twin_gaps):.3e}) within {DIST_LOSS_RTOL}")
    print(f"[train] distributed: median step {med * 1e3:.1f} ms over steps "
          f"5-{DIST_STEPS} (the plain twin: {twin_run['median_ms']:.1f} ms "
          f"over the same steps; phase 7: {ref['median_ms']:.1f} ms over 5-"
          f"{len(steps)}); device idle share {window['device_idle_share']:.3f}"
          f" over steps {window['first_iter']}-{window['last_iter']} (twin: "
          f"{twin_run['idle']:.3f} over 5-{DIST_STEPS}; phase 7: "
          f"{ref['idle']:.3f} over 5-{len(steps)}); peak "
          f"{window['max_memory_allocated_bytes'] / 1e9:.2f} GB (twin: "
          f"{twin_run['peak_gb']:.2f}); trace "
          f"{os.path.getsize(trace) / 1e6:.1f} MB; process wall {wall:.1f} s")
    SUMMARY.append(f"distributed world-1 train: median step {med * 1e3:.1f} "
                   f"ms (plain twin {twin_run['median_ms']:.1f}), idle "
                   f"{window['device_idle_share']:.3f} (twin "
                   f"{twin_run['idle']:.3f}), peak "
                   f"{window['max_memory_allocated_bytes'] / 1e9:.2f} GB")

    seen = {}
    load = test_net.load_model

    def record(cfg, weights=None):
        model = load(cfg, weights)
        seen.update(weights=weights, state=model.state_dict())
        return model

    rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
    rp.roi_pool_backward.launches = 0
    test_net.load_model = record
    try:
        res = test_net.main(["--config-file", config, "--data-root", tmp,
                             "--device", "cuda", "OUTPUT_DIR", out,
                             "TPU.EVAL_DEVICE_RESIZE", "True"])
    finally:
        test_net.load_model = load
    evals = (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
             rp.roi_pool_backward.launches)
    with open(os.path.join(out, "last_checkpoint")) as f:
        last = f.read().strip()
    if seen["weights"] != last:
        raise AssertionError(f"test_net evaluated {seen['weights']}, not "
                             f"last_checkpoint's {last}")
    want = torch.load(last, map_location="cpu", weights_only=True)["model"]
    if any(not torch.equal(seen["state"][k].cpu(), v)
           for k, v in want.items()):
        raise AssertionError("test_net's model is not the checkpoint's")
    (r,) = res.values()
    if not math.isfinite(r["map"]) or not evals[0] or any(evals[1:]):
        raise AssertionError(f"distributed checkpoint eval: mAP {r['map']}, "
                             f"launches {evals}")
    print(f"[eval] test_net without --weights evaluated "
          f"{os.path.basename(last)} (last_checkpoint): mAP {r['map']:.4f}, "
          f"roi_pool_fwd launches {evals[0]}")
    return (launches[1], launches[2]), evals[0]


TP_ROWS = 16384
SP_BATCH = (8, 1280, 1664)


def phase_tp_sp(dev):
    """Phase 23 (see the module's docstring)."""
    import torch
    import torch.distributed as dist
    from odwscl_tpu_torch.models.vgg16 import VGGBackbone, VGGRoINeck
    from odwscl_tpu_torch.parallel import (shard_neck_params,
                                           sp_backbone_apply, tp_neck_apply,
                                           tp_neck_plain)

    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        bf16 = torch.bfloat16
        g = torch.Generator().manual_seed(0)
        gd = torch.Generator(device=dev).manual_seed(0)
        neck = VGGRoINeck(25088, 4096, bf16, 0.0)
        neck.reset_parameters(g)
        neck.to(dev)
        x = torch.randn(TP_ROWS, 7, 7, 512, generator=gd, device=dev,
                        dtype=bf16).relu_()
        shard = shard_neck_params(neck, 0, 1)
        with torch.no_grad():
            got = tp_neck_apply(shard, x, None, bf16)
            want = tp_neck_plain(neck, x, bf16)
            model = neck(x)
        if not torch.equal(got, want):
            raise AssertionError(f"tp_neck_apply != tp_neck_plain: max "
                                 f"{(got.float() - want.float()).abs().max()}")
        gap = ((got.float() - model.float()).abs().max()
               / model.float().abs().max()).item()
        with torch.no_grad():
            tp_ms = cuda_ms(lambda: tp_neck_apply(shard, x, None, bf16), 10)
            plain_ms = cuda_ms(lambda: tp_neck_plain(neck, x, bf16), 10)
            neck_ms = cuda_ms(lambda: neck(x), 10)
        del x
        bb = VGGBackbone("VGG16-OICR", bf16)
        bb.reset_parameters(g)
        bb.to(dev)
        images = torch.randn(*SP_BATCH, 3, generator=gd, device=dev) * 50
        with torch.no_grad():
            got = sp_backbone_apply(bb, images, None)
            want = bb(images)
            if not torch.equal(got, want):
                raise AssertionError("sp_backbone_apply != the backbone: "
                                     f"max {(got.float() - want.float()).abs().max()}")
            sp_ms = cuda_ms(lambda: sp_backbone_apply(bb, images, None), 5)
            bb_ms = cuda_ms(lambda: bb(images), 5)
    finally:
        dist.destroy_process_group()
    print(f"[parallel] tp_neck_apply, world 1, bf16 [{TP_ROWS}, 25088] -> "
          f"4096 -> 4096: bit-exact vs tp_neck_plain; {tp_ms:.3f} ms (plain "
          f"{plain_ms:.3f}, the model's neck {neck_ms:.3f}, whose bias in the "
          f"GEMM's epilogue rounds once: gap {gap:.2e} of its largest)")
    print(f"[parallel] sp_backbone_apply, world 1, bf16 {list(SP_BATCH)}: "
          f"bit-exact vs the backbone; {sp_ms:.3f} ms (backbone {bb_ms:.3f})")
    SUMMARY.append(f"tp world 1 {tp_ms:.3f} ms (plain {plain_ms:.3f}); sp "
                   f"world 1 {sp_ms:.3f} ms (backbone {bb_ms:.3f})")


# the main config's training variants at full width: (label, config
# overrides, evaluate the checkpoint with the device-resize TTA)
VARIANTS = [
    ("concrete", ["DB.METHOD", "concrete"], False),
    ("mist_p0.15", ["SOLVER.CONTRA", "False",
                    "MODEL.ROI_WEAK_HEAD.OICR_P", "0.15"], False),
    ("cam", ["MODEL.FASTER_RCNN", "True", "SOLVER.CONTRA", "False",
             "DB.METHOD", "none"], False),
    ("oicr", ["MODEL.ROI_WEAK_HEAD.PREDICTOR", "OICRPredictor",
              "MODEL.ROI_WEAK_HEAD.REGRESS_ON", "False",
              "SOLVER.CONTRA", "False"], True),
    ("wsddn", ["MODEL.ROI_WEAK_HEAD.PREDICTOR", "WSDDNPredictor",
               "MODEL.ROI_WEAK_HEAD.REGRESS_ON", "False",
               "SOLVER.CONTRA", "False"], True),
]
VARIANT_STEPS_N = 6


def check_cdb_ascent(out, steps, cfg):
    """The last update of the Concrete DropBlock's parameters, between the
    checkpoints of iterations ``steps - 1`` and ``steps``, against the
    ascent it must be: +DB.WEIGHT * lr_cdb * lr_factor * buf, with the
    momentum buffer ``buf`` (weight decay inside) and the count from the
    final checkpoint's optimizer state, lr_cdb from SOLVER_CDB's schedule.
    Every element within an ulp of the parameter (plus 1e-5 of the
    update); returns (elements whose update exceeds 4 ulps, so that a
    descent would fail them, all elements, largest |update|)."""
    import torch
    from odwscl_tpu_torch.solver import warmup_multistep_schedule

    def load(name):
        return torch.load(os.path.join(out, name), map_location="cpu",
                          weights_only=True)

    prev, last = load(f"model_{steps - 1:07d}.pt"), load("model_final.pt")
    opt = last["optimizer"]
    groups = [g for g in opt["param_groups"] if g["schedule"] == 1]
    names = [k for k in last["model"] if k.startswith("cdb.")]
    split = ([n for n in names if n.rsplit(".", 1)[1] not in ("scale",
                                                             "bias")],
             [n for n in names if n.rsplit(".", 1)[1] in ("scale", "bias")])
    sc = cfg.SOLVER_CDB
    lr = warmup_multistep_schedule(sc.BASE_LR, sc.STEPS, sc.GAMMA,
                                   sc.WARMUP_FACTOR, sc.WARMUP_ITERS,
                                   sc.WARMUP_METHOD)(groups[0]["count"])
    visible = total = 0
    largest = 0.0
    for g, gnames in zip(groups, split):
        if len(g["params"]) != len(gnames) or g["count"] != steps:
            raise AssertionError(f"CDB group {gnames}: {len(g['params'])} "
                                 f"params, count {g['count']}")
        if g["scale"] != -cfg.DB.WEIGHT:
            raise AssertionError(f"CDB group scale {g['scale']}")
        for idx, n in zip(g["params"], gnames):
            buf = opt["state"][idx]["momentum_buffer"].double()
            want = cfg.DB.WEIGHT * lr * g["lr_factor"] * buf
            p1 = last["model"][n]
            moved = p1.double() - prev["model"][n].double()
            ulp = torch.from_numpy(np.spacing(np.maximum(
                p1.abs().numpy(), prev["model"][n].abs().numpy()))).double()
            if ((moved - want).abs() > ulp + 1e-5 * want.abs()).any():
                err = (moved - want).abs().max().item()
                raise AssertionError(f"{n}: the last CDB update is not "
                                     f"+DB.WEIGHT * lr * buf (max |diff| "
                                     f"{err:.3e})")
            visible += int((want.abs() > 4 * ulp).sum())
            total += want.numel()
            largest = max(largest, want.abs().max().item())
    if not visible:
        raise AssertionError("no CDB update exceeds 4 ulps: the ascent "
                             "check would pass a descent")
    return visible, total, largest, lr


def phase_variants(rp, tmp, cfg):
    """Train each of ``VARIANTS`` ``VARIANT_STEPS_N`` steps at full width
    (``phase_train``'s checks: finite losses, #1[argmax] and #2 once per
    step), the concrete one with a checkpoint one step before the end so
    that its last CDB update is checked as an ascent; the CAM one with
    each image's proposal count recorded (between 1 and RPN_POST_NMS);
    then evaluate the OICR and WSDDN checkpoints with the device-resize
    TTA (``phase_eval``). Returns {label: {"train": (fwd[argmax], bwd),
    "eval": fwd launches}}."""
    import torch
    from odwscl_tpu_torch.models import detector as tdet

    launches = {}
    steps = VARIANT_STEPS_N
    for label, opts, evaluate in VARIANTS:
        opts = ["MODEL.WEIGHT", "", *opts]
        counts = []
        cam_props = tdet.cam_to_proposals

        def record(*args, **kwargs):
            out = cam_props(*args, **kwargs)
            counts.append(out[1].sum(-1))
            return out

        concrete = label == "concrete"
        tdet.cam_to_proposals = record
        try:
            train, ckpt = phase_train(rp, tmp, CONFIG, steps, "VGG16 " + label,
                                      opts, steps - 1 if concrete else None)
        finally:
            tdet.cam_to_proposals = cam_props
        launches[label] = {"train": train}
        if concrete:
            visible, total, largest, lr = check_cdb_ascent(
                os.path.dirname(ckpt), steps, cfg)
            print(f"[train] VGG16 concrete: the last CDB update equals "
                  f"+DB.WEIGHT {cfg.DB.WEIGHT} * lr_cdb {lr:.4e} * "
                  f"lr_factor * buf on all {total} elements (within an ulp);"
                  f" {visible} move by more than 4 ulps, largest "
                  f"{largest:.3e}, so a descent would have failed them")
            SUMMARY.append(f"CDB ascent: {visible}/{total} elements past "
                           "4 ulps")
        if label == "cam":
            n = torch.stack(counts).cpu()
            if len(counts) != steps or n.min() < 1 or n.max() > \
                    cfg.TPU.RPN_POST_NMS:
                raise AssertionError(f"CAM proposals per image out of [1, "
                                     f"{cfg.TPU.RPN_POST_NMS}]: {n.tolist()}")
            print(f"[train] VGG16 cam: CAM proposals per image over "
                  f"{steps} steps x {n.shape[1]} images: min {int(n.min())},"
                  f" median {int(n.median())}, max {int(n.max())} (cap "
                  f"{cfg.TPU.RPN_POST_NMS})")
            SUMMARY.append(f"CAM proposals per image {int(n.min())}-"
                           f"{int(n.max())}")
        if evaluate:
            launches[label]["eval"] = phase_eval(
                rp, tmp, CONFIG, ckpt, "VGG16_" + label, [("det", True)],
                opts)
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    return launches


def phase_resize(tmp, config):
    """The device resize against the host path on the card, at every TTA
    scale of ``config`` on the synthetic test split, through the
    Inferencer's own two paths: ``_device_resize_batches`` from the f32
    normalized originals (``TPU.EVAL_TRANSFER_BF16 False``) against
    ``_prep_scale`` (PIL's uint8 resize, then the normalization, then the
    collate). Per image, the valid region within RESIZE_MAX BGR-255 units
    per pixel and RESIZE_MEAN on average; the targets and canvases equal;
    zero beyond each target. Returns (worst pixel, worst image mean)."""
    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.engine.inference import Inferencer, _tta_groups

    cfg = get_default_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(["TPU.EVAL_TRANSFER_BF16", "False"])
    (_, loader), = make_eval_loaders(cfg, tmp)
    inf = Inferencer(torch.nn.Identity(), cfg, "cuda")
    groups = _tta_groups(inf.tta.transforms())
    worst_px = worst_mean = 0.0
    n = 0
    for _, samples, _ in loader:
        for (tr, _), (dev_b, dev_wh) in zip(
                groups, inf._device_resize_batches(groups, samples, None)):
            host_b, host_wh = inf._prep_scale(tr, samples)
            d_img, h_img = dev_b.images, host_b.images
            if d_img.dtype != torch.float32 or not torch.equal(dev_wh,
                                                               host_wh):
                raise AssertionError(f"device resize at {tr.min_size}: "
                                     f"{d_img.dtype}, targets (w, h) "
                                     f"{dev_wh.tolist()} vs host "
                                     f"{host_wh.tolist()}")
            if d_img.shape != h_img.shape:
                raise AssertionError(f"device resize at {tr.min_size}: canvas "
                                     f"{list(d_img.shape)} vs host "
                                     f"{list(h_img.shape)}")
            for i, (w, h) in enumerate(host_wh.long().tolist()):
                d = (d_img[i, :h, :w] - h_img[i, :h, :w]).abs()
                worst_px = max(worst_px, d.max().item())
                worst_mean = max(worst_mean, d.mean().item())
                if d_img[i, h:].any() or d_img[i, :, w:].any():
                    raise AssertionError(f"device resize at {tr.min_size}, "
                                         f"image {i}: non-zero padding")
                n += 1
    print(f"[resize] device vs host resize, {n} (image, scale) pairs at "
          f"scales {[tr.min_size for tr, _ in groups]}: max |d| "
          f"{worst_px:.4f} BGR-255 units (bound {RESIZE_MAX}), worst image "
          f"mean {worst_mean:.4f} (bound {RESIZE_MEAN}); padding zero")
    if worst_px > RESIZE_MAX or worst_mean > RESIZE_MEAN:
        raise AssertionError("device resize != host resize beyond the bound")
    return worst_px, worst_mean


def phase_eval(rp, tmp, config, weights, label, runs, opts=(),
               per_forward=1):
    """``test_net`` (14-transform TTA, AVG) with ``config`` on
    ``weights``, once per (task, device resize) of ``runs``. Every forward
    must have gone through the forward kernel without the argmax, and
    nothing else (``per_forward`` launches a forward: 0 under ROIAlign).
    The merged scores of the two resize modes (task det)
    must agree within tests/test_torch_device_resize.py's bound (rtol
    0.05, atol 5e-3), the merged boxes within MERGE_BOX_ATOL_PX. Returns
    the forward kernel's launches."""
    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.engine import inference
    from odwscl_tpu_torch.tools import test_net

    cfg = get_default_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(opts))
    n_batches = math.ceil(16 / cfg.TEST.IMS_PER_BATCH)
    n_tta = 2 * (1 + len(cfg.TEST.BBOX_AUG.SCALES))
    merged = {}
    finalize = inference.Inferencer._finalize

    def capture(self, scores, boxes, mask):
        merged.setdefault(self.device_resize, []).append(
            (scores.float().cpu(), boxes.float().cpu()))
        return finalize(self, scores, boxes, mask)

    rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
    rp.roi_pool_backward.launches = 0
    total = 0
    try:
        for task, device_resize in runs:
            inference.Inferencer._finalize = (capture if task == "det"
                                              else finalize)
            torch.cuda.reset_peak_memory_stats()
            timing = {}
            t0 = time.perf_counter()
            res = test_net.main([
                "--config-file", config, "--data-root", tmp, "--task", task,
                "--device", "cuda", "--weights", weights,
                "OUTPUT_DIR", os.path.join(tmp, f"{label}_{task}_"
                                                f"{device_resize}"),
                "TPU.EVAL_DEVICE_RESIZE", str(device_resize), *opts],
                timing_out=timing)
            wall = time.perf_counter() - t0
            (t,), (r,) = timing.values(), res.values()
            name = ("mAP" if "map" in r else "COCO AP" if "AP" in r
                    else "CorLoc")
            metric = r.get("map", r.get("AP", r.get("mean_corloc")))
            stats = ({k: v for k, v in r.items() if k in COCO_STATS}
                     if "AP" in r else {name: metric})
            if "AP" in r and set(stats) != set(COCO_STATS):
                raise AssertionError(f"{label}: COCO stats {sorted(r)}")
            if not all(math.isfinite(v) for v in stats.values()):
                raise AssertionError(f"{label} {task}: non-finite {stats}")
            if t["n_forwards"] != n_batches * n_tta:
                raise AssertionError(f"{label} {task}: {t['n_forwards']} "
                                     f"forwards, expected {n_batches} x "
                                     f"{n_tta}")
            total += t["n_forwards"]
            mode = "device resize" if device_resize else "host resize"
            extra = (" (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                      stats.items()) + ")"
                     if len(stats) > 1 else "")
            print(f"[eval] {label} {task}, {mode}: {name} {metric:.4f}"
                  f"{extra}; "
                  f"{t['n_images']} images in {t['wall_s']:.2f} s = "
                  f"{t['n_images'] / t['wall_s']:.2f} images/s; "
                  f"{t['n_forwards']} forwards; stage s: load wait "
                  f"{t['load_wait_s']:.2f}, prep_wait_s "
                  f"{t['prep_wait_s']:.2f}, forward+merge "
                  f"{t['forward_s']:.2f}, NMS+top-K+to-host "
                  f"{t['finalize_s']:.2f}, eval {t['eval_s']:.3f}; max memory "
                  f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
                  f"GB; CLI wall {wall:.2f} s")
            SUMMARY.append(f"{label} eval {task} {mode}: "
                           f"{t['n_images'] / t['wall_s']:.2f} images/s, "
                           f"prep_wait_s {t['prep_wait_s']:.2f}")
    finally:
        inference.Inferencer._finalize = finalize
    launches = rp.roi_pool.launches
    if (launches != per_forward * total or rp.roi_pool_argmax.launches
            or rp.roi_pool_backward.launches):
        raise AssertionError(f"{label}: roi_pool kernel launched {launches} "
                             f"times for {total} forwards (argmax "
                             f"{rp.roi_pool_argmax.launches}, backward "
                             f"{rp.roi_pool_backward.launches})")
    print(f"[eval] {label} roi_pool kernel launches {launches} = "
          f"{per_forward} x forwards {total} ({n_tta} per batch); no argmax, "
          "no backward")
    if len(merged) == 2:
        bounds = ((0.05, 5e-3), (1e-4, MERGE_BOX_ATOL_PX))
        worst, excess = [0.0, 0.0], [-math.inf, -math.inf]
        for (hs, hb), (ds, db) in zip(merged[False], merged[True]):
            for i, (h, d) in enumerate(((hs, ds), (hb, db))):
                excess[i] = max(excess[i], ((d - h).abs() - bounds[i][0]
                                            * h.abs()).max().item())
                worst[i] = max(worst[i], (d - h).abs().max().item())
        print(f"[eval] {label} device-resize vs host-resize merged "
              f"detections ({len(merged[True])} batches): max |d score| "
              f"{worst[0]:.3e}, past rtol 0.05 {excess[0]:.3e} (atol 5e-3); "
              f"max |d box| {worst[1]:.3e} px, past rtol 1e-4 "
              f"{excess[1]:.3e} (atol {MERGE_BOX_ATOL_PX})")
        for name, (rtol, atol), ex in zip(("scores", "boxes"), bounds, excess):
            if ex > atol:
                raise AssertionError(f"{label}: device-resize merge != host "
                                     f"merge ({name}: |d| exceeds rtol {rtol} "
                                     f"by {ex:.3e} > atol {atol})")
    torch.cuda.synchronize()
    return launches



# phase 13: the COCO configuration. The 7 stats of the COCO evaluator (the
# JAX package's set: AP over IoU .5:.95, AP50, AP75, AR at 100
# detections, AP by area)
COCO_STATS = ("AP", "AP50", "AP75", "AR", "AP_s", "AP_m", "AP_l")
COCO_STEPS = 6
COCO_VARIANT_STEPS = 5
COCO_TRAIN_PROPS = ("proposal/MCG/coco/MCG-coco14_train.pkl",
                    "proposal/MCG/coco/MCG-coco14_valminusminival.pkl")
TWO_DATASETS = ["DATASETS.TRAIN",
                "('coco_2014_train', 'coco_2014_valminusminival')",
                "PROPOSAL_FILES.TRAIN", str(COCO_TRAIN_PROPS)]
# (label, overrides) of the COCO14 config, 5 steps each
COCO_VARIANTS = [
    ("two datasets", TWO_DATASETS),
    ("CLASS_BATCH", ["SOLVER.CLASS_BATCH", "True"]),
    ("point", ["MODEL.ROI_WEAK_HEAD.PARTIAL_LABELS", "point",
               "MODEL.ROI_WEAK_HEAD.ROI_LOSS_REFINE", "True"]),
    ("scribble", ["MODEL.ROI_WEAK_HEAD.PARTIAL_LABELS", "scribble",
                  "MODEL.ROI_WEAK_HEAD.ROI_LOSS_REFINE", "True"]),
]
# the planted evaluator check: GT boxes shifted by this many pixels
COCO_SHIFT_PX = 8.0


def write_coco_data(tmp):
    """The synthetic ``coco14`` layout under ``tmp``: 32 train, 16 val and
    16 valminusminival images of COCO's 480x640 with 1-3 objects of 40-300
    px among COCO's 80 categories, point and scribble annotations, 2048
    MCG-named proposals each."""
    from odwscl_tpu_torch.data.synthetic import write_synthetic_coco

    t0 = time.perf_counter()
    write_synthetic_coco(tmp, n_train=32, n_val=16, seed=0,
                         img_hw=(480, 640), n_props=2048, layout="coco14",
                         obj_size=(40, 300), prop_size=(20, 400),
                         n_valminusminival=16, partial=True)
    print(f"[data] synthetic COCO (coco14 layout, 80 categories): 32 train "
          f"+ 16 val + 16 valminusminival images 480x640, 2048 proposals "
          f"each, points and scribbles, written in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_coco_planted(tmp):
    """The COCO evaluator on the val split's own GT as predictions (boxes
    in the +1 convention, score 1): AP, AP50, AP75 and AR must be 1.0;
    with the boxes shifted by COCO_SHIFT_PX they must fall below."""
    from odwscl_tpu_torch.data.build import build_dataset
    from odwscl_tpu_torch.evaluation.coco_eval import do_coco_evaluation

    ds = build_dataset("coco_2014_val", None, tmp)
    out = {}
    for shift in (0.0, COCO_SHIFT_PX):
        preds = []
        for i in range(len(ds)):
            boxes, labels, _ = ds.get_groundtruth(i)
            boxes = boxes + np.float32([shift, shift, shift, shift])
            preds.append({"boxes": boxes, "labels": labels,
                          "scores": np.ones(len(labels), np.float32)})
        out[shift] = do_coco_evaluation(ds, preds)
    exact, shifted = out[0.0], out[COCO_SHIFT_PX]
    print(f"[eval] COCO evaluator, planted: the val GT as predictions gives "
          + ", ".join(f"{k} {exact[k]:.4f}" for k in COCO_STATS)
          + f"; shifted {COCO_SHIFT_PX:g} px: "
          + ", ".join(f"{k} {shifted[k]:.4f}" for k in COCO_STATS))
    if any(exact[k] != 1.0 for k in ("AP", "AP50", "AP75", "AR")):
        raise AssertionError(f"COCO evaluator on the GT itself: {exact}")
    if not shifted["AP"] < 1.0:
        raise AssertionError(f"COCO evaluator on shifted GT: {shifted}")
    SUMMARY.append(f"COCO planted AP 1.0 / shifted {shifted['AP']:.4f}")


def phase_coco(rp, tmp):
    """The COCO14 config as shipped (81 classes, bf16, batch 8, scales
    480-1200, MCG proposals; random init): train COCO_STEPS steps with
    the mining counters live, evaluate the checkpoint with the 14
    transforms, device-resized, into COCO AP; the planted evaluator check;
    then COCO_VARIANT_STEPS steps of each of COCO_VARIANTS, after checking
    that CLASS_BATCH over two datasets raises the port's ValueError.
    Returns {label: launches}."""
    from odwscl_tpu_torch.tools import train_net

    launches = {}
    live = ("n_bank", "n_mined", "n_pos0")
    train, ckpt = phase_train(rp, tmp, CONFIG_COCO, COCO_STEPS, "COCO14",
                              ("MODEL.WEIGHT", ""), live=live)
    launches["COCO14"] = {"train": train}
    launches["COCO14"]["eval"] = phase_eval(
        rp, tmp, CONFIG_COCO, ckpt, "COCO14", [("det", True)])
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    phase_coco_planted(tmp)
    try:
        train_net.main(["--config-file", CONFIG_COCO, "--data-root", tmp,
                        "--device", "cuda", "--skip-test", "OUTPUT_DIR",
                        os.path.join(tmp, "coco_refused"), "MODEL.WEIGHT",
                        "", "SOLVER.CLASS_BATCH", "True", *TWO_DATASETS])
    except ValueError as e:
        print(f"[train] COCO14 CLASS_BATCH over two datasets refused: {e}")
    else:
        raise AssertionError("CLASS_BATCH over two datasets trained")
    for label, opts in COCO_VARIANTS:
        train, ckpt = phase_train(
            rp, tmp, CONFIG_COCO, COCO_VARIANT_STEPS, "COCO14 " + label,
            ("MODEL.WEIGHT", "", *opts),
            live=("n_pos0",) if label in ("point", "scribble") else live)
        launches["COCO14 " + label] = {"train": train}
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    return launches

# the neck's int8 GEMMs at 8 images x 2048 rois: (name, K, N)
INT8_DENSE = [("fc6", 25088, 4096), ("fc7", 4096, 4096)]
INT8_DENSE_ROWS = 16384
# the JAX package's own int8 bound on backbone features
# (tests/test_int8_eval.py): 0.25 of the bf16 features' largest magnitude
INT8_FEAT_REL = 0.25


def int8_act_scale(mode, x):
    """The three activation-scale modes: None (dynamic), a calibrated
    scalar (90% of the batch's abs-max: the top codes saturate), the
    per-channel abs-maxes at 90% with channel 0 calibrated dead (0)."""
    if mode == "dynamic":
        return None
    if mode == "scalar":
        return x.abs().amax().float() * 0.9
    amax = x.abs().amax(dim=(0, 1, 2)).float() * 0.9
    amax[0] = 0.0
    return amax


def next_scales(q, y, kind, pow2=True):
    """The next conv's input scales [C] for the fused output of y (NHWC), as
    a calibration on y gives them: per channel from y's channel abs-maxes,
    or y's per-tensor scale broadcast. Those abs-maxes are bf16 values, so
    many quotients of y by their scales are exact half-integer ties before
    the scale's rounding (the epilogue's exact tie decision); with
    ``pow2`` every 4th channel's scale is also rounded to a power of two
    (exact quotients: ties that stay ties)."""
    import torch

    if kind == "scalar":
        return q.per_tensor_scale(y.abs().amax().float()).expand(
            y.shape[-1]).contiguous()
    s = q.channel_scales(y.abs().amax(dim=(0, 1, 2)).float())[0]
    if pow2:
        s[::4] = torch.exp2(torch.round(torch.log2(s[::4])))
    return s


def phase_int8_kernel(dev, q):
    """The int8 conv kernel against its plain versions, bit for bit, on the
    wgmma + TMA main loop: the int32 ``ACC`` output of both wgmma tiles
    against ``conv2d_int8_acc_plain`` (a float64 convolution of the codes,
    exact), the fused dequantize (bf16, and f32 on the awkward shapes)
    against ``dequantize_plain`` of that accumulator, compared as values
    (-0.0 equals 0.0), and the fused next-layer codes against
    ``_quantize(dequantize_plain(acc, ..., relu), s_next)`` (then pooled:
    ``max_pool_nhwc`` before the quantize), per-channel and per-tensor
    ``s_next`` (``next_scales``), pooled and not. Every VGG16 int8 layer
    shape at the 480 scale (B = 8) and awkward sizes (37x53, B = 1 and 2,
    both dilations), each in the three activation-scale modes (quantized on
    the card by ``quantize_conv_input``). Returns the largest absolute
    difference (0)."""
    import torch
    from odwscl_tpu_torch.tools.tune_conv_int8 import (CANVAS, INT8_LAYERS,
                                                       conv_inputs)

    gen = torch.Generator(device=dev).manual_seed(0)
    hc, wc = CANVAS[480]
    cases = [(f"conv{i}@480", 8, hc // s, wc // s, cin, cout, d, i < 12,
              (torch.bfloat16,))
             for i, s, cin, cout, d in INT8_LAYERS]
    cases += [("37x53 B=1", 1, 37, 53, 64, 128, 1, True,
               (torch.bfloat16, torch.float32)),
              ("37x53 B=1 dil 2", 1, 37, 53, 512, 512, 2, False,
               (torch.bfloat16, torch.float32)),
              ("37x53 B=2 dil 2", 2, 37, 53, 128, 256, 2, True,
               (torch.float32,))]
    worst = 0.0
    n = n_codes = 0
    for label, b, h, w, cin, cout, d, relu, dtypes in cases:
        x, wt, bias = conv_inputs(dev, gen, b, h, w, cin, cout)
        for mode in ("dynamic", "scalar", "channel"):
            xq, kq, scale = q.quantize_conv_input(x, wt,
                                                  int8_act_scale(mode, x))
            ref = q.conv2d_int8_acc_plain(xq, kq, d, d)
            for tile in ("wg128x128", "wg256x128"):
                acc = q.conv_int8_acc(xq, kq, d, d, tile)
                torch.cuda.synchronize()
                if not torch.equal(acc, ref):
                    bad = int((acc != ref).sum())
                    raise AssertionError(f"int8 conv {label} {mode} {tile}: "
                                         f"ACC differs from the plain "
                                         f"accumulator at {bad} values")
            for dt in dtypes:
                y = q.conv_int8_nhwc(xq, kq, scale, bias, d, d, dt, relu)
                want = q.dequantize_plain(ref, scale, bias, dt, relu)
                torch.cuda.synchronize()
                diff = (y.float() - want.float()).abs().max().item()
                worst = max(worst, diff)
                if not bool((y == want).all()):
                    raise AssertionError(f"int8 conv {label} {mode} {dt}: "
                                         f"max |d| {diff} against the plain "
                                         "dequantize")
                n += 1
        # the fused next-layer codes, on the channel mode's codes
        for dt in dtypes:
            y = q.dequantize_plain(ref, scale, bias, dt, True)
            for kind in ("channel", "scalar"):
                s_next = next_scales(q, y, kind)
                for pool in (False, True):
                    got = q.conv_int8_nhwc(xq, kq, scale, bias, d, d, dt,
                                           True, out_scale=s_next, pool=pool)
                    want = q._quantize(q.max_pool_nhwc(y) if pool else y,
                                       s_next)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        bad = int((got != want).sum())
                        raise AssertionError(
                            f"int8 conv {label} {dt} codes ({kind}, pool "
                            f"{pool}): {bad} codes differ from the plain "
                            "quantize")
                    n_codes += 1
        del acc, ref, x, xq
    print(f"[int8] conv kernel bit-exact against the plain versions: {n} "
          f"(shape, mode, dtype) cases on the wgmma main loop (ACC on both "
          f"wgmma tiles) and {n_codes} fused next-layer code cases "
          f"(per-channel and per-tensor scales, pooled and not), the 11 "
          f"VGG16 int8 layers at 480 (B=8, {hc}x{wc} canvas) and 37x53 B=1/2 "
          "at dilations 1 and 2; ACC = float64 conv of the codes, fused "
          f"output = plain dequantize (max |d| {worst}), codes = plain "
          "quantize")
    return worst


def phase_quant_kernel(dev, q):
    """The quantize kernel (csrc/quant_int8.cu) against its plain versions
    (``quantize_conv_act``, ``quantize_rows_plain``: the JAX expressions as
    torch ops), bit for bit, codes and scales, in bf16 and f32: the map with
    per-channel scales (some far below the values: codes past +-127
    saturate) and with a calibrated per-tensor scale, the dynamic
    per-tensor mode (abs-max, then the map), each on conv2's input shape at
    the 480 scale with exact half-way ties ((k + 0.5) s at s = 1/16, whose
    abs-max makes the dynamic scale 1/16 too) and on an all-zero tensor;
    and the dynamic per-row mode on fc6's rows (2048 x 25088) with a tie
    row, an all-zero row and a row whose scale takes the 1e-12 floor; then
    the map over every magnitude (f32 subnormals to overflowing quotients,
    scales over 20 decades), which holds the kernels' division-free
    rounding to the true division."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        shape = (8, 256, 320, 64)
        ties = (torch.randint(-127, 127, shape, generator=gen, device=dev)
                + 0.5) / 16
        x = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5,
                        ties, torch.randn(shape, generator=gen, device=dev)
                        * 3).clamp_(-127 / 16, 127 / 16)
        x[0, 0, 0, 0] = 127 / 16
        x = x.to(dt)
        amax = x.abs().amax(dim=(0, 1, 2)).float()
        sa = q.channel_scales(amax * torch.linspace(0.05, 1.0, 64,
                                                    device=dev))[0]
        zero = torch.zeros((2, 16, 16, 64), dtype=dt, device=dev)
        rows = (torch.randn((2048, 25088), generator=gen, device=dev)
                * 2).to(dt)
        rows[1] = x.reshape(-1)[:25088]
        rows[2] = 0
        rows[3] = (rows[3].float() * 1e-13).to(dt)
        checks = [("map per channel", lambda t: q.quantize_act(t, sa),
                   lambda t: q.quantize_conv_act(t, sa), (x,)),
                  ("map per tensor", lambda t: q.quantize_act(
                      t, None, amax.max() * 0.5),
                   lambda t: q.quantize_conv_act(t, None, amax.max() * 0.5),
                   (x,)),
                  ("dynamic per tensor", q.quantize_act, q.quantize_conv_act,
                   (x, zero)),
                  ("dynamic per row", q.quantize_rows, q.quantize_rows_plain,
                   (rows,))]
        for label, kernel, plain, inputs in checks:
            for t in inputs:
                (got, gs), (want, ws) = kernel(t), plain(t)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"quant_int8 {label} {dt} {tuple(t.shape)}: "
                        f"{int((got != want).sum())} codes differ")
                if (gs is None) != (ws is None) or (
                        gs is not None and not torch.equal(gs, ws)):
                    raise AssertionError(f"quant_int8 {label} {dt}: the "
                                         "scales differ")
                n += 1
        if not ((x.float() * 16).frac().abs() == 0.5).sum() > 1000:
            raise AssertionError("quant_int8 check: too few half-way ties")
        del x, ties, rows
    # the division-free rounding over every magnitude: f32 values from
    # subnormals to 2^100 (quotients that overflow), scales from 1e-14 to 1e6
    gen64 = torch.Generator(device=dev).manual_seed(4)
    mag = torch.exp2(torch.rand((4, 64, 64, 64), generator=gen64,
                                device=dev) * 250 - 150)
    x = mag * torch.randn((4, 64, 64, 64), generator=gen64,
                          device=dev).sign()
    sa = torch.exp2(torch.rand((64,), generator=gen64, device=dev) * 66 - 46)
    for t in (x, x * 1e-30, (x * 2.0 ** -100).clamp(-300, 300)):
        got, want = q.quantize_act(t, sa)[0], q.quantize_conv_act(t, sa)[0]
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quant_int8 map over every magnitude: "
                                 f"{int((got != want).sum())} codes differ")
        n += 1
    del x, mag
    torch.cuda.empty_cache()
    print(f"[int8] quantize kernel bit-exact against the plain versions "
          f"(codes and scales): {n} (mode, dtype, input) cases; half-way "
          "ties, saturated codes, an all-zero tensor, all-zero and floored "
          "rows")
    return 0.0


def im2col_int_mm(xq, kq, scale, bias, d, relu):
    """The one PyTorch route to the same int32 result: an int8 im2col (pad,
    the 9 shifted slices concatenated on the channel axis, tap-major as the
    packed weights) and ``torch._int_mm``, then the same dequantize."""
    import torch
    import torch.nn.functional as F
    from odwscl_tpu_torch.ops.quant import dequantize_plain

    b, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, d, d, d, d))
    cols = torch.cat([xp[:, ty * d:ty * d + h, tx * d:tx * d + w]
                      for ty in range(3) for tx in range(3)], dim=-1)
    acc = torch._int_mm(cols.reshape(-1, 9 * c), kq.reshape(kq.shape[0], -1).t())
    return dequantize_plain(acc, scale, bias, torch.bfloat16,
                            relu).reshape(b, h, w, -1)


def _bound(ops, nbytes, ops_rate, mem_rate):
    """(bound ms, what bounds it) of ``ops`` operations and ``nbytes``."""
    t_ops, t_mem = ops / ops_rate, nbytes / mem_rate
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops > t_mem else "bytes")


def phase_int8_timing(dev, q):
    """Rows 5 and 6 at each int8 layer shape of the 1200 scale (B = 8,
    padded 1280x1664), in turns (3 readings of 5). Row 5: the kernel's
    wgmma main loop in the output mode the static path runs (the next
    conv's codes for conv2-conv11, with per-channel scales from the
    output's own range; bf16 for conv12) and in the other mode, each beside
    its bound; the mma.sync main loop (bf16 out); its library route
    (``im2col_int_mm``, checked equal to the kernel); cuDNN's bf16 conv of
    the same shape (channels_last); the plain version (float64) once. Row
    6 at each layer's input: the static map (kernel, plain), the dynamic
    per-tensor quantize (kernel, plain) and PR 8's reading,
    ``quantize_conv_input`` (the dynamic quantize plus the weight codes);
    then the neck's rows (fc6, fc7 at 16,384 rows, kernel and plain) and
    ``torch._int_mm`` beside ``F.linear`` in bf16. Bounds: max(ops / peak,
    bytes / memory rate); for row 5 the int8 operations and the bytes of
    the int8 input and weights and of the output written (int8 codes or
    bf16); for row 6 a division a value (and a comparison for an abs-max)
    at the f32 rate and one read and one write (two reads for the dynamic
    abs-max). Returns (conv layer dicts, conv sums, quantize dicts, dense
    dicts)."""
    import torch
    import torch.nn.functional as F
    from odwscl_tpu_torch.tools.tune_conv_int8 import (CANVAS, INT8_LAYERS,
                                                       conv_inputs)
    from odwscl_tpu_torch.utils.profiling import (F32_OPS_PER_S,
                                                  INT8_OPS_PER_S,
                                                  MEM_BYTES_PER_S, card_rate)

    name = torch.cuda.get_device_name(dev)
    mem_rate = card_rate(name, MEM_BYTES_PER_S)
    rates = (card_rate(name, INT8_OPS_PER_S), mem_rate)
    # the quantize: a division a value (and a comparison a value for an
    # abs-max) on the f32 units, outside the tensor cores
    q_rates = (card_rate(name, F32_OPS_PER_S), mem_rate)
    gen = torch.Generator(device=dev).manual_seed(1)
    hc, wc = CANVAS[1200]
    layers, quant = [], []
    for i, s, cin, cout, d in INT8_LAYERS:
        h, w = hc // s, wc // s
        relu = i < 12
        x, wt, bias = conv_inputs(dev, gen, 8, h, w, cin, cout)
        xq, kq, scale = q.quantize_conv_input(x, wt)
        got = q.conv_int8_nhwc(xq, kq, scale, bias, d, d, torch.bfloat16, relu)
        if not bool((im2col_int_mm(xq, kq, scale, bias, d, relu) == got).all()):
            raise AssertionError(f"conv{i}: im2col + _int_mm != the kernel")
        s_next = next_scales(q, got, "channel", pow2=False)
        sa = q.channel_scales(x.abs().amax(dim=(0, 1, 2)).float())[0]
        del got
        mma = "128x128k128" if cin % 128 == 0 else "256x128"
        xc = x.permute(0, 3, 1, 2)                 # channels_last NCHW view
        wb, bb = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
        fns = {"codes_ms": lambda: q.conv_int8_nhwc(
                   xq, kq, scale, bias, d, d, torch.bfloat16, True,
                   out_scale=s_next),
               "bf16_ms": lambda: q.conv_int8_nhwc(
                   xq, kq, scale, bias, d, d, torch.bfloat16, relu),
               "mma_sync_ms": lambda: q.conv_int8_nhwc(
                   xq, kq, scale, bias, d, d, torch.bfloat16, relu, mma),
               "library_ms": lambda: im2col_int_mm(xq, kq, scale, bias, d,
                                                   relu),
               "cudnn_bf16_ms": lambda: F.conv2d(xc, wb, bb, padding=d,
                                                 dilation=d),
               "q_static_ms": lambda: q.quantize_act(x, sa),
               "q_static_plain_ms": lambda: q.quantize_conv_act(x, sa),
               "q_dynamic_ms": lambda: q.quantize_act(x),
               "q_dynamic_plain_ms": lambda: q.quantize_conv_act(x),
               "q_pr8_ms": lambda: q.quantize_conv_input(x, wt)}
        reads = {k: [] for k in fns}
        for _ in range(3):
            for k, fn in fns.items():
                reads[k].append(cuda_ms(fn, iters=5))
        row = {k: statistics.mean(v) for k, v in reads.items()}
        row["plain_ms"] = cuda_ms(lambda: q.dequantize_plain(
            q.conv2d_int8_acc_plain(xq, kq, d, d), scale, bias,
            torch.bfloat16, relu), iters=1, warmup=1)
        m = 8 * h * w
        ops = 2.0 * m * cout * 9 * cin
        into = xq.numel() + kq.numel()
        row["codes_bound_ms"], row["codes_bound_by"] = _bound(
            ops, into + m * cout, *rates)
        row["bf16_bound_ms"], row["bf16_bound_by"] = _bound(
            ops, into + 2 * m * cout, *rates)
        path = "codes" if i < 12 else "bf16"
        row.update(layer=f"conv{i}", shape=[8, h, w, cin, cout, d], ops=ops,
                   path_mode=path, ms=row[path + "_ms"],
                   bound_ms=row[path + "_bound_ms"],
                   bound_by=row[path + "_bound_by"],
                   tops=ops / row[path + "_ms"] / 1e9)
        layers.append(row)
        n = x.numel()
        quant.append({"at": f"conv{i} input", "shape": list(x.shape),
                      **{k: row.pop(k) for k in list(row)
                         if k.startswith("q_")},
                      "q_static_bound_ms": _bound(n, 3 * n, *q_rates)[0],
                      "q_dynamic_bound_ms": _bound(2 * n, 5 * n,
                                                   *q_rates)[0]})
        print(f"[int8] conv{i} [8,{h},{w},{cin}]->{cout} dil {d}: wgmma "
              f"{path} {row['ms']:.4f} ms ({row['tops']:.1f} TOP/s; "
              f"readings {', '.join(f'{t:.4f}' for t in reads[path + '_ms'])}"
              f"), bound {row['bound_ms']:.4f} ({row['bound_by']}); codes "
              f"{row['codes_ms']:.4f} (bound {row['codes_bound_ms']:.4f}), "
              f"bf16 {row['bf16_ms']:.4f} (bound {row['bf16_bound_ms']:.4f})"
              f"; mma.sync {mma} {row['mma_sync_ms']:.4f}; cuDNN bf16 "
              f"{row['cudnn_bf16_ms']:.4f}; im2col+_int_mm "
              f"{row['library_ms']:.4f}; plain f64 {row['plain_ms']:.3f}")
        qr = quant[-1]
        print(f"[int8] quantize at conv{i}'s input {list(x.shape)}: static "
              f"map {qr['q_static_ms']:.4f} ms (plain "
              f"{qr['q_static_plain_ms']:.4f}, bound "
              f"{qr['q_static_bound_ms']:.4f}), dynamic "
              f"{qr['q_dynamic_ms']:.4f} (plain "
              f"{qr['q_dynamic_plain_ms']:.4f}, bound "
              f"{qr['q_dynamic_bound_ms']:.4f}); PR 8's quantize_conv_input "
              f"{qr['q_pr8_ms']:.4f}")
        del x, xq, xc, fns
        torch.cuda.empty_cache()
    keys = ("ms", "codes_ms", "bf16_ms", "mma_sync_ms", "library_ms",
            "cudnn_bf16_ms", "plain_ms", "bound_ms", "ops")
    total = {k: sum(r[k] for r in layers) for k in keys}
    slower = [r["layer"] for r in layers if r["ms"] > r["cudnn_bf16_ms"]]
    print(f"[int8] the 11 int8 convs of one 1200-scale batch in the static "
          f"path's modes: kernel {total['ms']:.3f} ms "
          f"({total['ops'] / total['ms'] / 1e9:.1f} TOP/s; target 15.0); "
          f"bound {total['bound_ms']:.3f}; all codes {total['codes_ms']:.3f},"
          f" all bf16 {total['bf16_ms']:.3f}; mma.sync "
          f"{total['mma_sync_ms']:.3f}; im2col+_int_mm "
          f"{total['library_ms']:.3f}; cuDNN bf16 "
          f"{total['cudnn_bf16_ms']:.3f}; plain {total['plain_ms']:.1f}; "
          f"slower than cuDNN bf16: {slower or 'none'}")
    SUMMARY.append(f"int8 convs {total['ms']:.3f} ms (cuDNN bf16 "
                   f"{total['cudnn_bf16_ms']:.3f})")

    dense = []
    for label, k, n in INT8_DENSE:
        x = (torch.randn((INT8_DENSE_ROWS, k), generator=gen, device=dev)
             .relu_()).to(torch.bfloat16)
        a, _ = q.quantize_rows(x)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        if not torch.equal(q.int_mm(a[:64], wq.t()),
                           q.int_mm_plain(a[:64], wq.t())):
            raise AssertionError(f"{label}: torch._int_mm != int_mm_plain")
        ab, wb = a.to(torch.bfloat16), wq.to(torch.bfloat16)
        fns = {"int_mm_ms": lambda: torch._int_mm(a, wq.t()),
               "bf16_linear_ms": lambda: F.linear(ab, wb),
               "q_rows_ms": lambda: q.quantize_rows(x),
               "q_rows_plain_ms": lambda: q.quantize_rows_plain(x)}
        reads = {kk: [] for kk in fns}
        for _ in range(3):
            for kk, fn in fns.items():
                reads[kk].append(cuda_ms(fn, iters=5))
        ops = 2.0 * INT8_DENSE_ROWS * k * n
        row = {kk: statistics.mean(v) for kk, v in reads.items()}
        row.update(layer=label, shape=[INT8_DENSE_ROWS, k, n],
                   bound_ms=_bound(ops, a.numel() + wq.numel()
                                   + INT8_DENSE_ROWS * n * 4, *rates)[0],
                   q_rows_bound_ms=_bound(2 * x.numel(), 3 * x.numel(),
                                          *q_rates)[0])
        dense.append(row)
        print(f"[int8] {label} [{INT8_DENSE_ROWS},{k}]x[{k},{n}]: "
              f"torch._int_mm {row['int_mm_ms']:.4f} ms "
              f"({ops / row['int_mm_ms'] / 1e9:.1f} TOP/s), bound "
              f"{row['bound_ms']:.4f}; F.linear bf16 "
              f"{row['bf16_linear_ms']:.4f}; row quantize "
              f"{row['q_rows_ms']:.4f} (plain {row['q_rows_plain_ms']:.4f}, "
              f"bound {row['q_rows_bound_ms']:.4f})")
        del a, wq, ab, wb, x, fns
    torch.cuda.empty_cache()
    static = {k: quant[0]["q_static" + k] + sum(r["q_rows" + k] for r in dense)
              for k in ("_ms", "_plain_ms", "_bound_ms")}
    dynamic = {k: sum(r["q_dynamic" + k] for r in quant)
               + sum(r["q_rows" + k] for r in dense)
               for k in ("_ms", "_plain_ms", "_bound_ms")}
    pr8 = sum(r["q_pr8_ms"] for r in quant)
    print(f"[int8] quantize left in a forward (conv2's input and the neck's "
          f"rows): static {static['_ms']:.4f} ms (target 2.0; plain "
          f"{static['_plain_ms']:.4f}, bound {static['_bound_ms']:.4f}); "
          f"dynamic (the 11 conv inputs and the rows) {dynamic['_ms']:.4f} "
          f"(plain {dynamic['_plain_ms']:.4f}, bound "
          f"{dynamic['_bound_ms']:.4f}); PR 8's quantize_conv_input over the "
          f"11 layers {pr8:.4f}")
    SUMMARY.append(f"int8 quantize static {static['_ms']:.4f} ms, dynamic "
                   f"{dynamic['_ms']:.4f}")
    return layers, total, {"static": static, "dynamic": dynamic, "pr8": pr8,
                           "by_input": quant}, dense


def phase_int8_eval(rp, q, tmp, config, weights):
    """int8 serving of the main path's checkpoint: ``test_net`` det with
    the device-resize TTA, in bf16, then twice with ``TPU.INT8_EVAL``,
    ``INT8_EVAL_CONVS`` and ``INT8_STATIC``, then once dynamic
    (``INT8_STATIC False``). The first static run calibrates
    (``TPU.INT8_CALIB_BATCHES`` x 14 host-path forwards) and writes
    ``int8_scales.npz``; the second starts from a copy of that file,
    calibrates nothing and must give identical predictions. Every int8
    forward launches the conv kernel 11 times and #1 once, and the quantize
    kernel as the layer plan says: static, once for conv2's input and once
    for each of the neck's two row sets; dynamic, twice (abs-max, map) for
    each of the 11 conv inputs and the two row sets. A calibration forward
    launches #1 and the neck's two, and no int8 conv. No plain activation
    quantize (``quantize_conv_act``, ``quantize_rows_plain``) may run on a
    CUDA tensor. The merged detections' gap to bf16 is printed. On one
    1200-scale batch, the fused static backbone must equal the unfused
    chain (``unfused_int8_forward``) bit for bit, and its features stay
    within INT8_FEAT_REL of bf16's largest magnitude. Returns {run: (int8
    conv launches, quantize kernel launches, roi_pool launches)}."""
    import pickle

    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.engine import inference
    from odwscl_tpu_torch.engine.inference import (Inferencer,
                                                   load_int8_scales)
    from odwscl_tpu_torch.models import vgg16
    from odwscl_tpu_torch.tools import test_net

    int8_opts = ["TPU.INT8_EVAL", "True", "TPU.INT8_EVAL_CONVS", "True",
                 "TPU.INT8_STATIC", "True"]
    finalize = inference.Inferencer._finalize
    merged = {}
    stats = {}
    plain_on_cuda = []

    def guard(fn):
        def plain(x, *args, **kwargs):
            if x.is_cuda:
                plain_on_cuda.append(fn.__name__)
            return fn(x, *args, **kwargs)
        return plain

    def run(label, opts, scales=None, quant_per_fwd=0):
        out = os.path.join(tmp, "int8_" + label)
        if scales:
            os.makedirs(out)
            shutil.copy(scales, out)

        def capture(self, scores, boxes, mask):
            merged.setdefault(label, []).append(
                (scores.float().cpu(), boxes.float().cpu()))
            return finalize(self, scores, boxes, mask)

        rp.roi_pool.launches = q.conv_int8_nhwc.launches = 0
        q.quantize_act.launches = q.quantize_rows.launches = 0
        inference.Inferencer._finalize = capture
        timing = {}
        try:
            res = test_net.main([
                "--config-file", config, "--data-root", tmp, "--task", "det",
                "--device", "cuda", "--weights", weights, "OUTPUT_DIR", out,
                "TPU.EVAL_DEVICE_RESIZE", "True", *opts], timing_out=timing)
        finally:
            inference.Inferencer._finalize = finalize
        (t,), (r,) = timing.values(), res.values()
        conv, pool = q.conv_int8_nhwc.launches, rp.roi_pool.launches
        quant = q.quantize_act.launches + q.quantize_rows.launches
        fwd, calib = t["n_forwards"], t["n_calib_forwards"]
        want = ((11 if opts else 0) * fwd,
                quant_per_fwd * fwd + (2 if opts else 0) * calib,
                fwd + calib)
        if (conv, quant, pool) != want:
            raise AssertionError(
                f"int8 eval {label}: int8 conv, quantize and roi_pool "
                f"launches {(conv, quant, pool)} for {fwd} forwards and "
                f"{calib} calibration forwards; the layer plan says {want}")
        if not math.isfinite(r["map"]):
            raise AssertionError(f"int8 eval {label}: mAP {r['map']}")
        with open(os.path.join(out, "inference", "voc_2007_test",
                               "predictions.pkl"), "rb") as f:
            preds = pickle.load(f)   # written by the run above
        stats[label] = dict(t, conv=conv, quant=quant, pool=pool,
                            map=r["map"], out=out, preds=preds)
        print(f"[int8] eval {label}: mAP {r['map']:.4f}; {t['n_images']} "
              f"images in {t['wall_s']:.2f} s = "
              f"{t['n_images'] / t['wall_s']:.2f} images/s; forward+merge "
              f"{t['forward_s']:.2f} s, NMS+top-K {t['finalize_s']:.2f} s, "
              f"calibration {t['calib_s']:.2f} s ({calib} forwards, outside "
              f"the loop); {fwd} forwards: int8 conv launches {conv}, "
              f"quantize {quant}, roi_pool {pool}")
        SUMMARY.append(f"int8 eval {label}: "
                       f"{t['n_images'] / t['wall_s']:.2f} images/s, "
                       f"calibration {t['calib_s']:.2f} s")

    patched = [(mod, name, getattr(mod, name))
               for mod, name in ((q, "quantize_conv_act"),
                                 (q, "quantize_rows_plain"),
                                 (vgg16, "quantize_conv_act"))]
    for mod, name, fn in patched:
        setattr(mod, name, guard(fn))
    try:
        run("bf16", [])
        run("calibrate", int8_opts, quant_per_fwd=3)
        scales = os.path.join(stats["calibrate"]["out"], "int8_scales.npz")
        if not os.path.exists(scales):
            raise AssertionError("the calibrating run wrote no "
                                 "int8_scales.npz")
        run("from_file", int8_opts, scales, quant_per_fwd=3)
        run("dynamic", int8_opts[:4] + ["TPU.INT8_STATIC", "False"],
            quant_per_fwd=2 * 11 + 2)
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    if plain_on_cuda:
        raise AssertionError(f"int8 serving ran a plain activation quantize "
                             f"on CUDA tensors: {sorted(set(plain_on_cuda))}")
    first, second = stats["calibrate"], stats["from_file"]
    if first["n_calib_forwards"] != 2 * 14 or second["n_calib_forwards"]:
        raise AssertionError(f"calibration forwards {first['n_calib_forwards']}"
                             f" then {second['n_calib_forwards']}, expected "
                             "28 then 0")
    for a, b in zip(first["preds"], second["preds"]):
        for key in ("boxes", "scores", "labels"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError("int8 eval from the scales file differs "
                                     f"from the calibrating run ({key})")
    gaps = {}
    for label in ("calibrate", "dynamic"):
        gaps[label] = (
            max((a[0] - b[0]).abs().max().item()
                for a, b in zip(merged["bf16"], merged[label])),
            max((a[1] - b[1]).abs().max().item()
                for a, b in zip(merged["bf16"], merged[label])))
    rate = {k: v["n_images"] / v["wall_s"] for k, v in stats.items()}
    print(f"[int8] the run from int8_scales.npz gave predictions identical "
          f"to the calibrating run; no plain activation quantize ran on the "
          f"card; merged detections vs bf16: static max |d score| "
          f"{gaps['calibrate'][0]:.3e}, max |d box| "
          f"{gaps['calibrate'][1]:.3f} px; dynamic {gaps['dynamic'][0]:.3e}, "
          f"{gaps['dynamic'][1]:.3f} px (printed only: random weights); "
          f"images/s: bf16 {rate['bf16']:.2f}, static "
          f"{rate['calibrate']:.2f} / {rate['from_file']:.2f}, dynamic "
          f"{rate['dynamic']:.2f}")

    # one batch at the largest scale: the fused static backbone against the
    # unfused chain on the same scales, and against bf16
    cfg = get_default_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(int8_opts)
    model = test_net.load_model(cfg, weights)
    inf = Inferencer(model, cfg, "cuda")
    model.backbone.act_amax = {i: a.cuda()
                               for i, a in load_int8_scales(scales).items()}
    (_, loader), = make_eval_loaders(cfg, tmp)
    _, samples, _ = next(iter(loader))
    tr = max(inf.tta.transforms(), key=lambda t: t.min_size)   # 1200
    batch, _ = inf._prep_scale(tr, samples)
    with torch.no_grad():
        f16 = model.backbone(batch.images).float()
        f8 = model.backbone(batch.images, fast_eval=True)
        unfused = vgg16.unfused_int8_forward(model.backbone, batch.images)
        if not torch.equal(f8, unfused):
            bad = int((f8 != unfused).sum())
            raise AssertionError(f"the fused static backbone differs from "
                                 f"the unfused chain at {bad} of "
                                 f"{f8.numel()} features")
        f8 = f8.float()
        model.backbone.int8_static = False
        f8d = model.backbone(batch.images, fast_eval=True).float()
    top = f16.abs().max().item()
    gap, gap_d = ((f8 - f16).abs().max().item() / top,
                  (f8d - f16).abs().max().item() / top)
    print(f"[int8] backbone features of a {tr.min_size}-scale batch "
          f"{list(batch.images.shape)}: fused static == unfused chain, bit "
          f"for bit; int8 static vs bf16 max |d| {gap:.4f} of the largest "
          f"(bound {INT8_FEAT_REL}); dynamic {gap_d:.4f}")
    if not gap < INT8_FEAT_REL:
        raise AssertionError(f"int8 static features off bf16 by {gap:.4f}")
    SUMMARY.append(f"int8 features vs bf16 {gap:.4f} (static), {gap_d:.4f} "
                   "(dynamic)")
    torch.cuda.synchronize()
    return {k: (stats[k]["conv"], stats[k]["quant"], stats[k]["pool"])
            for k in stats}


# phases 14-17: the supervised stack (FPN Mask R-CNN, RetinaNet). The FPN
# pooler's levels (P2-P5) and the canvases of phase 14: the eval canvas of
# an 800x1333 image padded to 800x1344 (P2 200x336 = 67,200 cells, past the
# int16 codes' 65,535: int32 codes) and a training canvas of 640x1088 (P2
# 160x272 = 43,520 cells, int16 codes)
FPN_SCALES = (0.25, 0.125, 0.0625, 0.03125)
FPN_EVAL_HW = (800, 1344)
FPN_TRAIN_HW = (640, 1088)
FPN_ROIS = 1000
SUP_CONFIGS = (("RetinaNet", "coco_retinanet_smoke.yaml"),
               ("Mask R-CNN", "coco_mask_rcnn_smoke.yaml"))
# phase 15: the mask probabilities card vs CPU, the box scores' bound
MASK_PROB_ATOL = 1e-3


def fpn_inputs(rng, hw, b=2, c=256, p=None):
    """A random P2-P5 pyramid of an ``hw`` canvas (C channels) and P rois
    a image of 16-800 px (log-uniform sides; a third on even pixel
    coordinates, whose scaled edges fall on the kernel's half-way
    rounding; the last 16 masked as padding), each level's mask the rois
    that ``assign_levels`` sends there: [(level, feat, rois, mask,
    scale)]."""
    import torch
    from odwscl_tpu_torch.models.fpn import assign_levels

    h, w = hw
    p = p or FPN_ROIS
    wh = np.exp(rng.uniform(np.log(16), np.log(800), (b, p, 2)))
    x1y1 = rng.uniform(size=(b, p, 2)) * np.maximum(np.array([w, h]) - wh, 1)
    rois = np.concatenate([x1y1, np.minimum(x1y1 + wh, [w - 1, h - 1])], -1)
    even = rng.uniform(size=(b, p)) < 1 / 3
    rois[even] = np.round(rois[even] / 2) * 2
    rois = rois.astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[:, -16:] = False
    levels = assign_levels(torch.from_numpy(rois), 2, 5).numpy()
    return [(f"P{k}", rng.randn(b, int(h * s), int(w * s), c).astype(
        np.float32), rois, mask & (levels == k), s)
        for k, s in zip(range(2, 6), FPN_SCALES)]


def phase_fpn_kernels(dev, rp):
    """#1, #1[argmax] and #2 at the FPN shapes (C = 256, B = 2, P = 1000
    rois routed to P2-P5, each call with its level's mask and scale),
    bf16, at R = 7 and at R = ``POOLED_WIDE``: on the eval pyramid of an
    800x1344 canvas #1 bit-exact (atol 0) against ``roi_pool_plain`` at
    each level and #1[argmax] on its P2 (67,200 cells: int32 codes)
    against ``roi_pool_argmax_plain``; on the training pyramid of a
    640x1088 canvas #1[argmax] bit-exact at each level and #2 routing
    exact, within a bf16 ulp of the plain backward from the same codes.
    Each plain version runs once, timed. Then, in turns (3 rounds of 10):
    each eval level's #1 and the four-call pool, each training level's
    #1[argmax], #2 and #2's index_add_ yardstick, at both R, with their
    byte bounds; and plain ROIAlign's eval forward (sampling 0) at each
    eval level at both R. (The f32 checks and the map-rescan oracle of
    these kernels stand in phases 2-3 and 18 at R = 7 and in
    ``phase_pooled_grid`` at every R.) Returns {R: {kernel: {level:
    readings}}}, the worst errors and ROIAlign's {R: {level: ms}}."""
    import torch
    from odwscl_tpu_torch.models.fpn import multilevel_roi_pool
    from odwscl_tpu_torch.ops.roi_align import roi_align
    from odwscl_tpu_torch.utils.profiling import MEM_BYTES_PER_S, card_rate

    name = torch.cuda.get_device_name(dev)
    rate = card_rate(name, MEM_BYTES_PER_S)
    rng = np.random.RandomState(14)
    ev = fpn_inputs(rng, FPN_EVAL_HW)
    tr = fpn_inputs(rng, FPN_TRAIN_HW)
    print(f"[fpn] rois per level (eval, train; B=2, P={FPN_ROIS}, 16 "
          "masked): "
          + ", ".join(f"{lv} {int(m.sum())}, {int(mt.sum())}"
                      for (lv, _, _, m, _), (_, _, _, mt, _) in zip(ev, tr)))

    def on_card(pyr):
        return [(lv, torch.from_numpy(f).to(dev, torch.bfloat16),
                 torch.from_numpy(rr).to(dev), torch.from_numpy(mm).to(dev),
                 s) for lv, f, rr, mm, s in pyr]

    evc, trc = on_card(ev), on_card(tr)
    feats = [f for _, f, _, _, _ in evc]
    boxes = evc[0][2]
    box_mask = torch.from_numpy(ev[0][3] | ev[1][3] | ev[2][3]
                                | ev[3][3]).to(dev)
    del ev, tr
    errs = {"fwd": 0.0, "fwd_argmax": 0.0, "bwd": 0.0}
    fns, plain_ms, bounds, extra = {}, {}, {}, {}
    for res in (7, POOLED_WIDE):
        tag = f"R{res}"
        for lv, f, rr, mm, s in evc:
            want, plain_ms[f"fwd {lv} {tag}"] = timed_call(
                lambda: rp.roi_pool_plain(f, rr, mm, s, res))
            if not torch.equal(rp.roi_pool(f, rr, mm, s, res), want):
                raise AssertionError(f"#1 != plain (fpn eval {lv}, {tag})")
            fns[f"fwd {lv} {tag}"] = (lambda f=f, rr=rr, mm=mm, s=s, res=res:
                                      rp.roi_pool(f, rr, mm, s, res))
            fns[f"align {lv} {tag}"] = (lambda f=f, rr=rr, mm=mm, s=s,
                                        res=res: roi_align(f, rr, mm, s,
                                                           res, 0))
            bounds[f"fwd {lv} {tag}"] = _pooled_bounds(
                rp, name, f, rr, mm, s, res)["fwd"]
        lv, f, rr, mm, s = evc[0]
        want, want_codes = rp.roi_pool_argmax_plain(f, rr, mm, s, res)
        got, codes = rp.roi_pool_argmax(f, rr, mm, s, res, level=lv)
        if codes.dtype != torch.int32 or not torch.equal(got, want) \
                or not torch.equal(codes, want_codes):
            raise AssertionError(f"#1[argmax] at fpn eval {lv} ({tag}, codes "
                                 f"{codes.dtype}) != plain")
        del want, want_codes, got, codes

        def four_call(res=res):
            with torch.no_grad():
                return multilevel_roi_pool(
                    lambda f, b, m, s, lv: rp.RoIPoolFunction.apply(
                        f, b, m, s, lv, res),
                    feats, FPN_SCALES, boxes, box_mask)

        fns[f"fwd 4-call {tag}"] = four_call
        out_bytes = boxes.shape[0] * boxes.shape[1] * res * res * 256 * 2
        four_bytes = sum(bounds[f"fwd P{k} {tag}"][2]
                         for k in range(2, 6)) - 3 * out_bytes
        bounds[f"fwd 4-call {tag}"] = (four_bytes / rate * 1e3, "bytes",
                                       four_bytes)
        plain_ms[f"fwd 4-call {tag}"] = sum(plain_ms[f"fwd P{k} {tag}"]
                                            for k in range(2, 6))
        for lv, f, rr, mm, s in trc:
            hw = tuple(f.shape[1:3])
            (want, want_codes), plain_ms[f"fwd_argmax {lv} {tag}"] = \
                timed_call(lambda: rp.roi_pool_argmax_plain(f, rr, mm, s,
                                                            res))
            got, codes = rp.roi_pool_argmax(f, rr, mm, s, res)
            if not torch.equal(got, want) or not torch.equal(codes,
                                                             want_codes):
                raise AssertionError(f"#1[argmax] != plain (fpn train {lv}, "
                                     f"{tag})")
            del want, want_codes, got
            g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
            want, plain_ms[f"bwd {lv} {tag}"] = timed_call(
                lambda: rp.roi_pool_backward_argmax_plain(
                    codes, rr, mm, g, s, hw, res).float())
            ok, err = _bwd_within(rp.roi_pool_backward(
                codes, rr, mm, g, s, hw, res).float(), want, torch.bfloat16)
            if not ok:
                raise AssertionError(f"#2 != plain (fpn train {lv}, {tag}): "
                                     f"{err}")
            errs["bwd"] = max(errs["bwd"], err)
            cells, vals = argmax_cells(rp, codes, rr, mm, g, hw, s)
            n = f.numel()

            def yardstick(cells=cells, vals=vals, n=n):
                d = torch.zeros(n, dtype=torch.float32, device=dev)
                d.index_add_(0, cells, vals)
                return d.to(torch.bfloat16)

            fns[f"fwd_argmax {lv} {tag}"] = (
                lambda f=f, rr=rr, mm=mm, s=s, res=res:
                rp.roi_pool_argmax(f, rr, mm, s, res))
            fns[f"bwd {lv} {tag}"] = (
                lambda c=codes, rr=rr, mm=mm, g=g, s=s, hw=hw, res=res:
                rp.roi_pool_backward(c, rr, mm, g, s, hw, res))
            fns[f"bwd_library {lv} {tag}"] = yardstick
            b = _pooled_bounds(rp, name, f, rr, mm, s, res, codes, g)
            bounds[f"fwd_argmax {lv} {tag}"] = b["fwd_argmax"]
            bounds[f"bwd {lv} {tag}"] = b["bwd"]
            extra[f"{lv} {tag}"] = int(cells.numel())
        print(f"[fpn] {tag}: #1 bit-exact vs plain at P2-P5 (eval pyramid), "
              "#1[argmax] with int32 codes at eval P2, #1[argmax] bit-exact "
              "and #2 within a bf16 ulp of the plain backward at P2-P5 "
              "(train pyramid)")
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=10))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    for k in bounds:
        kernel, lv, tag = k.split(" ")
        lib = (f"; index_add_ yardstick "
               f"{ms[f'bwd_library {lv} {tag}']:.4f} ms "
               f"({extra[f'{lv} {tag}']} routed)" if kernel == "bwd" else "")
        align = (f"; ROIAlign {ms[f'align {lv} {tag}']:.4f} ms"
                 if f"align {lv} {tag}" in ms else "")
        print(f"[fpn] {k} bf16: {ms[k]:.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in times[k])}), bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]}, "
              f"{bounds[k][2] / 1e9:.4f} GB), plain {plain_ms[k]:.3f} ms"
              f"{lib}{align}")
    for res in (7, POOLED_WIDE):
        SUMMARY.append(f"fpn c256 R={res} ms " + ", ".join(
            f"{k.rsplit(' ', 1)[0]} {ms[k]:.4f}" for k in bounds
            if k.endswith(f" R{res}")))
    out = {res: {"fwd": {}, "fwd_argmax": {}, "bwd": {}}
           for res in (7, POOLED_WIDE)}
    for k in bounds:
        kernel, lv, tag = k.split(" ")
        out[int(tag[1:])][kernel][lv] = {
            "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": ms.get(f"bwd_library {lv} {tag}")
            if kernel == "bwd" else None}
    align = {res: {lv: ms[f"align {lv} R{res}"] for lv, *_ in evc}
             for res in (7, POOLED_WIDE)}
    return out, errs, align


def sup_batch(rng, b=2, h=256, w=384, p=128, g=8, stride=4, scale=1.0,
              keypoints=0):
    """A seeded supervised batch (CPU): images (normals times ``scale``),
    P rois of 16-160 px (the last 12 of the second image masked), G GT
    boxes (near the first rois) with labels 1-80 and their rectangles as
    bitmasks at 1/stride; ``keypoints`` > 0 adds that many GT keypoints an
    instance (drawn after the rest, in and around each box, visibility
    0-2)."""
    import torch
    from odwscl_tpu_torch.models import Batch

    sizes = np.float32([[h, w], [h - 16, w - 32]])
    images = (rng.randn(b, h, w, 3) * scale).astype(np.float32)
    x1y1 = rng.uniform(0, 1, (b, p, 2)) * [w - 40, h - 40]
    wh = rng.uniform(16, 160, (b, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, [w - 1, h - 1])],
                           -1).astype(np.float32)
    box_mask = np.ones((b, p), bool)
    box_mask[1, -12:] = False
    gt = boxes[:, :g] + rng.uniform(-4, 4, (b, g, 4)).astype(np.float32)
    gt = np.clip(gt, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 8)
    bit = np.zeros((b, g, h // stride, w // stride), np.float32)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2 = (gt[i, j] / stride).astype(int)
            bit[i, j, y1:y2 + 1, x1:x2 + 1] = 1.0
    kp = None
    if keypoints:
        kp = np.zeros((b, g, keypoints, 3), np.float32)
        kp[..., :2] = gt[:, :, None, :2] + rng.uniform(
            -0.1, 1.1, (b, g, keypoints, 2)) * (gt[..., 2:]
                                                - gt[..., :2])[:, :, None]
        kp[..., 2] = rng.randint(0, 3, (b, g, keypoints))
        kp = torch.from_numpy(kp)
    return Batch(images=torch.from_numpy(images),
                 image_sizes=torch.from_numpy(sizes),
                 boxes=torch.from_numpy(boxes),
                 box_mask=torch.from_numpy(box_mask),
                 labels=torch.ones(b, 81),
                 gt_boxes=torch.from_numpy(gt),
                 gt_labels=torch.from_numpy(rng.randint(1, 81, (b, g))),
                 gt_mask=torch.ones(b, g, dtype=torch.bool),
                 gt_bitmasks=torch.from_numpy(bit), gt_keypoints=kp)


def _rel_gap(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()


def phase_supervised_card_vs_cpu(dev, rp):
    """Card against CPU, f32 with TF32 off, at the published widths: R-50-
    FPN Mask R-CNN (81 classes, MLP 1024, mask convs 4x256) and R-50
    RetinaNet (81 classes), seeded weights, a 256x384 canvas, P = 128
    rois an image (512 took the CPU 77 s) and 8 GT instances with
    bitmasks. The images are unit normals: with frozen norms at identity
    and zero biases the random network is homogeneous, so BGR-255-sized
    inputs put every head at O(100) (box deltas past the clip, decoded
    boxes past the image, saturated probabilities whose bounds would read
    100 times the f32 drift); at unit scale the heads are O(1). Eval:
    scores within SCORE_ATOL,
    boxes within BOX_ATOL_PX, mask probabilities within MASK_PROB_ATOL;
    RetinaNet's dense logits and deltas within 1e-3 of their largest and
    its valid count equal. One train step each with the same sampler
    draws: the Fast R-CNN matches, labels and sampled rois and the anchor
    labels equal; losses within TRAIN_LOSS_RTOL, the gradients of every
    trainable tensor outside the ResNet body within TRAIN_GRAD_REL of its
    largest (a body ReLU within the drift of 0 may flip, phase 6)."""
    import torch
    from odwscl_tpu_torch.losses.fast_rcnn import prepare_fast_rcnn_targets
    from odwscl_tpu_torch.models import RetinaNetDetector, SupervisedRCNN
    from odwscl_tpu_torch.models.retinanet import retinanet_targets

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(15)
    batch = sup_batch(rng)
    b, p = batch.boxes.shape[:2]
    uniform = torch.from_numpy(rng.uniform(size=(b, 2, p)).astype(
        np.float32))
    gaps = {}
    try:
        for label, model in (
                ("Mask R-CNN", SupervisedRCNN(
                    81, "R-50-FPN", mask_on=True, mlp_dim=1024,
                    compute_dtype="float32")),
                ("RetinaNet", RetinaNetDetector(81, "R-50",
                                                compute_dtype="float32"))):
            model.reset_parameters(torch.Generator().manual_seed(0))
            res = {}
            for device in ("cpu", dev):
                model.to(device).zero_grad(set_to_none=True)
                bt = batch.to(device)
                t0 = time.perf_counter()
                r = {}
                if label == "Mask R-CNN":
                    out = model.eval_forward(bt)
                    r["scores"], r["boxes"] = out["scores"], out["boxes"]
                    det = bt.boxes[:, :100].contiguous()
                    k = det.shape[1]
                    lab = bt.gt_labels.repeat(1, k)[:, :k]
                    r["masks"] = model.predict_masks(bt, det, lab,
                                                     out["features"])
                    tgt = prepare_fast_rcnn_targets(
                        bt.boxes, bt.box_mask, bt.gt_boxes, bt.gt_labels,
                        bt.gt_mask, uniform=uniform.to(device))
                    for k in ("labels", "pos_mask", "neg_mask", "matched"):
                        r[k] = getattr(tgt, k)
                    draws = {"fast_rcnn": uniform.to(device)}
                else:
                    out = model.eval_forward(bt)
                    r["valid"] = out["valid"].sum()
                    with torch.no_grad():
                        anchors, r["logits"], r["deltas"] = model.dense(
                            model.backbone(bt.images))
                    r["anchor_labels"] = retinanet_targets(
                        anchors, bt.gt_boxes, bt.gt_labels, bt.gt_mask)[0]
                    draws = None
                losses, _ = model.train_forward(bt, draws=draws)
                sum(losses.values()).backward()
                r.update({"loss " + k: v.detach() for k, v in
                          losses.items()})
                r.update({"grad " + n: q.grad for n, q in
                          model.named_parameters()
                          if q.requires_grad and q.grad is not None
                          and not n.startswith("backbone.body.")})
                if device != "cpu":
                    torch.cuda.synchronize()
                r = {k: v.detach().float().cpu() if v.is_floating_point()
                     else v.cpu() for k, v in r.items()}
                res[str(device)] = (r, time.perf_counter() - t0)
            (c, t_cpu), (g, t_gpu) = res["cpu"], res[str(dev)]
            exact = [k for k in c if k in ("labels", "pos_mask", "neg_mask",
                                           "matched", "anchor_labels",
                                           "valid")]
            for k in exact:
                if not torch.equal(c[k], g[k]):
                    raise AssertionError(f"{label}: {k} differ card vs CPU")
            loss_gap = max(abs(float(g[k]) - float(c[k]))
                           / max(abs(float(c[k])), 1e-12)
                           for k in c if k.startswith("loss "))
            grad_keys = [k for k in c if k.startswith("grad ")]
            grad_gap, worst = max((_rel_gap(g[k], c[k]), k[5:])
                                  for k in grad_keys)
            bounds = {"scores": SCORE_ATOL, "boxes": BOX_ATOL_PX,
                      "masks": MASK_PROB_ATOL}
            evals = {k: (g[k] - c[k]).abs().max().item() for k in bounds
                     if k in c}
            dense = {k: _rel_gap(g[k], c[k]) for k in ("logits", "deltas")
                     if k in c}
            print(f"[sup] {label} f32 card vs CPU, B={b} "
                  f"{bt.images.shape[1]}x{bt.images.shape[2]} P={p}: "
                  f"{', '.join(exact)} equal"
                  + (f" ({int(c['pos_mask'].sum())} fg, "
                     f"{int(c['neg_mask'].sum())} bg sampled)"
                     if "pos_mask" in c else
                     f" ({int((c['anchor_labels'] > 0).sum())} positive "
                     f"anchors, {int(c['valid'])} valid detections)")
                  + "; eval max |d| " + ", ".join(
                      f"{k} {v:.3e}" for k, v in {**evals, **dense}.items())
                  + f"; losses {sorted(k[5:] for k in c if k[:5] == 'loss ')}"
                  f" max rel diff {loss_gap:.3e} (tol {TRAIN_LOSS_RTOL}); "
                  f"max grad diff {grad_gap:.3e} of the largest ({worst};"
                  f" tol {TRAIN_GRAD_REL}, {len(grad_keys)} tensors); CPU "
                  f"{t_cpu:.2f} s, card {t_gpu:.2f} s")
            if any(v > bounds[k] for k, v in evals.items()) or any(
                    v > 1e-3 for v in dense.values()):
                raise AssertionError(f"{label}: eval card vs CPU {evals} "
                                     f"{dense}")
            if loss_gap > TRAIN_LOSS_RTOL or grad_gap > TRAIN_GRAD_REL:
                raise AssertionError(f"{label}: train step card vs CPU "
                                     "disagree")
            gaps[label] = loss_gap
            model.to("cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return gaps


def phase_supervised_cli(rp, tmp):
    """Both shipped supervised configs as shipped (only the paths on the
    command line) on a synthetic ``coco17`` layout with polygon and RLE
    masks: ``train_net`` (SOLVER.MAX_ITER 5, the configs' own) and
    ``test_net`` on the checkpoint it writes. Every loss finite; bbox AP
    (and segm AP) in [0, 1]. Each Mask R-CNN training step launches
    #1[argmax] 4 times and #2 4 times, and #1 never; each eval batch #1 8
    times (4 for the boxes, 4 for the mask pass) and nothing else;
    RetinaNet launches none. Returns {path: (fwd, fwd[argmax], bwd)}."""
    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
    from odwscl_tpu_torch.tools import test_net, train_net

    root = os.path.join(tmp, "coco17")
    t0 = time.perf_counter()
    write_synthetic_coco(root, n_train=16, n_val=8, seed=3, img_hw=(240, 320),
                         n_props=128, layout="coco17")
    print(f"[data] synthetic COCO (coco17 layout, 6 categories, polygon and "
          f"RLE masks): 16 train + 8 val images 240x320, 128 proposals each,"
          f" written in {time.perf_counter() - t0:.2f} s")

    def counts():
        return (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                rp.roi_pool_backward.launches)

    def reset():
        rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
        rp.roi_pool_backward.launches = 0

    launches = {}
    for label, name in SUP_CONFIGS:
        config = os.path.join(ROOT, "configs", "coco", name)
        cfg = get_default_cfg()
        cfg.merge_from_file(config)
        out = os.path.join(tmp, "sup_" + name[:-5])
        steps = cfg.SOLVER.MAX_ITER
        per_level = 4 if cfg.MODEL.MASK_ON else 0
        reset()
        timing = {}
        t0 = time.perf_counter()
        train_net.main(["--config-file", config, "--data-root", root,
                        "--device", "cuda", "--skip-test", "OUTPUT_DIR", out],
                       timing_out=timing)
        wall = time.perf_counter() - t0
        train = counts()
        steps_log = timing["train"]["steps"]
        if len(steps_log) != steps:
            raise AssertionError(f"{label}: {len(steps_log)} steps")
        for st in steps_log:
            bad = [k for k, v in st.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{label} iteration {st['iter']}: "
                                     f"non-finite {bad}")
        if train != (0, per_level * steps, per_level * steps):
            raise AssertionError(f"{label} train: kernel launches (fwd, "
                                 f"fwd[argmax], bwd) {train} for {steps} "
                                 "steps")
        loss_keys = [k for k in steps_log[0] if k.startswith("loss")]
        print(f"[sup] {label} train ({name}, as shipped): {steps} steps, "
              + ", ".join(f"{k} {steps_log[0][k]:.4f} -> "
                          f"{steps_log[-1][k]:.4f}" for k in loss_keys)
              + f"; median step {statistics.median(st['step_s'] for st in steps_log) * 1e3:.1f} ms;"
              f" kernel launches (fwd, fwd[argmax], bwd) {train}; CLI wall "
              f"{wall:.2f} s")
        reset()
        timing = {}
        res = test_net.main(["--config-file", config, "--data-root", root,
                             "--device", "cuda", "--weights",
                             os.path.join(out, "model_final.pt"),
                             "OUTPUT_DIR", out + "_eval"], timing_out=timing)
        evals = counts()
        (t,), (r,) = timing.values(), res.values()
        n_batches = math.ceil(t["n_images"] / cfg.TEST.IMS_PER_BATCH)
        if evals != (2 * per_level * n_batches, 0, 0):
            raise AssertionError(f"{label} eval: kernel launches {evals} for "
                                 f"{n_batches} batches")
        keys = ("AP", "segm_AP") if cfg.MODEL.MASK_ON else ("AP",)
        if not all(0.0 <= r[k] <= 1.0 for k in keys):
            raise AssertionError(f"{label}: {[(k, r[k]) for k in keys]}")
        print(f"[sup] {label} eval: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items())
            + f"; {t['n_images']} images in {t['wall_s']:.2f} s; kernel "
            f"launches {evals} for {n_batches} batches")
        SUMMARY.append(f"{label} smoke: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in keys))
        launches[label + " train"] = train
        launches[label + " eval"] = evals
    torch.cuda.synchronize()
    return launches


def phase_fullsize_eval(dev, rp, canvas=FPN_EVAL_HW,
                        image_hw=((800, 1333), (800, 1200)),
                        n_props=FPN_ROIS):
    """The eval forward at COCO size, bf16, seeded weights: R-50-FPN Mask
    R-CNN with 1000 proposals an image and R-50 RetinaNet (81 classes
    each) on an 800x1344 batch of 2 (800x1333 and 800x1200 images). Per
    model, 3 timed repeats after a warm-up (CUDA events): ms per image of
    the eval forward, peak memory; the four-level pool alone on the same
    features and its share of the forward; the mask pass on the 100 kept
    detections; the NMS + top-K (RetinaNet: its decode, then the NMS).
    Every Mask R-CNN repeat launches #1 8 times; RetinaNet none. Returns
    the Mask R-CNN's launches."""
    import torch
    from odwscl_tpu_torch.engine.postprocess import finalize_detections_device
    from odwscl_tpu_torch.models import (Batch, RetinaNetDetector,
                                         SupervisedRCNN)
    from odwscl_tpu_torch.models.fpn import multilevel_roi_pool
    from odwscl_tpu_torch.models.retinanet import retinanet_decode
    from odwscl_tpu_torch.models.supervised import FPN_SCALES as SCALES

    rng = np.random.RandomState(17)
    b, (h, w) = 2, canvas
    sizes = np.float32(image_hw)
    images = np.zeros((b, h, w, 3), np.float32)
    for i, (ih, iw) in enumerate(sizes.astype(int)):
        images[i, :ih, :iw] = rng.randn(ih, iw, 3) * 50
    wh = np.exp(rng.uniform(np.log(16), np.log(800), (b, n_props, 2)))
    x1y1 = rng.uniform(size=(b, n_props, 2)) * np.maximum(
        sizes[:, None, ::-1] - wh, 1)
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh,
                                             sizes[:, None, ::-1] - 1)], -1)
    batch = Batch(images=torch.from_numpy(images).to(dev),
                  image_sizes=torch.from_numpy(sizes).to(dev),
                  boxes=torch.from_numpy(boxes.astype(np.float32)).to(dev),
                  box_mask=torch.ones(b, n_props, dtype=torch.bool,
                                      device=dev))

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    rows = {}
    for label, model in (
            ("Mask R-CNN", SupervisedRCNN(81, "R-50-FPN", mask_on=True,
                                          mlp_dim=1024,
                                          compute_dtype="bfloat16")),
            ("RetinaNet", RetinaNetDetector(81, "R-50",
                                            compute_dtype="bfloat16"))):
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).eval()

        def run():
            if label == "RetinaNet":
                (anchors, logits, deltas), t_dense = timed(
                    lambda: model.dense(model.backbone(batch.images)))
                dec, t_dec = timed(lambda: retinanet_decode(
                    anchors, logits, deltas, batch.image_sizes.flip(-1),
                    model.score_thresh, model.pre_nms_top_n))
                boxes_k, scores_k, labels_k, valid_k = dec
                sc = torch.zeros(b, scores_k.shape[1], 81, device=dev)
                sc.scatter_(2, labels_k[..., None],
                            torch.where(valid_k, scores_k, 0.0)[..., None])
                _, t_nms = timed(lambda: finalize_detections_device(
                    boxes_k, sc, valid_k, 0.4, 0.05, 100))
                return {"forward": t_dense + t_dec, "decode": t_dec,
                        "nms": t_nms}
            out, t_fwd = timed(lambda: model.eval_forward(batch))
            feats = out["features"]
            before = rp.roi_pool.launches
            _, t_pool = timed(lambda: multilevel_roi_pool(
                model.pool, feats[:4], SCALES, batch.boxes, batch.box_mask))
            # the pool timed alone is a measurement, not the path
            rp.roi_pool.launches = before
            b_, p_ = out["scores"].shape[:2]
            dets, t_nms = timed(lambda: finalize_detections_device(
                out["boxes"].reshape(b_, p_, -1, 4), out["scores"],
                batch.box_mask, 0.5, 0.05, 100))
            _, t_masks = timed(lambda: model.predict_masks(
                batch, dets[0], dets[2], feats))
            return {"forward": t_fwd, "pool": t_pool, "nms": t_nms,
                    "masks": t_masks}

        with torch.no_grad():
            run()                                          # warm-up
            torch.cuda.reset_peak_memory_stats()
            rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
            rp.roi_pool_backward.launches = 0
            reps = [run() for _ in range(3)]
        launches = (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                    rp.roi_pool_backward.launches)
        # each repeat: the forward's 4 and the mask pass's 4
        want = (8 * 3, 0, 0) if label == "Mask R-CNN" else (0, 0, 0)
        if launches != want:
            raise AssertionError(f"{label} full-size eval: kernel launches "
                                 f"{launches}, expected {want}")
        mean = {k: statistics.mean(r[k] for r in reps) for k in reps[0]}
        peak = torch.cuda.max_memory_allocated() / 1e9
        parts = ", ".join(f"{k} {v:.2f} ms" for k, v in mean.items()
                          if k != "forward")
        share = (f"; the four-level pool {mean['pool'] / mean['forward']:.3f}"
                 " of the forward" if "pool" in mean else "")
        print(f"[full] {label} bf16 eval, B=2 {h}x{w}"
              + (f", {n_props} proposals an image" if "pool" in mean
                 else "")
              + f": forward {mean['forward']:.2f} ms = "
              f"{mean['forward'] / b:.2f} ms per image ({', '.join(f'{r['forward']:.2f}' for r in reps)});"
              f" {parts}{share}; peak memory {peak:.2f} GB")
        SUMMARY.append(f"{label} full-size bf16 eval {mean['forward'] / b:.2f}"
                       f" ms/image, peak {peak:.2f} GB")
        rows[label] = launches
        model.to("cpu")
        del model
        torch.cuda.empty_cache()
    return rows["Mask R-CNN"][0]


# phase 18: the wide (int32) argmax codes. The 256x257 map (65,792 cells)
# is the smallest of the grid's shapes past the int16 codes; 255x257 (65,535
# cells) the largest under them
WIDE_HW = (256, 257)
NARROW_HW = (255, 257)


def wide_grid_inputs(rng, c=64):
    """The size grid of phase 2 on a 256x257 map, plus a roi seven times
    the map (its first bin is the whole map), with a maximum planted in
    the map's last row for a few channels, so that codes past 65,535
    occur."""
    feat, rois, mask = grid_inputs(rng, c, *WIDE_HW)
    h, w = WIDE_HW
    feat[:, h - 1, w - 7, :8] = 10.0
    big = np.float32([0, 0, 7 * w * 8 - 1, 7 * h * 8 - 1])
    rois = np.concatenate([rois, np.broadcast_to(big, (2, 1, 4))], 1)
    mask = np.concatenate([mask, np.ones((2, 1), bool)], 1)
    return feat, rois, mask


def phase_wide_codes(dev, rp):
    """#1[argmax] and #2 with the int32 codes: on the 256x257 grid and on
    P2 of the 800x1344 eval pyramid (200x336, C = 256, B = 2, P = 1000
    rois routed by ``assign_levels``), f32 and bf16: the forward's output
    and codes bit-exact against ``roi_pool_argmax_plain`` (grid; P2 is
    phase 14's), the backward within phase 3's bound of the map-rescan
    plain version, routing exact. The int16 codes stay chosen at 255x257
    and at phase 14's 640x1088 training P2 (160x272). Then, bf16, in turns
    (3 rounds of 10): at the training P2 both instantiations of each
    kernel on the same inputs (the int32 ones called past the shape's
    choice), and at the eval P2 the wide pair and #2's ``index_add_``
    yardstick, each with its byte bound; the plain versions once. Returns
    ({key: readings}, worst errors)."""
    import torch
    from odwscl_tpu_torch.ops.roi_pool_stages import stage_work
    from odwscl_tpu_torch.utils.profiling import MEM_BYTES_PER_S, card_rate

    for hw, want in ((NARROW_HW, torch.int16), (WIDE_HW, torch.int32),
                     ((160, 272), torch.int16), ((200, 336), torch.int32)):
        if rp.code_dtype(*hw) != want:
            raise AssertionError(f"code_dtype{hw} != {want}")
    grid = wide_grid_inputs(np.random.RandomState(18))
    fwd_err = phase_kernel(dev, rp, [("wide 256x257", grid, 0.125)])
    r = torch.from_numpy(grid[1]).to(dev)
    m = torch.from_numpy(grid[2]).to(dev)
    f = torch.from_numpy(grid[0]).to(dev)
    _, codes = rp.roi_pool_argmax(f, r, m, 0.125)
    off = rp.decode_cells(codes)
    past = int(((off != rp.UNSIGNED_NO_CELL[torch.int32])
                & (off > rp.NARROW_MAP_CELLS)).sum())
    if codes.dtype != torch.int32 or not past:
        raise AssertionError(f"256x257: codes {codes.dtype}, {past} past "
                             "65,535")
    print(f"[wide] 256x257: int32 codes, {past} of them past 65,535")
    rng = np.random.RandomState(14)
    ev = fpn_inputs(rng, FPN_EVAL_HW)
    tr = fpn_inputs(rng, FPN_TRAIN_HW)
    lv, f2, r2, m2, s2 = ev[0]
    both = (torch.float32, torch.bfloat16)
    bwd_err = phase_bwd_kernel(dev, rp, [
        ("wide 256x257", grid, both, 0.125),
        (f"wide eval {lv}", (f2, r2, m2), both, s2)])

    name = torch.cuda.get_device_name(dev)
    rate = card_rate(name, MEM_BYTES_PER_S)
    fns, plain, bounds, lib = {}, {}, {}, {}
    for tag, (_, fe, ro, ma, sc) in (("train P2", tr[0]),
                                     ("eval P2", ev[0])):
        fe = torch.from_numpy(fe).to(dev, torch.bfloat16)
        ro, ma = torch.from_numpy(ro).to(dev), torch.from_numpy(ma).to(dev)
        hw = tuple(fe.shape[1:3])
        g = torch.rand((2, FPN_ROIS, 7, 7, 256), device=dev).to(
            torch.bfloat16)
        kinds = ((torch.int16, torch.int32) if tag == "train P2"
                 else (torch.int32,))
        for dt in kinds:
            w = "int32" if dt == torch.int32 else "int16"
            _, cd = rp._launch_fwd(fe, ro, ma, sc, 7, dt)
            fns[f"fwd_argmax {w} {tag}"] = \
                lambda fe=fe, ro=ro, ma=ma, sc=sc, dt=dt: rp._launch_fwd(
                    fe, ro, ma, sc, 7, dt)
            fns[f"bwd {w} {tag}"] = \
                lambda cd=cd, ro=ro, ma=ma, g=g, sc=sc, hw=hw, dt=dt: \
                rp._launch_bwd(cd, ro, ma, g, sc, hw, 7, dt)
            nbytes = (stage_work("roi_pool", fe, ro, ma, sc)[0]
                      + cd.numel() * cd.element_size())
            bounds[f"fwd_argmax {w} {tag}"] = (nbytes / rate * 1e3, "bytes",
                                               nbytes)
            bounds[f"bwd {w} {tag}"] = bwd_bound(fe, ro, ma, g, name, sc)
        if tag == "eval P2":
            plain["fwd_argmax int32 eval P2"] = \
                lambda fe=fe, ro=ro, ma=ma, sc=sc: rp.roi_pool_argmax_plain(
                    fe, ro, ma, sc)
            plain["bwd int32 eval P2"] = \
                lambda cd=cd, ro=ro, ma=ma, g=g, sc=sc, hw=hw: \
                rp.roi_pool_backward_argmax_plain(cd, ro, ma, g, sc, hw)
            cells, vals = argmax_cells(rp, cd, ro, ma, g, hw, sc)

            def yardstick(cells=cells, vals=vals, n=fe.numel()):
                d = torch.zeros(n, dtype=torch.float32, device=dev)
                d.index_add_(0, cells, vals)
                return d.to(torch.bfloat16)

            fns["bwd_library eval P2"] = yardstick
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=10))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    plain_ms = {k: cuda_ms(fn, iters=1, warmup=0) for k, fn in plain.items()}
    for k in bounds:
        extra = (f"; index_add_ yardstick {ms['bwd_library eval P2']:.4f} ms"
                 if k == "bwd int32 eval P2" else "")
        pl = f", plain {plain_ms[k]:.3f} ms" if k in plain_ms else ""
        print(f"[wide] {k} bf16: {ms[k]:.4f} ms ("
              f"{', '.join(f'{t:.4f}' for t in times[k])}), bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]}, "
              f"{bounds[k][2] / 1e9:.4f} GB){pl}{extra}")
    SUMMARY.append("wide codes bf16 ms " + ", ".join(
        f"{k} {ms[k]:.4f}" for k in bounds))
    out = {k: {"ms": ms[k], "bound_ms": bounds[k][0],
               "bound_by": bounds[k][1], "plain_ms": plain_ms.get(k)}
           for k in bounds}
    out["bwd int32 eval P2"]["library_ms"] = ms["bwd_library eval P2"]
    return out, {"fwd_argmax": fwd_err["argmax"], "bwd": bwd_err}


# phases 19-21: Keypoint R-CNN, FBNet, the deformable-conv ops
KP_LOGIT_ATOL = 1e-3       # card vs CPU, of the logits' largest
KP_DECODE_AGREE = 0.9      # share of decoded keypoints on the same cell
DEFORM_REL = 1e-4          # card vs CPU, of each tensor's largest
KP_BIAS_MARGIN = 0.1
KP_LOGIT_MAX = 4.0
KP_STEPS = 5


def active_keypoint_tower(model, batch):
    """Set the keypoint tower's biases so that every pre-activation over
    the batch's pooled rois lies at least KP_BIAS_MARGIN of its channel's
    range above 0 (a float64 pass on the CPU), and scale the deconv so the
    logits peak at KP_LOGIT_MAX: 8 x 512 units over 256 rois cannot keep a
    ReLU margin over the f32 drift, and one unit on the other side of 0
    moves every gradient below it by a permille (tests/test_torch_
    supervised_models.py). With every unit active the gradients read the
    drift alone; the tower's ReLUs are compared in the eval pass."""
    import copy

    import torch
    import torch.nn.functional as F

    m64 = copy.deepcopy(model).to("cpu").double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    head = model.roi_heads.keypoint
    with torch.no_grad():
        bt = batch.to("cpu")
        pooled = m64.pooled(m64.backbone(bt.images.double()), bt.boxes,
                            bt.box_mask)
        x = pooled.reshape(-1, *pooled.shape[2:]).permute(0, 3, 1, 2)
        ext = m64.roi_heads.keypoint.extractor
        for i in range(1, ext.n + 1):
            pre = F.conv2d(x, getattr(ext, f"conv_fcn{i}").weight, padding=1)
            lo, hi = pre.amin(dim=(0, 2, 3)), pre.amax(dim=(0, 2, 3))
            bias = -lo + KP_BIAS_MARGIN * (hi - lo)
            getattr(head.extractor, f"conv_fcn{i}").bias.copy_(bias)
            x = pre + bias[None, :, None, None]
        dec = m64.roi_heads.keypoint.predictor.kps_score_lowres
        logits = F.conv_transpose2d(x, dec.weight, None, stride=2, padding=1)
        head.predictor.kps_score_lowres.weight.mul_(
            KP_LOGIT_MAX / logits.abs().max().item())


def _card_vs_cpu(model, batch, dev, run, grad_skip):
    """``run(model, batch, device)`` -> {name: tensor} on the CPU and on
    the card (the model moved between them), then its gradients (every
    trainable tensor but those whose name starts with one of
    ``grad_skip``): (cpu, card, seconds each)."""
    import torch

    res = {}
    for device in ("cpu", dev):
        model.to(device).zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        r = run(model, batch.to(device), device)
        r.update({"grad " + n: q.grad for n, q in model.named_parameters()
                  if q.requires_grad and q.grad is not None
                  and not n.startswith(grad_skip)})
        if device != "cpu":
            torch.cuda.synchronize()
        res[str(device)] = ({k: v.detach().float().cpu()
                             if v.is_floating_point() else v.cpu()
                             for k, v in r.items()},
                            time.perf_counter() - t0)
    model.to("cpu")
    return res["cpu"], res[str(dev)]


def phase_keypoint_fbnet_card_vs_cpu(dev, rp):
    """Card against CPU, f32 with TF32 off, at the published widths and
    phase 15's bounds: R-50-FPN Keypoint R-CNN (2 classes, 17 keypoints,
    MLP 1024, the 8x512 tower, its ReLUs all active for the train step:
    ``active_keypoint_tower``) and FBNet-default Fast R-CNN (81 classes,
    stride-16 pool), seeded, on a 256x384 canvas with P = 128 rois and 8
    GT instances (with keypoints). Eval: scores within SCORE_ATOL, boxes
    within BOX_ATOL_PX; the keypoint pass on 2 x 100 rois: logits within
    KP_LOGIT_ATOL of their largest, the decode's scores alike and its xy
    equal on at least KP_DECODE_AGREE of the keypoints (the rest tie
    within the drift). One train step with the same sampler draws:
    sampled rois equal, losses within TRAIN_LOSS_RTOL, the gradients of
    every trainable tensor outside the backbone body within TRAIN_GRAD_REL
    of its largest. Then ``deform_conv2d`` v1 and v2 (3x3, 512 -> 512
    channels, 2 deformable groups, offsets up to 6 px off the map) and
    ``deform_psroi_pooling`` (7x7 parts, 8 x 49 channels, 100 rois):
    outputs and gradients within DEFORM_REL of each tensor's largest.
    Returns {label: loss gap}."""
    import torch
    from odwscl_tpu_torch.losses.fast_rcnn import prepare_fast_rcnn_targets
    from odwscl_tpu_torch.models import SupervisedRCNN
    from odwscl_tpu_torch.models.keypoint_head import heatmaps_to_keypoints
    from odwscl_tpu_torch.ops import deform_conv as dc

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(19)
    batch = sup_batch(rng, keypoints=17)
    b, p = batch.boxes.shape[:2]
    uniform = torch.from_numpy(rng.uniform(size=(b, 2, p)).astype(
        np.float32))
    gaps = {}

    def run(model, bt, device):
        r = {}
        out = model.eval_forward(bt)
        r["scores"], r["boxes"] = out["scores"], out["boxes"]
        if model.keypoint_on:
            det = bt.boxes[:, :100].contiguous()
            hm = model.predict_kp_heatmaps(bt, det, out["features"])
            r["kp_logits"] = hm
            xy, sc = heatmaps_to_keypoints(hm.reshape(-1, *hm.shape[2:]),
                                           det.reshape(-1, 4))
            r["kp_xy"], r["kp_scores"] = (torch.from_numpy(xy),
                                          torch.from_numpy(sc))
        tgt = prepare_fast_rcnn_targets(
            bt.boxes, bt.box_mask, bt.gt_boxes, bt.gt_labels, bt.gt_mask,
            uniform=uniform.to(device))
        r["pos_mask"], r["neg_mask"] = tgt.pos_mask, tgt.neg_mask
        losses, _ = model.train_forward(
            bt, draws={"fast_rcnn": uniform.to(device)})
        sum(losses.values()).backward()
        r.update({"loss " + k: v for k, v in losses.items()})
        return r

    try:
        for label, model in (
                ("Keypoint R-CNN", SupervisedRCNN(
                    2, "R-50-FPN", keypoint_on=True, num_keypoints=17,
                    mlp_dim=1024, compute_dtype="float32")),
                ("FBNet Fast R-CNN", SupervisedRCNN(
                    81, "FBNet-default", pooler_scale=0.0625, mlp_dim=1024,
                    compute_dtype="float32"))):
            model.reset_parameters(torch.Generator().manual_seed(0))
            bt = batch
            if model.keypoint_on:
                # one class, the person
                bt = batch.replace(gt_labels=torch.ones_like(
                    batch.gt_labels))
                active_keypoint_tower(model, bt)
            (c, t_cpu), (g, t_gpu) = _card_vs_cpu(
                model, bt, dev, run,
                ("backbone.body.", "backbone.first.", "backbone.stages."))
            for k in ("pos_mask", "neg_mask"):
                if not torch.equal(c[k], g[k]):
                    raise AssertionError(f"{label}: {k} differ card vs CPU")
            evals = {k: (g[k] - c[k]).abs().max().item()
                     for k in ("scores", "boxes")}
            if evals["scores"] > SCORE_ATOL or evals["boxes"] > BOX_ATOL_PX:
                raise AssertionError(f"{label}: eval card vs CPU {evals}")
            kp = ""
            if "kp_logits" in c:
                lg = _rel_gap(g["kp_logits"], c["kp_logits"])
                sg = ((g["kp_scores"] - c["kp_scores"]).abs().max()
                      / c["kp_logits"].abs().max()).item()
                agree = (g["kp_xy"] == c["kp_xy"]).all(-1).float().mean()
                if lg > KP_LOGIT_ATOL or sg > KP_LOGIT_ATOL \
                        or agree < KP_DECODE_AGREE:
                    raise AssertionError(f"{label}: keypoints card vs CPU: "
                                         f"logits {lg}, scores {sg}, xy "
                                         f"agree {agree}")
                kp = (f"; keypoint logits max |d| {lg:.3e} of the largest, "
                      f"decode scores {sg:.3e}, xy equal on "
                      f"{float(agree):.4f} of {c['kp_xy'].shape[0]}x"
                      f"{c['kp_xy'].shape[1]}")
            loss_gap = max(abs(float(g[k]) - float(c[k]))
                           / max(abs(float(c[k])), 1e-12)
                           for k in c if k.startswith("loss "))
            # the deconv's bias gradient is exactly 0 (a constant per map
            # through the bilinear x2 and a softmax over the map): both
            # sides held under TRAIN_GRAD_REL of the largest gradient
            zero = "grad roi_heads.keypoint.predictor.kps_score_lowres.bias"
            grad_keys = [k for k in c if k.startswith("grad ") and k != zero]
            grad_gap, worst = max((_rel_gap(g[k], c[k]), k[5:])
                                  for k in grad_keys)
            if zero in c:
                top = max(c[k].abs().max().item() for k in grad_keys)
                if max(c[zero].abs().max().item(),
                       g[zero].abs().max().item()) > TRAIN_GRAD_REL * top:
                    raise AssertionError(f"{label}: {zero[5:]} not 0")
            print(f"[kp] {label} f32 card vs CPU, B={b} 256x384 P={p}: "
                  f"sampled rois equal ({int(c['pos_mask'].sum())} fg); "
                  f"scores {evals['scores']:.3e}, boxes "
                  f"{evals['boxes']:.3e}{kp}; losses ("
                  + ", ".join(f"{k[5:]} {float(c[k]):.4f}" for k in c
                              if k.startswith("loss "))
                  + f") max rel diff {loss_gap:.3e};"
                  f" max grad diff {grad_gap:.3e} of the largest ({worst}; "
                  f"{len(grad_keys)} tensors); CPU {t_cpu:.2f} s, card "
                  f"{t_gpu:.2f} s")
            if loss_gap > TRAIN_LOSS_RTOL or grad_gap > TRAIN_GRAD_REL:
                raise AssertionError(f"{label}: train step card vs CPU "
                                     "disagree")
            gaps[label] = loss_gap

        # the deformable-conv ops
        drng = np.random.RandomState(20)
        x = drng.randn(1, 24, 32, 512).astype(np.float32)
        k, dg = 3, 2
        whole = drng.randint(-6, 6, (1, 24, 32, dg * 2 * k * k))
        offset = (whole + drng.uniform(0.05, 0.95, whole.shape)).astype(
            np.float32)
        weight = (drng.randn(k, k, 512, 512) * 0.02).astype(np.float32)
        bias = drng.randn(512).astype(np.float32)
        mask = drng.uniform(size=(1, 24, 32, dg * k * k)).astype(np.float32)
        feat = drng.randn(48, 64, 8 * 49).astype(np.float32)
        rois = np.concatenate([drng.uniform(-40, 200, (100, 2)),
                               drng.uniform(210, 300, (100, 2))],
                              1).astype(np.float32)
        trans = drng.randn(100, 2, 7, 7).astype(np.float32)

        def deform_runs(device):
            out = {}
            for tag, m in (("v1", None), ("v2", mask)):
                ts = [torch.from_numpy(a).to(device).requires_grad_()
                      for a in (x, offset, weight, bias)
                      + ((m,) if m is not None else ())]
                y = dc.deform_conv2d(*ts[:4], ts[4] if len(ts) > 4 else None,
                                     padding=1, deformable_groups=dg)
                (y * y).sum().backward()
                out[f"{tag} out"] = y
                for n, t in zip(("x", "offset", "weight", "bias", "mask"),
                                ts):
                    out[f"{tag} d{n}"] = t.grad
            f = torch.from_numpy(feat).to(device).requires_grad_()
            tr = torch.from_numpy(trans).to(device).requires_grad_()
            y = dc.deform_psroi_pooling(f, torch.from_numpy(rois).to(device),
                                        tr, 7, 8, False, 0.25, 7, 7, 4, 0.1)
            (y * y).sum().backward()
            out.update({"psroi out": y, "psroi dfeat": f.grad,
                        "psroi dtrans": tr.grad})
            if device != "cpu":
                torch.cuda.synchronize()
            return {k: v.detach().cpu() for k, v in out.items()}

        t0 = time.perf_counter()
        c = deform_runs("cpu")
        t1 = time.perf_counter()
        g = deform_runs(dev)
        t2 = time.perf_counter()
        rel = {k: _rel_gap(g[k], c[k]) for k in c}
        worst = max(rel, key=rel.get)
        print(f"[kp] deform_conv2d v1/v2 (1x24x32x512 -> 512, 3x3, 2 "
              "deformable groups) and deform_psroi_pooling (100 rois, 7x7) "
              f"f32 card vs CPU: {len(rel)} outputs and gradients, worst "
              f"{rel[worst]:.3e} of the largest ({worst}; tol {DEFORM_REL});"
              f" CPU {t1 - t0:.2f} s, card {t2 - t1:.2f} s")
        if rel[worst] > DEFORM_REL:
            raise AssertionError(f"deform ops card vs CPU: {rel}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return gaps


def fullsize_train_batch(rng, dev, b=2, canvas=FPN_EVAL_HW,
                         image_hw=((800, 1333), (800, 1200)),
                         n_props=FPN_ROIS, g=16, k=17):
    """A COCO-size batch on the card: unit-normal images on an 800x1344
    canvas, ``n_props`` proposals an image of 16-800 px, G GT boxes (the
    first proposals, jittered) of class 1 with K keypoints each."""
    import torch
    from odwscl_tpu_torch.models import Batch

    h, w = canvas
    sizes = np.float32(image_hw)
    images = np.zeros((b, h, w, 3), np.float32)
    for i, (ih, iw) in enumerate(sizes.astype(int)):
        images[i, :ih, :iw] = rng.randn(ih, iw, 3)
    wh = np.exp(rng.uniform(np.log(16), np.log(800), (b, n_props, 2)))
    lim = sizes[:, None, ::-1] - 1
    x1y1 = rng.uniform(size=(b, n_props, 2)) * np.maximum(lim - wh, 1)
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, lim)], -1)
    gt = np.clip(boxes[:, :g] + rng.uniform(-8, 8, (b, g, 4)), 0,
                 np.concatenate([lim, lim], -1)[:, :, :]).astype(np.float32)
    gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 8)
    kp = np.zeros((b, g, k, 3), np.float32)
    kp[..., :2] = gt[:, :, None, :2] + rng.uniform(0, 1, (b, g, k, 2)) * (
        gt[..., 2:] - gt[..., :2])[:, :, None]
    kp[..., 2] = rng.randint(0, 3, (b, g, k))
    return Batch(images=torch.from_numpy(images).to(dev),
                 image_sizes=torch.from_numpy(sizes).to(dev),
                 boxes=torch.from_numpy(boxes.astype(np.float32)).to(dev),
                 box_mask=torch.ones(b, n_props, dtype=torch.bool,
                                     device=dev),
                 labels=torch.ones(b, 2, device=dev),
                 gt_boxes=torch.from_numpy(gt).to(dev),
                 gt_labels=torch.ones(b, g, dtype=torch.long, device=dev),
                 gt_mask=torch.ones(b, g, dtype=torch.bool, device=dev),
                 gt_keypoints=torch.from_numpy(kp).to(dev))


def _launch_counts(rp):
    return (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
            rp.roi_pool_backward.launches, rp.roi_pool_argmax.launches_wide,
            rp.roi_pool_backward.launches_wide)


def _reset_launches(rp):
    rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
    rp.roi_pool_backward.launches = rp.roi_pool_argmax.launches_wide = 0
    rp.roi_pool_backward.launches_wide = 0


def phase_fullsize_keypoint_fbnet(dev, rp):
    """COCO size, bf16, seeded weights, B = 2 on an 800x1344 canvas with
    1000 proposals an image: R-50-FPN Keypoint R-CNN (2 classes, 17
    keypoints) trains KP_STEPS steps (forward, backward, the port's SGD;
    ``engine.trainer.do_train`` with steps 2-5 traced): step ms, the
    device's idle share, peak memory; each step launches #1[argmax] 4
    times (P2 200x336 with the int32 codes, 1) and #2 4 times (int32 1),
    every loss finite. Then its eval (3 timed repeats after a warm-up):
    the box forward, the NMS, the keypoint pass on the 2 x 100 kept
    detections and the decode, ms each. Then FBNet-default Fast R-CNN (81
    classes): KP_STEPS train steps (1 #1[argmax] and 1 #2 a step) and the
    eval forward. Returns {path: launches}."""
    import torch
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.engine.postprocess import finalize_detections_device
    from odwscl_tpu_torch.engine.trainer import do_train
    from odwscl_tpu_torch.models import SupervisedRCNN
    from odwscl_tpu_torch.models.keypoint_head import heatmaps_to_keypoints
    from odwscl_tpu_torch.solver import make_optimizer

    rng = np.random.RandomState(20)
    batch = fullsize_train_batch(rng, dev)
    b = batch.images.shape[0]
    solver = get_default_cfg().SOLVER
    solver.BASE_LR = 1e-4
    solver.WARMUP_ITERS = 2
    paths = {}

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    for label, model, per_step in (
            ("Keypoint R-CNN", SupervisedRCNN(
                2, "R-50-FPN", keypoint_on=True, num_keypoints=17,
                mlp_dim=1024, compute_dtype="bfloat16"), (4, 4, 1, 1)),
            ("FBNet Fast R-CNN", SupervisedRCNN(
                81, "FBNet-default", pooler_scale=0.0625, mlp_dim=1024,
                compute_dtype="bfloat16"), (1, 1, 0, 0))):
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev)
        bt = batch if model.keypoint_on else batch.replace(
            gt_keypoints=None, labels=torch.ones(b, 81, device=dev))
        optimizer, _ = make_optimizer(solver, model)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timing = {}
        _reset_launches(rp)
        do_train(model, optimizer, [bt] * KP_STEPS, KP_STEPS, dev, gen,
                 log_period=0, timing_out=timing,
                 profile_iters=(2, KP_STEPS))
        launches = _launch_counts(rp)
        want = (0, KP_STEPS * per_step[0], KP_STEPS * per_step[1],
                KP_STEPS * per_step[2], KP_STEPS * per_step[3])
        if launches != want:
            raise AssertionError(f"{label} full-size train: launches (fwd, "
                                 f"fwd[argmax], bwd, fwd[argmax] int32, "
                                 f"bwd int32) {launches}, expected {want}")
        steps = timing["steps"]
        for st in steps:
            bad = [k for k, v in st.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{label} full-size step {st['iter']}:"
                                     f" non-finite {bad}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_ms = [st["step_s"] * 1e3 for st in steps]
        med = statistics.median(step_ms[1:])
        print(f"[full] {label} bf16 train, B=2 800x1344, {FPN_ROIS} "
              f"proposals an image: {KP_STEPS} steps "
              f"({', '.join(f'{t:.1f}' for t in step_ms)} ms), median of "
              f"2-{KP_STEPS} {med:.1f} ms; device idle share "
              f"{timing['device_idle_share']:.4f} over steps 2-{KP_STEPS}; "
              f"peak memory {peak:.2f} GB; losses "
              + ", ".join(f"{k} {steps[0][k]:.4f} -> {steps[-1][k]:.4f}"
                          for k in steps[0] if k.startswith("loss_"))
              + f"; launches (fwd, fwd[argmax], bwd, int32 fwd[argmax], "
              f"int32 bwd) {launches}")
        SUMMARY.append(f"{label} full-size bf16 train step {med:.1f} ms, "
                       f"idle {timing['device_idle_share']:.3f}, peak "
                       f"{peak:.2f} GB")
        paths[f"{label} full-size train"] = launches
        model.eval()
        with torch.no_grad():
            def run():
                out, t_fwd = timed(lambda: model.eval_forward(bt))
                b_, p_ = out["scores"].shape[:2]
                dets, t_nms = timed(lambda: finalize_detections_device(
                    out["boxes"].reshape(b_, p_, -1, 4), out["scores"],
                    bt.box_mask, 0.5, 0.05, 100))
                r = {"forward": t_fwd, "nms": t_nms}
                if model.keypoint_on:
                    hm, r["keypoints"] = timed(
                        lambda: model.predict_kp_heatmaps(bt, dets[0],
                                                          out["features"]))
                    _, r["decode"] = timed(lambda: heatmaps_to_keypoints(
                        hm.reshape(-1, *hm.shape[2:]),
                        dets[0].reshape(-1, 4)))
                return r

            run()                                             # warm-up
            _reset_launches(rp)
            reps = [run() for _ in range(3)]
        launches = _launch_counts(rp)
        want = (3 * (8 if model.keypoint_on else 1), 0, 0, 0, 0)
        if launches != want:
            raise AssertionError(f"{label} full-size eval: launches "
                                 f"{launches}, expected {want}")
        mean = {k: statistics.mean(r[k] for r in reps) for k in reps[0]}
        print(f"[full] {label} bf16 eval, B=2 800x1344: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in mean.items())
            + f"; launches {launches[:3]}")
        SUMMARY.append(f"{label} full-size bf16 eval " + ", ".join(
            f"{k} {v:.2f}" for k, v in mean.items()) + " ms")
        paths[f"{label} full-size eval"] = launches
        model.to("cpu")
        del model, optimizer
        torch.cuda.empty_cache()
    return paths


KP_CLI = (("Keypoint R-CNN", ["MODEL.KEYPOINT_ON", "True"], 4),
          ("FBNet Fast R-CNN", ["MODEL.BACKBONE.CONV_BODY", "FBNet-default",
                                "MODEL.ROI_BOX_HEAD.POOLER_SCALES",
                                "(0.0625,)", "MODEL.MASK_ON", "False"], 1))


def phase_keypoint_fbnet_cli(rp, tmp):
    """configs/coco/coco_mask_rcnn_smoke.yaml on phase 16's synthetic
    ``coco17`` layout (3x3 keypoint grids in its annotations) with
    ``MODEL.KEYPOINT_ON True``, and as an FBNet-default Fast R-CNN
    (``CONV_BODY FBNet-default``, ``POOLER_SCALES (0.0625,)``, ``MASK_ON
    False``): ``train_net`` for its 5 iterations, then ``test_net`` on the
    checkpoint (bbox, and segm with the masks; the JAX package evaluates
    no keypoints). Every loss finite (``loss_kp`` among them), the APs in
    [0, 1]; a Keypoint R-CNN step launches #1[argmax] 4 times and #2 4
    times (box, mask and keypoint heads share the pool), an eval batch #1
    8 times; FBNet 1 of each a step and 1 a batch. Returns {path:
    launches}."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.tools import test_net, train_net

    root = os.path.join(tmp, "coco17")
    config = os.path.join(ROOT, "configs", "coco", "coco_mask_rcnn_smoke.yaml")
    launches = {}
    for label, opts, per in KP_CLI:
        cfg = get_default_cfg()
        cfg.merge_from_file(config)
        cfg.merge_from_list(opts)
        out = os.path.join(tmp, "kp_" + label.split()[0])
        steps = cfg.SOLVER.MAX_ITER
        _reset_launches(rp)
        timing = {}
        t0 = time.perf_counter()
        train_net.main(["--config-file", config, "--data-root", root,
                        "--device", "cuda", "--skip-test", "OUTPUT_DIR", out,
                        *opts], timing_out=timing)
        wall = time.perf_counter() - t0
        train = _launch_counts(rp)[:3]
        steps_log = timing["train"]["steps"]
        if len(steps_log) != steps:
            raise AssertionError(f"{label}: {len(steps_log)} steps")
        for st in steps_log:
            bad = [k for k, v in st.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{label} iteration {st['iter']}: "
                                     f"non-finite {bad}")
        if cfg.MODEL.KEYPOINT_ON and "loss_kp" not in steps_log[0]:
            raise AssertionError(f"{label}: no loss_kp")
        if train != (0, per * steps, per * steps):
            raise AssertionError(f"{label} train: kernel launches {train} "
                                 f"for {steps} steps")
        print(f"[kp] {label} train (coco_mask_rcnn_smoke.yaml "
              f"{' '.join(opts)}): {steps} steps, "
              + ", ".join(f"{k} {steps_log[0][k]:.4f} -> "
                          f"{steps_log[-1][k]:.4f}" for k in steps_log[0]
                          if k.startswith("loss"))
              + f"; kernel launches (fwd, fwd[argmax], bwd) {train}; CLI "
              f"wall {wall:.2f} s")
        _reset_launches(rp)
        timing = {}
        res = test_net.main(["--config-file", config, "--data-root", root,
                             "--device", "cuda", "--weights",
                             os.path.join(out, "model_final.pt"),
                             "OUTPUT_DIR", out + "_eval", *opts],
                            timing_out=timing)
        evals = _launch_counts(rp)[:3]
        (t,), (r,) = timing.values(), res.values()
        n_batches = math.ceil(t["n_images"] / cfg.TEST.IMS_PER_BATCH)
        per_eval = 8 if cfg.MODEL.MASK_ON else per
        if evals != (per_eval * n_batches, 0, 0):
            raise AssertionError(f"{label} eval: kernel launches {evals} "
                                 f"for {n_batches} batches")
        keys = ("AP", "segm_AP") if cfg.MODEL.MASK_ON else ("AP",)
        if not all(0.0 <= r[k] <= 1.0 for k in keys):
            raise AssertionError(f"{label}: {[(k, r[k]) for k in keys]}")
        print(f"[kp] {label} eval: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in keys)
            + f"; {t['n_images']} images in {t['wall_s']:.2f} s; kernel "
            f"launches {evals} for {n_batches} batches")
        SUMMARY.append(f"{label} smoke: " + ", ".join(
            f"{k} {r[k]:.4f}" for k in keys))
        launches[label + " train"] = train
        launches[label + " eval"] = evals
    return launches


# phase 24: the JAX package's Orbax checkpoints (tests/make_orbax_fixture.py
# wrote the fixture: the main config's WSOD detector at narrow widths after
# 3 JAX train steps; expected.npz holds the JAX eval_forward on its inputs)
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_wsod_small")
ORBAX_RESUME_STEPS = 3
# the native decoder's throughput is read over at least this long
ZSTD_TIMED_S = 1.0


def phase_orbax(dev, rp, tmp):
    """Import tests/data/orbax_wsod_small with the native zstd decoder, the
    OCDBT reader and the zarr reader (no orbax, tensorstore or zstd library
    on this machine) and evaluate it on the card in f32 (TF32 off): its
    ``eval_forward`` on the fixture's inputs must match the JAX package's
    (``expected.npz``) within phase 6's card-vs-CPU bounds (SCORE_ATOL,
    BOX_ATOL_PX), through the forward kernel once. Then ``train_net``
    resumes a copy of the fixture as a JAX ``OUTPUT_DIR`` (its
    ``last_checkpoint`` rewritten to the copy's path) on phase 7's data for
    ORBAX_RESUME_STEPS steps: the first logged iteration must be the saved
    step + 1, every step must launch #1[argmax] and #2 once, every loss
    must be finite. Prints the import's wall time, the decoder's output MB/s
    over the fixture's frames (decoded again and again for ZSTD_TIMED_S;
    the decoder's g++ build is timed apart) and the card's name and power
    limit. Returns {path: (fwd, fwd[argmax],
    bwd) launches}."""
    import torch
    import odwscl_tpu_torch.models.vgg16 as tvgg
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.models import Batch, build_model
    from odwscl_tpu_torch.tools import train_net
    from odwscl_tpu_torch.utils import zstd
    from odwscl_tpu_torch.utils.checkpoint import load_model_weights
    from odwscl_tpu_torch.utils.ocdbt import OcdbtStore
    from odwscl_tpu_torch.utils.profiling import card_name_and_limit

    with open(os.path.join(ORBAX_FIXTURE, "fixture.json")) as f:
        fx = json.load(f)
    ckpt = os.path.join(ORBAX_FIXTURE, fx["checkpoint"])
    launches = {}
    wide = tvgg.VGG_CFGS["VGG16-OICR"]
    tvgg.VGG_CFGS["VGG16-OICR"] = fx["VGG16-OICR"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        t0 = time.perf_counter()
        zstd.load()                       # g++, at first use
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state_dict = load_model_weights(ckpt)
        import_s = time.perf_counter() - t0
        store = OcdbtStore(ckpt)
        frames = [store.get(k) for k in store.keys()
                  if not k.endswith(b"/.zarray")]
        reps, n_bytes, t0 = 0, 0, time.perf_counter()
        while time.perf_counter() - t0 < ZSTD_TIMED_S or reps == 0:
            n_bytes += sum(len(zstd.decompress(fr)) for fr in frames)
            reps += 1
        mb_s = n_bytes / 1e6 / (time.perf_counter() - t0)

        cfg = get_default_cfg()
        cfg.merge_from_file(os.path.join(ROOT, fx["config"]))
        cfg.merge_from_list(fx["opts"])
        cfg.freeze()
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        e = np.load(os.path.join(ORBAX_FIXTURE, "expected.npz"))
        batch = Batch(*(torch.from_numpy(e[k]).to(dev) for k in (
            "images", "sizes", "boxes", "mask")),
            torch.zeros(e["images"].shape[0], 21, device=dev))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _reset_launches(rp)
        with torch.no_grad():
            scores, boxes = model.eval_forward(batch)
        torch.cuda.synchronize()
        launches["Orbax import eval"] = _launch_counts(rp)[:3]
        if launches["Orbax import eval"] != (1, 0, 0):
            raise AssertionError(f"Orbax import eval: launches (fwd, "
                                 f"fwd[argmax], bwd) "
                                 f"{launches['Orbax import eval']}, "
                                 "expected (1, 0, 0)")
        d_score = float(np.abs(scores.cpu().numpy() - e["scores"]).max())
        d_box = float(np.abs(boxes.cpu().numpy().reshape(
            e["pred_boxes"].shape) - e["pred_boxes"]).max())
        if not (d_score <= SCORE_ATOL and d_box <= BOX_ATOL_PX):
            raise AssertionError(f"the imported model on the card vs the JAX "
                                 f"eval_forward: max |d score| {d_score:.3e} "
                                 f"(bound {SCORE_ATOL}), max |d box| "
                                 f"{d_box:.3e} px (bound {BOX_ATOL_PX})")
        model.to("cpu")
        del model
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32

        out = os.path.join(tmp, "orbax_run")
        copy = os.path.join(out, fx["checkpoint"])
        shutil.copytree(ckpt, copy)
        with open(os.path.join(out, "last_checkpoint"), "w") as f:
            f.write(os.path.abspath(copy))
        first = fx["step"] + 1
        last = fx["step"] + ORBAX_RESUME_STEPS
        timing = {}
        _reset_launches(rp)
        t0 = time.perf_counter()
        train_net.main(["--config-file", CONFIG, "--data-root", tmp,
                        "--device", "cuda", "--skip-test", "OUTPUT_DIR", out,
                        "SOLVER.MAX_ITER", str(last),
                        "SOLVER.CHECKPOINT_PERIOD", "1000", *fx["opts"]],
                       timing_out=timing)
        wall = time.perf_counter() - t0
        launches["Orbax resume"] = _launch_counts(rp)[:3]
    finally:
        tvgg.VGG_CFGS["VGG16-OICR"] = wide
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    steps = timing["train"]["steps"]
    iters = [st["iter"] for st in steps]
    if iters != list(range(first, last + 1)):
        raise AssertionError(f"resumed iterations {iters}, expected "
                             f"{first}-{last}")
    for st in steps:
        bad = [k for k, v in st.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"resumed iteration {st['iter']}: "
                                 f"non-finite {bad}")
    n = ORBAX_RESUME_STEPS
    if launches["Orbax resume"] != (0, n, n):
        raise AssertionError(f"Orbax resume: launches (fwd, fwd[argmax], bwd)"
                             f" {launches['Orbax resume']} for {n} steps")
    card = card_name_and_limit()
    print(f"[orbax] {card}: the native zstd decoder built in {build_s:.2f} "
          f"s; imported {fx['checkpoint']} "
          f"({len(state_dict)} tensors, {len(frames)} zarr chunks) in "
          f"{import_s:.3f} s; native zstd {mb_s:.1f} MB/s over the "
          f"fixture's frames ({n_bytes / 1e6:.1f} MB decoded in {reps} "
          f"passes); f32 eval_forward on the card vs the JAX package's: max "
          f"|d score| {d_score:.3e}, max |d box| {d_box:.3e} px; launches "
          f"{launches['Orbax import eval']}")
    print(f"[orbax] train_net resumed the JAX OUTPUT_DIR at iteration "
          f"{iters[0]} (saved step {fx['step']}): {n} steps, losses "
          + ", ".join(f"{k} {steps[0][k]:.4f} -> {steps[-1][k]:.4f}"
                      for k in ("loss", "loss_img", "loss_sim")
                      if k in steps[0])
          + f"; launches (fwd, fwd[argmax], bwd) {launches['Orbax resume']};"
          f" CLI wall {wall:.2f} s")
    SUMMARY.append(f"Orbax import {import_s:.3f} s, zstd {mb_s:.1f} MB/s "
                   f"({card}), resumed at {iters[0]}")
    return launches


# phase 25: the pooler configurations. The resolutions held bit for bit on
# the grid, and the one checked and timed at full shapes beside 7
POOLED_GRID = (1, 2, 3, 6, 8, 14, 16)
POOLED_WIDE = 14
POOLER_TRAIN_STEPS = {"ROIAlign": 5, "ROIPool R=14": 3}
MASK_CANVAS_IMAGE = (400, 672)   # resized x2 to the 800x1344 canvas
MASK_STEPS = 5


class PooledLaunches:
    """Records the resolution of every ROIPool kernel launch inside the
    block: the wrappers' ``_launch_fwd`` and ``_launch_bwd`` (which do not
    count launches; ``roi_pool``, ``roi_pool_argmax`` and
    ``roi_pool_backward`` do) wrapped, ``seen[(kernel, R)]`` counted."""

    def __init__(self, rp):
        self.rp, self.seen = rp, {}

    def __enter__(self):
        fwd = self.fwd = self.rp._launch_fwd
        bwd = self.bwd = self.rp._launch_bwd
        seen = self.seen

        def launch_fwd(feat, rois, mask, scale, pooled, argmax):
            key = ("fwd" if argmax is None else "fwd_argmax", pooled)
            seen[key] = seen.get(key, 0) + 1
            return fwd(feat, rois, mask, scale, pooled, argmax)

        def launch_bwd(argmax, rois, mask, grad, scale, hw, pooled, dtype):
            seen[("bwd", pooled)] = seen.get(("bwd", pooled), 0) + 1
            return bwd(argmax, rois, mask, grad, scale, hw, pooled, dtype)

        self.rp._launch_fwd, self.rp._launch_bwd = launch_fwd, launch_bwd
        return seen

    def __exit__(self, *exc):
        self.rp._launch_fwd, self.rp._launch_bwd = self.fwd, self.bwd


def timed_call(fn):
    """(fn's result, its ms on the card's clock, one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _signed_codes(rp, codes):
    """Codes of either width as int64 offsets, -1 for no cell."""
    import torch

    off = rp.decode_cells(codes).long()
    return torch.where(off == rp.UNSIGNED_NO_CELL[codes.dtype], -1, off)


def _bwd_within(got, want, dtype, count=None):
    """Routing exact and the values within phase 3's bound: the f32 sums'
    reordering (``count`` the bins routed to each cell) or a bf16 ulp."""
    import torch

    if not torch.equal(got != 0, want != 0):
        return False, math.inf
    err = (got - want).abs()
    if dtype == torch.float32 and count is not None:
        bound = count * 2.0 ** -23 * want.abs() + 1e-30
    elif dtype == torch.float32:
        bound = 2.0 ** -20 * want.abs() + 1e-30
    else:
        bound = 2.0 ** -7 * want.abs()
    return bool((err <= bound).all()), err.max().item()


def phase_pooled_grid(dev, rp):
    """#1, #1[argmax] with int16 and with int32 codes, and #2 from each,
    at every R of ``POOLED_GRID`` on phase 2's size grid (200x260 map, C =
    64), f32, bf16 and bf16 with ties: the outputs and codes bit-exact
    against ``roi_pool_argmax_plain``, the backward's routing exact and
    its values within phase 3's bound of the map-rescan
    ``roi_pool_backward_plain``. A resolution past the cap raises.
    Returns the worst errors."""
    import torch

    rng = np.random.RandomState(25)
    feat, rois, mask = grid_inputs(rng, 64)
    ties = np.round(feat * 1.5).astype(np.float32)
    r = torch.from_numpy(rois).to(dev)
    m = torch.from_numpy(mask).to(dev)
    hw = feat.shape[1:3]
    worst = {"fwd": 0.0, "fwd_argmax": 0.0, "bwd": 0.0}
    for res in POOLED_GRID:
        routed = 0
        for case, arr, dtype in (("f32", feat, torch.float32),
                                 ("bf16", feat, torch.bfloat16),
                                 ("bf16 ties", ties, torch.bfloat16)):
            f = torch.from_numpy(arr).to(dev, dtype)
            want, want_codes = rp.roi_pool_argmax_plain(f, r, m, 0.125, res)
            got = rp.roi_pool(f, r, m, 0.125, res)
            got16, codes16 = rp.roi_pool_argmax(f, r, m, 0.125, res)
            got32, codes32 = rp._launch_fwd(f, r, m, 0.125, res, torch.int32)
            torch.cuda.synchronize()
            for kind, out in (("fwd", got), ("fwd_argmax", got16),
                              ("fwd_argmax", got32)):
                if not torch.equal(out, want):
                    raise AssertionError(f"roi_pool {kind} kernel != plain at "
                                         f"R={res} ({case})")
            want_off = _signed_codes(rp, want_codes)
            for codes in (codes16, codes32):
                if not torch.equal(_signed_codes(rp, codes), want_off):
                    raise AssertionError(f"roi_pool argmax codes "
                                         f"({codes.dtype}) != plain at "
                                         f"R={res} ({case})")
            g = (torch.rand(r.shape[:2] + (res, res, 64), device=dev)
                 + 0.05).to(dtype)
            oracle = rp.roi_pool_backward_plain(f, r, m, g, 0.125,
                                                res).float()
            count = (rp.roi_pool_backward_plain(
                f, r, m, torch.ones_like(g), 0.125, res).float()
                if dtype == torch.float32 else None)
            for codes in (codes16, codes32):
                dtype_c = codes.dtype
                d = (rp.roi_pool_backward(codes, r, m, g, 0.125, hw, res)
                     if dtype_c == torch.int16 else rp._launch_bwd(
                         codes, r, m, g, 0.125, hw, res, dtype_c)).float()
                ok, err = _bwd_within(d, oracle, dtype, count)
                if not ok:
                    raise AssertionError(f"roi_pool_bwd ({dtype_c} codes) != "
                                         f"the map rescan at R={res} "
                                         f"({case}): max |diff| {err}")
                worst["bwd"] = max(worst["bwd"], err)
            routed = max(routed, int((oracle != 0).sum()))
        print(f"[pooled] R={res} grid feat {list(f.shape)} P={r.shape[1]}, "
              "f32 / bf16 / bf16 ties: #1, #1[argmax] int16 and int32 "
              "bit-exact vs plain (outputs, codes); #2 from both code widths"
              f" routes as the map rescan, within the bound ({routed} cells "
              "routed)")
    for bad in (0, 17):
        try:
            rp.roi_pool(f, r, m, 0.125, bad)
        except ValueError as exc:
            if "from 1 to 16" not in str(exc):
                raise
        else:
            raise AssertionError(f"roi_pool at R={bad} did not raise")
    print("[pooled] R=0 and R=17 raise a ValueError that names the cap of 16")
    return worst


def _pooled_bounds(rp, name, f, r, m, scale, res, codes=None, g=None):
    """{kernel: (bound ms, by, bytes)} at ``res``: #1 by ``stage_bound``,
    #1[argmax] its bytes and the codes', #2 by ``bwd_bound``."""
    from odwscl_tpu_torch.ops.roi_pool_stages import stage_bound, stage_work
    from odwscl_tpu_torch.utils.profiling import MEM_BYTES_PER_S, card_rate

    rate = card_rate(name, MEM_BYTES_PER_S)
    ms_, by, nbytes, _ = stage_bound("roi_pool", f, r, m, scale, name, res)
    out = {"fwd": (ms_, by, nbytes)}
    if codes is not None:
        arg = (stage_work("roi_pool", f, r, m, scale, res)[0]
               + codes.numel() * codes.element_size())
        out["fwd_argmax"] = (arg / rate * 1e3, "bytes", arg)
        out["bwd"] = bwd_bound(f, r, m, g, name, scale, res)
    return out


def phase_pooled_timing(dev, rp):
    """At R = ``POOLED_WIDE`` on the eval shape (feat [8, 104, 168, 512]
    bf16, P = 2048): #1, #1[argmax] and #2 held against their plain
    versions (one call each, timed: outputs and codes bit-exact, #2's
    routing exact and within a bf16 ulp of the plain backward from the same
    codes). Then, bf16, in turns (3 rounds of 10; ROIAlign's training pass
    of 3): #1 at the eval shape, #1[argmax], #2 and #2's index_add_
    yardstick at the training shape (feat [8, 160, 208, 512]), each at R =
    7 and at R = ``POOLED_WIDE``, and plain ROIAlign (sampling 0, the
    adaptive grid): its eval forward at the eval shape at both R, its
    forward and autograd backward at the training shape at R = 7; the plain
    #1[argmax] and #2 at the training shape once (checked too). Returns
    {kernel: readings at R = 14} and the worst errors."""
    import torch
    from odwscl_tpu_torch.ops.roi_align import roi_align

    name = torch.cuda.get_device_name(dev)
    res = POOLED_WIDE
    rng = np.random.RandomState(5)
    fe, re_, me = (torch.from_numpy(a).to(dev) for a in main_path_inputs(rng))
    fe = fe.to(torch.bfloat16)
    ft, rt, mt = (torch.from_numpy(a).to(dev)
                  for a in train_shape_inputs(rng))
    ft = ft.to(torch.bfloat16)
    plain = {}
    want, plain["eval fwd"] = timed_call(
        lambda: rp.roi_pool_plain(fe, re_, me, 0.125, res))
    if not torch.equal(rp.roi_pool(fe, re_, me, 0.125, res), want):
        raise AssertionError(f"#1 != plain at R={res}, eval shape")
    del want
    (want, want_codes), plain["eval fwd_argmax"] = timed_call(
        lambda: rp.roi_pool_argmax_plain(fe, re_, me, 0.125, res))
    got, codes = rp.roi_pool_argmax(fe, re_, me, 0.125, res)
    if not torch.equal(got, want) or not torch.equal(codes, want_codes):
        raise AssertionError(f"#1[argmax] != plain at R={res}, eval shape")
    del got, want, want_codes
    g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
    hw = tuple(fe.shape[1:3])
    want, plain["eval bwd"] = timed_call(
        lambda: rp.roi_pool_backward_argmax_plain(codes, re_, me, g, 0.125,
                                                  hw, res).float())
    ok, err = _bwd_within(rp.roi_pool_backward(codes, re_, me, g, 0.125, hw,
                                               res).float(), want,
                          torch.bfloat16)
    if not ok:
        raise AssertionError(f"#2 != plain at R={res}, eval shape: {err}")
    errs = {"fwd": 0.0, "fwd_argmax": 0.0, "bwd": err}
    del codes, g, want
    print(f"[pooled] R={res} eval shape feat {list(fe.shape)} bf16 P=2048: "
          f"#1, #1[argmax] (int16) bit-exact vs plain, #2 routes as the "
          f"plain backward from the same codes (max |diff| {err:.3e}); plain"
          f" ms: " + ", ".join(f"{k} {v:.1f}" for k, v in plain.items()))
    hwt = tuple(ft.shape[1:3])
    (want, want_codes), plain["train fwd_argmax"] = timed_call(
        lambda: rp.roi_pool_argmax_plain(ft, rt, mt, 0.125, res))
    got, codes = rp.roi_pool_argmax(ft, rt, mt, 0.125, res)
    if not torch.equal(got, want) or not torch.equal(codes, want_codes):
        raise AssertionError(f"#1[argmax] != plain at R={res}, train shape")
    del got, want, want_codes
    g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
    want, plain["train bwd"] = timed_call(
        lambda: rp.roi_pool_backward_argmax_plain(codes, rt, mt, g, 0.125,
                                                  hwt, res).float())
    ok, err = _bwd_within(rp.roi_pool_backward(codes, rt, mt, g, 0.125, hwt,
                                               res).float(), want,
                          torch.bfloat16)
    if not ok:
        raise AssertionError(f"#2 != plain at R={res}, train shape: {err}")
    errs["bwd"] = max(errs["bwd"], err)
    del want, codes, g
    torch.cuda.empty_cache()
    fns, bounds = {}, {}
    for rr in (7, res):
        fns[f"fwd R{rr}"] = lambda rr=rr: rp.roi_pool(fe, re_, me, 0.125, rr)
        _, codes = rp.roi_pool_argmax(ft, rt, mt, 0.125, rr)
        g = torch.rand(codes.shape, device=dev).to(torch.bfloat16)
        # d feat (136M cells) fits int32 indices
        cells, vals = argmax_cells(rp, codes, rt, mt, g, hwt,
                                   index_dtype=torch.int32)
        n = ft.numel()

        def yardstick(cells=cells, vals=vals, n=n):
            d = torch.zeros(n, dtype=torch.float32, device=dev)
            d.index_add_(0, cells, vals)
            return d.to(torch.bfloat16)

        if not torch.equal(rp.roi_pool_backward(codes, rt, mt, g, 0.125, hwt,
                                                rr) != 0,
                           yardstick().reshape(ft.shape) != 0):
            raise AssertionError(f"#2 and its index_add_ yardstick route "
                                 f"differently at R={rr}")
        fns[f"fwd_argmax R{rr}"] = lambda rr=rr: rp.roi_pool_argmax(
            ft, rt, mt, 0.125, rr)
        fns[f"bwd R{rr}"] = lambda c=codes, g=g, rr=rr: rp.roi_pool_backward(
            c, rt, mt, g, 0.125, hwt, rr)
        fns[f"bwd_library R{rr}"] = yardstick
        fns[f"align_eval R{rr}"] = lambda rr=rr: roi_align(
            fe, re_, me, 0.125, rr, 0)
        b_eval = _pooled_bounds(rp, name, fe, re_, me, 0.125, rr)
        b_train = _pooled_bounds(rp, name, ft, rt, mt, 0.125, rr, codes, g)
        bounds.update({f"fwd R{rr}": b_eval["fwd"],
                       f"fwd_argmax R{rr}": b_train["fwd_argmax"],
                       f"bwd R{rr}": b_train["bwd"]})
    fa = ft.detach().requires_grad_()

    def align_train(rr):
        out = roi_align(fa, rt, mt, 0.125, rr, 0)
        out.backward(torch.ones_like(out))

    times = {k: [] for k in fns}
    # at R = 7 only: its autograd keeps [P, R, W, C] per image, 24 GB at
    # R = 7 on this batch, 48 GB at 14
    align_t = {7: []}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, iters=10 if "align" not in k else 3,
                                    warmup=1))
        for rr in align_t:
            align_t[rr].append(cuda_ms(lambda rr=rr: align_train(rr),
                                       iters=3, warmup=1))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    for k in fns:
        b = (f"; bound {bounds[k][0]:.4f} ms ({bounds[k][1]}, "
             f"{bounds[k][2] / 1e9:.4f} GB)" if k in bounds else "")
        shape = "eval" if k.startswith(("fwd R", "align")) else "train"
        print(f"[pooled] {k} bf16 ({shape} shape): {ms[k]:.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in times[k])}){b}")
    for rr, v in align_t.items():
        print(f"[pooled] align_train R{rr} bf16 (train shape, forward and "
              f"backward): {statistics.mean(v):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in v)})")
    SUMMARY.append(f"R={res} ms " + ", ".join(
        f"{k} {ms[k]:.4f}" for k in fns) + ", " + ", ".join(
        f"align_train R{rr} {statistics.mean(v):.4f}"
        for rr, v in align_t.items()))
    out = {"fwd": {"ms": ms[f"fwd R{res}"], "plain_ms": plain["eval fwd"]},
           "fwd_argmax": {"ms": ms[f"fwd_argmax R{res}"],
                          "plain_ms": plain["train fwd_argmax"]},
           "bwd": {"ms": ms[f"bwd R{res}"], "plain_ms": plain["train bwd"],
                   "library_ms": ms[f"bwd_library R{res}"]}}
    for k in out:
        ms_, by, _ = bounds[f"{k} R{res}"]
        out[k].update(bound_ms=ms_, bound_by=by, max_abs_err=errs[k],
                      r7_ms=ms[f"{k} R7"],
                      shape=("eval" if k == "fwd" else "train"))
        out[k].setdefault("library_ms", None)
    torch.cuda.empty_cache()
    align = {"eval_ms": {rr: ms[f"align_eval R{rr}"] for rr in (7, res)},
             "train_ms": {rr: statistics.mean(v)
                          for rr, v in align_t.items()}}
    return out, align


def phase_pooler_paths(dev, rp, tmp):
    """Phase 25's WSOD paths at full width, through the CLIs, on phase 7's
    synthetic VOC: (a) the main config with ``POOLER_METHOD ROIAlign``,
    trained ``POOLER_TRAIN_STEPS`` steps (``phase_train``'s checks) and
    evaluated with the 14-transform device-resize TTA (``phase_eval``);
    no ROIPool kernel may launch; then one f32 train step card against
    CPU (``phase_train_card_vs_cpu``'s bounds); (b) the same config with
    ROIPool at R = 14, trained and evaluated alike: every launch of
    #1[argmax] and #2 (one a step) and of #1 (one a forward) at R = 14.
    Each path's launches are read right after it ran. Returns
    {path: (fwd, fwd[argmax], bwd)} and the card-vs-CPU loss gap."""
    launches = {}
    for label, opts, per in (
            ("ROIAlign", ["MODEL.ROI_BOX_HEAD.POOLER_METHOD", "ROIAlign"], 0),
            ("ROIPool R=14", ["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION",
                              str(POOLED_WIDE)], 1)):
        opts = ["MODEL.WEIGHT", "", *opts]
        steps = POOLER_TRAIN_STEPS[label]
        with PooledLaunches(rp) as seen:
            train, ckpt = phase_train(rp, tmp, CONFIG, steps, "VGG16 " + label,
                                      opts, per_step=per)
        launches[f"VGG16 {label} train"] = (0, *train)
        want = ({} if not per else
                {("fwd_argmax", POOLED_WIDE): steps,
                 ("bwd", POOLED_WIDE): steps})
        if seen != want:
            raise AssertionError(f"{label} training launched {seen}, not "
                                 f"{want}")
        with PooledLaunches(rp) as seen:
            ev = phase_eval(rp, tmp, CONFIG, ckpt, "VGG16_" + label.replace(
                " ", "_").replace("=", ""), [("det", True)], opts,
                per_forward=per)
        launches[f"VGG16 {label} eval"] = (ev, 0, 0)
        want = {} if not per else {("fwd", POOLED_WIDE): ev}
        if seen != want:
            raise AssertionError(f"{label} eval launched {seen}, not {want}")
        print(f"[pooler] {label}: the launches by kernel and R, train "
              f"{dict(want) if per else 'none'}; eval "
              f"{ev if per else 'none'} (checked)")
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    # seed 4: at the other phases' seed 3 one fc7 unit's pre-activation
    # lies within the card's f32 drift of 0 under ROIAlign (one row of its
    # gradient 1.8e-2 of the largest apart, every other within 3.7e-5);
    # seeds 4-6 read 9.5e-4, 2.8e-3 and 3.1e-4 (PERF.md §6)
    gap = phase_train_card_vs_cpu(dev, label="VGG16-OICR ROIAlign", seed=4,
                                  pooler_method="ROIAlign")
    SUMMARY.append(f"ROIAlign f32 card vs CPU loss gap {gap:.1e}")
    return launches, gap


def phase_pooler_mask_rcnn(rp, tmp):
    """Phase 25's supervised path: configs/coco/coco_mask_rcnn_smoke.yaml at
    the published R-50-FPN Mask R-CNN widths (MLP 1024, mask convs 4x256,
    512 sampled rois an image) with ROIPool at R = 14 and a 28x28 mask, in
    bf16, on a synthetic ``coco17`` layout of 400x672 images resized to the
    800x1344 canvas (1000 proposals an image): ``train_net``
    ``MASK_STEPS`` steps (every loss finite; each step #1[argmax] and #2 4
    times, one a level, all at R = 14), then ``test_net`` bbox and segm
    (each batch #1 8 times at R = 14: 4 for the boxes, 4 for the mask
    pass; every stat in [0, 1] or -1). Returns {path: launches}."""
    import torch
    from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
    from odwscl_tpu_torch.tools import test_net, train_net

    root = os.path.join(tmp, "coco17_800")
    t0 = time.perf_counter()
    write_synthetic_coco(root, n_train=8, n_val=4, seed=5,
                         img_hw=MASK_CANVAS_IMAGE, n_props=FPN_ROIS,
                         layout="coco17", obj_size=(60, 300),
                         prop_size=(16, 400))
    print(f"[pooler] synthetic COCO (coco17): 8 train + 4 val images "
          f"{MASK_CANVAS_IMAGE[0]}x{MASK_CANVAS_IMAGE[1]}, {FPN_ROIS} "
          f"proposals each, written in {time.perf_counter() - t0:.2f} s")
    config = os.path.join(ROOT, "configs", "coco", "coco_mask_rcnn_smoke.yaml")
    opts = ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN",
            "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "1024",
            "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(256, 256, 256, 256)",
            "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", str(POOLED_WIDE),
            "MODEL.ROI_MASK_HEAD.RESOLUTION", str(2 * POOLED_WIDE),
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "512",
            "INPUT.MIN_SIZE_TRAIN", "(800,)", "INPUT.MAX_SIZE_TRAIN", "1344",
            "INPUT.MIN_SIZE_TEST", "800", "INPUT.MAX_SIZE_TEST", "1344",
            "TPU.IMAGE_PAD_MULTIPLE", "32", "TPU.PROPOSAL_BUCKETS", "(1024,)",
            "TPU.COMPUTE_DTYPE", "bfloat16",
            # random FrozenBN-identity R-50 weights over BGR-255 inputs put
            # the heads at O(1000) (step 1's loss_mask 2474.6: NaN by step
            # 3); the PyTorch-style std of maskrcnn-benchmark's configs for
            # torchvision weights keeps the inputs, and the steps, at O(1)
            "INPUT.PIXEL_STD", "(57.375, 57.12, 58.395)",
            "SOLVER.MAX_ITER", str(MASK_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(MASK_STEPS)]
    out = os.path.join(tmp, "mask_rcnn_r14")

    def counts():
        return (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                rp.roi_pool_backward.launches)

    def reset():
        rp.roi_pool.launches = rp.roi_pool_argmax.launches = 0
        rp.roi_pool_backward.launches = 0

    reset()
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    t0 = time.perf_counter()
    with PooledLaunches(rp) as seen:
        train_net.main(["--config-file", config, "--data-root", root,
                        "--device", "cuda", "--skip-test", "OUTPUT_DIR", out,
                        *opts], timing_out=timing)
    wall = time.perf_counter() - t0
    train = counts()
    steps_log = timing["train"]["steps"]
    if len(steps_log) != MASK_STEPS:
        raise AssertionError(f"Mask R-CNN R=14: {len(steps_log)} steps")
    for st in steps_log:
        bad = [k for k, v in st.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"Mask R-CNN R=14 iteration {st['iter']}: "
                                 f"non-finite {bad}")
    want = {("fwd_argmax", POOLED_WIDE): 4 * MASK_STEPS,
            ("bwd", POOLED_WIDE): 4 * MASK_STEPS}
    if train != (0, 4 * MASK_STEPS, 4 * MASK_STEPS) or seen != want:
        raise AssertionError(f"Mask R-CNN R=14 train: launches {train}, by "
                             f"R {seen}")
    med = statistics.median(st["step_s"] for st in steps_log[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    idle = timing["train"].get("device_idle_share")
    print(f"[pooler] Mask R-CNN R-50-FPN R=14 mask 28 train (800x1344, "
          f"B=2, bf16): {MASK_STEPS} steps, " + ", ".join(
              f"{k} {steps_log[0][k]:.4f} -> {steps_log[-1][k]:.4f}"
              for k in ("loss_classifier", "loss_box_reg", "loss_mask"))
          + f"; median step {med * 1e3:.1f} ms over steps 2-{MASK_STEPS}; "
          f"device idle share {'n/a' if idle is None else f'{idle:.3f}'}; "
          f"peak {peak:.2f} GB; launches {train} (all at R=14); CLI wall "
          f"{wall:.2f} s")
    reset()
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    with PooledLaunches(rp) as seen:
        res = test_net.main(["--config-file", config, "--data-root", root,
                             "--device", "cuda", "--weights",
                             os.path.join(out, "model_final.pt"),
                             "OUTPUT_DIR", out + "_eval", *opts],
                            timing_out=timing)
    evals = counts()
    (t,), (r,) = timing.values(), res.values()
    n_batches = math.ceil(t["n_images"] / 2)
    if evals != (8 * n_batches, 0, 0) or seen != {
            ("fwd", POOLED_WIDE): 8 * n_batches}:
        raise AssertionError(f"Mask R-CNN R=14 eval: launches {evals}, by R "
                             f"{seen}, for {n_batches} batches")
    keys = ("AP", "segm_AP")
    if not all(r[k] == -1.0 or 0.0 <= r[k] <= 1.0 for k in keys):
        raise AssertionError(f"Mask R-CNN R=14: {[(k, r[k]) for k in keys]}")
    print(f"[pooler] Mask R-CNN R=14 eval: " + ", ".join(
        f"{k} {v:.4f}" for k, v in r.items() if k in keys)
        + f"; {t['n_images']} images in {t['wall_s']:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{evals} for {n_batches} batches (all at R=14)")
    SUMMARY.append(f"Mask R-CNN R=14 train: median step {med * 1e3:.1f} ms, "
                   f"idle {'n/a' if idle is None else f'{idle:.3f}'}, peak "
                   f"{peak:.2f} GB")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    return {"Mask R-CNN R=14 train": train, "Mask R-CNN R=14 eval": evals}


# phase 26: the int8 accuracy study at a smoke size, through its real
# subprocesses, in a process of its own that runs beside phases 6, 15 and
# 19 (their card sides time nothing); each CLI run reports its kernel
# launches into the seed's log
STUDY_ARGS = ["--seeds", "1234", "--iters", "30", "--n-train", "8",
              "--n-test", "8"]
STUDY_LAUNCHER = r"""
import json, runpy, sys
from odwscl_tpu_torch.ops import quant as q
from odwscl_tpu_torch.ops import roi_pool as rp
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__")
print("LAUNCHES " + json.dumps({
    "fwd": rp.roi_pool.launches, "fwd_argmax": rp.roi_pool_argmax.launches,
    "bwd": rp.roi_pool_backward.launches,
    "conv_int8": q.conv_int8_nhwc.launches,
    "quant_int8": q.quantize_act.launches + q.quantize_rows.launches}))
"""
# the study with each CLI command run through STUDY_LAUNCHER
STUDY_RUNNER = r"""
import sys
from odwscl_tpu_torch.tools import int8_accuracy_study as study
launcher, run = sys.argv[1], study.run
def counted(cmd, log):
    i = cmd.index("-m")
    run(cmd[:i] + ["-c", launcher] + cmd[i + 1:], log)
study.run = counted
study.main(sys.argv[2:])
"""
STUDY_MODES = ("bf16", "int8", "int8-fb")


def start_int8_study(root):
    """Start phase 26's study in a process of its own (its output in
    ``root/study.out``); returns (the process, its start time)."""
    import subprocess

    os.makedirs(root, exist_ok=True)
    # two intra-op threads: its CLI runs wait on the card, and the CPU
    # sides of phases 6-19 run beside them
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    with open(os.path.join(root, "study.out"), "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-c", STUDY_RUNNER, STUDY_LAUNCHER]
            + STUDY_ARGS + ["--root", root, "--device", "cuda"], cwd=ROOT,
            env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def phase_int8_study(started, root):
    """Phase 26 (see the module's docstring): waits for the study that
    ``start_int8_study`` started and checks it. Returns {run: {kernel:
    launches}} for the training and each mode's evaluation."""
    proc, t0 = started
    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "study.out")) as f:
        out = f.read()
    if rc != 0:
        print(out[-6000:], file=sys.stderr)
        raise AssertionError(f"the int8 study exited {rc}")
    with open(os.path.join(root, "INT8_STUDY.json")) as f:
        res = json.load(f)
    maps = res["seeds"]["1234"]
    if sorted(maps) != sorted(STUDY_MODES) or not all(
            math.isfinite(v) and 0.0 <= v <= 1.0 for v in maps.values()):
        raise AssertionError(f"int8 study mAPs {maps}")
    if sorted(res["summary"]) != sorted(
            list(STUDY_MODES) + ["delta_int8", "delta_int8-fb"]):
        raise AssertionError(f"int8 study summary {sorted(res['summary'])}")
    with open(os.path.join(root, "seed1234.log")) as f:
        counts = [json.loads(line.split("LAUNCHES ", 1)[1])
                  for line in f if line.startswith("LAUNCHES ")]
    runs = dict(zip(["train"] + list(STUDY_MODES), counts))
    iters = int(STUDY_ARGS[STUDY_ARGS.index("--iters") + 1])
    batches = -(-int(STUDY_ARGS[STUDY_ARGS.index("--n-test") + 1]) // 4)
    want = {"train": {"fwd": 0, "fwd_argmax": iters, "bwd": iters,
                      "conv_int8": 0, "quant_int8": 0},
            "bf16": {"fwd_argmax": 0, "bwd": 0, "conv_int8": 0,
                     "quant_int8": 0},
            "int8": {"fwd_argmax": 0, "bwd": 0, "conv_int8": 11 * batches},
            "int8-fb": {"fwd_argmax": 0, "bwd": 0,
                        "conv_int8": 8 * batches}}
    bad = [(r, k, runs.get(r, {}).get(k), v) for r, w in want.items()
           for k, v in w.items() if runs.get(r, {}).get(k) != v]
    if len(runs) == 4:
        bad += [(r, "fwd", runs[r]["fwd"], ">= batches") for r in STUDY_MODES
                if runs[r]["fwd"] < batches]
        bad += [(r, "quant_int8", runs[r]["quant_int8"], "> 0")
                for r in ("int8", "int8-fb") if not runs[r]["quant_int8"]]
    if len(runs) != 4 or bad:
        raise AssertionError(f"int8 study launches: {runs}; {bad}")
    with open(os.path.join(root, "timing.json")) as f:
        timing = json.load(f)["seeds"]["1234"]
    print(f"[int8 study] {' '.join(STUDY_ARGS)} (beside phases 6, 15 and "
          "19): mAP " + ", ".join(f"{m} {maps[m]:.4f}" for m in STUDY_MODES)
          + f"; delta int8 {res['summary']['delta_int8']['mean']:+.4f}, "
          f"int8-fb {res['summary']['delta_int8-fb']['mean']:+.4f}; wall "
          f"{wall:.1f} s; median step {timing['median_step_ms']:.1f} ms; "
          "eval images/s " + ", ".join(
              f"{m} {timing[m + '_images_per_s']:.2f}" for m in STUDY_MODES)
          + f"; launches {runs}")
    SUMMARY.append(f"int8 study (smoke size) wall {wall:.1f} s")
    return runs


# phase 27: the spatially-parallel ResNet, FPN and FBNet bodies. The bands
# stitched in one process (f32, TF32 off) against the unsharded body: each
# level within SP_STITCH_REL of its largest magnitude (the convolutions of
# a band run on other shapes, so cuDNN may sum in another order)
SP_STITCH_REL = 1e-4
SP_STITCH_WORLD = 4


def phase_sp_bodies(dev):
    """Phase 27 (see the module's docstring)."""
    import torch
    import torch.distributed as dist
    from odwscl_tpu_torch.models.fbnet import FBNetTrunk
    from odwscl_tpu_torch.models.fpn import ResNetFPNBackbone
    from odwscl_tpu_torch.models.resnet import ResNetBackbone
    from odwscl_tpu_torch.parallel import sp_backbone_apply, sp_stitch

    def levels(out):
        return out if isinstance(out, tuple) else (out,)

    bodies = (
        ("R-50-FPN", lambda dt: ResNetFPNBackbone("R-50", 256, dt),
         (2, *FPN_EVAL_HW)),
        ("R-50-C5", lambda dt: ResNetBackbone("R-50", 5, dt), SP_BATCH),
        ("FBNet-default", lambda dt: FBNetTrunk(compute_dtype=dt),
         (2, *FPN_EVAL_HW)))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        for name, make, shape in bodies:
            g = torch.Generator().manual_seed(0)
            gd = torch.Generator(device=dev).manual_seed(0)
            bb = make(torch.bfloat16)
            bb.reset_parameters(g)
            bb.to(dev)
            images = torch.randn(*shape, 3, generator=gd, device=dev)
            with torch.no_grad():
                got, want = (levels(sp_backbone_apply(bb, images, None)),
                             levels(bb(images)))
                if len(got) != len(want) or not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}: sp_backbone_apply != the "
                                         "body at world size 1")
                if not all(torch.isfinite(w).all() for w in want):
                    raise AssertionError(f"{name}: non-finite features")
                sp_ms = cuda_ms(lambda: sp_backbone_apply(bb, images, None),
                                5)
                bb_ms = cuda_ms(lambda: bb(images), 5)
            # the stitched bands, f32
            b32 = make(torch.float32)
            b32.load_state_dict(bb.state_dict())
            b32.to(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            with torch.no_grad():
                want = levels(b32(images))
                worst = 0.0
                for r, out in enumerate(sp_stitch(b32, images,
                                                  SP_STITCH_WORLD)):
                    for a, b in zip(levels(out), want, strict=True):
                        if a.shape != b.shape:
                            raise AssertionError(f"{name} stitched rank {r}:"
                                                 f" {a.shape} != {b.shape}")
                        worst = max(worst, ((a - b).abs().max()
                                            / b.abs().max()).item())
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            print(f"[parallel] sp_backbone_apply {name}, world 1, bf16 "
                  f"{list(shape)} ({len(want)} level(s)): bit-exact vs the "
                  f"body; {sp_ms:.3f} ms (body {bb_ms:.3f}); {SP_STITCH_WORLD}"
                  f" bands stitched in one process, f32: {worst:.2e} of each "
                  f"level's largest (tol {SP_STITCH_REL})")
            SUMMARY.append(f"sp {name} world 1 {sp_ms:.3f} ms (body "
                           f"{bb_ms:.3f})")
            if not worst <= SP_STITCH_REL:
                raise AssertionError(f"{name}: stitched bands part from the "
                                     f"body by {worst:.2e}")
            del bb, b32, images, got, want
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        dist.destroy_process_group()


def build(rp, q):
    """Build the four kernel sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    libs = (rp.KERNEL, rp.BWD_KERNEL, q.CONV_KERNEL, q.QUANT_KERNEL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(k.get) for k in libs]:
            fut.result()
    print(f"[build] {', '.join(k.source.name for k in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for k in libs:
        for entry, regs, spill in ptxas_entries(k.compile_log):
            print(f"[build] {k.name}: {entry}: {regs} registers, {spill}")


def ptxas_entries(log):
    """(kernel's mangled name, registers, spill line) for every kernel of
    an nvcc ``-Xptxas -v`` log, in its order."""
    out, entry, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append((entry, regs, spill))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.ops import quant as q
    from odwscl_tpu_torch.ops import roi_pool as rp
    from odwscl_tpu_torch.ops import roi_pool_stages as rs
    from odwscl_tpu_torch.utils.profiling import card_name_and_limit

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(card_name_and_limit())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build(rp, q)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {label} {time.perf_counter() - t0:.1f} s")
        return out

    rng = np.random.RandomState(0)
    fwd_err = timed("forward kernel checks", phase_kernel, dev, rp, [
        ("grid", grid_inputs(rng, 64), 0.125),
        ("eval", main_path_inputs(rng), 0.125),
        ("train", train_shape_inputs(rng), 0.125)])
    bwd_err = timed("backward kernel checks", phase_bwd_kernel, dev, rp,
                    bwd_cases(np.random.RandomState(2)))
    tm = timed("kernel timing", phase_timing, dev, rp)
    r50_in = r50_check_inputs(np.random.RandomState(7))
    fwd_err_c = timed("forward kernel checks, C=2048", phase_kernel, dev,
                      rp, [("c2048", r50_in, 0.0625)])
    bwd_err_c = timed("backward kernel checks, C=2048", phase_bwd_kernel,
                      dev, rp, [("c2048", r50_in,
                                 (torch.float32, torch.bfloat16), 0.0625)])
    r50_timed = r50_train_inputs(np.random.RandomState(6))
    tm_c = timed("kernel timing, C=2048", phase_timing_c2048, dev, rp,
                 r50_timed)
    err_c, plain_c = timed("kernel checks at the C=2048 timed shape",
                           phase_check_c2048, dev, rp, r50_timed)
    del r50_timed
    fpn_all, fpn_err, fpn_align = timed(
        "FPN kernel checks and timing at R=7 and R=14, C=256",
        phase_fpn_kernels, dev, rp)
    fpn_tm = fpn_all[7]
    pooled_err = timed("pooled kernels on the grid at every R",
                       phase_pooled_grid, dev, rp)
    r14_tm, align_tm = timed("R=14 kernel checks and timing, ROIAlign",
                             phase_pooled_timing, dev, rp)
    wide_tm, wide_err = timed("wide argmax codes: checks and timing",
                              phase_wide_codes, dev, rp)
    stages = timed("stage profiler", phase_stage_kernels, dev, rp, rs)
    int8_err = timed("int8 conv kernel checks", phase_int8_kernel, dev, q)
    quant_err = timed("quantize kernel checks", phase_quant_kernel, dev, q)
    int8_layers, int8_total, int8_quant, int8_dense = timed(
        "int8 conv and quantize timing", phase_int8_timing, dev, q)
    study_root = tempfile.mkdtemp(prefix="odwscl_study_")
    started = start_int8_study(study_root)
    try:
        for arch in ("VGG16-OICR", "R-18-C5"):
            timed(f"eval card vs CPU {arch}", phase_card_vs_cpu, dev, arch)
            timed(f"train card vs CPU {arch}", phase_train_card_vs_cpu, dev,
                  arch)
        variant_gaps = {label: timed(
            f"train card vs CPU {label}",
            lambda lb=label, kw=kw: phase_train_card_vs_cpu(dev, label=lb,
                                                            **kw))
            for label, kw in VARIANT_STEPS}
        variant_gaps["81 classes"] = timed(
            "train card vs CPU, 81 classes", phase_train_card_vs_cpu, dev,
            "VGG16-OICR", "VGG16-OICR 81 classes", 81)
        variant_gaps.update(timed("supervised card vs CPU",
                                  phase_supervised_card_vs_cpu, dev, rp))
        variant_gaps.update(timed("Keypoint R-CNN, FBNet, deform ops card "
                                  "vs CPU", phase_keypoint_fbnet_card_vs_cpu,
                                  dev, rp))
        study = timed("int8 accuracy study, smoke size (the rest of its "
                      "wall)", phase_int8_study, started, study_root)
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
        shutil.rmtree(study_root, ignore_errors=True)
    SUMMARY.append("variants f32 card vs CPU loss gaps " + ", ".join(
        f"{k} {v:.1e}" for k, v in variant_gaps.items()))
    cfg, cfg_r50 = get_default_cfg(), get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg_r50.merge_from_file(CONFIG_R50)
    tmp = tempfile.mkdtemp(prefix="odwscl_smoke_")
    try:
        write_data(tmp, cfg, cfg_r50)
        blobs = write_r50_weights(tmp)
        timed("device resize vs host", phase_resize, tmp, CONFIG)
        rs.roi_pool_stage.launches = dict.fromkeys(rs.STAGES, 0)
        (train_fwd, train_bwd), ckpt = timed(
            "train main path", phase_train, rp, tmp, CONFIG, TRAIN_STEPS,
            "VGG16-OICR", ("MODEL.WEIGHT", ""))
        eval_fwd = timed("eval main path", phase_eval, rp, tmp, CONFIG, ckpt,
                         "VGG16-OICR", [("det", False), ("corloc", False),
                                        ("det", True)])
        int8_eval = timed("int8 eval main path", phase_int8_eval, rp, q, tmp,
                          CONFIG, ckpt)
        (dist_fwd, dist_bwd), dist_eval = timed(
            "distributed training", phase_distributed, rp, tmp, CONFIG,
            "VGG16-OICR")
        timed("tp and sp", phase_tp_sp, dev)
        timed("sp over the ResNet, FPN and FBNet bodies", phase_sp_bodies,
              dev)
        orbax = timed("Orbax checkpoint import and resume", phase_orbax, dev,
                      rp, tmp)
        (r50_fwd, r50_bwd), ckpt = timed(
            "R-50-C5 train", phase_train, rp, tmp, CONFIG_R50, R50_STEPS,
            "R-50-C5", ("MODEL.WEIGHT", cfg_r50.MODEL.WEIGHT))
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        for key, blob in (("stem_conv.weight", "conv1_w"),
                          ("layer1_2.conv3.weight", "res2_2_branch2c_w"),
                          ("layer4_2.bn3.scale", "res5_2_branch2c_bn_s")):
            if not np.array_equal(sd["backbone." + key].numpy(), blobs[blob]):
                raise AssertionError(f"R-50-C5 after training: {key} is not "
                                     f"the .pkl's {blob}")
        print(f"[train] R-50-C5 warm start from {cfg_r50.MODEL.WEIGHT} (a "
              f".pkl of {len(blobs)} random blobs): the frozen stem, layer1 "
              "and norms still hold its values exactly")
        r50_eval = timed("R-50-C5 eval", phase_eval, rp, tmp, CONFIG_R50,
                         ckpt, "R-50-C5", [("det", False), ("det", True)])
        variants = timed("training variants", phase_variants, rp, tmp, cfg)
        pooler, align_gap = timed("pooler configurations: ROIAlign, R=14",
                                  phase_pooler_paths, dev, rp, tmp)
        write_coco_data(tmp)
        coco = timed("COCO train, eval and variants", phase_coco, rp, tmp)
        sup = timed("supervised configs train and eval", phase_supervised_cli,
                    rp, tmp)
        sup_full = timed("full-size supervised eval", phase_fullsize_eval,
                         dev, rp)
        kp_full = timed("full-size Keypoint R-CNN and FBNet",
                        phase_fullsize_keypoint_fbnet, dev, rp)
        kp_cli = timed("Keypoint R-CNN and FBNet configs train and eval",
                       phase_keypoint_fbnet_cli, rp, tmp)
        mask14 = timed("Mask R-CNN R-50-FPN at R=14, mask 28",
                       phase_pooler_mask_rcnn, rp, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(rs.roi_pool_stage.launches.values()):
        raise AssertionError(f"the train and eval paths launched stage "
                             f"kernels: {rs.roi_pool_stage.launches}")
    # each path's launches, read right after it ran
    # the supervised paths: Mask R-CNN train and eval, its full-size eval,
    # RetinaNet (which pools nothing: 0 of each)
    sup_paths = {"Mask R-CNN train": sup["Mask R-CNN train"],
                 "Mask R-CNN eval": sup["Mask R-CNN eval"],
                 "Mask R-CNN full-size eval": (sup_full, 0, 0),
                 "RetinaNet": tuple(map(sum, zip(sup["RetinaNet train"],
                                                 sup["RetinaNet eval"]))),
                 **{k: v[:3] for k, v in kp_full.items()}, **kp_cli,
                 **pooler, **mask14}
    # the int32 instantiations: the paths on maps past 65,535 cells
    wide_paths = {k: v[3:] for k, v in kp_full.items()}
    # the int8 study's CLI runs (phase 26) count in their own processes
    by_path = {"fwd": {"VGG16-OICR eval": eval_fwd, "R-50-C5 eval": r50_eval,
                       "Orbax import eval": orbax["Orbax import eval"][0],
                       "VGG16-OICR distributed checkpoint eval": dist_eval,
                       **{f"VGG16-OICR int8 eval {k}": v[2]
                          for k, v in int8_eval.items()},
                       **{f"{k} eval": v["eval"] for k, v in variants.items()
                          if "eval" in v},
                       "COCO14 eval": coco["COCO14"]["eval"],
                       **{k: v[0] for k, v in sup_paths.items()},
                       **{f"int8 study eval {m}": study[m]["fwd"]
                          for m in STUDY_MODES}},
               "fwd_argmax": {"VGG16-OICR": train_fwd, "R-50-C5": r50_fwd,
                              "Orbax resume": orbax["Orbax resume"][1],
                              "VGG16-OICR distributed": dist_fwd,
                              **{k: v["train"][0]
                                 for k, v in variants.items()},
                              **{k: v["train"][0] for k, v in coco.items()},
                              **{k: v[1] for k, v in sup_paths.items()},
                              "int8 study train": study["train"][
                                  "fwd_argmax"]},
               "bwd": {"VGG16-OICR": train_bwd, "R-50-C5": r50_bwd,
                       "Orbax resume": orbax["Orbax resume"][2],
                       "VGG16-OICR distributed": dist_bwd,
                       **{k: v["train"][1] for k, v in variants.items()},
                       **{k: v["train"][1] for k, v in coco.items()},
                       **{k: v[2] for k, v in sup_paths.items()},
                       "int8 study train": study["train"]["bwd"]}}

    src = "odwscl_tpu_torch/csrc/"
    no_lib = ("no single PyTorch call computes ROIPool; torchvision is not "
              "installed")
    fwd_src = {"route": "cuda", "source": src + "roi_pool_fwd.cu",
               "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:245 _fwd_kernel"}

    # phase 25's paths at R = 14 (the ROIAlign ones launch none)
    r14_paths = {k: v for k, v in {**pooler, **mask14}.items()
                 if "R=14" in k}

    def r14(k):
        """The R = 14 readings: the eval or training shape's, the FPN
        levels', the launches of the R = 14 paths; for #1, ROIAlign's
        times beside it (plain torch, no kernel)."""
        i = ("fwd", "fwd_argmax", "bwd").index(k)
        out = {**r14_tm[k],
               "max_abs_err": max(r14_tm[k]["max_abs_err"], pooled_err[k]),
               "launches": sum(v[i] for v in r14_paths.values()),
               "launches_by_path": {p: v[i] for p, v in r14_paths.items()},
               "fpn_c256": fpn_all[POOLED_WIDE][k]}
        if k == "fwd":
            out["roi_align_ms"] = {
                "eval_shape": align_tm["eval_ms"],
                "train_shape_fwd_bwd": align_tm["train_ms"],
                "fpn_eval_levels": fpn_align,
                "note": "plain torch ops/roi_align.py, sampling 0; by R"}
        return {"r14": out}

    def c2048(k, err, launches):
        """The R-50-C5 readings: the worst error over both C = 2048 checks,
        the plain time over the timed shape's chunks (bf16); and the FPN
        readings (C = 256, each level's and, for #1, the four-call pool's),
        with the supervised paths' launches."""
        fpn_paths = {"fwd": ("Mask R-CNN eval", 0),
                     "fwd_argmax": ("Mask R-CNN train", 1),
                     "bwd": ("Mask R-CNN train", 2)}[k]
        return {"c2048": {"library_ms": None, **tm_c[k], "max_abs_err": err,
                          "plain_ms": plain_c.get(k), "launches": launches},
                "fpn_c256": {"max_abs_err": fpn_err[k],
                             "launches": sup[fpn_paths[0]][fpn_paths[1]],
                             "levels": fpn_tm[k]}}

    kernels = [
        {"name": "roi_pool_fwd", **fwd_src, "launches": eval_fwd,
         "launches_by_path": by_path["fwd"],
         "max_abs_err": fwd_err["eval"], **tm["fwd"], "library_ms": None,
         "library_note": no_lib,
         **c2048("fwd", max(fwd_err_c["eval"], err_c["eval"]), r50_eval),
         **r14("fwd")},
        {"name": "roi_pool_fwd[argmax]", **fwd_src, "launches": train_fwd,
         "launches_by_path": by_path["fwd_argmax"],
         "max_abs_err": fwd_err["argmax"], **tm["fwd_argmax"],
         "library_ms": None, "library_note": no_lib,
         **c2048("fwd_argmax", max(fwd_err_c["argmax"], err_c["argmax"]),
                 r50_fwd), **r14("fwd_argmax")},
        {"name": "roi_pool_bwd", "route": "cuda",
         "source": src + "roi_pool_bwd.cu",
         "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:292 _bwd_kernel",
         "launches": train_bwd, "launches_by_path": by_path["bwd"],
         "max_abs_err": bwd_err, **tm["bwd"],
         "library_note": ("torch.zeros f32, one index_add_ of g at the cells "
                          "decoded from the stored argmax (indices built "
                          "outside the timing), then .to(bf16)"),
         **c2048("bwd", max(bwd_err_c, err_c["bwd"]), r50_bwd),
         **r14("bwd")}]
    # the int32-code instantiations of #1[argmax] and #2, timed at the eval
    # P2 (200x336) and, beside the int16 ones on the same inputs, at the
    # training P2 (160x272)
    wide_fwd = wide_tm["fwd_argmax int32 eval P2"]
    wide_bwd = wide_tm["bwd int32 eval P2"]
    kernels += [
        {"name": "roi_pool_fwd[argmax,int32]", **fwd_src,
         "launches": sum(v[0] for v in wide_paths.values()),
         "launches_by_path": {k: v[0] for k, v in wide_paths.items()},
         "max_abs_err": wide_err["fwd_argmax"], **wide_fwd,
         "library_ms": None, "library_note": no_lib,
         "timed": "eval P2 of an 800x1344 canvas, feat [2, 200, 336, 256] "
                  "bf16, P = 1000 rois an image routed to P2-P5",
         "train_P2": {k.split()[1]: wide_tm[k] for k in wide_tm
                      if k.startswith("fwd_argmax") and "train" in k}},
        {"name": "roi_pool_bwd[int32]", "route": "cuda",
         "source": src + "roi_pool_bwd.cu",
         "replaces": "odwscl_tpu/ops/roi_pool_pallas.py:292 _bwd_kernel",
         "launches": sum(v[1] for v in wide_paths.values()),
         "launches_by_path": {k: v[1] for k, v in wide_paths.items()},
         "max_abs_err": wide_err["bwd"], **wide_bwd,
         "library_note": ("torch.zeros f32, one index_add_ of g at the cells "
                          "decoded from the stored int32 argmax, then "
                          ".to(bf16)"),
         "timed": "as roi_pool_fwd[argmax,int32]",
         "train_P2": {k.split()[1]: wide_tm[k] for k in wide_tm
                      if k.startswith("bwd") and "train" in k}}]
    kernels += stages
    int8_runs = {f"VGG16-OICR int8 eval {k}": v for k, v in int8_eval.items()
                 if k != "bf16"}
    kernels.append({
        "name": "conv_int8", "route": "cuda", "source": src + "conv_int8.cu",
        "replaces": ("odwscl_tpu/ops/quant.py:58 conv2d_int8 (XLA "
                     "conv_general_dilated int8 -> int32 at :109; no Pallas "
                     "kernel)"),
        "launches": sum(v[0] for v in int8_runs.values()),
        "launches_by_path": {**{k: v[0] for k, v in int8_runs.items()},
                             **{f"int8 study eval {m}": study[m]["conv_int8"]
                                for m in STUDY_MODES[1:]}},
        "max_abs_err": int8_err,
        **{k: int8_total[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "cudnn_bf16_ms",
                                      "codes_ms", "bf16_ms", "mma_sync_ms")},
        # the kind that bounds most of the summed bound
        "bound_by": max(("operations", "bytes"), key=lambda kind: sum(
            r["bound_ms"] for r in int8_layers if r["bound_by"] == kind)),
        "timed": "sum over the 11 int8 convs of one 1200-scale batch (B=8, "
                 "1280x1664), each in the static path's output mode (the "
                 "next conv's int8 codes for conv2-conv11, bf16 for conv12)",
        "library_note": "int8 im2col (pad, 9 shifted slices) + "
                        "torch._int_mm, same dequantize",
        "by_layer": [{k: r[k] for k in (
            "layer", "shape", "path_mode", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "cudnn_bf16_ms", "codes_ms",
            "codes_bound_ms", "bf16_ms", "bf16_bound_ms", "mma_sync_ms")}
            for r in int8_layers],
        "int_mm": int8_dense})
    dyn = int8_quant["dynamic"]
    kernels.append({
        "name": "quant_int8", "route": "cuda", "source": src + "quant_int8.cu",
        "replaces": ("odwscl_tpu/ops/quant.py:58 conv2d_int8's activation "
                     "quantize (:97, :100-103) and :119 dense_int8's "
                     "(:128-131); XLA elementwise and reduce, no Pallas "
                     "kernel"),
        "launches": sum(v[1] for v in int8_runs.values()),
        "launches_by_path": {**{k: v[1] for k, v in int8_runs.items()},
                             **{f"int8 study eval {m}": study[m]["quant_int8"]
                                for m in STUDY_MODES[1:]}},
        "max_abs_err": quant_err,
        "ms": dyn["_ms"], "plain_ms": dyn["_plain_ms"],
        "bound_ms": dyn["_bound_ms"], "bound_by": "bytes",
        "library_ms": int8_quant["pr8"],
        "timed": "the dynamic forward's quantize passes at a 1200-scale "
                 "batch: the 11 conv inputs (abs-max, then the map) and the "
                 "neck's rows (fc6, fc7 at 16,384 rows)",
        "library_note": "PR 8's reading: the plain torch chain "
                        "quantize_conv_input (the dynamic activation quantize "
                        "and the weight codes) at the 11 conv inputs",
        "static": {k.strip("_"): v for k, v in int8_quant["static"].items()},
        "by_input": int8_quant["by_input"],
        "rows": [{k: r[k] for k in ("layer", "shape", "q_rows_ms",
                                    "q_rows_plain_ms", "q_rows_bound_ms")}
                 for r in int8_dense]})
    SUMMARY.append(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    print("[summary] " + "; ".join(SUMMARY))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
