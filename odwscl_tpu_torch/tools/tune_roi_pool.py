"""Time variants of the ROIPool forward and backward kernels on the card.

    python -m odwscl_tpu_torch.tools.tune_roi_pool [--only fwd|bwd]
        [--pooled R]

Each variant is a copy of ``csrc/roi_pool_fwd.cu`` or
``csrc/roi_pool_bwd.cu`` with some of its ``constexpr int`` tile constants
changed, or one pattern replaced: the forward with its map loads kept out
of L1 (``__ldcg``), and the ablations of the backward (their result is
wrong on purpose: they only say where the time goes). The ``ordered``
variants append ``tools/roi_pool_fwd_ordered.cu`` to the forward: the
rois taken in a spatial order, with the shipped direct loads or staged in
shared memory. All sources are built at once (``build/odwscl_tpu_torch/``)
and timed beside the shipped kernels, in turns, twice, with CUDA events
(10 launches per reading), in bf16 at three shapes, each P = 2048 rois per
image of 8:

- ``eval``: feat [8, 104, 168, 512], rois 16-300 px (832x1344 images), as
  the JAX package's ``tools/profile_pool_stages.py`` draws them;
- ``train``: feat [8, 160, 208, 512], the same rois (a padded 1200-scale
  batch, as ``chip_smoke.py`` draws it);
- ``step480`` ... ``step1200``: the batch of a training step at each of the
  config's six train scales, which the loop draws with equal chance, with
  rois drawn as ``tools/profile_train.py`` draws them (20 px to 0.6 of the
  shorter side of the resized 375x500 image; ``step1200`` is
  ``profile_train``'s own shape). The ``mix`` line is their mean: the
  ROIPool time of an average training step.

Beside each forward variant it times that source's ``write`` stage (the
forward's stores alone, ``ops/roi_pool_stages.py``) and ``torch.zeros``
of the output, the library call that computes it. The forward variants
must give the shipped kernel's output and argmax bit for bit, and their
``write`` stage zeros, the backward variants (not the ablations) its
routing; a variant that does not is marked. ``--pooled R`` (1 to 16, 7 by
default) times every kernel at R x R: at R other than 7 the kernels' run-
time instantiations, without the ``write`` stage and the ``ordered``
variants, which pool 7x7 only. Prints one JSON line per
shape with the card's name and power limit. The chosen constants and the
readings are in PERF.md.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import roi_pool as rp
from ..ops.roi_pool_stages import STAGES
from ..utils.cuda_build import BUILD_DIR, CSRC_DIR, CudaLibrary
from ..utils.device import resolve_device
from ..utils.profiling import card_name_and_limit

SCALE = 0.125
ITERS = 10
# (H, W), x1 y1 upper bound (x, y), width/height range, clip (x, y)
SHAPES = {
    "eval": ((104, 168), (1000, 1000), (16, 300), (1332, 799)),
    "train": ((160, 208), (1200, 1200), (16, 300), (1599, 1199)),
}


def _step_shapes() -> dict:
    """The train step's batch at each train scale, as profile_train draws
    it (``synthetic_batch``): padded map, roi corners and sizes."""
    from ..config import cfg as default_cfg
    from ..data.collate import _round_up
    from ..data.transforms import get_resize_size
    from .profile_train import CONFIG

    cfg = default_cfg.clone()
    cfg.merge_from_file(CONFIG)
    shapes = {}
    for scale in cfg.INPUT.MIN_SIZE_TRAIN:
        h, w = get_resize_size((500, 375), scale, cfg.INPUT.MAX_SIZE_TRAIN)
        ph, pw = (_round_up(_round_up(n, cfg.DATALOADER.SIZE_DIVISIBILITY),
                            cfg.TPU.IMAGE_PAD_MULTIPLE) for n in (h, w))
        shapes[f"step{scale}"] = ((round(ph * SCALE), round(pw * SCALE)),
                                  (w - 40, h - 40), (20, 0.6 * min(h, w)),
                                  (w - 1, h - 1))
    return shapes


FWD_VARIANTS = {
    "kGroup=1": {"kGroup": 1},
    "kGroup=4": {"kGroup": 4},
    "kGroup=7": {"kGroup": 7},
    "kRun=2": {"kRun": 2},
    "kRun=8": {"kRun": 8},
    "kRun=16": {"kRun": 16},
    "kUnroll=2": {"kUnroll": 2},
    "kUnrollArgmax=4": {"kUnrollArgmax": 4},
    "kTileC=32": {"kTileC": 32},
    "kMinThreads=128": {"kMinThreads": 128},
    "loads kept out of L1": {r"__ldg\(p \+": "__ldcg(p +"},
    "streaming stores": {
        r"out\[e\] = empty \? make_uint4\(0, 0, 0, 0\) : m\[j\];":
            "__stcs(out + e, empty ? make_uint4(0, 0, 0, 0) : m[j]);"},
    "channel tiles fastest in the grid": {
        r"const int cv = blockIdx\.y \* S::kLanes":
            "const int cv = blockIdx.x * S::kLanes",
        r"\(blockIdx\.x \+ 1\) \* kRun": "(blockIdx.y + 1) * kRun",
        r"int roi = blockIdx\.x \* kRun": "int roi = blockIdx.y * kRun",
        r"grid\(\(n \+ kRun - 1\) / kRun, \(cv \+ S::kLanes - 1\) / S::kLanes\)":
            "grid((cv + S::kLanes - 1) / S::kLanes, (n + kRun - 1) / kRun)"},
}
ORDERED_VARIANTS = {  # tools/roi_pool_fwd_ordered.cu appended
    "spatial order": {"kStagedRun": 0},
    "spatial order, kOrderCell=32": {"kStagedRun": 0, "kOrderCell": 32},
    "staged, 1 roi": {"kStagedRun": 1},
    "staged, 2 rois": {"kStagedRun": 2},
    "staged, 4 rois": {},
    "staged, 4 rois, 32 KB bands": {"kBandBytes": 32768},
}
BWD_VARIANTS = {
    "8x16 tile, 1 block/SM": {"kTileW": 16, "kMinBlocks": 1},
    "16x8 tile, 1 block/SM": {"kTileH": 16, "kMinBlocks": 1},
    "kBins=1": {"kBins": 1},
    "kBins=2": {"kBins": 2},
    "kList=256": {"kList": 256},
    "ablation: list and epilogue only": {
        r"const int items = count \* np;": "const int items = 0;"},
    "ablation: loads, no decode": {
        r"if \(code == Code::kNone\) continue;":
            "if (code != 0x7ffe) continue;"},
    "ablation: plain shared adds": {
        r"atomicAdd\(&acc\[([^]]*)\],\s*([^;]*)\);": r"acc[\1] += \2;"},
}


def _variant(base: str, name: str, subs: dict, bind,
             extra: str = "") -> CudaLibrary:
    src = (CSRC_DIR / f"{base}.cu").read_text() + extra
    for key, value in subs.items():
        if key.startswith("k"):  # a constant
            key, value = (rf"constexpr int {key} = [^;]+;",
                          f"constexpr int {key} = {value};")
        src, n = re.subn(key, value, src)
        if n != 1:
            raise ValueError(f"{base}: {key!r} found {n} times")
    tag = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
    path = BUILD_DIR / "variants" / f"{base}_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = CudaLibrary(f"{base}_{tag}", bind)
    lib.source = path
    return lib


def _bind_ordered(lib) -> None:
    lib.roi_pool_fwd_ordered_bf16.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    lib.roi_pool_fwd_ordered_bf16.restype = ctypes.c_int


def _inputs(shape, dev, seed=0):
    (h, w), xy, wh, limit = {**SHAPES, **_step_shapes()}[shape]
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(rng.randn(8, h, w, 512).astype(np.float32))
    x1y1 = rng.uniform(0, xy, (8, 2048, 2))
    rois = np.concatenate([x1y1, np.minimum(x1y1 + rng.uniform(
        *wh, (8, 2048, 2)), limit)], -1).astype(np.float32)
    return (feat.to(dev, torch.bfloat16), torch.from_numpy(rois).to(dev),
            torch.ones((8, 2048), dtype=torch.bool, device=dev))


def _ms(fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _fwd_call(lib, feat, rois, mask, out, codes, order=None):
    """A launch of ``lib``'s bf16 forward into the given buffers (codes
    None: the eval instantiation) at out's R; with an ``order`` scratch, of
    an ordered variant (R = 7)."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    pooled = out.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (feat.data_ptr(), rois.data_ptr(), mask.data_ptr())
    if order is not None:
        fn = lib.roi_pool_fwd_ordered_bf16
        ptrs += (order.data_ptr(),)
    else:
        fn = lib.roi_pool_fwd_bf16

    size = (b, p, h, w, c) + (() if order is not None else (pooled,))

    def call():
        err = fn(*ptrs, out.data_ptr(),
                 None if codes is None else codes.data_ptr(), *size, SCALE,
                 stream)
        if err:
            raise RuntimeError(f"roi_pool_fwd launch failed: {err}")
        return out, codes
    return call


def _write_call(lib, feat, rois, mask, out):
    """A launch of ``lib``'s bf16 ``write`` stage into ``out`` (it reads no
    column window)."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.roi_pool_stage_bf16(
            feat.data_ptr(), rois.data_ptr(), mask.data_ptr(), None, None,
            out.data_ptr(), b, p, h, w, c, SCALE, STAGES.index("write"),
            stream)
        if err:
            raise RuntimeError(f"roi_pool_stage[write] launch failed: {err}")
        return out
    return call


def _bwd_call(lib, codes, rois, mask, g, d):
    b, p = rois.shape[:2]
    hw = tuple(d.shape[1:3])
    c = g.shape[-1]
    pooled = g.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.roi_pool_bwd_bf16(
            codes.data_ptr(), rois.data_ptr(), mask.data_ptr(), g.data_ptr(),
            d.data_ptr(), b, p, hw[0], hw[1], c, pooled, SCALE, stream)
        if err:
            raise RuntimeError(f"roi_pool_bwd launch failed: {err}")
        return d
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--pooled", type=int, default=rp.POOLED,
                    help=f"the resolution R (1 to {rp.MAX_POOLED})")
    args = ap.parse_args(argv)
    at7 = args.pooled == rp.POOLED
    dev = resolve_device("cuda")
    card = card_name_and_limit()
    print(card)
    fwd = {"shipped": rp.KERNEL}
    bwd = {"shipped": rp.BWD_KERNEL}
    ordered = {}
    if args.only != "bwd":
        fwd.update({k: _variant("roi_pool_fwd", k, v, rp._bind)
                    for k, v in FWD_VARIANTS.items()})
        extra = (Path(__file__).parent / "roi_pool_fwd_ordered.cu").read_text()
        ordered = {k: _variant("roi_pool_fwd", k, v, _bind_ordered, extra)
                   for k, v in ORDERED_VARIANTS.items() if at7}
    if args.only != "fwd":
        bwd.update({k: _variant("roi_pool_bwd", k, v, rp._bind_bwd)
                    for k, v in BWD_VARIANTS.items()})
    libs = [*fwd.values(), *ordered.values(), *bwd.values()]
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(lib.get) for lib in libs]:
            fut.result()
    for lib in libs:
        regs = [line.split(":")[-1].strip() for line in
                lib.compile_log.splitlines() if "registers" in line]
        print(f"[build] {lib.name}: {'; '.join(regs)}")

    mix = {}
    for shape in [*SHAPES, *_step_shapes()]:
        feat, rois, mask = _inputs(shape, dev)
        out = torch.empty(feat.shape[:1] + rois.shape[1:2]
                          + (args.pooled, args.pooled) + feat.shape[3:],
                          dtype=feat.dtype, device=dev)
        codes = torch.empty(out.shape, dtype=torch.int16, device=dev)
        order = torch.empty(out.shape[0] * out.shape[1], dtype=torch.int32,
                            device=dev)
        d = torch.empty_like(feat)
        ref_out, ref_codes = (t.clone() for t in _fwd_call(
            rp.KERNEL.get(), feat, rois, mask, out, codes)())
        g = torch.rand(ref_codes.shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(0)).to(
                           torch.bfloat16)
        ref_d = _bwd_call(rp.BWD_KERNEL.get(), ref_codes, rois, mask, g,
                          d)().clone()
        calls, same = {}, {}
        if args.only != "bwd":
            for name, lib in [*fwd.items(), *ordered.items()]:
                for am in (False, True):
                    call = _fwd_call(lib.get(), feat, rois, mask, out,
                                     codes if am else None,
                                     order if name in ordered else None)
                    o, a = call()
                    key = f"fwd{'[argmax]' if am else ''} {name}"
                    calls[key] = call
                    same[key] = torch.equal(o, ref_out) and (
                        not am or torch.equal(a, ref_codes))
                if name in fwd and at7:
                    call = _write_call(lib.get(), feat, rois, mask, out)
                    calls[f"write {name}"] = call
                    same[f"write {name}"] = not call().any()
            calls["torch.zeros"] = functools.partial(
                torch.zeros, out.shape, dtype=out.dtype, device=dev)
            same["torch.zeros"] = True
        if args.only != "fwd":
            for name, lib in bwd.items():
                call = _bwd_call(lib.get(), ref_codes, rois, mask, g, d)
                calls[f"bwd {name}"] = call
                same[f"bwd {name}"] = torch.equal(call() != 0, ref_d != 0)
        times = {k: [] for k in calls}
        for _ in range(2):
            for k, call in calls.items():
                times[k].append(_ms(call))
        for k, v in times.items():
            print(f"[{shape}] {k}: {' '.join(f'{t:.4f}' for t in v)} ms"
                  f"{'' if same[k] else ' (differs from the shipped kernel)'}")
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        print(json.dumps({"shape": shape, "card": card, "feat": list(
            feat.shape), "pooled": args.pooled, "ms": ms,
            "same_as_shipped": same}))
        if shape.startswith("step"):
            mix[shape] = ms
    mean = {k: sum(m[k] for m in mix.values()) / len(mix) for k in calls}
    for k, t in mean.items():
        print(f"[mix] {k}: {t:.4f} ms")
    print(json.dumps({"shape": "mix", "card": card, "of": list(mix),
                      "pooled": args.pooled, "ms": mean}))


if __name__ == "__main__":
    main()
