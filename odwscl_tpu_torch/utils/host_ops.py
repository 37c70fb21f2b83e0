"""The native host library (``csrc/host_ops.cpp``) through ``ctypes``.

Counterpart of ``odwscl_tpu/utils/host_ops.py``: ``clean_proposals``
(dedup, clip and min-size in one pass over an image's proposals; every
training and eval image goes through it, ``data/proposals.py``), greedy
``nms`` and ``iou_plus1``. The library is built at first use with ``g++
-O3 -shared -fPIC -ffp-contract=off`` into ``build/odwscl_tpu_torch/`` at
the root of the checkout, named by a hash of the source and the flags, as
the CUDA sources are (``utils/cuda_build.py``). A failed build raises:
unlike the JAX module there is no silent numpy fallback. The numpy
versions (``nms_plain``, ``voc_eval._iou_plus1``,
``data/proposals.py:clean_proposals_plain``) are the plain versions the
tests hold it to.

The dedup hash rounds half away from zero (``std::round``), as the JAX
package's native pass does; numpy's ``round`` (the plain version) rounds
half to even, so the two differ only for coordinates ending in .5.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "host_ops.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (by default ``csrc/host_ops.cpp``; the zstd
    decoder's ``csrc/zstd_decode.cpp`` is built the same way) unless a
    library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {source.name}: no C++ compiler "
                           f"({e}); set CXX") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {source.name} failed (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built and bound on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.host_nms.restype = ctypes.c_int32
            lib.host_nms.argtypes = [f32p, f32p, ctypes.c_int32,
                                     ctypes.c_float, i32p]
            lib.host_iou_plus1.restype = None
            lib.host_iou_plus1.argtypes = [f32p, ctypes.c_int32, f32p,
                                           ctypes.c_int32, f32p]
            lib.host_clean_proposals.restype = ctypes.c_int32
            lib.host_clean_proposals.argtypes = [
                f64p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, f32p]
            _lib = lib
        return _lib


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float
        ) -> List[int]:
    """Greedy NMS (no +1, suppress IoU > ``iou_thresh``): the kept indices
    in descending-score order, the first of equal scores first."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(boxes), np.int32)
    n = lib.host_nms(boxes, scores, len(boxes), float(iou_thresh), keep)
    return keep[:n].tolist()


def iou_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] -> [N, M] f32 IoU with the +1 convention."""
    lib = load()
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 4)
    out = np.empty((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.host_iou_plus1(a, len(a), b, len(b), out)
    return out


def clean_proposals(boxes: np.ndarray, img_w: float, img_h: float,
                    min_size: float) -> np.ndarray:
    """Dedup (first occurrence of each rounded-coordinate hash, original
    order), clip to the image, drop empty boxes and those with a side
    (x2 - x1 + 1) under ``min_size``: [K, 4] f32."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
    out = np.empty((len(boxes), 4), np.float32)
    n = lib.host_clean_proposals(boxes, len(boxes), float(img_w),
                                 float(img_h), float(min_size), out)
    return out[:n].copy()


def nms_plain(boxes, scores, iou_threshold) -> List[int]:
    """``nms`` in numpy (float64)."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas[i] + areas - inter
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
        suppressed |= iou > iou_threshold
    return keep
