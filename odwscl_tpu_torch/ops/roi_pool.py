"""7x7 RoI max pooling with the reference CUDA kernel's exact semantics.

Counterpart of ``odwscl_tpu/ops/roi_pool.py`` (``roi_pool_numpy``) and of
the Pallas kernels ``odwscl_tpu/ops/roi_pool_pallas.py:_fwd_kernel`` and
``_bwd_kernel``:

- roi edges are scaled, then rounded half up: ``floor(x * scale + 0.5)``
  in f32;
- malformed rois are forced to 1x1 (``max(end - start + 1, 1)``);
- bin (ph, pw) covers rows ``[floor(ph*h/7), ceil((ph+1)*h/7))`` offset by
  the roi start and clipped to the map, in integer arithmetic;
- empty bins and masked rois output 0;
- the backward gives each bin's cotangent whole to the bin's first maximum
  in row-major order (ties are never split), accumulates in f32 and
  returns the gradient in the feature's dtype.

The training forward also returns that first maximum as a code per output
element (the argmax, as the reference CUDA ROIPool stores it): the offset
``(y - hs) * (we - ws) + (x - ws)`` of the cell inside its bin, read as an
unsigned value, or -1 (all ones) for an empty bin or a masked roi. The
backward routes the cotangent by it and never reads the map again. A bin
can be as large as the map (a roi hanging off it), so the code's width
follows the map's shape (``code_dtype``): int16 while H * W <=
``NARROW_MAP_CELLS`` (65535), int32 above (FPN P2 of an 800x1344 canvas,
200x336 cells, among them). Only a map past ``MAX_MAP_CELLS`` (2^31 - 1
cells, the kernels' int offsets) raises.

``roi_pool``, ``roi_pool_argmax`` and ``roi_pool_backward`` dispatch on
the tensor's device: a CPU tensor goes to the plain version
(``roi_pool_plain``, ``roi_pool_argmax_plain``,
``roi_pool_backward_argmax_plain``); a CUDA tensor goes to the
hand-written kernel (``csrc/roi_pool_fwd.cu``, without and with the
argmax, and ``csrc/roi_pool_bwd.cu``) or raises. Their ``launches``
attributes count kernel launches. ``RoIPoolFunction`` wraps them in a
``torch.autograd.Function``. ``roi_pool_backward_plain`` is the backward
from the map (the argmax rescanned), the oracle of both paths.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.cuda_build import CudaLibrary

POOLED = 7
# cells of the largest map whose bin offsets fit an unsigned 16-bit code
# below the 0xFFFF that marks "no cell"; larger maps take int32 codes
NARROW_MAP_CELLS = 65535
# cells of the largest map the kernels address (int offsets)
MAX_MAP_CELLS = 2 ** 31 - 1
NO_CELL = -1
# a decoded "no cell" per code dtype (the unsigned value of -1)
UNSIGNED_NO_CELL = {torch.int16: 0xFFFF, torch.int32: 0xFFFFFFFF}

# bytes of gathered roi windows held at once by the plain versions
_PLAIN_CHUNK_BYTES = 1 << 28


def _bin_edges(start: torch.Tensor, length: torch.Tensor, pooled: int,
               limit: int):
    """Per-bin [lo, hi) cell ranges, offset and clipped: [..., pooled]."""
    k = torch.arange(pooled, device=start.device)
    lo = k * length[..., None] // pooled + start[..., None]
    hi = ((k + 1) * length[..., None] + pooled - 1) // pooled + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_bin_edges(rois: torch.Tensor, spatial_scale: float, pooled: int,
                  h: int, w: int):
    """Bin edges of every roi of ``rois`` [B, P, 4] on an [h, w] map: row
    (lo, hi) and column (lo, hi), each [B * P, pooled]."""
    cells = torch.floor(rois.to(torch.float32).reshape(-1, 4)
                        * spatial_scale + 0.5).to(torch.int64)
    x1, y1, x2, y2 = cells.unbind(-1)
    hs, he = _bin_edges(y1, (y2 - y1 + 1).clamp(min=1), pooled, h)
    ws, we = _bin_edges(x1, (x2 - x1 + 1).clamp(min=1), pooled, w)
    return hs, he, ws, we


def roi_pool_plain(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
                   spatial_scale: float, pooled: int = POOLED) -> torch.Tensor:
    """Plain torch RoI max pooling, exact for every roi size.

    feat [B, H, W, C]; rois [B, P, 4] xyxy in image pixels (f32); mask
    [B, P] bool -> [B, P, pooled, pooled, C] in feat's dtype.

    The max of a rectangle is the max over its columns of the max over its
    rows, so the bin-by-bin reduction of ``pool_rects`` is exact.
    """
    b, h, w, c = feat.shape
    p = rois.shape[1]
    if b * p == 0:
        return torch.zeros((b, p, pooled, pooled, c), dtype=feat.dtype,
                           device=feat.device)
    edges = roi_bin_edges(rois, spatial_scale, pooled, h, w)
    return pool_rects(feat, mask, *edges).reshape(b, p, pooled, pooled, c)


def pool_rects(fmap: torch.Tensor, mask: torch.Tensor, row_lo: torch.Tensor,
               row_hi: torch.Tensor, col_lo: torch.Tensor,
               col_hi: torch.Tensor) -> torch.Tensor:
    """out[n, i, j] = max of image n // P of ``fmap`` [B, H, W, C] over rows
    [row_lo, row_hi)[n, i] x columns [col_lo, col_hi)[n, j]: [B * P, K, K,
    C]. Empty rectangles and masked rois (``mask`` [B, P]) give 0.

    Each roi's window is reduced over rows into the row bins, then over
    columns.
    """
    geo = _Windows(fmap, mask, row_lo, row_hi, col_lo, col_hi)
    n, k = row_lo.shape
    out = torch.empty((n, k, k, geo.c), dtype=fmap.dtype, device=fmap.device)
    for s, e, win, _, row_in, col_in in geo.chunks():
        for i in range(k):
            rowmax = torch.where(row_in[:, i, :, None, None], win,
                                 geo.neg).amax(dim=1)              # [m, mw, C]
            out[s:e, i] = torch.where(col_in[:, :, :, None],
                                      rowmax[:, None], geo.neg).amax(dim=2)
    return torch.where(geo.dead[..., None], torch.zeros(
        (), dtype=fmap.dtype, device=fmap.device), out)


class _Windows:
    """The bin rectangles of every roi, rows [row_lo, row_hi) x columns
    [col_lo, col_hi) ([B * P, K] each, non-decreasing along the bins,
    inside the map), and its cell window (rows row_lo[:, 0] to
    row_hi[:, -1], columns likewise, padded to the largest in the batch),
    gathered from the map in chunks with each cell's index."""

    def __init__(self, fmap, mask, row_lo, row_hi, col_lo, col_hi):
        b, h, w, c = fmap.shape
        n = row_lo.shape[0]
        dev = fmap.device
        self.fmap, self.h, self.w, self.c, self.n = fmap, h, w, c, n
        self.hs, self.he, self.ws, self.we = row_lo, row_hi, col_lo, col_hi
        self.r0, self.c0 = row_lo[:, 0], col_lo[:, 0]
        self.mh = max(1, int((row_hi[:, -1] - self.r0).max()))
        self.mw = max(1, int((col_hi[:, -1] - self.c0).max()))
        self.img = torch.arange(b, device=dev).repeat_interleave(n // b)
        self.neg = torch.tensor(float("-inf"), dtype=fmap.dtype, device=dev)
        empty = ((row_hi <= row_lo)[:, :, None]
                 | (col_hi <= col_lo)[:, None, :])                 # [N, K, K]
        self.dead = empty | ~mask.reshape(n)[:, None, None]
        per_roi = self.mh * self.mw * c * fmap.element_size() * 3
        self.chunk = max(1, _PLAIN_CHUNK_BYTES // per_roi)

    def chunks(self):
        """Yields (s, e, win [n, mh, mw, C], cell index of win [n, mh, mw],
        row_in [n, K, mh], col_in [n, K, mw]) for rois s:e."""
        h, w, c, dev = self.h, self.w, self.c, self.fmap.device
        flat = self.fmap.reshape(-1, c)
        for s in range(0, self.n, self.chunk):
            e = min(s + self.chunk, self.n)
            rows = self.r0[s:e, None] + torch.arange(self.mh, device=dev)
            cols = self.c0[s:e, None] + torch.arange(self.mw, device=dev)
            idx = ((self.img[s:e, None, None] * h
                    + rows.clamp(max=h - 1)[:, :, None]) * w
                   + cols.clamp(max=w - 1)[:, None, :])
            win = flat.index_select(0, idx.reshape(-1)).reshape(
                e - s, self.mh, self.mw, c)
            row_in = ((rows[:, None, :] >= self.hs[s:e, :, None])
                      & (rows[:, None, :] < self.he[s:e, :, None]))
            col_in = ((cols[:, None, :] >= self.ws[s:e, :, None])
                      & (cols[:, None, :] < self.we[s:e, :, None]))
            yield s, e, win, idx, row_in, col_in


def roi_pool_backward_plain(feat: torch.Tensor, rois: torch.Tensor,
                            mask: torch.Tensor, grad: torch.Tensor,
                            spatial_scale: float,
                            pooled: int = POOLED) -> torch.Tensor:
    """Plain torch ROIPool backward, exact for every roi size.

    grad [B, P, pooled, pooled, C] -> d feat [B, H, W, C] in feat's dtype.
    Each live bin's cotangent goes whole to the bin's first maximum in
    row-major order (``_first_maxima``), found by a rescan of the map;
    the sums are f32 (``index_add_``), then cast.
    """
    b, h, w, c = feat.shape
    p = rois.shape[1]
    dev = feat.device
    dfeat = torch.zeros(b * h * w * c, dtype=torch.float32, device=dev)
    if b * p == 0:
        return dfeat.reshape(b, h, w, c).to(feat.dtype)
    geo = _Windows(feat, mask, *roi_bin_edges(rois, spatial_scale, pooled,
                                              h, w))
    g = grad.reshape(b * p, pooled, pooled, c).to(torch.float32)
    ch = torch.arange(c, device=dev)
    for s, e, idx, ph, pw, _, key, live in _first_maxima(geo, pooled):
        cell = torch.gather(idx.reshape(e - s, -1), 1, key)       # [n, C]
        dfeat.index_add_(0, (cell * c + ch).reshape(-1),
                         torch.where(live, g[s:e, ph, pw], 0.0).reshape(-1))
    return dfeat.reshape(b, h, w, c).to(feat.dtype)


def _first_maxima(geo: _Windows, pooled: int):
    """Yields, per chunk s:e of rois and bin (ph, pw): (s, e, the chunk's
    cell index [n, mh, mw], ph, pw, the bin max [n, C], the window key
    row * mw + column of the bin's first row-major maximum [n, C], whether
    the bin routes [n, C]).

    Per row bin, every window column keeps its max over the bin's rows and
    the first row that reaches it (``argmax`` returns the first). Per
    column bin, among the columns that reach the bin max, the first
    row-major cell is the one with the least (row, column) key. A bin
    routes unless it is empty, its roi is masked or it holds only -inf.
    """
    xs = torch.arange(geo.mw, device=geo.fmap.device)[None, :, None]
    big = geo.mh * geo.mw
    for s, e, win, idx, row_in, col_in in geo.chunks():
        for ph in range(pooled):
            masked = torch.where(row_in[:, ph, :, None, None], win, geo.neg)
            rowmax = masked.amax(dim=1)                            # [n, mw, C]
            rowarg = masked.argmax(dim=1)                          # first row
            for pw in range(pooled):
                colmax = torch.where(col_in[:, pw, :, None], rowmax, geo.neg)
                binmax = colmax.amax(dim=1, keepdim=True)          # [n, 1, C]
                key = torch.where(colmax == binmax, rowarg * geo.mw + xs,
                                  big).amin(dim=1)                 # [n, C]
                live = ((binmax[:, 0] > geo.neg)
                        & ~geo.dead[s:e, ph, pw, None])
                yield (s, e, idx, ph, pw, binmax[:, 0],
                       key.clamp(max=big - 1), live)


def code_dtype(h: int, w: int, level: Optional[str] = None) -> torch.dtype:
    """The argmax codes' dtype for an [h, w] map, from its shape alone:
    int16 while every bin offset (at most h * w - 1) fits an unsigned
    16-bit code below 0xFFFF, else int32. A map past ``MAX_MAP_CELLS``
    raises; ``level`` (an FPN level's name) goes into the message."""
    if h * w <= NARROW_MAP_CELLS:
        return torch.int16
    if h * w > MAX_MAP_CELLS:
        where = f" at FPN level {level}" if level else ""
        raise ValueError(f"roi_pool argmax{where}: a {h}x{w} map has "
                         f"{h * w} cells, more than the {MAX_MAP_CELLS} "
                         "that the kernels address")
    return torch.int32


def encode_cells(code: torch.Tensor,
                 dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Bin offsets, or -1, as codes of ``dtype``: int16 for offsets
    0..65534 (the two's complement of the unsigned 16-bit value), int32
    for any offset."""
    if dtype == torch.int16:
        return torch.where(code >= 32768, code - 65536, code).to(torch.int16)
    return code.to(torch.int32)


def decode_cells(argmax: torch.Tensor) -> torch.Tensor:
    """Codes -> their unsigned bin offsets: int16 -> int32 0..65534, or
    65535 for no cell; int32 -> int64, 0xFFFFFFFF for no cell
    (``UNSIGNED_NO_CELL``)."""
    if argmax.dtype == torch.int16:
        return argmax.to(torch.int32) & 0xFFFF
    return argmax.to(torch.int64) & 0xFFFFFFFF


def roi_pool_argmax_plain(feat: torch.Tensor, rois: torch.Tensor,
                          mask: torch.Tensor, spatial_scale: float,
                          pooled: int = POOLED):
    """Plain torch training forward: (``roi_pool_plain``'s output, the
    argmax codes [B, P, pooled, pooled, C] of ``code_dtype(H, W)``) with
    the first row-major maximum of ``roi_pool_backward_plain``."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    dtype = code_dtype(h, w)
    out = torch.zeros((b * p, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    code = torch.full((b * p, pooled, pooled, c), NO_CELL, dtype=torch.int64,
                      device=feat.device)
    if b * p:
        hs, _, ws, we = edges = roi_bin_edges(rois, spatial_scale, pooled,
                                              h, w)
        geo = _Windows(feat, mask, *edges)
        bw = we - ws
        zero = torch.zeros((), dtype=feat.dtype, device=feat.device)
        for s, e, _, ph, pw, binmax, key, live in _first_maxima(geo, pooled):
            out[s:e, ph, pw] = torch.where(geo.dead[s:e, ph, pw, None], zero,
                                           binmax)
            y = geo.r0[s:e, None] + key // geo.mw
            x = geo.c0[s:e, None] + key % geo.mw
            off = ((y - hs[s:e, ph, None]) * bw[s:e, pw, None]
                   + x - ws[s:e, pw, None])
            code[s:e, ph, pw] = torch.where(live, off, NO_CELL)
    shape = (b, p, pooled, pooled, c)
    return out.reshape(shape), encode_cells(code, dtype).reshape(shape)


def roi_pool_backward_argmax_plain(argmax: torch.Tensor, rois: torch.Tensor,
                                   mask: torch.Tensor, grad: torch.Tensor,
                                   spatial_scale: float, map_hw,
                                   pooled: int = POOLED) -> torch.Tensor:
    """Plain torch backward from the stored argmax: argmax (int16 or int32
    codes) and grad [B, P, pooled, pooled, C], map_hw (H, W) -> d feat [B,
    H, W, C] in grad's dtype. Decode each code to its map cell, one f32
    ``index_add_`` of the live cotangents, then the cast."""
    b, p = rois.shape[:2]
    h, w = map_hw
    c = grad.shape[-1]
    dev = grad.device
    none = UNSIGNED_NO_CELL[argmax.dtype]
    dfeat = torch.zeros(b * h * w * c, dtype=torch.float32, device=dev)
    n = b * p
    if n:
        hs, _, ws, we = roi_bin_edges(rois, spatial_scale, pooled, h, w)
        bw = (we - ws).clamp(min=1)[:, None, :, None]
        img = torch.arange(b, device=dev).repeat_interleave(p)
        live_roi = mask.reshape(n)
        codes = argmax.reshape(n, pooled, pooled, c)
        g = grad.reshape(n, pooled, pooled, c)
        ch = torch.arange(c, device=dev)
        chunk = max(1, _PLAIN_CHUNK_BYTES // (pooled * pooled * c * 32))
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            off = decode_cells(codes[s:e]).to(torch.int64)
            live = (off != none) & live_roi[s:e, None, None, None]
            y = hs[s:e, :, None, None] + off // bw[s:e]
            x = ws[s:e, None, :, None] + off % bw[s:e]
            cell = ((img[s:e, None, None, None] * h + y) * w + x) * c + ch
            dfeat.index_add_(0, cell[live], g[s:e][live].to(torch.float32))
    return dfeat.reshape(b, h, w, c).to(grad.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.roi_pool_fwd_bf16, lib.roi_pool_fwd_f32,
               lib.roi_pool_fwd_wide_bf16, lib.roi_pool_fwd_wide_f32):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the stage profiler's entry points (ops/roi_pool_stages.py)
    for fn in (lib.roi_pool_stage_bf16, lib.roi_pool_stage_f32):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.roi_pool_block_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.roi_pool_block_shape.restype = None


def _bind_bwd(lib: ctypes.CDLL) -> None:
    for fn in (lib.roi_pool_bwd_bf16, lib.roi_pool_bwd_f32,
               lib.roi_pool_bwd_wide_bf16, lib.roi_pool_bwd_wide_f32):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


KERNEL = CudaLibrary("roi_pool_fwd", _bind)
BWD_KERNEL = CudaLibrary("roi_pool_bwd", _bind_bwd)


def _check_cuda_inputs(feat, rois, mask, pooled):
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool: feat on {feat.device} is neither a CPU "
                         "tensor (plain path) nor a CUDA tensor (kernel)")
    if pooled != POOLED:
        raise ValueError(f"roi_pool kernel pools {POOLED}x{POOLED}, "
                         f"not {pooled}x{pooled}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_pool kernel takes f32 or bf16, not {feat.dtype}")
    if feat.dim() != 4 or not feat.is_contiguous():
        raise ValueError("roi_pool kernel takes a contiguous NHWC feat "
                         f"[B, H, W, C], got shape {tuple(feat.shape)}")
    b, _, _, c = feat.shape
    if c % 2 or feat.data_ptr() % 8:
        raise ValueError("roi_pool kernel reads channel pairs: C must be "
                         f"even and feat 8-byte aligned (C={c})")
    _check_rois_mask(rois, mask, b, feat.device)


def _check_rois_mask(rois, mask, b, device):
    if (rois.dtype != torch.float32 or rois.dim() != 3
            or rois.shape[0] != b or rois.shape[2] != 4
            or not rois.is_contiguous() or rois.device != device):
        raise ValueError("roi_pool kernel takes contiguous f32 rois "
                         f"[B, P, 4] on {device}")
    if (mask.dtype != torch.bool or tuple(mask.shape) != tuple(rois.shape[:2])
            or not mask.is_contiguous() or mask.device != device):
        raise ValueError("roi_pool kernel takes a contiguous bool mask "
                         f"[B, P] on {device}")


def _check_vectors(name, t, c):
    """The fwd and bwd kernels move 8 channels at a time, 16-byte aligned."""
    if c % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} kernel moves 8 channels at a time: C must "
                         f"be a multiple of 8 and the tensor 16-byte aligned "
                         f"(C={c})")


def _launch_fwd(feat, rois, mask, spatial_scale, pooled, argmax):
    """``argmax``: None (the eval forward) or the codes' dtype."""
    _check_cuda_inputs(feat, rois, mask, pooled)
    b, h, w, c = feat.shape
    _check_vectors("roi_pool", feat, c)
    p = rois.shape[1]
    out = torch.empty((b, p, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    codes = (None if argmax is None else
             torch.empty(out.shape, dtype=argmax, device=feat.device))
    lib = KERNEL.get()
    fn = getattr(lib, "roi_pool_fwd_"
                      f"{'wide_' if argmax == torch.int32 else ''}"
                      f"{'bf16' if feat.dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), rois.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), None if codes is None else codes.data_ptr(),
                 b, p, h, w, c, float(spatial_scale), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_fwd launch failed: cudaError_t {err}")
    return out, codes


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
             spatial_scale: float, pooled: int = POOLED) -> torch.Tensor:
    """Batched RoI max pooling: feat [B, H, W, C] (NHWC), rois [B, P, 4],
    mask [B, P] -> [B, P, pooled, pooled, C].

    CPU tensors take ``roi_pool_plain``. CUDA tensors launch the kernel
    without the argmax on the current stream (any map and roi size; f32 or
    bf16, C a multiple of 8) or raise; each launch adds one to
    ``roi_pool.launches``.
    """
    if feat.device.type == "cpu":
        return roi_pool_plain(feat, rois, mask, spatial_scale, pooled)
    out, _ = _launch_fwd(feat, rois, mask, spatial_scale, pooled, None)
    roi_pool.launches += 1
    return out


roi_pool.launches = 0


def roi_pool_argmax(feat: torch.Tensor, rois: torch.Tensor,
                    mask: torch.Tensor, spatial_scale: float,
                    pooled: int = POOLED, level: Optional[str] = None):
    """The training forward: (``roi_pool``'s output, the argmax codes [B,
    P, pooled, pooled, C]; see the module docstring), int16 or int32 by
    ``code_dtype(H, W)``, which names ``level`` (an FPN level) if it
    raises.

    CPU tensors take ``roi_pool_argmax_plain``. CUDA tensors launch the
    kernel with the argmax from the same scan (its int16 or int32
    instantiation), or raise; each launch adds one to
    ``roi_pool_argmax.launches``, and an int32 one also to
    ``roi_pool_argmax.launches_wide``.
    """
    dtype = code_dtype(*feat.shape[1:3], level)
    if feat.device.type == "cpu":
        return roi_pool_argmax_plain(feat, rois, mask, spatial_scale, pooled)
    out = _launch_fwd(feat, rois, mask, spatial_scale, pooled, dtype)
    roi_pool_argmax.launches += 1
    roi_pool_argmax.launches_wide += dtype == torch.int32
    return out


roi_pool_argmax.launches = roi_pool_argmax.launches_wide = 0


def roi_pool_backward(argmax: torch.Tensor, rois: torch.Tensor,
                      mask: torch.Tensor, grad: torch.Tensor,
                      spatial_scale: float, map_hw,
                      pooled: int = POOLED) -> torch.Tensor:
    """ROIPool backward from the training forward's argmax: argmax (the
    codes of ``code_dtype(H, W)``) and grad [B, P, pooled, pooled, C],
    map_hw (H, W) -> d feat [B, H, W, C] in grad's dtype.

    CPU tensors take ``roi_pool_backward_argmax_plain``. CUDA tensors
    launch the kernel on the current stream, which writes every cell of d
    feat once, or raise; each launch adds one to
    ``roi_pool_backward.launches``, and one from int32 codes also to
    ``roi_pool_backward.launches_wide``.
    """
    codes_dtype = code_dtype(*map_hw)
    if grad.device.type == "cpu":
        return roi_pool_backward_argmax_plain(argmax, rois, mask, grad,
                                              spatial_scale, map_hw, pooled)
    dfeat = _launch_bwd(argmax, rois, mask, grad, spatial_scale, map_hw,
                        pooled, codes_dtype)
    roi_pool_backward.launches += 1
    roi_pool_backward.launches_wide += codes_dtype == torch.int32
    return dfeat


roi_pool_backward.launches = roi_pool_backward.launches_wide = 0


def _launch_bwd(argmax, rois, mask, grad, spatial_scale, map_hw, pooled,
                codes_dtype):
    """The backward kernel's instantiation for ``codes_dtype`` (argmax's
    dtype must be it), after the checks."""
    h, w = map_hw
    if grad.device.type != "cuda":
        raise ValueError(f"roi_pool_backward: grad on {grad.device} is "
                         "neither a CPU tensor (plain path) nor a CUDA "
                         "tensor (kernel)")
    if pooled != POOLED:
        raise ValueError(f"roi_pool kernel pools {POOLED}x{POOLED}, "
                         f"not {pooled}x{pooled}")
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_pool kernel takes f32 or bf16, not {grad.dtype}")
    b, p = rois.shape[:2]
    c = grad.shape[-1]
    shape = (b, p, pooled, pooled, c)
    for name, t, dtype in (("grad", grad, grad.dtype),
                           ("argmax", argmax, codes_dtype)):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != grad.device):
            raise ValueError(f"roi_pool backward kernel takes a contiguous "
                             f"{name} {list(shape)} {dtype} on {grad.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
        _check_vectors("roi_pool_bwd", t, c)
    _check_rois_mask(rois, mask, b, grad.device)
    dfeat = torch.empty((b, h, w, c), dtype=grad.dtype, device=grad.device)
    lib = BWD_KERNEL.get()
    fn = getattr(lib, "roi_pool_bwd_"
                      f"{'wide_' if codes_dtype == torch.int32 else ''}"
                      f"{'bf16' if grad.dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = fn(argmax.data_ptr(), rois.data_ptr(), mask.data_ptr(),
                 grad.data_ptr(), dfeat.data_ptr(), b, p, h, w, c,
                 float(spatial_scale), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_bwd launch failed: cudaError_t {err}")
    return dfeat


class RoIPoolFunction(torch.autograd.Function):
    """``roi_pool`` forward; when a gradient is needed
    (``torch.is_grad_enabled()`` and ``feat.requires_grad``, decided in
    ``apply``) the training forward ``roi_pool_argmax``, whose argmax
    (int16, or int32 past 65535 map cells) is saved and routes the
    cotangent in ``roi_pool_backward``. Under ``no_grad`` nothing is saved.
    rois and mask get no gradient. ``level`` names the FPN level in the
    map-size error."""

    @classmethod
    def apply(cls, feat, rois, mask, spatial_scale, level=None):
        return super().apply(feat, rois, mask, spatial_scale,
                             torch.is_grad_enabled() and feat.requires_grad,
                             level)

    @staticmethod
    def forward(ctx, feat, rois, mask, spatial_scale, keep_argmax, level):
        if not keep_argmax:
            return roi_pool(feat, rois, mask, spatial_scale)
        out, argmax = roi_pool_argmax(feat, rois, mask, spatial_scale,
                                      level=level)
        ctx.save_for_backward(argmax, rois, mask)
        ctx.spatial_scale = spatial_scale
        ctx.map_hw = tuple(feat.shape[1:3])
        return out

    @staticmethod
    def backward(ctx, grad):
        argmax, rois, mask = ctx.saved_tensors
        dfeat = roi_pool_backward(argmax, rois, mask, grad.contiguous(),
                                  ctx.spatial_scale, ctx.map_hw)
        return dfeat, None, None, None, None, None
