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

``roi_pool`` and ``roi_pool_backward`` dispatch on the tensor's device: a
CPU tensor goes to the plain version; a CUDA tensor goes to the
hand-written kernel (``csrc/roi_pool_fwd.cu``, ``csrc/roi_pool_bwd.cu``)
or raises. Their ``launches`` attributes count kernel launches.
``RoIPoolFunction`` wraps the two in a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary

POOLED = 7

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
    row-major order; the sums are f32 (``index_add_``), then cast.

    Per row bin, every window column keeps its max over the bin's rows and
    the first row that reaches it (``argmax`` returns the first). Per
    column bin, among the columns that reach the bin max, the first
    row-major cell is the one with the least (row, column) key.
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
    xs = torch.arange(geo.mw, device=dev)[None, :, None]
    big = geo.mh * geo.mw
    for s, e, win, idx, row_in, col_in in geo.chunks():
        n = e - s
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
                cell = torch.gather(idx.reshape(n, -1), 1,
                                    key.clamp(max=big - 1))        # [n, C]
                dfeat.index_add_(0, (cell * c + ch).reshape(-1),
                                 torch.where(live, g[s:e, ph, pw],
                                             0.0).reshape(-1))
    return dfeat.reshape(b, h, w, c).to(feat.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.roi_pool_fwd_bf16, lib.roi_pool_fwd_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    for fn in (lib.roi_pool_bwd_bf16, lib.roi_pool_bwd_f32):
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
    if (rois.dtype != torch.float32 or rois.dim() != 3
            or rois.shape[0] != b or rois.shape[2] != 4
            or not rois.is_contiguous() or rois.device != feat.device):
        raise ValueError("roi_pool kernel takes contiguous f32 rois "
                         f"[B, P, 4] on {feat.device}")
    if (mask.dtype != torch.bool or tuple(mask.shape) != tuple(rois.shape[:2])
            or not mask.is_contiguous() or mask.device != feat.device):
        raise ValueError("roi_pool kernel takes a contiguous bool mask "
                         f"[B, P] on {feat.device}")


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
             spatial_scale: float, pooled: int = POOLED) -> torch.Tensor:
    """Batched RoI max pooling: feat [B, H, W, C] (NHWC), rois [B, P, 4],
    mask [B, P] -> [B, P, pooled, pooled, C].

    CPU tensors take ``roi_pool_plain``. CUDA tensors launch the kernel on
    the current stream (any map and roi size; f32 or bf16, C even) or
    raise; each launch adds one to ``roi_pool.launches``.
    """
    if feat.device.type == "cpu":
        return roi_pool_plain(feat, rois, mask, spatial_scale, pooled)
    _check_cuda_inputs(feat, rois, mask, pooled)
    b, h, w, c = feat.shape
    p = rois.shape[1]
    out = torch.empty((b, p, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    lib = KERNEL.get()
    fn = (lib.roi_pool_fwd_bf16 if feat.dtype == torch.bfloat16
          else lib.roi_pool_fwd_f32)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), rois.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), b, p, h, w, c, float(spatial_scale), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_fwd launch failed: cudaError_t {err}")
    roi_pool.launches += 1
    return out


roi_pool.launches = 0


def roi_pool_backward(feat: torch.Tensor, rois: torch.Tensor,
                      mask: torch.Tensor, grad: torch.Tensor,
                      spatial_scale: float,
                      pooled: int = POOLED) -> torch.Tensor:
    """ROIPool backward: grad [B, P, pooled, pooled, C] -> d feat
    [B, H, W, C] in feat's dtype.

    CPU tensors take ``roi_pool_backward_plain``. CUDA tensors zero an f32
    scratch, launch the kernel on the current stream (it accumulates with
    atomics) and cast, or raise; each launch adds one to
    ``roi_pool_backward.launches``.
    """
    if feat.device.type == "cpu":
        return roi_pool_backward_plain(feat, rois, mask, grad, spatial_scale,
                                       pooled)
    _check_cuda_inputs(feat, rois, mask, pooled)
    b, h, w, c = feat.shape
    p = rois.shape[1]
    if (grad.dtype != feat.dtype or grad.device != feat.device
            or tuple(grad.shape) != (b, p, pooled, pooled, c)
            or not grad.is_contiguous() or grad.data_ptr() % 8):
        raise ValueError("roi_pool backward kernel takes a contiguous grad "
                         f"[B, P, {pooled}, {pooled}, C] in {feat.dtype} on "
                         f"{feat.device}, got {tuple(grad.shape)} "
                         f"{grad.dtype} on {grad.device}")
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=feat.device)
    lib = BWD_KERNEL.get()
    fn = (lib.roi_pool_bwd_bf16 if feat.dtype == torch.bfloat16
          else lib.roi_pool_bwd_f32)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), rois.data_ptr(), mask.data_ptr(),
                 grad.data_ptr(), dfeat.data_ptr(), b, p, h, w, c,
                 float(spatial_scale), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_bwd launch failed: cudaError_t {err}")
    roi_pool_backward.launches += 1
    return dfeat.to(feat.dtype)


roi_pool_backward.launches = 0


class RoIPoolFunction(torch.autograd.Function):
    """``roi_pool`` forward, ``roi_pool_backward`` backward. The argmax is
    recomputed in the backward from the saved (feat, rois, mask), as the
    JAX custom_vjp does; rois and mask get no gradient."""

    @staticmethod
    def forward(ctx, feat, rois, mask, spatial_scale):
        ctx.save_for_backward(feat, rois, mask)
        ctx.spatial_scale = spatial_scale
        return roi_pool(feat, rois, mask, spatial_scale)

    @staticmethod
    def backward(ctx, grad):
        feat, rois, mask = ctx.saved_tensors
        dfeat = roi_pool_backward(feat, rois, mask, grad.contiguous(),
                                  ctx.spatial_scale)
        return dfeat, None, None, None

