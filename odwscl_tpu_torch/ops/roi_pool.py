"""7x7 RoI max pooling with the reference CUDA kernel's exact semantics.

Counterpart of ``odwscl_tpu/ops/roi_pool.py`` (``roi_pool_numpy``) and of
the Pallas forward ``odwscl_tpu/ops/roi_pool_pallas.py:_fwd_kernel``:

- roi edges are scaled, then rounded half up: ``floor(x * scale + 0.5)``
  in f32;
- malformed rois are forced to 1x1 (``max(end - start + 1, 1)``);
- bin (ph, pw) covers rows ``[floor(ph*h/7), ceil((ph+1)*h/7))`` offset by
  the roi start and clipped to the map, in integer arithmetic;
- empty bins and masked rois output 0.

``roi_pool`` dispatches on the tensor's device: a CPU tensor goes to
``roi_pool_plain``; a CUDA tensor goes to the hand-written kernel
``csrc/roi_pool_fwd.cu`` or raises. ``roi_pool.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary

POOLED = 7

# bytes of gathered roi windows held at once by the plain version
_PLAIN_CHUNK_BYTES = 1 << 28


def _bin_edges(start: torch.Tensor, length: torch.Tensor, pooled: int,
               limit: int):
    """Per-bin [lo, hi) cell ranges, offset and clipped: [..., pooled]."""
    k = torch.arange(pooled, device=start.device)
    lo = k * length[..., None] // pooled + start[..., None]
    hi = ((k + 1) * length[..., None] + pooled - 1) // pooled + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_pool_plain(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
                   spatial_scale: float, pooled: int = POOLED) -> torch.Tensor:
    """Plain torch RoI max pooling, exact for every roi size.

    feat [B, H, W, C]; rois [B, P, 4] xyxy in image pixels (f32); mask
    [B, P] bool -> [B, P, pooled, pooled, C] in feat's dtype.

    Each roi's cell window (its clipped extent, padded to the largest in
    the batch) is gathered in chunks, reduced over rows into the row bins,
    then over columns into the column bins. The max of a rectangle is the
    max over its columns of the max over its rows, so this is exact.
    """
    b, h, w, c = feat.shape
    p = rois.shape[1]
    dev = feat.device
    out = torch.zeros((b * p, pooled, pooled, c), dtype=feat.dtype, device=dev)
    if b * p == 0:
        return out.reshape(b, p, pooled, pooled, c)

    cells = torch.floor(rois.to(torch.float32).reshape(b * p, 4) * spatial_scale
                        + 0.5).to(torch.int64)
    x1, y1, x2, y2 = cells.unbind(-1)
    roi_w = (x2 - x1 + 1).clamp(min=1)
    roi_h = (y2 - y1 + 1).clamp(min=1)
    hs, he = _bin_edges(y1, roi_h, pooled, h)
    ws, we = _bin_edges(x1, roi_w, pooled, w)

    # window of cells that any bin of the roi can touch
    r0, c0 = y1.clamp(0, h), x1.clamp(0, w)
    mh = max(1, int(((y1 + roi_h).clamp(0, h) - r0).max()))
    mw = max(1, int(((x1 + roi_w).clamp(0, w) - c0).max()))
    img = torch.arange(b, device=dev).repeat_interleave(p)
    flat = feat.reshape(b * h * w, c)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=dev)
    per_roi = mh * mw * c * feat.element_size() * 3
    chunk = max(1, _PLAIN_CHUNK_BYTES // per_roi)

    for s in range(0, b * p, chunk):
        e = min(s + chunk, b * p)
        rows = r0[s:e, None] + torch.arange(mh, device=dev)       # [n, mh]
        cols = c0[s:e, None] + torch.arange(mw, device=dev)       # [n, mw]
        idx = ((img[s:e, None, None] * h + rows.clamp(max=h - 1)[:, :, None])
               * w + cols.clamp(max=w - 1)[:, None, :])
        win = flat.index_select(0, idx.reshape(-1)).reshape(e - s, mh, mw, c)
        row_in = ((rows[:, None, :] >= hs[s:e, :, None])
                  & (rows[:, None, :] < he[s:e, :, None]))         # [n, 7, mh]
        col_in = ((cols[:, None, :] >= ws[s:e, :, None])
                  & (cols[:, None, :] < we[s:e, :, None]))         # [n, 7, mw]
        for ph in range(pooled):
            rowmax = torch.where(row_in[:, ph, :, None, None], win,
                                 neg).amax(dim=1)                  # [n, mw, C]
            out[s:e, ph] = torch.where(col_in[:, :, :, None],
                                       rowmax[:, None], neg).amax(dim=2)

    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]       # [BP, 7, 7]
    drop = empty | ~mask.reshape(b * p)[:, None, None]
    out = torch.where(drop[..., None], torch.zeros((), dtype=feat.dtype,
                                                   device=dev), out)
    return out.reshape(b, p, pooled, pooled, c)


def _bind(lib: ctypes.CDLL) -> None:
    for fn in (lib.roi_pool_fwd_bf16, lib.roi_pool_fwd_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


KERNEL = CudaLibrary("roi_pool_fwd", _bind)


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
