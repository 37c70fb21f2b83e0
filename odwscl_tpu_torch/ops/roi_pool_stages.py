"""7x7 RoI max pooling cut by stage: the ROIPool forward's stage profiler.

Counterpart of the TPU profiling kernels built from the blocks of
``odwscl_tpu/ops/roi_pool_pallas.py``: ``tools/profile_pool.py``
(``_fwd_rows_only``, ``_fwd_cols_only``) and
``tools/profile_pool_stages.py`` (``make_kernel``). They time parts of the
exact forward apart.

Each roi's column window is the TPU kernel's (``_roi_meta``,
``_padded_dims``, ``_cws``): an 8-aligned start ``xs`` and a width ``cw``
of 24, 40 or 88 columns or the padded map width. The TPU reads the map as
if zero-padded to [round_up(H, 8), max(round_up(W, 8), 24)].

Stages (masked rois give 0 in every stage):

- ``write``: 0; the output traffic alone;
- ``rows``: out[ph, pw] = max over the rows of row bin ph and the columns
  [xs, xs + 8); 0 where row bin ph is empty (``make_kernel``'s rows);
- ``rows_col0``: the same over column xs alone (``_fwd_rows_only``);
- ``cols``: out[ph, pw] = max over the columns of column bin pw inside
  [xs, xs + cw) of map row ph (rows 0..6, ``_fwd_cols_only``'s strip
  fill); 0 where that set is empty. It also stands for ``make_kernel``'s
  cols, whose TPU output is undefined (it reduces scratch that nothing
  wrote);
- ``full``: the exact forward, ``roi_pool_plain``'s bins.

``stage_edges`` gives each stage as a rectangle per output bin on the
unpadded map, plus a flag where the zero pad enters (only ``rows``
columns at or beyond W): that is the kernel's spec, and
``roi_pool_stage_plain`` is built on it.

``roi_pool_stage`` dispatches on the device as ``roi_pool`` does: CPU
tensors take ``roi_pool_stage_plain``; CUDA tensors launch the forward
kernel (``csrc/roi_pool_fwd.cu``) instantiated for the stage, which runs
the forward's own loop over the stage's rectangles, or raise.
``roi_pool_stage.launches`` counts launches per stage. ``stage_work`` and
``stage_bound`` count the bytes and comparisons that a stage, or the
forward kernel, needs on given inputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.profiling import F32_OPS_PER_S, MEM_BYTES_PER_S, card_rate
from .roi_pool import (KERNEL, POOLED, _check_cuda_inputs, _check_vectors,
                       pool_rects, roi_bin_edges)

STAGES = ("write", "rows", "rows_col0", "cols", "full")
COLUMN_WINDOWS = (24, 40, 88)
ROW_SPANS = {"rows": 8, "rows_col0": 1}   # columns from xs a rows stage reads


class StagePlan(NamedTuple):
    """Each roi's window start and width (int32 [B, P] on the feature's
    device; width 0 for a masked roi)."""
    xs: torch.Tensor
    cw: torch.Tensor


def padded_dims(h: int, w: int):
    """The TPU kernel's zero-padded map size (hp, wp)."""
    return max(-(-h // 8) * 8, 8), max(-(-w // 8) * 8, COLUMN_WINDOWS[0])


def tpu_windows(rois: torch.Tensor, mask: torch.Tensor, spatial_scale: float,
                h: int, w: int):
    """Each roi's column window as the TPU kernel plans it: (xs, cw), int32
    [B, P]. The narrowest of the 24/40/88-column windows narrower than the
    padded width that holds the roi's visible columns, starting at x1
    aligned down to 8 and kept inside the padded map; else the whole
    padded width from 0. Masked rois get (0, 0)."""
    _, wp = padded_dims(h, w)
    cells = torch.floor(rois.to(torch.float32) * spatial_scale + 0.5)
    x1, x2 = cells[..., 0].to(torch.int32), cells[..., 2].to(torch.int32)
    aligned = x1.clamp(0, wp - 1) // 8 * 8
    visible_hi = (x2 + 1).clamp(0, w)
    xs = torch.zeros_like(x1)
    cw = torch.full_like(x1, wp)
    for win in reversed(COLUMN_WINDOWS):          # the narrowest wins
        if win >= wp:
            continue
        start = aligned.clamp(0, wp - win)
        fits = visible_hi - start <= win
        xs = torch.where(fits, start, xs)
        cw = torch.where(fits, torch.full_like(cw, win), cw)
    zero = torch.zeros_like(xs)
    return torch.where(mask, xs, zero), torch.where(mask, cw, zero)


def stage_plan(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
               spatial_scale: float) -> StagePlan:
    """The windows of these rois on feat's map, made on the rois' device
    with no read-back to the host; a caller that launches several stages
    on the same rois plans once."""
    _, h, w, _ = feat.shape
    xs, cw = tpu_windows(rois, mask, spatial_scale, h, w)
    return StagePlan(xs.contiguous(), cw.contiguous())


def stage_edges(rois: torch.Tensor, mask: torch.Tensor, spatial_scale: float,
                h: int, w: int, stage: str):
    """The rectangle of every output bin of ``stage`` on the unpadded [h,
    w] map: (row_lo, row_hi, col_lo, col_hi), [B * P, 7] each (bin (ph, pw)
    covers rows [row_lo, row_hi)[:, ph] x columns [col_lo, col_hi)[:, pw],
    clipped to the map), and ``pad`` [B * P] bool: the roi's rectangles
    also reach the zero pad, so a non-empty one's max starts at +0.

    - ``write``: every rectangle empty;
    - ``rows``, ``rows_col0``: row bin ph x columns [xs, xs + 8) or [xs,
      xs + 1) clipped to W, for every pw; ``pad`` where those columns pass
      W;
    - ``cols``: row ph (clipped to H: a row of the pad holds only zeros,
      which an empty rectangle gives too) x column bin pw inside [xs, xs +
      cw);
    - ``full``: the forward's bins (``roi_bin_edges``).
    """
    _check_stage(stage)
    n = rois.shape[0] * rois.shape[1]
    dev = rois.device
    hs, he, ws, we = roi_bin_edges(rois, spatial_scale, POOLED, h, w)
    pad = torch.zeros(n, dtype=torch.bool, device=dev)
    if stage == "write":
        zero = torch.zeros_like(hs)
        return zero, zero, zero, zero, pad
    if stage == "full":
        return hs, he, ws, we, pad
    xs, cw = (t.reshape(n).long()
              for t in tpu_windows(rois, mask, spatial_scale, h, w))
    if stage == "cols":
        rows = torch.arange(POOLED, device=dev).expand(n, POOLED)
        return (rows.clamp(max=h), (rows + 1).clamp(max=h),
                torch.maximum(ws, xs[:, None]),
                torch.minimum(we, (xs + cw)[:, None]), pad)
    span = ROW_SPANS[stage]
    col_lo = xs.clamp(max=w)[:, None].expand(n, POOLED)
    col_hi = (xs + span).clamp(max=w)[:, None].expand(n, POOLED)
    return hs, he, col_lo, col_hi, xs + span > w


def _check_stage(stage):
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")


def roi_pool_stage_plain(feat: torch.Tensor, rois: torch.Tensor,
                         mask: torch.Tensor, spatial_scale: float,
                         stage: str) -> torch.Tensor:
    """Plain torch version of each stage: feat [B, H, W, C], rois [B, P, 4]
    f32, mask [B, P] bool -> [B, P, 7, 7, C] in feat's dtype. The max of
    each ``stage_edges`` rectangle, started at +0 where ``pad``."""
    _check_stage(stage)
    b, h, w, c = feat.shape
    p = rois.shape[1]
    if b * p == 0:
        return torch.zeros((b, p, POOLED, POOLED, c), dtype=feat.dtype,
                           device=feat.device)
    *rects, pad = stage_edges(rois, mask, spatial_scale, h, w, stage)
    out = pool_rects(feat, mask, *rects)       # empty and masked bins: 0
    out = torch.where(pad[:, None, None, None], out.clamp(min=0), out)
    return out.reshape(b, p, POOLED, POOLED, c)


def _cells_covered(b, h, w, img, r0, r1, c0, c1):
    """Distinct cells of a [b, h, w] map inside the union of the rectangles
    rows [r0, r1) x columns [c0, c1) of images ``img`` (all [N]), counted
    on a 2-D difference array."""
    r0, r1, c0, c1 = r0.clamp(0, h), r1.clamp(0, h), c0.clamp(0, w), \
        c1.clamp(0, w)
    live = (r1 > r0) & (c1 > c0)
    img, r0, r1, c0, c1 = (t[live] for t in (img, r0, r1, c0, c1))
    diff = torch.zeros((b, h + 1, w + 1), dtype=torch.int32,
                       device=img.device)
    for r, col, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1),
                         (r1, c1, 1)):
        diff.index_put_((img, r, col), torch.full_like(
            r, sign, dtype=torch.int32), accumulate=True)
    return int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())


def stage_work(name, feat, rois, mask, spatial_scale):
    """(bytes, comparisons) that ``name`` (a stage, or ``roi_pool`` for
    kernel #1) needs on these inputs: the output written once; the mask,
    the rois and each map cell the output depends on read once (a cell of
    the zero pad is no load); one comparison per value a bin's max
    reduces. Masked rois read nothing."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    isz = feat.element_size()
    nbytes = b * p * POOLED * POOLED * c * isz + mask.numel()
    if name == "write":
        return nbytes, 0
    n = b * p
    live = mask.reshape(n)
    hs, he, ws, we = roi_bin_edges(rois, spatial_scale, POOLED, h, w)
    xs, cw = (t.reshape(n).long()
              for t in tpu_windows(rois, mask, spatial_scale, h, w))
    rows = (he - hs).clamp(min=0).sum(1)
    r0, r1 = hs[:, 0], he[:, -1]
    if name in ("roi_pool", "full"):
        c0, c1 = ws[:, 0], we[:, -1]
        per_roi = rows * (we - ws).clamp(min=0).sum(1)
    elif name in ROW_SPANS:
        span = ROW_SPANS[name]
        c0, c1 = xs, xs + span
        per_roi = rows * span
    else:                                              # cols
        r0, r1 = torch.zeros_like(r0), torch.full_like(r1, POOLED)
        lo = torch.maximum(ws, xs[:, None])
        hi = torch.minimum(we, (xs + cw)[:, None])
        c0, c1 = lo[:, 0], hi[:, -1]
        per_roi = POOLED * (hi - lo).clamp(min=0).sum(1)
    img = torch.arange(b, device=feat.device).repeat_interleave(p)
    cells = _cells_covered(b, h, w, img[live], r0[live], r1[live], c0[live],
                           c1[live])
    nbytes += rois.numel() * 4 + cells * c * isz
    return nbytes, int(per_roi[live].sum()) * c


def stage_bound(name, feat, rois, mask, spatial_scale, card):
    """(bound ms, "bytes" or "operations", bytes, comparisons) on ``card``
    (its name) at the published memory rate and f32 rate."""
    nbytes, ops = stage_work(name, feat, rois, mask, spatial_scale)
    bytes_ms = nbytes / card_rate(card, MEM_BYTES_PER_S) * 1e3
    ops_ms = ops / card_rate(card, F32_OPS_PER_S) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


def block_shape(dtype: torch.dtype) -> dict:
    """The launch shape of the forward kernel (and so of every stage) for
    ``dtype``, as the built library reports it: channels, rois and threads
    per block."""
    shape = (ctypes.c_int * 3)()
    KERNEL.get().roi_pool_block_shape(torch.finfo(dtype).bits // 8, shape)
    return dict(zip(("channel_tile", "rois_per_block", "threads"), shape))


def _check_plan(plan, feat, rois):
    b, p = rois.shape[:2]
    for t in plan:
        if (t.dtype != torch.int32 or tuple(t.shape) != (b, p)
                or not t.is_contiguous() or t.device != feat.device):
            raise ValueError("roi_pool_stage plan: xs and cw must be "
                             f"contiguous int32 [{b}, {p}] on {feat.device}")


def roi_pool_stage(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
                   spatial_scale: float, stage: str,
                   plan: StagePlan | None = None) -> torch.Tensor:
    """One stage of the RoI max pooling (see the module docstring): feat
    [B, H, W, C] (NHWC), rois [B, P, 4], mask [B, P] -> [B, P, 7, 7, C].

    CPU tensors take ``roi_pool_stage_plain``. CUDA tensors launch the
    forward kernel's stage instantiation on the current stream (f32 or
    bf16, C a multiple of 8, feat 16-byte aligned) with ``plan`` (from
    ``stage_plan`` on the same rois, made here if None) or raise; each
    launch adds one to ``roi_pool_stage.launches[stage]``.
    """
    _check_stage(stage)
    if feat.device.type == "cpu":
        return roi_pool_stage_plain(feat, rois, mask, spatial_scale, stage)
    _check_cuda_inputs(feat, rois, mask, POOLED)
    b, h, w, c = feat.shape
    _check_vectors("roi_pool_stage", feat, c)
    if plan is None:
        plan = stage_plan(feat, rois, mask, spatial_scale)
    _check_plan(plan, feat, rois)
    p = rois.shape[1]
    out = torch.empty((b, p, POOLED, POOLED, c), dtype=feat.dtype,
                      device=feat.device)
    lib = KERNEL.get()
    fn = (lib.roi_pool_stage_bf16 if feat.dtype == torch.bfloat16
          else lib.roi_pool_stage_f32)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), rois.data_ptr(), mask.data_ptr(),
                 plan.xs.data_ptr(), plan.cw.data_ptr(), out.data_ptr(),
                 b, p, h, w, c, float(spatial_scale), STAGES.index(stage),
                 stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_stage[{stage}] launch failed: "
                           f"cudaError_t {err}")
    roi_pool_stage.launches[stage] += 1
    return out


roi_pool_stage.launches = dict.fromkeys(STAGES, 0)
