"""The reference's primitives: box geometry, compaction, greedy NMS,
DropBlock and the noise view, the loss terms and R x R ROIPool.

Frozen copies of the port's plain versions (``structures/boxes.py``,
``losses/compact.py``, ``ops/nms.py``, ``ops/dropblock.py``,
``ops/losses.py``, the bin edges of ``ops/roi_pool.py``), so that the
yardstick stays put when the program changes. ROIPool is a plain
version of its own with the port's semantics (the max of each bin; the
backward gives each bin's cotangent whole to its first row-major
maximum): the rows of a bin are reduced by range-maximum tables instead
of a scan of each roi's window, which keeps the reference's time at the
training shape to a fraction of a second.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

TO_REMOVE = 1.0  # Detectron pixel convention: width = x2 - x1 + 1
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
_IOU_CHUNK_ELEMS = 1 << 27
# bytes of the temporaries of a chunk of rois held at once by the pooling
_POOL_CHUNK_BYTES = 1 << 31
POOLED = 7


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area with the +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, +1 convention. [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def clip_to_image(boxes: torch.Tensor, image_size_hw: torch.Tensor
                  ) -> torch.Tensor:
    """Clip xyxy boxes to [0, size-1]; ``image_size_hw`` broadcasts against
    the boxes' batch dims (shape ``boxes.shape[:-1] + (2,)`` or a prefix)."""
    h = image_size_hw[..., 0]
    w = image_size_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w - TO_REMOVE)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h - TO_REMOVE)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w - TO_REMOVE)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                               5.0, 5.0)
                 ) -> torch.Tensor:
    """(dx, dy, dw, dh) regression targets of ``reference_boxes`` relative to
    ``proposals``, both [..., 4] xyxy."""
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    wx, wy, ww, wh = weights
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float] = (10.0, 10.0,
                                                               5.0, 5.0)
                 ) -> torch.Tensor:
    """rel_codes [..., P, 4*K], boxes [..., P, 4] -> [..., P, 4*K]; the
    x2/y2 '-1' asymmetry follows the reference box coder."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    shape = rel_codes.shape
    codes = rel_codes.reshape(*shape[:-1], -1, 4)  # [..., P, K, 4]
    wx, wy, ww, wh = weights
    dx = codes[..., 0] / wx
    dy = codes[..., 1] / wy
    dw = (codes[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (codes[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack([
        pred_cx - 0.5 * pred_w,
        pred_cy - 0.5 * pred_h,
        pred_cx + 0.5 * pred_w - 1.0,
        pred_cy + 0.5 * pred_h - 1.0,
    ], dim=-1)
    return out.reshape(shape)


def first_true(mask: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [..., L] bool -> (idx [..., cap] int64 with -1 fill, count [...]
    of True entries, including those past ``cap``)."""
    lead, length = mask.shape[:-1], mask.shape[-1]
    m = mask.reshape(-1, length)
    rank = m.long().cumsum(dim=-1) - 1
    sel = m & (rank < cap)
    pos = torch.arange(length, device=mask.device).expand_as(m)
    out = torch.full((m.shape[0], cap + 1), -1, dtype=torch.long,
                     device=mask.device)
    # unselected entries all land in the extra column, which is dropped
    out.scatter_(1, torch.where(sel, rank, cap), torch.where(sel, pos, -1))
    return (out[:, :cap].reshape(*lead, cap),
            m.sum(dim=-1).reshape(lead))


def _iou_no_offset(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with torchvision conventions (no +1)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     mask: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over any number of leading batch axes.

    boxes [..., P, 4], scores [..., P], mask [..., P] bool -> keep [..., P]
    in the original order. Masked entries are never kept and suppress
    nothing.
    """
    batch_shape = scores.shape[:-1]
    p = scores.shape[-1]
    boxes = boxes.reshape(-1, p, 4)
    scores = scores.reshape(-1, p)
    mask = mask.reshape(-1, p)
    n = scores.shape[0]

    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(mask, scores, neg_inf), dim=-1,
                          stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(n, p, 4))
    valid = torch.gather(mask, 1, order)

    upper = torch.ones(p, p, dtype=torch.bool, device=scores.device).triu(1)
    sup = torch.empty((n, p, p), dtype=torch.bool, device=scores.device)
    rows = max(1, _IOU_CHUNK_ELEMS // max(p * p, 1))
    for s in range(0, n, rows):
        e = min(s + rows, n)
        # sup[j, i]: kept j (earlier in score order) would suppress i
        sup[s:e] = ((_iou_no_offset(b[s:e], b[s:e]) > iou_threshold) & upper
                    & valid[s:e, :, None] & valid[s:e, None, :])

    keep = valid
    while True:
        suppressed = (sup & keep[:, :, None]).any(dim=1)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    out = torch.zeros_like(mask)
    out.scatter_(1, order, keep)
    return out.reshape(*batch_shape, p)


def dropblock_2d(x: torch.Tensor, drop_prob: float, block_size: int,
                 valid: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H, W, C] (NHWC) -> same shape. ``uniform`` [N, H, W] in [0, 1)
    replaces the draw from ``generator``."""
    if drop_prob == 0.0:
        return x
    n, h, w, _ = x.shape
    gamma = drop_prob / (block_size ** 2)
    if uniform is None:
        uniform = torch.rand((n, h, w), generator=generator, device=x.device)
    centers = (uniform < gamma).to(torch.float32)
    if block_size > 1:
        grown = F.max_pool2d(centers[:, None], block_size, stride=1,
                             padding=block_size // 2)[:, 0]
        if block_size % 2 == 0:
            grown = grown[:, :-1, :-1]
    else:
        grown = centers
    block_mask = (1.0 - grown).to(x.dtype)                   # 1 = keep
    if valid is None:
        total = torch.tensor(float(block_mask.numel()), dtype=x.dtype,
                             device=x.device)
        keep = block_mask.sum()
    else:
        v = valid.to(x.dtype)[:, None, None]
        total = v.sum() * (h * w)
        keep = (block_mask * v).sum()
    scale = total / keep.clamp(min=1.0)
    return x * block_mask[..., None] * scale


def noise_augment(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + N(0, 1) * x; ``normal`` (x's shape) replaces the draw."""
    if normal is None:
        normal = torch.randn(x.shape, generator=generator, device=x.device)
    return normal.to(x.dtype) * x + x


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def binary_cross_entropy(probs: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, each log term clamped at -100 as
    ``F.binary_cross_entropy`` does, so probabilities of exactly 0 or 1
    give a finite loss."""
    probs = probs.clamp(0.0, 1.0)
    log_p = torch.log(probs).clamp(min=-100.0)
    log_1mp = torch.log1p(-probs).clamp(min=-100.0)
    return -(targets * log_p + (1.0 - targets) * log_1mp)


def cross_entropy_with_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE with integer labels: logits [..., C], labels [...]."""
    logz = logits.amax(dim=-1, keepdim=True)
    logsumexp = logz[..., 0] + torch.log(torch.exp(logits - logz).sum(dim=-1))
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logsumexp - picked


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


def _row_tables(feat: torch.Tensor):
    """Range maxima over rows of ``feat`` [B, H, W, C]: for each level k,
    the max over rows [y, y + 2^k) and the first row that attains it,
    stacked as [K, B, H, W, C] (rows past H - 2^k hold -inf)."""
    b, h, w, c = feat.shape
    levels = max(1, h.bit_length())
    vals = torch.full((levels, b, h, w, c), float("-inf"), dtype=feat.dtype,
                      device=feat.device)
    rows = torch.empty((levels, b, h, w, c), dtype=torch.int32,
                       device=feat.device)
    vals[0] = feat
    rows[0] = torch.arange(h, dtype=torch.int32, device=feat.device)[
        None, :, None, None]
    for k in range(1, levels):
        half, n = 1 << (k - 1), h - (1 << k) + 1
        if n <= 0:
            break
        a, bb = vals[k - 1, :, :n], vals[k - 1, :, half:half + n]
        later = bb > a                      # a tie keeps the earlier row
        vals[k, :, :n] = torch.where(later, bb, a)
        rows[k, :, :n] = torch.where(later, rows[k - 1, :, half:half + n],
                                     rows[k - 1, :, :n])
    return vals, rows


def pool_bins(feat: torch.Tensor, rois: torch.Tensor, mask: torch.Tensor,
              spatial_scale: float, pooled: int = POOLED):
    """Plain R x R ROIPool with its routing: (output [B, P, R, R, C] in
    feat's dtype, the flat index b*H*W + y*W + x of each bin's first
    row-major maximum [B*P, R, R, C] (int64), whether each bin routes).

    A bin's row range is reduced by two lookups of the row range-maximum
    tables (``_row_tables``), its columns by a masked max over the roi's
    columns; among the columns that reach the bin's max, the first
    row-major cell is the least (row, column)."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    dev = feat.device
    n = b * p
    vals, rows = _row_tables(feat)
    hs, he, ws, we = roi_bin_edges(rois, spatial_scale, pooled, h, w)
    c0 = ws[:, 0]
    mw = max(1, int((we[:, -1] - c0).max())) if n else 1
    img = torch.arange(b, device=dev).repeat_interleave(p)
    live_roi = mask.reshape(n)
    out = torch.zeros((n, pooled, pooled, c), dtype=feat.dtype, device=dev)
    cell = torch.zeros((n, pooled, pooled, c), dtype=torch.int64, device=dev)
    live = torch.zeros((n, pooled, pooled, c), dtype=torch.bool, device=dev)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=dev)
    chunk = max(1, _POOL_CHUNK_BYTES // (pooled * mw * c * 24))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        cols = c0[s:e, None] + torch.arange(mw, device=dev)       # [m, mw]
        col_in = ((cols[:, None, :] >= ws[s:e, :, None])
                  & (cols[:, None, :] < we[s:e, :, None]))       # [m, R, mw]
        colc = cols.clamp(max=w - 1)
        im = img[s:e, None]
        for ph in range(pooled):
            lo, hi = hs[s:e, ph], he[s:e, ph]
            length = (hi - lo).clamp(min=1)
            k = torch.floor(torch.log2(length.to(torch.float64))).long()
            k = torch.minimum(k, torch.tensor(vals.shape[0] - 1, device=dev))
            r1 = lo.clamp(max=h - 1)
            r2 = (hi - (1 << k)).clamp(min=0, max=h - 1)
            v1 = vals[k[:, None], im, r1[:, None], colc]           # [m,mw,C]
            v2 = vals[k[:, None], im, r2[:, None], colc]
            first = torch.where(v2 > v1, rows[k[:, None], im, r2[:, None],
                                              colc],
                                rows[k[:, None], im, r1[:, None], colc])
            rowmax = torch.maximum(v1, v2)
            masked = torch.where(col_in[:, :, :, None], rowmax[:, None],
                                 neg)                          # [m,R,mw,C]
            binmax = masked.amax(dim=2)                         # [m, R, C]
            key = first.long()[:, None] * w + colc[:, None, :, None]
            key = torch.where(masked == binmax[:, :, None],
                              key, h * w).amin(dim=2)           # [m, R, C]
            ok = ((hi > lo)[:, None, None] & (we[s:e] > ws[s:e])[:, :, None]
                  & live_roi[s:e, None, None])
            out[s:e, ph] = torch.where(ok, binmax, torch.zeros(
                (), dtype=feat.dtype, device=dev))
            cell[s:e, ph] = img[s:e, None, None] * h * w + key.clamp(
                max=h * w - 1)
            live[s:e, ph] = ok.expand_as(binmax)
    return out.reshape(b, p, pooled, pooled, c), cell, live


class RoIPool(torch.autograd.Function):
    """ROIPool whose backward gives each bin's cotangent whole to the
    bin's first row-major maximum, summed in f32 (rois get no
    gradient)."""

    @staticmethod
    def forward(ctx, feat, rois, mask, spatial_scale, pooled):
        out, cell, live = pool_bins(feat, rois, mask, spatial_scale, pooled)
        ctx.save_for_backward(cell, live)
        ctx.shape, ctx.dtype = feat.shape, feat.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        cell, live = ctx.saved_tensors
        b, h, w, c = ctx.shape
        g = grad.reshape(cell.shape).to(torch.float32)
        ch = torch.arange(c, device=grad.device)
        dfeat = torch.zeros(b * h * w * c, dtype=torch.float32,
                            device=grad.device)
        dfeat.index_add_(0, (cell * c + ch)[live], g[live])
        return (dfeat.reshape(b, h, w, c).to(ctx.dtype), None, None, None,
                None)
