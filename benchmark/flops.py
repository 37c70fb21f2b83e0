"""FLOP and byte counts of the benchmark's work, from shapes alone.

- Training: the VGG convs forward, then their weight gradients where
  autograd reaches (the convs past ``FREEZE_CONV_BODY_AT``'s block) and
  their input gradients past the first trainable conv; fc6/fc7 and the
  heads (and SimNet) once for each pass that ``train_forward`` defines,
  with the backward of those that carry a gradient. Recomputed work is not
  counted: the bank rows' clean embeddings, recomputed with gradient, count
  their backward only (``recomputed=True`` adds their forward, which is
  what the program executes).
- Eval: each TTA forward's convs, fc6/fc7 and heads at its own canvas.
- ROIPool: the least bytes of the kernels (the kernel table's bounds,
  copied from the port's ``ops/roi_pool_stages.py:stage_work`` and
  ``chip_smoke.py:bwd_bound``): each map cell the output depends on read
  once, the output (and the training forward's argmax codes) written
  once; the backward reads the map and the output cotangent and writes the
  map's gradient.

A FLOP is a multiply or an add: 2 per multiply-add. Only the convs and the
matrix products of the backbone, the neck, SimNet and the heads count.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .reference.ops import roi_bin_edges


def conv_flops(spec: Sequence, h: int, w: int, batch: int = 1,
               cin: int = 3) -> List[int]:
    """Forward FLOPs of each 3x3 conv of a VGG spec on [batch, h, w]
    ('M' halves the size, 'I' is no layer; padded convs keep it)."""
    out = []
    for v in spec:
        if v == "M":
            h, w = h // 2, w // 2
        elif v != "I":
            ch = int(str(v).split("-")[0])
            out.append(2 * batch * h * w * cin * ch * 9)
            cin = ch
    return out


def head_width(num_classes: int, num_refs: int) -> int:
    """Outputs of the MIST predictor's fused heads."""
    return 2 * num_classes + num_refs * (num_classes + 4 * num_classes)


def _mlp(rows: int, dims: Sequence[Tuple[int, int]]) -> int:
    return sum(2 * rows * k * n for k, n in dims)


def train_step_flops(m: dict, canvas: Tuple[int, int], batch: int,
                     rois: int, recomputed: bool = False) -> int:
    """One training step at a padded ``canvas`` (h, w) with ``rois``
    proposals an image. ``m``: ``program.model_shape``."""
    convs = conv_flops(m["spec"], canvas[0], canvas[1], batch)
    frozen = m["frozen_convs"]
    total = sum(convs)                                   # forward
    total += sum(convs[frozen:])                         # weight grads
    total += sum(convs[frozen + 1:])                     # input grads
    d, n = m["mlp_dim"], batch * rois
    k6 = 512 * m["pooled"] ** 2
    neck = [(k6, d), (d, d)]
    sim = [(d, d), (d, m["embed"])]
    heads = [(d, head_width(m["num_classes"], m["num_refs"]))]
    total += _mlp(n, neck + sim)                         # clean pass
    total += 3 * _mlp(n, neck + heads)                   # aug pass + bwd
    total += 2 * 3 * _mlp(m["cap_a"], neck + sim)        # two views + bwd
    bank = m["cap_a"] + m["cap_b"]
    total += (3 if recomputed else 2) * _mlp(bank, neck + sim)
    return total


def eval_forward_flops(m: dict, canvas: Tuple[int, int], batch: int,
                       rois: int) -> int:
    """One eval forward at ``canvas`` with ``rois`` proposals an image."""
    d, n = m["mlp_dim"], batch * rois
    k6 = 512 * m["pooled"] ** 2
    return (sum(conv_flops(m["spec"], canvas[0], canvas[1], batch))
            + _mlp(n, [(k6, d), (d, d),
                       (d, head_width(m["num_classes"], m["num_refs"]))]))


def _cells_covered(b, h, w, img, r0, r1, c0, c1) -> int:
    """Distinct cells of a [b, h, w] map inside the union of the rectangles
    rows [r0, r1) x columns [c0, c1) of images ``img``."""
    r0, r1, c0, c1 = r0.clamp(0, h), r1.clamp(0, h), c0.clamp(0, w), \
        c1.clamp(0, w)
    live = (r1 > r0) & (c1 > c0)
    img, r0, r1, c0, c1 = (t[live] for t in (img, r0, r1, c0, c1))
    diff = torch.zeros((b, h + 1, w + 1), dtype=torch.int32)
    for r, col, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1),
                         (r1, c1, 1)):
        diff.index_put_((img, r, col), torch.full_like(
            r, sign, dtype=torch.int32), accumulate=True)
    return int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())


def roi_pool_work(feat_shape, rois: torch.Tensor, mask: torch.Tensor,
                  scale: float, pooled: int, itemsize: int,
                  argmax: bool = False) -> Tuple[int, int]:
    """(least bytes, comparisons) of ROIPool forward #1 (``argmax``: #1's
    training instantiation, which also writes the codes: int16 up to
    65,535 map cells, int32 above) on a [B, H, W, C] map."""
    b, h, w, c = feat_shape
    p = rois.shape[1]
    rois = rois.to("cpu", torch.float32)
    mask = mask.to("cpu")
    out_elems = b * p * pooled * pooled * c
    nbytes = out_elems * itemsize + mask.numel() + rois.numel() * 4
    if argmax:
        nbytes += out_elems * (2 if h * w <= 65535 else 4)
    hs, he, ws, we = roi_bin_edges(rois, scale, pooled, h, w)
    live = mask.reshape(-1)
    img = torch.arange(b).repeat_interleave(p)
    cells = _cells_covered(b, h, w, img[live], hs[live, 0], he[live, -1],
                           ws[live, 0], we[live, -1])
    per_roi = (he - hs).clamp(min=0).sum(1) * (we - ws).clamp(min=0).sum(1)
    return nbytes + cells * c * itemsize, int(per_roi[live].sum()) * c


def roi_pool_bwd_bytes(feat_shape, rois_shape, pooled: int,
                       itemsize: int) -> int:
    """Least bytes of ROIPool backward #2: the map and the output's
    cotangent read once, the map's gradient written once."""
    b, h, w, c = feat_shape
    p = rois_shape[1]
    return ((2 * b * h * w * c + b * p * pooled * pooled * c) * itemsize
            + b * p * 4 * 4 + b * p)
