"""RoI Align (bilinear average pooling) as plain torch ops.

Counterpart of ``odwscl_tpu/ops/roi_align.py`` (XLA there, no Pallas
kernel): the legacy maskrcnn-benchmark variant without the -0.5 pixel
shift, selected by ``POOLER_METHOD: ROIAlign``. Each bin averages a grid of
bilinear samples: ``sampling`` per axis, or with ``sampling`` 0
ceil(bin size) per axis, capped at ``SMAX`` (16). A sample beyond one cell
outside the map reads 0; one inside is clamped to the map.

Bilinear sampling is separable, so each roi's output is ``Wy @ feat @
Wx^T``: Wy [pooled, H] holds every row's summed weight over the bin's
samples (divided by their count), Wx [pooled, W] the same for columns.
Rois go through in chunks that bound the [chunk, pooled, W, C]
intermediate. Masked rois output 0. Differentiable by autograd.
"""

from __future__ import annotations

import torch

SMAX = 16
_CHUNK_ELEMS = 1 << 26


def _axis_weights(start: torch.Tensor, length: torch.Tensor, pooled: int,
                  sampling: int, size: int) -> torch.Tensor:
    """[N, pooled, size] weights of one axis: start, length [N] in map
    cells."""
    # a true division on every device: CUDA's ``tensor / python int``
    # multiplies by the reciprocal, so a roi of 14 cells made 7 bins of
    # 2.0000002 and ceil() 3 adaptive samples where the JAX package takes 2
    binsz = length / torch.full((), float(pooled), dtype=length.dtype,
                                device=length.device)
    if sampling > 0:
        s = sampling
        n = torch.full_like(binsz, float(sampling))
    else:
        s = SMAX
        n = torch.ceil(binsz).clamp(1.0, float(s))
    dev = start.device
    ph = torch.arange(pooled, dtype=torch.float32, device=dev)
    i = torch.arange(s, dtype=torch.float32, device=dev)
    # sample centres [N, pooled, s]: start + ph * bin + (i + .5) * bin / n
    c = (start[:, None, None] + ph[None, :, None] * binsz[:, None, None]
         + (i[None, None, :] + 0.5) * (binsz / n)[:, None, None])
    live = (i[None, None, :] < n[:, None, None]) & (c >= -1.0) & (c <= size)
    c = c.clamp(min=0.0)
    lo = torch.minimum(c.to(torch.int64), torch.tensor(size - 1, device=dev))
    hi = torch.clamp(lo + 1, max=size - 1)
    frac = torch.where(lo >= size - 1, torch.zeros_like(c), c - lo)
    scale = live.to(torch.float32) / n[:, None, None]
    w = torch.zeros(start.shape[0], pooled, size, dtype=torch.float32,
                    device=dev)
    w.scatter_add_(2, lo, (1.0 - frac) * scale)
    w.scatter_add_(2, hi, frac * scale)
    return w


def roi_align(feat: torch.Tensor, rois: torch.Tensor, roi_mask: torch.Tensor,
              spatial_scale: float, pooled: int = 7,
              sampling: int = 0) -> torch.Tensor:
    """feat [B, H, W, C], rois [B, P, 4] xyxy (image pixels), roi_mask
    [B, P] -> [B, P, pooled, pooled, C] in feat's dtype."""
    b, h, w, c = feat.shape
    p = rois.shape[1]
    r = rois.to(torch.float32) * spatial_scale
    x1, y1, x2, y2 = r.unbind(-1)
    roi_w = (x2 - x1).clamp(min=1.0)
    roi_h = (y2 - y1).clamp(min=1.0)
    wy = _axis_weights(y1.reshape(-1), roi_h.reshape(-1), pooled, sampling,
                       h).reshape(b, p, pooled, h)
    wx = _axis_weights(x1.reshape(-1), roi_w.reshape(-1), pooled, sampling,
                       w).reshape(b, p, pooled, w)
    keep = roi_mask.to(torch.float32)[..., None, None]
    wy = (wy * keep).to(feat.dtype)
    wx = wx.to(feat.dtype)
    chunk = max(1, _CHUNK_ELEMS // max(pooled * w * c, 1))
    out = []
    for i in range(b):
        parts = []
        for s in range(0, p, chunk):
            rows = torch.einsum("pyh,hwc->pywc", wy[i, s:s + chunk], feat[i])
            parts.append(torch.einsum("pywc,pxw->pyxc", rows,
                                      wx[i, s:s + chunk]))
        out.append(torch.cat(parts))
    return torch.stack(out)
