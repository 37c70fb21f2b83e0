"""Deformable convolution v1 / v2 and deformable PS-RoI pooling, in plain
PyTorch.

Counterpart of ``odwscl_tpu/ops/deform_conv.py`` (``deform_conv2d``,
``modulated_deform_conv2d``, ``deform_psroi_pooling``), which the JAX
package computes with XLA (no Pallas kernel) and no model of either
package calls: bilinear gathers of every tap into an im2col tensor, then
one contraction per group; autograd gives the backward.

Layouts and channel orders are the JAX functions': NHWC features, HWIO
weights [kh, kw, Cin / groups, Cout]; offsets [B, Ho, Wo, dg * 2 * K]
ordered (deformable group, tap, (dy, dx)), masks [B, Ho, Wo, dg * K]
ordered (group, tap). The bilinear sample keeps the CUDA kernel's
boundary rule (``_bilinear``): a position at or beyond -1 or H (W) gives
0, and each of the four corners outside the map is zeroed on its own.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
              batch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear samples of x [H, W, C] (or [B, H, W, C] with ``batch``, an
    image index broadcast against h) at (h, w) -> [..., C], with the CUDA
    kernel's boundary rule."""
    hgt, wid = x.shape[-3], x.shape[-2]
    h0 = torch.floor(h)
    w0 = torch.floor(w)
    lh, lw = h - h0, w - w0
    hh, hw = 1.0 - lh, 1.0 - lw
    h0i, w0i = h0.long(), w0.long()

    def corner(dy, dx, wt):
        yy, xx = h0i + dy, w0i + dx
        ok = (yy >= 0) & (yy <= hgt - 1) & (xx >= 0) & (xx <= wid - 1)
        idx = (yy.clamp(0, hgt - 1), xx.clamp(0, wid - 1))
        v = x[idx] if batch is None else x[(batch,) + idx]
        return torch.where(ok[..., None], v, 0.0) * wt[..., None]

    val = (corner(0, 0, hh * hw) + corner(0, 1, hh * lw)
           + corner(1, 0, lh * hw) + corner(1, 1, lh * lw))
    inside = (h > -1) & (h < hgt) & (w > -1) & (w < wid)
    return torch.where(inside[..., None], val, 0.0)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None, stride: Pair = 1,
                  padding: Pair = 0, dilation: Pair = 1, groups: int = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin], offset [B, Ho, Wo, dg * 2 * K], weight [kh, kw,
    Cin / groups, Cout], mask [B, Ho, Wo, dg * K] (v2's modulation; None
    is v1) -> [B, Ho, Wo, Cout]."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    b, hgt, wid, cin = x.shape
    kh, kw, cin_g, cout = weight.shape
    k = kh * kw
    ho = (hgt + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wid + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = deformable_groups
    cpg = cin // dg
    dev = x.device
    base_h = (torch.arange(ho, device=dev) * sh - ph).to(x.dtype)
    base_w = (torch.arange(wo, device=dev) * sw - pw).to(x.dtype)
    off = offset.reshape(b, ho, wo, dg, k, 2)
    mod = None if mask is None else mask.reshape(b, ho, wo, dg, k)
    img = torch.arange(b, device=dev)[:, None, None]
    cols = []
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            h_im = (base_h[None, :, None, None] + i * dh) + off[..., t, 0]
            w_im = (base_w[None, None, :, None] + j * dw) + off[..., t, 1]
            taps = []
            for g in range(dg):
                v = _bilinear(x[..., g * cpg:(g + 1) * cpg], h_im[..., g],
                              w_im[..., g], img)
                if mod is not None:
                    v = v * mod[..., g, t][..., None]
                taps.append(v)
            cols.append(torch.cat(taps, dim=-1))             # [B, Ho, Wo, Cin]
    cols = torch.stack(cols, dim=3)                     # [B, Ho, Wo, K, Cin]
    wmat = weight.reshape(k, cin_g, cout)
    cg, og = cin // groups, cout // groups
    out = torch.cat([torch.einsum("bhwkc,kco->bhwo",
                                  cols[..., g * cg:(g + 1) * cg],
                                  wmat[:, :, g * og:(g + 1) * og])
                     for g in range(groups)], dim=-1)
    return out if bias is None else out + bias


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, stride=1,
                            padding=0, dilation=1, groups=1,
                            deformable_groups=1):
    """DCNv2: ``deform_conv2d`` with per-tap masks (post-sigmoid, as the
    CUDA op takes them)."""
    return deform_conv2d(x, offset, weight, bias=bias, mask=mask,
                         stride=stride, padding=padding, dilation=dilation,
                         groups=groups, deformable_groups=deformable_groups)


def deform_psroi_pooling(feat: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor], out_size: int,
                         out_channels: int, no_trans: bool,
                         spatial_scale: float, group_size: int = 1,
                         part_size: Optional[int] = None,
                         sample_per_part: int = 4,
                         trans_std: float = 0.0) -> torch.Tensor:
    """Deformable position-sensitive RoI pooling: feat [H, W, C] with C =
    out_channels * group_size^2 position-sensitive maps, rois [N, 4] xyxy
    in image pixels, trans [N, 2, part, part] the learned (dy, dx) part
    offsets (ignored with ``no_trans``) -> [N, out_size, out_size,
    out_channels]: each bin the mean of its sample_per_part^2 bilinear
    samples that fall on the map, from its position-sensitive channels."""
    hgt, wid, _ = feat.shape
    part = part_size or out_size
    n = rois.shape[0]
    dev = feat.device
    os_ = out_size
    r = rois.to(feat.dtype)
    x1 = r[:, 0] * spatial_scale - 0.5
    y1 = r[:, 1] * spatial_scale - 0.5
    x2 = (r[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (r[:, 3] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = rh / os_, rw / os_
    sub_h, sub_w = bin_h / sample_per_part, bin_w / sample_per_part

    py = torch.arange(os_, device=dev)
    part_i = torch.floor(py.to(torch.float32) / os_ * part).long()
    if no_trans or trans is None:
        dy = dx = torch.zeros((n, os_, os_), dtype=feat.dtype, device=dev)
    else:
        tr = trans[:, :, part_i[:, None], part_i[None, :]]   # [N, 2, os, os]
        dy = tr[:, 0] * trans_std * rh[:, None, None]
        dx = tr[:, 1] * trans_std * rw[:, None, None]

    def per_roi(v):
        return v[:, None, None, None, None]

    start_y = (py[None, :, None, None, None] * per_roi(bin_h) + per_roi(y1)
               + dy[:, :, :, None, None])
    start_x = (py[None, None, :, None, None] * per_roi(bin_w) + per_roi(x1)
               + dx[:, :, :, None, None])
    iy = torch.arange(sample_per_part, device=dev)
    sy = start_y + (iy[None, None, None, :, None] + 0.5) * per_roi(sub_h)
    sx = start_x + (iy[None, None, None, None, :] + 0.5) * per_roi(sub_w)
    g = torch.clamp((py * group_size) // os_, 0, group_size - 1)
    vals = _bilinear(feat, sy.clamp(0.0, hgt - 1.0),
                     sx.clamp(0.0, wid - 1.0))     # [N, os, os, s, s, C]
    valid = ((sy > -0.5) & (sy < hgt - 0.5) & (sx > -0.5)
             & (sx < wid - 0.5))
    vals = torch.where(valid[..., None], vals, 0.0)
    cnt = valid.sum(dim=(3, 4)).clamp(min=1)                  # [N, os, os]
    summed = vals.sum(dim=(3, 4)).reshape(n, os_, os_, group_size,
                                          group_size, out_channels)
    sel = summed[:, py[:, None], py[None, :], g[:, None], g[None, :]]
    return sel / cnt[..., None]
