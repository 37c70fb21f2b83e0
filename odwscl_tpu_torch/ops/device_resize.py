"""Antialiased image resize on the device, for the TTA's
``TPU.EVAL_DEVICE_RESIZE`` path.

Counterpart of ``odwscl_tpu/ops/device_resize.py``. The host path resizes
the original image once per TTA scale with PIL (BILINEAR) and uploads
every copy; this path uploads the normalized original once and makes each
scale on the device as two matrix products, ``out = R_h @ img @ R_w^T``,
with the weights built from each image's source and target sizes, so one
padded batch serves every image geometry.

The PIL convention (Pillow ``src/libImaging/Resample.c``):
- output pixel i is centred at ``(i + 0.5) * in / out`` in input pixels;
- the filter support is ``max(1, in / out)``: minification widens the
  triangle (antialiasing), magnification is the 2-tap bilinear;
- input pixel j weighs ``max(0, 1 - |j + 0.5 - centre| / support)``;
- taps past the valid input are dropped and the rest renormalised.

PIL resamples the uint8 image with fixed-point rounding before the
normalization; here the resample runs in f32 on normalized pixels. The two
agree up to the uint8 rounding, about one BGR-255 unit per pixel, and the
products are kept in true f32 (TF32 off) so as not to add to it. Against
PIL's float ('F' mode) resize they agree to float tolerance.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch


@contextlib.contextmanager
def _no_tf32():
    """f32 matrix products in full f32 on the card (no TF32)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def triangle_weights(out_pad: int, in_pad: int, valid_in, valid_out
                     ) -> torch.Tensor:
    """[..., out_pad, in_pad] PIL-BILINEAR resampling matrices for one
    axis. ``valid_in`` / ``valid_out``: the unpadded source and target
    lengths (tensors of any batch shape, or numbers); rows >= valid_out and
    columns >= valid_in are zero, so padded canvas regions stay zero."""
    valid_in = torch.as_tensor(valid_in, dtype=torch.float32)
    valid_out = torch.as_tensor(valid_out, dtype=torch.float32,
                                device=valid_in.device)
    valid_in, valid_out = valid_in[..., None, None], valid_out[..., None, None]
    dev = valid_in.device
    scale = valid_in / torch.clamp(valid_out, min=1.0)
    fs = torch.clamp(scale, min=1.0)
    i = torch.arange(out_pad, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(in_pad, dtype=torch.float32, device=dev)[None, :]
    center = (i + 0.5) * scale
    w = torch.clamp(1.0 - torch.abs(j + 0.5 - center) / fs, min=0.0)
    w = torch.where(j < valid_in, w, 0.0)
    w = torch.where(i < valid_out, w, 0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)


def resize_image_batch(images: torch.Tensor, in_sizes: torch.Tensor,
                       out_sizes: torch.Tensor, out_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Resize each image's valid region to its target size.

    images:    [B, H0, W0, C] (any float dtype; padding must be zero)
    in_sizes:  [B, 2] (h, w) valid source extents
    out_sizes: [B, 2] (h, w) per-image targets
    out_hw:    the padded output canvas (H1, W1)

    Returns [B, H1, W1, C] in ``images.dtype``, zero beyond each target.
    """
    h1, w1 = out_hw
    b, h0, w0, c = images.shape
    in_sizes = in_sizes.to(torch.float32)
    out_sizes = out_sizes.to(torch.float32)
    ry = triangle_weights(h1, h0, in_sizes[:, 0], out_sizes[:, 0])
    rx = triangle_weights(w1, w0, in_sizes[:, 1], out_sizes[:, 1])
    with _no_tf32():
        t = torch.bmm(ry, images.to(torch.float32).reshape(b, h0, w0 * c))
        t = t.reshape(b, h1, w0, c).transpose(1, 2).reshape(b, w0, h1 * c)
        out = torch.bmm(rx, t).reshape(b, w1, h1, c).transpose(1, 2)
    return out.to(images.dtype).contiguous()


def scale_boxes_batch(boxes: torch.Tensor, in_sizes: torch.Tensor,
                      out_sizes: torch.Tensor) -> torch.Tensor:
    """Per-image box rescale as the host resize does (x *= ow / w,
    y *= oh / h). boxes [B, P, 4] xyxy; sizes [B, 2] (h, w)."""
    r = (out_sizes.to(torch.float32)
         / torch.clamp(in_sizes.to(torch.float32), min=1.0))
    rh, rw = r[:, 0:1], r[:, 1:2]
    return torch.stack([boxes[..., 0] * rw, boxes[..., 1] * rh,
                        boxes[..., 2] * rw, boxes[..., 3] * rh], dim=-1)
