"""Spatially-parallel backbone serving: the VGG16 bodies sharded by image
height, with halo exchanges.

Counterpart of ``odwscl_tpu/parallel/sp.py`` (a serving option; no CLI
uses it in either package), where GSPMD partitions the convolutions over
an ``sp`` mesh axis and inserts the halo exchanges itself. Here each of
``world`` ranks convolves one horizontal band of the images:

- the bands' edges fall on multiples of the body's stride (8 input rows
  for VGG16-OICR, 16 for VGG16) counted in whole feature rows, so every
  2x2 pool (floor) sees the windows it sees on the whole image; the last
  band takes the rows below the last whole feature row too, so a height
  that is not a multiple of stride x world still gives the unsharded
  result;
- before every 3x3 conv of dilation d the band gets d rows from each
  neighbour (a point-to-point exchange), and zero rows at the image's
  true top and bottom, which is the conv's own zero padding there; the
  width is padded as the unsharded conv pads it;
- ``gather=True`` all-gathers the bands of the stride-8 features, so
  every rank holds the whole map (the RoI stage needs whole rois);
  ``gather=False`` leaves each rank its band.

At world size 1 the band is the image and the convs run exactly as
``VGGBackbone.forward`` runs them. Float paths only (the int8 serving
convs are not sharded). The ResNet and FPN bodies are not ported here
yet: ``sp_backbone_apply`` raises for them.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.vgg16 import VGGBackbone


def sp_bands(height: int, stride: int, world: int
             ) -> List[Tuple[int, int]]:
    """Each rank's input rows [start, stop): whole feature rows of
    ``stride`` image rows, ceil(H // stride / world) a rank, the last rank
    also taking the rows past the last whole feature row. Raises when a
    band would be empty."""
    rows = height // stride
    per = math.ceil(rows / world)
    bands = [(r * per * stride, min((r + 1) * per, rows) * stride)
             for r in range(world)]
    bands[-1] = (bands[-1][0], height)
    if any(a >= b for a, b in bands[:-1]) or bands[-1][0] >= rows * stride:
        raise ValueError(f"a height of {height} rows ({rows} feature rows "
                         f"at stride {stride}) leaves a band of {world} "
                         f"empty")
    return bands


def _exchange(x: torch.Tensor, d: int, group, rank: int, world: int
              ) -> torch.Tensor:
    """The band x [B, C, h, W] with d rows of each neighbour above and
    below (zero rows at the image's top and bottom)."""
    b, c, h, w = x.shape

    def rows(t):           # exactly d rows, zero rows past a short band
        if t.shape[2] < d:
            t = torch.cat([t, t.new_zeros(b, c, d - t.shape[2], w)], 2)
        return t.contiguous()

    above, below = x.new_zeros(b, c, d, w), x.new_zeros(b, c, d, w)
    ops = []
    if rank > 0:
        ops += [dist.P2POp(dist.isend, rows(x[:, :, :d]), rank - 1, group),
                dist.P2POp(dist.irecv, above, rank - 1, group)]
    if rank + 1 < world:
        ops += [dist.P2POp(dist.isend, x[:, :, h - d:].contiguous(),
                           rank + 1, group),
                dist.P2POp(dist.irecv, below, rank + 1, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat([above, x, below], dim=2)


def sp_backbone_apply(backbone, images: torch.Tensor, group=None,
                      gather: bool = True) -> torch.Tensor:
    """The VGG16 ``backbone``'s features of ``images`` [B, H, W, 3] (the
    whole batch, the same on every rank of ``group``), each rank
    convolving its band (``sp_bands``). Returns the NHWC features
    [B, H // stride, W // stride, C] on every rank (``gather``), or this
    rank's band of them."""
    if not isinstance(backbone, VGGBackbone):
        raise NotImplementedError(
            f"spatial parallelism covers the VGG16 bodies; "
            f"{type(backbone).__name__} (the ResNet and FPN bodies) is not "
            f"ported yet (ROADMAP.md, Queue 1)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    stride = 2 ** backbone._layers.count("M")
    start, stop = sp_bands(images.shape[1], stride, world)[rank]
    per = math.ceil(images.shape[1] // stride / world)
    dilation = max(layer[1] for layer in backbone._layers if layer != "M")
    if world > 1 and per < dilation:
        raise ValueError(f"bands of {per} feature rows cannot take the "
                         f"dilated convs' {dilation}-row halos")
    dt = backbone.compute_dtype
    x = images[:, start:stop].to(dt).permute(0, 3, 1, 2)
    for layer in backbone._layers:
        if layer == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        i, d = layer
        conv = getattr(backbone, f"conv{i}")
        wgt, bias = conv.weight.to(dt), conv.bias.to(dt)
        if world == 1:
            x = F.conv2d(x, wgt, bias, padding=d, dilation=d)
        else:
            x = F.conv2d(_exchange(x, d, group, rank, world), wgt, bias,
                         padding=(0, d), dilation=d)
        if i + 1 < backbone.num_convs:
            x = F.relu(x)
    band = x.permute(0, 2, 3, 1).contiguous()
    if not gather or world == 1:
        return band
    padded = torch.cat([band, band.new_zeros(
        band.shape[0], per - band.shape[1], *band.shape[2:])], 1)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts, 1)[:, :images.shape[1] // stride]
