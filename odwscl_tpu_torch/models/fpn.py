"""Feature Pyramid Network bodies and multi-level RoI pooling.

Counterpart of ``odwscl_tpu/models/fpn.py``: ``FPN`` (lateral 1x1, nearest
2x top-down, 3x3 output per level; the ``maxpool`` and ``p6p7`` top
blocks; a lateral of width 0 is skipped), ``ResNetFPNBackbone`` (P2-P5 and
the max-pooled P6) and ``ResNetFPNP3P7Backbone`` (RetinaNet's P3-P7),
``assign_levels`` and ``multilevel_roi_pool``.

Module names follow the flax tree (``body``, ``fpn``, ``fpn_inner{i}``,
``fpn_layer{i}``, ``p6``, ``p7``). Features come in and go out NHWC and
contiguous; the convolutions run on the NCHW view (``channels_last`` in
memory), with the f32 parameters cast to the compute dtype at each use.

``multilevel_roi_pool`` keeps the JAX package's static design: every level
pools all P rois under that level's mask (the rois assigned elsewhere are
masked: the pooler gives them 0 and routes them no gradient), and the
four results are summed. On the card each level is one launch of the
ROIPool kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNetBackbone


def conv_nchw(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on x in x's dtype (the f32 parameters cast at use)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation)


@torch.no_grad()
def kaiming_uniform_a1(conv: nn.Module, generator: torch.Generator) -> None:
    """torch's kaiming_uniform_(a=1) (flax ``variance_scaling(1, fan_in,
    uniform)``): U(-sqrt(3 / fan_in), +); bias 0."""
    fan_in = conv.weight[0].numel()
    bound = math.sqrt(3.0 / fan_in)
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()


class FPN(nn.Module):
    """``in_channels_list`` lowest stride first; 0 skips that level's
    lateral and output (RetinaNet's C2). ``top_block``: None, "maxpool"
    (a stride-2 1x1 max pool of the last output) or "p6p7" (two stride-2
    3x3 convs, p6 on C5 when ``p6p7_on_c5``, else on P5; ReLU between)."""

    def __init__(self, in_channels_list: Sequence[int],
                 out_channels: int = 256, top_block: Optional[str] = "maxpool",
                 p6p7_on_c5: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if top_block not in (None, "maxpool", "p6p7"):
            raise ValueError(f"unknown FPN top block {top_block!r}")
        self.in_channels_list = tuple(in_channels_list)
        self.top_block = top_block
        self.p6p7_on_c5 = p6p7_on_c5
        self.compute_dtype = compute_dtype
        for i, cin in enumerate(self.in_channels_list, 1):
            if cin == 0:
                continue
            setattr(self, f"fpn_inner{i}", nn.Conv2d(cin, out_channels, 1))
            setattr(self, f"fpn_layer{i}",
                    nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if top_block == "p6p7":
            cin = self.in_channels_list[-1] if p6p7_on_c5 else out_channels
            self.p6 = nn.Conv2d(cin, out_channels, 3, stride=2, padding=1)
            self.p7 = nn.Conv2d(out_channels, out_channels, 3, stride=2,
                                padding=1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_uniform_a1(m, generator)

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        if len(features) != len(self.in_channels_list):
            raise ValueError(f"FPN takes {len(self.in_channels_list)} "
                             f"levels, got {len(features)}")
        feats = [f.to(self.compute_dtype).permute(0, 3, 1, 2)
                 for f in features]
        n = len(feats)
        last_inner = conv_nchw(getattr(self, f"fpn_inner{n}"), feats[-1])
        results = [conv_nchw(getattr(self, f"fpn_layer{n}"), last_inner)]
        for idx in range(n - 2, -1, -1):
            if self.in_channels_list[idx] == 0:
                continue
            lateral = conv_nchw(getattr(self, f"fpn_inner{idx + 1}"),
                                feats[idx])
            top_down = F.interpolate(last_inner, scale_factor=2,
                                     mode="nearest")
            # odd sizes: the 2x map is cut to the lateral's
            top_down = top_down[..., :lateral.shape[2], :lateral.shape[3]]
            last_inner = lateral + top_down
            results.insert(0, conv_nchw(getattr(self, f"fpn_layer{idx + 1}"),
                                        last_inner))
        if self.top_block == "maxpool":
            results.append(F.max_pool2d(results[-1], 1, 2))
        elif self.top_block == "p6p7":
            src = feats[-1] if self.p6p7_on_c5 else results[-1]
            p6 = conv_nchw(self.p6, src)
            results += [p6, conv_nchw(self.p7, F.relu(p6))]
        return tuple(r.permute(0, 2, 3, 1).contiguous() for r in results)


def _stage_channels(depth: str):
    return [64, 128, 256, 512] if depth == "R-18" else [256, 512, 1024, 2048]


class ResNetFPNBackbone(nn.Module):
    """R-{18,50,101} C2-C5 (stride-32 C5) -> P2-P5 and the max-pooled P6,
    ``out_channels`` wide. Only the frozen norms are frozen, as in the JAX
    package, whose freeze labels do not reach into ``body``."""

    def __init__(self, depth: str = "R-50", out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.body = ResNetBackbone(depth, 5, compute_dtype,
                                   c5_stride_one=False, return_stages=True)
        self.fpn = FPN(_stage_channels(depth), out_channels, "maxpool",
                       compute_dtype=compute_dtype)
        self.out_channels = out_channels

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.body.reset_parameters(generator)
        self.fpn.reset_parameters(generator)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.fpn(self.body(images))


class ResNetFPNP3P7Backbone(ResNetFPNBackbone):
    """RetinaNet's pyramid P3-P7: C2's lateral skipped, P6/P7 on C5
    (``use_c5``, ``MODEL.RETINANET.USE_C5``) or on P5."""

    def __init__(self, depth: str = "R-50", out_channels: int = 256,
                 use_c5: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(depth, out_channels, compute_dtype)
        self.fpn = FPN([0] + _stage_channels(depth)[1:], out_channels,
                       "p6p7", p6p7_on_c5=use_c5, compute_dtype=compute_dtype)


def assign_levels(boxes: torch.Tensor, k_min: int, k_max: int,
                  canonical_scale: int = 224,
                  canonical_level: int = 4) -> torch.Tensor:
    """The FPN paper's eqn. 1: each roi's pyramid level from sqrt(area)
    (+1 convention), floor(4 + log2(s / 224 + 1e-6)) clipped to [k_min,
    k_max]. boxes [..., 4] -> int64 [...]."""
    w = (boxes[..., 2] - boxes[..., 0] + 1).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1] + 1).clamp(min=0)
    s = torch.sqrt(w * h)
    lvl = torch.floor(canonical_level
                      + torch.log2(s / canonical_scale + 1e-6))
    return lvl.clamp(k_min, k_max).to(torch.int64)


def multilevel_roi_pool(pool_fn: Callable, features: Sequence[torch.Tensor],
                        scales: Sequence[float], boxes: torch.Tensor,
                        box_mask: torch.Tensor,
                        canonical_scale: int = 224) -> torch.Tensor:
    """Pool each roi at its level: ``pool_fn(feat, boxes, mask, scale,
    level_name)`` -> [B, P, r, r, C] with masked rois 0, called once per
    level with the rois of that level unmasked; the results are summed."""
    k_min = int(round(-math.log2(scales[0])))
    k_max = int(round(-math.log2(scales[-1])))
    levels = assign_levels(boxes, k_min, k_max, canonical_scale)
    out = None
    for li, (feat, scale) in enumerate(zip(features, scales)):
        sel = (levels == k_min + li) & box_mask
        pooled = pool_fn(feat, boxes, sel, scale, f"P{k_min + li}")
        out = pooled if out is None else out + pooled
    return out
