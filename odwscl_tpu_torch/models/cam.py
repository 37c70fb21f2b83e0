"""The CAM (class activation map) image-level loss and attention logits.

Counterpart of ``odwscl_tpu/models/cam.py`` (``CAMModule``,
``cam_proposals``). One weight matrix serves twice: as a 1x1 convolution
without bias over the backbone features it gives the per-class attention
maps, and on the globally average-pooled features, with its bias, the
image-level logits of a BCE loss whose background column is zeroed. The
weights start N(0, 0.01), the bias at 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class CAMModule(nn.Module):
    """``cam_conv``: Linear(in_channels, num_classes) over NHWC features."""

    def __init__(self, in_channels: int = 512, num_classes: int = 21,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cam_conv = nn.Linear(in_channels, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cam_conv.weight.normal_(0.0, 0.01, generator=generator)
        self.cam_conv.bias.zero_()

    def forward(self, features: torch.Tensor,
                labels_img: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """features [B, H, W, C] -> (attention logits [B, H, W, classes] in
        the compute dtype, the BCE loss or None without labels)."""
        weight = self.cam_conv.weight
        dt = self.compute_dtype
        atten = F.linear(features.to(dt), weight.to(dt))
        if labels_img is None:
            return atten, None
        gap = features.to(torch.float32).mean(dim=(1, 2))          # [B, C]
        logits = F.linear(gap, weight, self.cam_conv.bias)
        tgt = labels_img.clamp(0.0, 1.0)
        tgt = torch.cat([torch.zeros_like(tgt[:, :1]), tgt[:, 1:]], dim=1)
        # BCE with logits, in the stable form
        bce = (logits.clamp(min=0.0) - logits * tgt
               + torch.log1p(torch.exp(-logits.abs())))
        return atten, bce.mean()


def cam_proposals(cam: torch.Tensor, labels_img: torch.Tensor,
                  threshold: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell objectness of the present classes' normalised maps: cam
    [B, H, W, classes], labels_img [B, classes] -> (objectness [B, H, W],
    objectness >= threshold)."""
    maps = cam.to(torch.float32)
    lo = maps.amin(dim=(1, 2), keepdim=True)
    hi = maps.amax(dim=(1, 2), keepdim=True)
    norm = (maps - lo) / (hi - lo).clamp(min=1e-6)
    present = labels_img[:, None, None, :] > 0
    objectness = torch.where(present, norm, 0.0).amax(dim=-1)
    return objectness, objectness >= threshold
