"""VGG16-OICR backbone and the fc6/fc7 RoI neck.

Counterpart of ``odwscl_tpu/models/vgg16.py``. The OICR variant drops pool4
and dilates conv5 by 2 (pad 2), so the output stride is 8 with 512
channels, and the final ReLU is stripped.

Training: ``freeze_at`` (``FREEZE_CONV_BODY_AT``) > 0 freezes the first
``FREEZE_CONV_COUNTS[freeze_at - 1]`` convolutions with
``requires_grad_(False)``, so autograd never reaches them (the JAX
package's ``stop_gradient`` at the freeze boundary). The neck's dropout
takes explicit keep masks, one row per RoI, so that a recompute of some
rows can reuse the masks of the all-RoI pass.

Parameters are held in f32, as in the JAX package, and cast to the compute
dtype at each use. Images come in NHWC, the JAX layout; viewed as NCHW they
are ``channels_last`` in memory, so every convolution runs channels_last
and the output features return to NHWC with a free permute. The TPU's
space-to-depth stem (``ops/s2d_stem.py``) is an exact re-association of
conv1_1, conv1_2 and pool1 with the same parameters, so the plain stem
here is its counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Conv counts delimiting the freeze blocks: FREEZE_CONV_BODY_AT = k freezes
# the first FREEZE_CONV_COUNTS[k - 1] convolutions.
FREEZE_CONV_COUNTS = [2, 4, 7, 10, 13]

# Layer spec: int = 3x3 conv channels, 'M' = 2x2 maxpool, 'I' = identity
# (removed pool), '<n>-D' = dilated 3x3 conv.
VGG_CFGS = {
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512],
    "VGG16-OICR": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
                   512, "I", "512-D", "512-D", "512-D"],
    "VGG16-ENCODER": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512,
                      512, 512, "512-D", "512-D", "512-D"],
}


class VGGBackbone(nn.Module):
    """NHWC images [B, H, W, 3] -> NHWC features [B, H/8, W/8, 512]
    (OICR variant), contiguous."""

    def __init__(self, arch: str = "VGG16-OICR",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 freeze_at: int = 0):
        super().__init__()
        self.arch = arch
        self.compute_dtype = compute_dtype
        self.spec = VGG_CFGS[arch]
        self._layers = []  # (conv index, dilation) or "M"
        cin, i = 3, 0
        for v in self.spec:
            if v in ("M", "I"):
                if v == "M":
                    self._layers.append("M")
                continue
            dilated = isinstance(v, str) and v.endswith("-D")
            ch = int(v.split("-")[0]) if dilated else int(v)
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3))
            self._layers.append((i, 2 if dilated else 1))
            cin, i = ch, i + 1
        self.num_convs = i
        for k in range(FREEZE_CONV_COUNTS[freeze_at - 1] if freeze_at > 0
                       else 0):
            getattr(self, f"conv{k}").requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan-out convs with zero bias, as the JAX init."""
        for i in range(self.num_convs):
            conv = getattr(self, f"conv{i}")
            fan_out = conv.out_channels * 9
            conv.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                generator=generator)
            conv.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = images.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels_last
        for layer in self._layers:
            if layer == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            i, dil = layer
            conv = getattr(self, f"conv{i}")
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                         padding=dil, dilation=dil)
            # the reference strips the final ReLU
            if i + 1 < self.num_convs:
                x = F.relu(x)
        return x.permute(0, 2, 3, 1).contiguous()


class VGGRoINeck(nn.Module):
    """fc6/fc7 over pooled rois flattened in (h, w, c) order: [N, 7, 7, C]
    -> [N, hidden]. Dropout applies only where keep masks are given.
    ``mid_dim`` (default ``hidden_dim``) is fc6's width."""

    def __init__(self, in_dim: int = 512 * 7 * 7, hidden_dim: int = 4096,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.5, mid_dim: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        mid_dim = mid_dim or hidden_dim
        self.fc6 = nn.Linear(in_dim, mid_dim)
        self.fc7 = nn.Linear(mid_dim, hidden_dim)

    def draw_keep(self, n: int, generator: torch.Generator, device
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Train-mode keep masks of fc6 and fc7 for n rows ([n, width of
        the layer] bool each), or None when the dropout rate is 0."""
        if self.dropout_rate == 0.0:
            return None
        return tuple(torch.rand((n, fc.out_features), generator=generator,
                                device=device) >= self.dropout_rate
                     for fc in (self.fc6, self.fc7))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for fc in (self.fc6, self.fc7):
            fc.weight.normal_(0.0, 0.01, generator=generator)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``keep``: the fc6 and fc7 keep masks of these rows (train-mode
        dropout, kept units scaled by 1 / (1 - rate)), or None."""
        dt = self.compute_dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        for li, fc in enumerate((self.fc6, self.fc7)):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
            if keep is not None:
                x = torch.where(keep[li], x / (1.0 - self.dropout_rate),
                                0.0).to(dt)
        return x
