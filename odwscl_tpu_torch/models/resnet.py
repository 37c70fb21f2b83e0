"""ResNet backbones with frozen batch norm (R-18/50/101, C4/C5) and the
ResNet RoI neck.

Counterpart of ``odwscl_tpu/models/resnet.py``. Module names follow its
flax tree (``stem_conv``, ``stem_bn``, ``layer{s}_{b}`` with ``conv{1,2,3}``,
``bn{1,2,3}``, ``downsample``, ``downsample_bn``), so the weight bridge and
the importers map names one to one. For the C5 variants layer4's first
block runs at stride 1, so the output stride is 16 (``POOLER_SCALES
(0.0625,)``).

``FrozenBatchNorm`` keeps the JAX package's four parameters and its eps of
1e-5: ``x * scale / sqrt(var + 1e-5) + (bias - mean * scale / sqrt(var +
1e-5))``. They never train (``requires_grad`` False). ``freeze_at`` > 0
(``MODEL.BACKBONE.FREEZE_CONV_BODY_AT``) also freezes the stem and every
``layer1_*`` block, as the JAX package's optimizer labels do for the conv
count its CLI passes (``odwscl_tpu/solver/build.py:116-126``).

As ``VGGBackbone``, the backbone takes NHWC images, runs its convolutions
on the NCHW view (``channels_last`` in memory) with the f32 parameters
cast to the compute dtype at each use, and returns contiguous NHWC
features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .vgg16 import VGGRoINeck

# block counts per stage for each depth
RESNET_STAGES = {
    "R-18": (2, 2, 2, 2),
    "R-50": (3, 4, 6, 3),
    "R-101": (3, 4, 23, 3),
}
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics and affine parameters, on NCHW."""

    INIT = (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0))

    def __init__(self, channels: int):
        super().__init__()
        for name, fill in self.INIT:
            setattr(self, name, nn.Parameter(
                torch.full((channels,), fill), requires_grad=False))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for name, fill in self.INIT:
            getattr(self, name).fill_(fill)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.var + BN_EPS)
        w = (self.scale / std).to(x.dtype)
        b = (self.bias - self.mean * self.scale / std).to(x.dtype)
        return x * w[:, None, None] + b[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class _Block(nn.Module):
    """The projection shortcut shared by both block types: a strided 1x1
    conv and its norm where the channels or the stride change."""

    def _shortcut(self, cin: int, cout: int, stride: int) -> None:
        if cin != cout or stride != 1:
            self.downsample = _conv(cin, cout, 1, stride)
            self.downsample_bn = FrozenBatchNorm(cout)
        else:
            self.downsample = None

    def _identity(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is None:
            return x
        return self.downsample_bn(_apply(self.downsample, x))


def _apply(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, conv.dilation)


class Bottleneck(_Block):
    """1x1 -> 3x3 -> 1x1 with the stride on the first 1x1 when
    ``stride_in_1x1`` (the MSRA weights), else on the 3x3."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 dilation: int = 1, stride_in_1x1: bool = True):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self._shortcut(in_channels, out_channels, stride)
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, s1)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3,
                           dilation, dilation)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.bn3 = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_apply(self.conv1, x)))
        out = F.relu(self.bn2(_apply(self.conv2, out)))
        out = self.bn3(_apply(self.conv3, out))
        return F.relu(out + self._identity(x))


class BasicBlock(_Block):
    """Two 3x3 convs (R-18)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self._shortcut(in_channels, out_channels, stride)
        self.conv1 = _conv(in_channels, out_channels, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(out_channels)
        self.conv2 = _conv(out_channels, out_channels, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_apply(self.conv1, x)))
        out = self.bn2(_apply(self.conv2, out))
        return F.relu(out + self._identity(x))


class ResNetBackbone(nn.Module):
    """NHWC images [B, H, W, 3] -> NHWC features of the last stage,
    contiguous: R-{18,50,101}-C{4,5}, C5 with layer4 at stride 1 unless
    ``c5_stride_one`` is False. ``return_stages`` returns every stage's
    output instead (C2, C3, ...), each NHWC and contiguous."""

    def __init__(self, depth: str = "R-50", stages_out: int = 5,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 freeze_at: int = 0, c5_stride_one: bool = True,
                 return_stages: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.return_stages = return_stages
        basic = depth == "R-18"
        channels = [64, 128, 256, 512] if basic else [256, 512, 1024, 2048]
        bott = [64, 128, 256, 512]
        self.stem_conv = _conv(3, 64, 7, 2, 3)
        self.stem_bn = FrozenBatchNorm(64)
        self.blocks = []
        self.stage_ends = []        # the last block of each stage
        cin = 64
        for stage in range(stages_out - 1):
            stride = (1 if stage == 0 or (stage == 3 and stages_out == 5
                                          and c5_stride_one) else 2)
            for b in range(RESNET_STAGES[depth][stage]):
                s = stride if b == 0 else 1
                block = (BasicBlock(cin, channels[stage], s) if basic else
                         Bottleneck(cin, channels[stage], bott[stage], s))
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block)
                self.blocks.append(name)
                cin = channels[stage]
            self.stage_ends.append(self.blocks[-1])
        self.out_channels = cin
        if freeze_at > 0:
            self.stem_conv.requires_grad_(False)
            for name in self.blocks:
                if name.startswith("layer1_"):
                    getattr(self, name).requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan-out convs and identity norms, as the JAX
        init."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                std = (2.0 / (m.out_channels * kh * kw)) ** 0.5
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, FrozenBatchNorm):
                m.reset_parameters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(_apply(self.stem_conv, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        for name in self.blocks:
            x = getattr(self, name)(x)
            if self.return_stages and name in self.stage_ends:
                stages.append(x.permute(0, 2, 3, 1).contiguous())
        return tuple(stages) if self.return_stages else \
            x.permute(0, 2, 3, 1).contiguous()


class ResNetRoINeck(VGGRoINeck):
    """The ResNet50Conv5ROIFeatureExtractor classifier: pooled rois
    flattened in (h, w, c) order, r*r*C (r the pooler's resolution) ->
    ``mid_dim`` -> ``out_dim``, each with ReLU and dropout; fc6/fc7 as in
    ``VGGRoINeck``."""

    def __init__(self, in_dim: int = 7 * 7 * 2048, mid_dim: int = 2048,
                 out_dim: int = 4096,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.5):
        super().__init__(in_dim, out_dim, compute_dtype, dropout_rate,
                         mid_dim=mid_dim)
