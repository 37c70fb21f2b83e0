"""Concrete DropBlock: the learned, adversarial feature dropping.

Counterpart of ``odwscl_tpu/models/cdb.py`` (``gumbel_softmax``,
``_MaskedBatchNorm``, ``ConvConcreteDB``). A small residual conv block
predicts a drop probability per cell of the pooled RoI features; a hard
(straight-through) gumbel-softmax sample picks the drop centres, which grow
to blocks with a stride-1 max pool and are applied with the global keep
rescale. Its parameters have their own optimizer, which ascends the
detection loss (solver/build.py).

The block reads a detached f32 copy of its input, so only its own
parameters get gradients, through the gumbel's soft path. Its batch norm
takes batch statistics over the valid rois only (biased variance, eps
1e-5) and keeps no running statistics. The convolutions run in f32: on the
card cuDNN runs f32 convolutions in TF32 while
``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default), and the
port leaves that switch to the caller. The block only sets the logits of a
sampled drop mask, and TF32 keeps its three convolutions, ~7.6 TFLOP per
full-width step with their weight gradients, off the f32 FMA pipes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the drop probability and the gumbel temperature: the JAX package's
# defaults, which no config key sets (its detector passes no DB.TAU)
DROP_PROB = 0.3
GSM_TAU = 0.01


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0,
                   hard: bool = False, eps: float = 1e-10, dim: int = -1,
                   generator: Optional[torch.Generator] = None,
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-softmax sample of ``logits`` along ``dim``; with ``hard`` the
    forward value is the one-hot of the first maximum and the gradient is
    the soft sample's. ``uniform`` (logits' shape, in [0, 1)) replaces the
    draw from ``generator``."""
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator,
                             device=logits.device)
    g = -torch.log(-torch.log(uniform + eps) + eps)
    y_soft = torch.softmax((logits + g) / tau, dim=dim)
    if not hard:
        return y_soft
    index = y_soft.argmax(dim=dim, keepdim=True)
    onehot = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return onehot - y_soft.detach() + y_soft


class _MaskedBatchNorm(nn.Module):
    """Train-mode batch norm of [N, C, H, W] over the rows where ``valid``
    [N] is True; parameters ``scale`` and ``bias``."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        w = valid.to(x.dtype)[:, None, None, None]
        count = (w.sum() * (x.shape[2] * x.shape[3])).clamp(min=1.0)
        mean = (x * w).sum(dim=(0, 2, 3)) / count
        xc = x - mean[:, None, None]
        var = (xc * xc * w).sum(dim=(0, 2, 3)) / count
        xhat = xc * torch.rsqrt(var + 1e-5)[:, None, None]
        return xhat * self.scale[:, None, None] + self.bias[:, None, None]


class ConvConcreteDB(nn.Module):
    """Pooled RoI features [N, r, r, C] (NHWC) and a valid mask [N] -> the
    features with learned blocks of ``block_size`` (``DB.SIZE``) dropped,
    same shape and dtype; the gumbel sample is hard."""

    def __init__(self, channels: int = 512, block_size: int = 3):
        super().__init__()
        self.block_size = block_size
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _MaskedBatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, 2, 3, padding=1, bias=False)
        self.bn2 = _MaskedBatchNorm(2)
        self.downsample = nn.Conv2d(channels, 2, 1, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming normal over fan_out (the JAX package's init); the norms
        start at scale 1, bias 0."""
        for conv in (self.conv1, self.conv2, self.downsample):
            o, _, kh, kw = conv.weight.shape
            std = (2.0 / (o * kh * kw)) ** 0.5
            conv.weight.normal_(0.0, std, generator=generator)
        for bn in (self.bn1, self.bn2):
            bn.scale.fill_(1.0)
            bn.bias.zero_()

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``uniform`` [N, r, r, 2] replaces the gumbel's draw."""
        gamma = DROP_PROB / (self.block_size ** 2)
        xd = x.detach().to(torch.float32).permute(0, 3, 1, 2)
        out = F.relu(self.bn1(self.conv1(xd), valid))
        out = self.bn2(self.conv2(out), valid) + self.downsample(xd)
        p_drop = torch.sigmoid(out[:, 0]) * gamma                 # [N, r, r]
        scores = torch.stack([p_drop, 1.0 - p_drop], dim=-1)
        mask = gumbel_softmax(torch.log(scores + 1e-10), tau=GSM_TAU,
                              hard=True, generator=generator,
                              uniform=uniform)[..., 0]            # drop = 1
        # stride-1 max pool, padded with -inf; even sizes crop the trailing
        # row and column
        grown = F.max_pool2d(mask[:, None], self.block_size, stride=1,
                             padding=self.block_size // 2)[:, 0]
        if self.block_size % 2 == 0:
            grown = grown[:, :-1, :-1]
        block_mask = 1.0 - grown
        v = valid.to(torch.float32)[:, None, None]
        total = (v.sum() * (mask.shape[1] * mask.shape[2])).clamp(min=1.0)
        keep = (block_mask * v).sum().clamp(min=1.0)
        return x * (block_mask[..., None] * (total / keep)).to(x.dtype)
