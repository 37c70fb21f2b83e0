"""DropBlock and the noise view on pooled RoI features.

Counterpart of ``odwscl_tpu/ops/dropblock.py``. The random draws are kept
apart from the arithmetic: each function draws from an explicit
``torch.Generator`` unless the caller hands it the draws, so a test can
feed both packages the same numbers.

DropBlock semantics: centers are ``uniform < gamma`` over [N, H, W] with
gamma = p / block^2, shared across channels; the block mask is grown by a
stride-1 max pool (padding block // 2; even sizes crop the trailing row and
column); the output is rescaled by the global ratio total / kept, counted
over the valid rows only when ``valid`` is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dropblock_2d(x: torch.Tensor, drop_prob: float, block_size: int,
                 valid: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H, W, C] (NHWC) -> same shape. ``uniform`` [N, H, W] in [0, 1)
    replaces the draw from ``generator``."""
    if drop_prob == 0.0:
        return x
    n, h, w, _ = x.shape
    gamma = drop_prob / (block_size ** 2)
    if uniform is None:
        uniform = torch.rand((n, h, w), generator=generator, device=x.device)
    centers = (uniform < gamma).to(torch.float32)
    if block_size > 1:
        grown = F.max_pool2d(centers[:, None], block_size, stride=1,
                             padding=block_size // 2)[:, 0]
        if block_size % 2 == 0:
            grown = grown[:, :-1, :-1]
    else:
        grown = centers
    block_mask = (1.0 - grown).to(x.dtype)                   # 1 = keep
    if valid is None:
        total = torch.tensor(float(block_mask.numel()), dtype=x.dtype,
                             device=x.device)
        keep = block_mask.sum()
    else:
        v = valid.to(x.dtype)[:, None, None]
        total = v.sum() * (h * w)
        keep = (block_mask * v).sum()
    scale = total / keep.clamp(min=1.0)
    return x * block_mask[..., None] * scale


def noise_augment(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + N(0, 1) * x; ``normal`` (x's shape) replaces the draw."""
    if normal is None:
        normal = torch.randn(x.shape, generator=generator, device=x.device)
    return normal.to(x.dtype) * x + x
