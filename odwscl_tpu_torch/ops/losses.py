"""Elementwise loss primitives of the weak-detection losses.

Counterpart of ``odwscl_tpu/ops/losses.py`` (the parts the WSOD training
path uses). Plain torch: nothing here is a kernel.
"""

from __future__ import annotations

import torch


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def binary_cross_entropy(probs: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, each log term clamped at -100 as
    ``F.binary_cross_entropy`` does, so probabilities of exactly 0 or 1
    give a finite loss."""
    probs = probs.clamp(0.0, 1.0)
    log_p = torch.log(probs).clamp(min=-100.0)
    log_1mp = torch.log1p(-probs).clamp(min=-100.0)
    return -(targets * log_p + (1.0 - targets) * log_1mp)


def cross_entropy_with_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE with integer labels: logits [..., C], labels [...]."""
    logz = logits.amax(dim=-1, keepdim=True)
    logsumexp = logz[..., 0] + torch.log(torch.exp(logits - logz).sum(dim=-1))
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logsumexp - picked


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """RetinaNet's focal loss, elementwise: logits [N, C] over the C
    foreground classes, targets [N] int in [0, C] (0 background, c > 0
    foreground class c, < 0 ignored) -> [N, C]. The logs are clamped at
    1e-20 as in the JAX package."""
    num_classes = logits.shape[-1]
    class_range = torch.arange(1, num_classes + 1, device=logits.device,
                               dtype=targets.dtype)[None, :]
    t = targets[:, None]
    p = torch.sigmoid(logits)
    term1 = (1.0 - p) ** gamma * torch.log(p.clamp(min=1e-20))
    term2 = p ** gamma * torch.log((1.0 - p).clamp(min=1e-20))
    pos = (t == class_range).to(logits.dtype)
    neg = ((t != class_range) & (t >= 0)).to(logits.dtype)
    return -pos * term1 * alpha - neg * term2 * (1.0 - alpha)
