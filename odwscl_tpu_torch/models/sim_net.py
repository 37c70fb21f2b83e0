"""Contrastive projection head: in_dim -> in_dim -> 128, L2-normalized.

Counterpart of ``odwscl_tpu/models/sim_net.py:SimNet``: the embeddings of
the contrastive mining and loss. Evaluation never calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class SimNet(nn.Module):
    def __init__(self, in_dim: int = 4096, embed_dim: int = 128,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp0 = nn.Linear(in_dim, in_dim)
        self.mlp1 = nn.Linear(in_dim, embed_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-normal fan-out weights (fan-out of a Dense is its output
        width), zero bias."""
        for lin in (self.mlp0, self.mlp1):
            lin.weight.normal_(0.0, (2.0 / lin.out_features) ** 0.5,
                               generator=generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = F.relu(F.linear(x.to(dt), self.mlp0.weight.to(dt),
                            self.mlp0.bias.to(dt)))
        z = F.linear(h, self.mlp1.weight.to(dt),
                     self.mlp1.bias.to(dt)).to(torch.float32)
        sq = (z * z).sum(dim=-1, keepdim=True).clamp(min=1e-24)
        return z * torch.rsqrt(sq)
