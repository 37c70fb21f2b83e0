"""The MIST weak-detection predictor, eval mode.

Counterpart of ``odwscl_tpu/models/predictors.py:MISTPredictor``: cls/det
heads plus ``num_refs`` refinement branches, each with 4*C box deltas. All
heads are one fused matmul over the concatenated head weights. The eval
softmaxes are taken with the proposal mask: the det softmax runs over P
with padding excluded.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _softmax_p(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax along the proposal axis P with padding excluded; pads get 0."""
    m3 = mask[..., None]
    masked = torch.where(m3, logits.to(torch.float32),
                         torch.tensor(float("-inf"), device=logits.device))
    m = masked.amax(dim=-2, keepdim=True)
    e = torch.where(m3, torch.exp(masked - m), torch.zeros((), device=m.device))
    return e / e.sum(dim=-2, keepdim=True).clamp(min=1e-20)


def _softmax_c(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.to(torch.float32), dim=-1)


class MISTPredictor(nn.Module):
    """Heads ``cls_score``, ``det_score``, ``ref{i}``, ``bbox_pred{i}``
    (i = 1..num_refs), each a Linear(in_dim, .)."""

    def __init__(self, in_dim: int = 4096, num_classes: int = 21,
                 num_refs: int = 3, cls_agnostic_bbox_reg: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        num_bbox_classes = 2 if cls_agnostic_bbox_reg else num_classes
        self.heads = [("cls_score", num_classes), ("det_score", num_classes)]
        for i in range(num_refs):
            self.heads.append((f"ref{i + 1}", num_classes))
            self.heads.append((f"bbox_pred{i + 1}", num_bbox_classes * 4))
        for name, feats in self.heads:
            self.add_module(name, nn.Linear(in_dim, feats))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, _ in self.heads:
            lin = getattr(self, name)
            lin.weight.normal_(0.0, 0.001, generator=generator)
            lin.bias.zero_()

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
        """x [B, P, D], mask [B, P] -> (cls softmax [B,P,C], det softmax over
        P [B,P,C], ref softmaxes, bbox deltas), the eval outputs."""
        dt = self.compute_dtype
        lins = [getattr(self, name) for name, _ in self.heads]
        weight = torch.cat([lin.weight for lin in lins]).to(dt)
        bias = torch.cat([lin.bias for lin in lins]).to(dt)
        fused = F.linear(x.to(dt), weight, bias)
        outs = torch.split(fused, [f for _, f in self.heads], dim=-1)
        refs = [_softmax_c(r) for r in outs[2::2]]
        return (_softmax_c(outs[0]), _softmax_p(outs[1], mask), refs,
                list(outs[3::2]))
