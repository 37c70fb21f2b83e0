"""The weak-detection predictor heads.

Counterpart of ``odwscl_tpu/models/predictors.py``: ``WSDDNPredictor``
(cls and det heads), ``OICRPredictor`` (plus ``num_refs`` refinement
branches) and ``MISTPredictor`` (each branch also with 4*C box deltas).
Every head is a Linear(in_dim, .) initialised N(0, 0.001) with a zero
bias, and all of a predictor's heads run as one matmul over their
concatenated weights. In train mode the heads return raw logits; the eval
softmaxes are taken with the proposal mask: the det softmax runs over P
with padding excluded. ``refs`` is None for WSDDN and ``bbox`` is None for
WSDDN and OICR.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


class _Predictor(nn.Module):
    """Heads named as in the JAX package, each a Linear(in_dim, .)."""

    def __init__(self, heads, in_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.heads = list(heads)
        for name, feats in self.heads:
            self.add_module(name, nn.Linear(in_dim, feats))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, _ in self.heads:
            lin = getattr(self, name)
            lin.weight.normal_(0.0, 0.001, generator=generator)
            lin.bias.zero_()

    def _logits(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Every head's logits from one fused matmul in the compute dtype."""
        dt = self.compute_dtype
        lins = [getattr(self, name) for name, _ in self.heads]
        weight = torch.cat([lin.weight for lin in lins]).to(dt)
        bias = torch.cat([lin.bias for lin in lins]).to(dt)
        fused = F.linear(x.to(dt), weight, bias)
        return torch.split(fused, [f for _, f in self.heads], dim=-1)


class WSDDNPredictor(_Predictor):
    """Heads ``cls_score`` and ``det_score``."""

    def __init__(self, in_dim: int = 4096, num_classes: int = 21,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__([("cls_score", num_classes),
                          ("det_score", num_classes)], in_dim, compute_dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False):
        """x [B, P, D], mask [B, P] -> (cls, det, None, None)."""
        cls, det = self._logits(x)
        if train:
            return cls, det, None, None
        return _softmax_c(cls), _softmax_p(det, mask), None, None


class OICRPredictor(_Predictor):
    """Heads ``cls_score``, ``det_score`` and ``ref{i}`` (i = 1..num_refs)."""

    def __init__(self, in_dim: int = 4096, num_classes: int = 21,
                 num_refs: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__([("cls_score", num_classes),
                          ("det_score", num_classes)]
                         + [(f"ref{i + 1}", num_classes)
                            for i in range(num_refs)], in_dim, compute_dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False):
        """x [B, P, D], mask [B, P] -> (cls, det, refs, None)."""
        cls, det, *refs = self._logits(x)
        if train:
            return cls, det, list(refs), None
        return (_softmax_c(cls), _softmax_p(det, mask),
                [_softmax_c(r) for r in refs], None)


class MISTPredictor(_Predictor):
    """Heads ``cls_score``, ``det_score``, ``ref{i}``, ``bbox_pred{i}``
    (i = 1..num_refs)."""

    def __init__(self, in_dim: int = 4096, num_classes: int = 21,
                 num_refs: int = 3, cls_agnostic_bbox_reg: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        num_bbox_classes = 2 if cls_agnostic_bbox_reg else num_classes
        heads = [("cls_score", num_classes), ("det_score", num_classes)]
        for i in range(num_refs):
            heads.append((f"ref{i + 1}", num_classes))
            heads.append((f"bbox_pred{i + 1}", num_bbox_classes * 4))
        super().__init__(heads, in_dim, compute_dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                           Optional[List[torch.Tensor]]]:
        """x [B, P, D], mask [B, P] -> (cls, det, refs, bbox deltas): raw
        logits in train mode; else the cls softmax [B,P,C], the det softmax
        over P, the ref softmaxes and the deltas."""
        outs = self._logits(x)
        if train:
            return outs[0], outs[1], list(outs[2::2]), list(outs[3::2])
        refs = [_softmax_c(r) for r in outs[2::2]]
        return (_softmax_c(outs[0]), _softmax_p(outs[1], mask), refs,
                list(outs[3::2]))


PREDICTORS = {
    "WSDDNPredictor": WSDDNPredictor,
    "OICRPredictor": OICRPredictor,
    "MISTPredictor": MISTPredictor,
}
