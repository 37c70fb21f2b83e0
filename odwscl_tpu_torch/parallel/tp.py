"""Tensor-parallel fc6/fc7 serving: fc6 by columns, fc7 by rows, one f32
all-reduce.

Counterpart of ``odwscl_tpu/parallel/tp.py`` (a serving option; no CLI
uses it in either package). Each of ``world`` ranks holds fc6's output
units ``[r * H / world, (r + 1) * H / world)`` (its rows of the torch
weight [H, K]) with their biases, and fc7's matching input columns; the
hidden activation [N, H / world] and its ReLU stay on the rank, and one
all-reduce of fc7's partial products gives every rank the whole output.
Weight memory and GEMM work per rank drop by the world size.

The numerics are the JAX function's (``tp.py:46-68`` there): both GEMMs
in the compute dtype, fc7's partial product cast to f32 and summed across
ranks in f32, fc7's bias (f32) and the ReLU after the sum, the result
cast back to the compute dtype. ``tp_neck_plain`` is the same arithmetic
on one rank with the whole weights; at world size 1 the two are equal
bit for bit.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F


def shard_neck_params(neck, rank: int, world: int
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Rank ``rank``'s shard of a neck with ``fc6`` and ``fc7``
    ``nn.Linear``s (``VGGRoINeck``): {"fc6": {"weight" [H/w, K], "bias"
    [H/w]}, "fc7": {"weight" [H2, H/w], "bias" [H2]}}. Raises unless
    ``world`` divides fc6's width."""
    h = neck.fc6.out_features
    if h % world:
        raise ValueError(f"fc6's {h} units do not split over {world} ranks")
    cols = slice(rank * h // world, (rank + 1) * h // world)
    return {"fc6": {"weight": neck.fc6.weight.detach()[cols].contiguous(),
                    "bias": neck.fc6.bias.detach()[cols].contiguous()},
            "fc7": {"weight": neck.fc7.weight.detach()[:, cols].contiguous(),
                    "bias": neck.fc7.bias.detach().clone()}}


def tp_neck_apply(params, x: torch.Tensor, group=None,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """Eval-mode fc6/fc7 (no dropout) of this rank's shard ``params``
    (``shard_neck_params``) on ``x`` [N, r, r, C] or [N, K], the same rows
    on every rank; returns [N, H2] in ``compute_dtype``, the same on every
    rank of ``group``."""
    dt = compute_dtype
    p6, p7 = params["fc6"], params["fc7"]
    x = x.reshape(x.shape[0], -1).to(dt)
    h = F.relu(F.linear(x, p6["weight"].to(dt), p6["bias"].to(dt)))
    z = F.linear(h, p7["weight"].to(dt)).to(torch.float32)
    dist.all_reduce(z, group=group)
    return F.relu(z + p7["bias"].to(torch.float32)).to(dt)


@torch.no_grad()
def tp_neck_plain(neck, x: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """``tp_neck_apply``'s arithmetic with the whole neck on one rank."""
    dt = compute_dtype
    x = x.reshape(x.shape[0], -1).to(dt)
    h = F.relu(F.linear(x, neck.fc6.weight.to(dt), neck.fc6.bias.to(dt)))
    z = F.linear(h, neck.fc7.weight.to(dt)).to(torch.float32)
    return F.relu(z + neck.fc7.bias.to(torch.float32)).to(dt)
