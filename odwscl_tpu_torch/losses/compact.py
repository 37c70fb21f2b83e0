"""Fixed-capacity compaction of boolean masks.

The counterpart of ``jnp.nonzero(mask, size=cap, fill_value=-1)`` on the
last axis: the indices of the first ``cap`` True entries, in order, padded
with -1. It runs on the device with a cumulative sum and a scatter, so it
brings no host sync (``torch.nonzero`` would, to size its output).
"""

from __future__ import annotations

from typing import Tuple

import torch


def first_true(mask: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [..., L] bool -> (idx [..., cap] int64 with -1 fill, count [...]
    of True entries, including those past ``cap``)."""
    lead, length = mask.shape[:-1], mask.shape[-1]
    m = mask.reshape(-1, length)
    rank = m.long().cumsum(dim=-1) - 1
    sel = m & (rank < cap)
    pos = torch.arange(length, device=mask.device).expand_as(m)
    out = torch.full((m.shape[0], cap + 1), -1, dtype=torch.long,
                     device=mask.device)
    # unselected entries all land in the extra column, which is dropped
    out.scatter_(1, torch.where(sel, rank, cap), torch.where(sel, pos, -1))
    return (out[:, :cap].reshape(*lead, cap),
            m.sum(dim=-1).reshape(lead))
