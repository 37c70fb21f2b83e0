"""The process group of a multi-process run, when there is one."""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist


def process_count_and_index(count: Optional[int] = None,
                            index: Optional[int] = None) -> Tuple[int, int]:
    """(process count, this process's index): the given values, else
    ``torch.distributed``'s world size and rank when it is initialized,
    else (1, 0)."""
    live = dist.is_available() and dist.is_initialized()
    if count is None:
        count = dist.get_world_size() if live else 1
    if index is None:
        index = dist.get_rank() if live else 0
    return count, index


def rank_slice(n: int, world_size: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n`` items; raises unless
    ``world_size`` divides ``n`` (the JAX sampler drops the remainder)."""
    if n % world_size:
        raise ValueError(
            f"a global batch of {n} images does not split over "
            f"{world_size} processes: set SOLVER.IMS_PER_BATCH to a "
            f"multiple of the world size")
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)
