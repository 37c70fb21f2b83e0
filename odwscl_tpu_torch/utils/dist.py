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
