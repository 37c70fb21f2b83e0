"""Device busy time from a ``torch.profiler`` trace."""

from __future__ import annotations

import torch


def device_busy_seconds(prof) -> float:
    """Summed duration of the device events (kernels and copies) of a
    finished ``torch.profiler.profile``. The port runs one stream, so the
    events do not overlap and the sum is the busy time."""
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e6
