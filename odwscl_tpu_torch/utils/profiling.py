"""Device busy time from a ``torch.profiler`` trace; the card's name, power
limit and published peak rates, for the bounds of the kernels."""

from __future__ import annotations

import subprocess

import torch

# Peak device-memory rate by card (NVIDIA data sheets) and the f32 rate
# outside the tensor cores, for the comparisons of the pooling kernels.
MEM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100": 3.35e12, "H200": 4.8e12}
F32_OPS_PER_S = {"H100 PCIe": 51.0e12, "H100": 67.0e12, "H200": 67.0e12}
# dense int8 tensor-core rate, for the int8 convolution kernel's bound
INT8_OPS_PER_S = {"H100 PCIe": 1513.0e12, "H100": 1979.0e12,
                  "H200": 1979.0e12}


def card_rate(name: str, table: dict) -> float:
    """The rate of the longest key of ``table`` found in the card's name."""
    for key in sorted(table, key=len, reverse=True):
        if key in name:
            return table[key]
    raise RuntimeError(f"no published rate for card {name!r}")


def card_name_and_limit() -> str:
    """Card 0's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def device_busy_seconds(prof) -> float:
    """Summed duration of the device events (kernels and copies) of a
    finished ``torch.profiler.profile``. The port runs one stream, so the
    events do not overlap and the sum is the busy time."""
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e6
