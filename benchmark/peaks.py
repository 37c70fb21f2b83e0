"""Published peak rates of the cards the benchmark runs on (NVIDIA's data
sheets, dense, without sparsity; at the card's full power limit: the run
reports the limit it found beside them). Matched by the longest key found
in ``torch.cuda.get_device_name()``."""

from __future__ import annotations

BF16_FLOPS = {"H100 PCIe": 756e12, "H100": 989e12, "H200": 989e12}
MEM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100": 3.35e12, "H200": 4.8e12}
F32_OPS_PER_S = {"H100 PCIe": 51e12, "H100": 67e12, "H200": 67e12}


def rate(card: str, table: dict) -> float:
    for key in sorted(table, key=len, reverse=True):
        if key in card:
            return table[key]
    raise KeyError(f"no published rate for card {card!r}")
