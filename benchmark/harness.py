"""The benchmark's general parts: finding a cell's files by name, the cache
directories, the import check, the device's record and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``driver`` (``drivers/<driver>.py``, the general loop of its kind:
  training or TTA eval) that runs it;
- ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None``;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may load (compared whole: the port's
# name, odwscl_tpu_torch, begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "odwscl_tpu")


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds (the port's nvcc libraries already go to
    ``build/odwscl_tpu_torch/``), and the switches that keep libraries
    from loading JAX."""
    build = root / "build"
    return {"TRITON_CACHE_DIR": str(build / "triton_cache"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor_cache"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache"),
            "USE_FLAX": "0"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark as a module of its own (file names
    may hold dots: ``metrics/train.mfu.py``)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    mod_name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    driver, limits and metrics, each found by name."""

    def __init__(self, spec: dict, name: str, here: Path = HERE):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(sorted(by_name))})")
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(here / "configs" /
                                f"{self.workload['config']}.json")
        self.traffic = load_json(here / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.driver_name = self.traffic["driver"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]
        self.here = here

    def driver(self) -> ModuleType:
        return importlib.import_module(f"benchmark.drivers.{self.driver_name}")

    def metric_reader(self, metric: str) -> ModuleType:
        return load_module(self.here / "metrics" / f"{metric}.py")


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name, whole, is forbidden."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def device_record(torch, count: int) -> dict:
    """The contract's ``device``: platform, the card's name, the cards used
    and the peak allocated bytes of the fullest."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def checks_text(checks: List[dict]) -> List[str]:
    """One line per compared number: its name, value and limit."""
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if c['ok'] else 'FAILED'})" for c in checks]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[dict],
                breakdown: Optional[dict] = None) -> str:
    """The contract's last line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
