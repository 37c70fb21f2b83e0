"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process: set-up (the cell's data written from the seed, the port's
model with the seed's weights, the cell's shapes warmed), then the
measured window of ``--seconds``, then the check of what the window's
path produced against the plain reference. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiler trace of the window and the loop's counts.
The numbers compared, each beside its limit, are the last lines on
standard error and the last key of the result, which is the last line on
standard output. Exits non-zero, printing no result, without enough CUDA
cards, or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, trace  # noqa: E402


class RunContext:
    """What a driver gets: the cell, the seed, the device, the data
    directory, (CPU tests only) extra config keys, and whether set-up warms
    the window's shapes (``calibrate.py`` runs no window)."""

    def __init__(self, cell, seed, device, data_root, extra=None,
                 warm=True):
        self.cell, self.seed, self.device = cell, seed, device
        self.data_root, self.extra, self.warm = data_root, extra, warm


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, extra=None, device=None) -> int:
    """``extra`` (config keys) and ``device`` (the CPU) are for the CPU
    tests; a run from the command line needs the cell's CUDA cards."""
    args = parse(argv)
    os.environ.update(harness.cache_env(ROOT))
    import torch

    spec = harness.load_spec(ROOT)
    cell = harness.Cell(spec, args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    data_root = tempfile.mkdtemp(prefix="bench-data-")
    try:
        run = RunContext(cell, args.seed, device, data_root, extra)
        driver = cell.driver()
        st = driver.setup(run)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        t_window = time.perf_counter()
        traced = bool(args.trace) and cuda
        with trace.maybe_profile(traced) as prof:
            marks = trace.Window(torch, device) if traced else None
            if marks:
                marks.start()
            counts = driver.window(st, args.seconds)
            if cuda:
                torch.cuda.synchronize()
            spans = marks.stop() if marks else []
        t_read = time.perf_counter()
        dev = (harness.device_record(torch, cell.chips) if cuda else
               {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0})
        breakdown = None
        if args.trace:
            tr = (trace.from_profiler(prof, marks, spans)
                  if prof is not None else None)
            prof = None
            # a reader gets the window's trace (None without a card), the
            # loop's counts and the card's name
            metrics = read_per_layer(cell, {"trace": tr, "counts": counts,
                                            "card": dev["kind"]})
            if tr is not None:
                dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
                breakdown = trace.breakdown(tr)
        else:
            metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
            units = {m["name"]: m["unit"] for m in cell.end_to_end}
            for name, value in driver.end_to_end(counts).items():
                metrics[name] = {"value": value, "unit": units[name]}
        driver.release(st)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = driver.check(st)
        print(f"[bench] {harness.power_limit() if cuda else 'cpu'}; set-up "
              f"{setup_s:.1f} s, window {t_read - t_window:.1f} s, trace "
              f"read {t_check - t_read:.1f} s, check "
              f"{time.perf_counter() - t_check:.1f} s; {counts.get('diag', '')}",
              file=sys.stderr)
        checks = [{"name": n, "value": v, "limit": cell.limits[n],
                   "ok": v <= cell.limits[n]} for n, v in numbers.items()]
        bad = harness.forbidden_loaded()
        if bad:
            print(f"modules of JAX or the JAX package were loaded: {bad}",
                  file=sys.stderr)
            return 4
        correct = all(c["ok"] for c in checks) and counts["failed"] == 0
        attempted = counts.get("steps", counts.get("images"))
        for line in harness.checks_text(checks):
            print(line, file=sys.stderr)
        print(harness.result_line(correct, attempted, counts["failed"],
                                  metrics, dev, checks, breakdown),
              flush=True)
        return 0
    finally:
        shutil.rmtree(data_root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
