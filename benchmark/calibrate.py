"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control] [--faults] --out FILE.json

For each seed, in one process: the program's numbers (the timed path's
set-up, then the check against the reference, as a run makes them), and
with ``--control`` the control's (training: the reference in fp8, one
precision below the configuration's bfloat16, in the program's place;
eval: the program's own int8 serving path, ``TPU.INT8_EVAL`` and
``TPU.INT8_EVAL_CONVS``), and with ``--faults`` the planted faults'.
Training's are planted in the reference put in the program's place: half
of each batch left out, the mean taken over the rest; every learning rate
off by ``faults.LR_FACTOR``; ROIPool's backward routing each cell's
gradient to another cell (``MISROUTES``); a step that leaves the state unchanged reads a
change gap of 1 and needs no run. Eval's are planted in the program
(``faults.EVAL``) and serve the same batches again. Writes every reading
to ``--out``.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference.model import MISROUTES  # noqa: E402
from benchmark.run import RunContext  # noqa: E402


def train_seed(driver, run, control: bool, faults: bool) -> dict:
    from benchmark import faults as F

    st = driver.setup(run)
    driver.release(st)
    gc.collect()
    ref = driver.reference_readings(st)
    out = {"program": driver.compare(st.readings, ref),
           "raw": {"program": _plain(st.readings), "reference": _plain(ref)}}
    if control:
        ctrl = driver.reference_readings(st, "fp8")
        out["control"] = driver.compare(ctrl, ref)
        out["raw"]["control"] = _plain(ctrl)
    if faults:
        planted = [("half_batch", {"half_batch": True}),
                   ("lr_scaled", {"lr_scale": F.LR_FACTOR})]
        planted += [(f"pool_grad_{r}", {"pool_grad_route": r})
                    for r in MISROUTES]
        for name, fault in planted:
            bad = driver.reference_readings(st, **fault)
            out[f"fault_{name}"] = driver.compare(bad, ref)
            out["raw"][f"fault_{name}"] = _plain(bad)
        still = copy.deepcopy(st.readings)
        still["change_norm"] = {n: 0.0 for n in still["change_norm"]}
        out["fault_unchanged"] = driver.compare(still, ref)
    return out


def _plain(raw: dict) -> dict:
    """The readings without their gradient tensors, for the JSON file."""
    return {k: v for k, v in raw.items() if k != "first_grad"}


def eval_seed(driver, run, control: bool, faults: bool) -> dict:
    import torch

    from benchmark import faults as F
    from benchmark import program

    st = driver.setup(run)
    keys = list(range(int(run.cell.traffic["check_batches"])))
    items = [x for _, x in zip(keys, st.loader)]
    st.served = {}
    driver.serve(st, iter(items), st.served)
    served = {}
    for name in F.EVAL if faults else ():
        served[f"fault_{name}"] = {}
        with F.plant(name):
            driver.serve(st, iter(items), served[f"fault_{name}"])
    if control:
        cfg_i8 = program.build_cfg(run.cell.config, run.cell.traffic, {
            **(run.extra or {}), "TPU.INT8_EVAL": True,
            "TPU.INT8_EVAL_CONVS": True})
        st_i8 = driver.State()
        st_i8.run, st_i8.cfg, st_i8.records = run, cfg_i8, st.records
        st_i8.model, st_i8.inferencer, st_i8.loader = driver._program(
            cfg_i8, run)
        served["control"] = {}
        driver.serve(st_i8, iter(items), served["control"])
        driver.release(st_i8)
    driver.release(st)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference_outputs(st, keys)
    nms = st.cfg.MODEL.ROI_HEADS.NMS
    out = {"program": driver.compare(st.served, keys, ref, nms),
           "raw": {"program": driver.gaps(st.served, keys, ref, nms)}}
    for name, got in served.items():
        out[name] = driver.compare(got, keys, ref, nms)
        out["raw"][name] = driver.gaps(got, keys, ref, nms)
    return out


def main(argv=None, extra=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    os.environ.update(harness.cache_env(ROOT))
    import torch

    cell = harness.Cell(harness.load_spec(ROOT), args.workload)
    device = device or torch.device("cuda", 0)
    driver = cell.driver()
    results = {"workload": cell.name, "card": (
        harness.power_limit() if device.type == "cuda" else "cpu"),
        "seeds": {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        root = tempfile.mkdtemp(prefix="bench-cal-")
        try:
            run = RunContext(cell, seed, device, root, extra, warm=False)
            fn = train_seed if cell.traffic["driver"] == "train" \
                else eval_seed
            res = fn(driver, run, args.control, args.faults)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        res["seconds"] = time.perf_counter() - t0
        results["seeds"][seed] = res
        print(json.dumps({"seed": seed, **{k: v for k, v in res.items()
                                           if k != "raw"}}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
