"""The control of ``correct`` at a size a CPU test run holds: training's
reference in fp8 in the program's place, and eval's int8 serving path,
have to read as not correct against the cells' limits, where the
program's own float32 path reads correct.

On the card, ``benchmark/calibrate.py --control`` reads the same at the
cells' own sizes (PERF.md gives those readings)."""

import json

import pytest
import torch

from benchmark import calibrate, harness


@pytest.mark.parametrize("workload", ["voc07_vgg16.train",
                                      "voc07_vgg16.eval_tta"])
def test_the_control_reads_not_correct(workload, tiny, tmp_path):
    out = tmp_path / "cal.json"
    calibrate.main(["--workload", workload, "--seeds", "5", "--control",
                    "--out", str(out)], extra=tiny,
                   device=torch.device("cpu"))
    res = json.loads(out.read_text())["seeds"]["5"]
    limits = harness.Cell(harness.load_spec(), workload).limits
    assert all(res["program"][n] <= lim for n, lim in limits.items()), res
    assert any(res["control"][n] > lim for n, lim in limits.items()), res
