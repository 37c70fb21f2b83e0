"""Tiny runs of each mix through the harness on the CPU (the port's plain
kernel paths), with and without a fault planted in the timed path.

Each fault (``benchmark/faults.py``) breaks the program underneath a run
that skips only the look for a card; the check has to read ``correct``
false. One card: no exchange between chips to leave out."""

import json

import pytest
import torch

from benchmark import faults, harness, run

CPU = torch.device("cpu")


def _run(workload, tiny, capsys, seed=11, seconds=2, trace=0):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], extra=tiny,
                  device=CPU)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.load_spec()["workloads"]])
def test_tiny_run_prints_the_contract_line(workload, tiny, capsys):
    res, err = _run(workload, tiny, capsys)
    cell = harness.Cell(harness.load_spec(), workload)
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(cell.limits)
    assert res["attempted"] > 0 and res["failed"] == 0
    last = err.strip().splitlines()[-len(cell.limits):]
    assert all(line.startswith("check ") for line in last)


def test_traced_tiny_run_reports_the_loop_metrics(tiny, capsys):
    res, _ = _run("voc07_vgg16.train", tiny, capsys, trace=1)
    # on the CPU only the host-clock reader finds something to read
    assert set(res["metrics"]) == {"train.data_wait_ms"}


@pytest.mark.parametrize("workload,fault", [
    *(("voc07_vgg16.train", f) for f in faults.TRAIN),
    *(("voc07_vgg16.eval_tta", f) for f in faults.EVAL),
])
def test_a_planted_fault_reads_not_correct(workload, fault, tiny, capsys):
    with faults.plant(fault):
        res, _ = _run(workload, tiny, capsys)
    assert res["correct"] is False, res["checks"]
