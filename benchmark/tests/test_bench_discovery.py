"""The harness finds every file of a cell by name, and a new cell needs
only new files and entries of ``BENCHMARK.json``."""

import json
import shutil

from benchmark import harness


def test_every_cell_of_the_spec_resolves():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.Cell(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.driver().__name__.endswith(cell.traffic["driver"])
        assert set(cell.limits)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)
    for c in spec["configs"]:
        assert harness.load_json(harness.ROOT / c["file"])["name"] == \
            c["name"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs/voc07_vgg16.json").read_text())
    cfg["name"] = "voc07_vgg16_b4"
    cfg["overrides"]["SOLVER.IMS_PER_BATCH"] = 4
    (here / "configs/voc07_vgg16_b4.json").write_text(json.dumps(cfg))
    (here / "traffic/train_long.json").write_text(json.dumps(
        {"driver": "train", "check_steps": 2}))
    (here / "limits/voc07_vgg16_b4.train_long.json").write_text(
        json.dumps({"loss_gap": 0.1}))
    (here / "metrics/train.steps.py").write_text(
        "def read(ctx):\n    return float(ctx['counts']['steps'])\n")
    spec = harness.load_spec()
    spec["configs"].append({"name": "voc07_vgg16_b4", "source": "x",
                            "file": "benchmark/configs/voc07_vgg16_b4.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "voc07_vgg16_b4.train_long",
                              "config": "voc07_vgg16_b4",
                              "traffic": "train_long", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("voc07_vgg16_b4.train_long")
    spec["per_layer"].append({"name": "train.steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "train_images_per_s",
                              "workloads": ["voc07_vgg16_b4.train_long"]})
    cell = harness.Cell(spec, "voc07_vgg16_b4.train_long", here=here)
    assert cell.config["overrides"]["SOLVER.IMS_PER_BATCH"] == 4
    assert cell.traffic["check_steps"] == 2
    assert [m["name"] for m in cell.per_layer] == ["train.steps"]
    assert cell.metric_reader("train.steps").read(
        {"counts": {"steps": 7}}) == 7.0
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s",
                                                   "setup_s"}
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file() and p.relative_to(
                 here) in before}
    assert after == before          # no file that was there changed


def test_metric_files_are_named_by_the_spec():
    spec = harness.load_spec()
    on_disk = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert on_disk == {m["name"] for m in spec["per_layer"]}
