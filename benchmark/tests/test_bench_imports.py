"""The whole-name check that no run loads JAX or the JAX package."""

import subprocess
import sys
import types

from benchmark import harness


def test_whole_top_level_names():
    assert harness.forbidden_loaded({"odwscl_tpu_torch", "odwscl_tpu_torch.x",
                                     "torch", "jaxtyping"}) == []
    assert harness.forbidden_loaded({"jax.numpy"}) == ["jax"]
    assert harness.forbidden_loaded({"odwscl_tpu.ops.roi_pool"}) == [
        "odwscl_tpu"]
    assert harness.forbidden_loaded({"flax", "jaxlib.xla_client"}) == [
        "flax", "jaxlib"]


def test_a_planted_import_jax_is_caught(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import jax; from benchmark import harness; "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(harness.ROOT)], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "['jax']"


def test_the_benchmark_and_the_port_load_neither():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.run, benchmark.calibrate, benchmark.flops; "
            "import benchmark.drivers.train, benchmark.drivers.eval_tta; "
            "import odwscl_tpu_torch.engine.trainer, "
            "odwscl_tpu_torch.engine.inference; "
            "from benchmark import harness; "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, tiny, capsys):
    import torch

    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "voc07_vgg16.eval_tta", "--seed", "3",
                   "--seconds", "1"], extra=tiny, device=torch.device("cpu"))
    assert rc != 0
    assert "correct" not in capsys.readouterr().out
