"""The CLI flags of this slice, on the CPU at a tiny size.

- ``train_net --use-tensorboard --profile-dir``: ``OUTPUT_DIR/logs/
  scalars.jsonl`` holds one record an iteration with the JAX
  ``JsonlLogger``'s keys (``iteration``, ``time``, ``data`` and the step's
  losses and metrics), the trace of iterations 2-6 lies in the profile
  directory, and ``OUTPUT_DIR/log.txt`` holds the log.
- ``train_net --distributed`` at world size 1 (a ``file://`` init method)
  takes the data-parallel step and trains as the plain run does.
- ``test_net`` without weights evaluates the checkpoint that
  ``OUTPUT_DIR/last_checkpoint`` names (it used to evaluate a random
  init); ``--ckpt`` names one; ``--vis`` writes jpgs; ``--int8`` sets
  ``TPU.INT8_EVAL``, ``INT8_EVAL_CONVS`` and ``INT8_STATIC``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.tools import test_net, train_net
from odwscl_tpu_torch.utils.checkpoint import load_model_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")
TINY = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
        "float32", "TPU.BANK_CAPACITY", "64", "TPU.PROPOSAL_BUCKETS", "(32,)",
        "DATALOADER.NUM_WORKERS", "1", "INPUT.MIN_SIZE_TRAIN", "(64,)",
        "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
        "INPUT.MAX_SIZE_TEST", "96"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    write_synthetic_voc(root, n_test=2, seed=0, img_hw=(80, 96), n_props=24,
                        prop_size=(10, 30), obj_size=(20, 40), n_trainval=4)
    return root


def _train(data, out, iters, *flags, timing=None):
    return train_net.main(["--config-file", CONFIG, "--data-root", data,
                           "--device", "cpu", "--skip-test", *flags,
                           "OUTPUT_DIR", str(out), "SOLVER.MAX_ITER",
                           str(iters), "SOLVER.CHECKPOINT_PERIOD", "1", *TINY],
                          timing_out=timing)


def test_tensorboard_scalars_and_profile_trace(data, tmp_path):
    from odwscl_tpu.utils.logging_utils import JsonlLogger as JaxJsonl

    timing = {}
    _train(data, tmp_path / "out", 6, "--use-tensorboard", "--profile-dir",
           str(tmp_path / "prof"), timing=timing)
    with open(tmp_path / "out" / "logs" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = timing["train"]["steps"]
    assert [r["iteration"] for r in recs] == [1, 2, 3, 4, 5, 6]
    # the JAX logger's record of the same update
    jax_log = JaxJsonl(str(tmp_path / "jax"))
    st = steps[0]
    values = {k: v for k, v in st.items()
              if k not in ("iter", "step_s", "data_s")}
    jax_log.update(time=st["step_s"], data=st["data_s"], **values)
    with open(jax_log.path) as f:
        want = json.loads(f.read())
    assert set(recs[0]) == set(want)
    assert {k: recs[0][k] for k in values} == {k: want[k] for k in values}
    assert recs[0]["time"] == st["step_s"] and recs[0]["data"] == st["data_s"]
    traces = glob.glob(str(tmp_path / "prof" / "worker0.pt.trace.json"))
    assert traces and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "out" / "log.txt") as f:
        assert "iter: 6" in f.read()


def test_distributed_world_one_trains_as_the_plain_run(data, tmp_path,
                                                        monkeypatch):
    import torch.distributed as dist

    plain, dp = {}, {}
    _train(data, tmp_path / "plain", 2, timing=plain)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    _train(data, tmp_path / "dp", 2, "--distributed", "--dist-url",
           "file://" + str(tmp_path / "init"), timing=dp)
    assert not dist.is_initialized()
    # the CPU convolutions' sums may differ in the last bits between two
    # equal calls on other buffers, so the bounds of
    # tests/test_torch_data_parallel.py apply
    for a, b in zip(plain["train"]["steps"], dp["train"]["steps"]):
        for k in a:
            if k not in ("step_s", "data_s"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-9,
                                           err_msg=k)
    got = load_model_weights(str(tmp_path / "dp" / "model_final.pt"))
    for k, v in load_model_weights(str(tmp_path / "plain" /
                                       "model_final.pt")).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.fixture
def evaluated(monkeypatch):
    """Records the config and the state_dict that test_net evaluates."""
    seen = {}

    def run_test(cfg, model, data_root, device, task="det", timing_out=None,
                 vis=False):
        seen.update(cfg=cfg, state=model.state_dict(), vis=vis)
        return {}

    monkeypatch.setattr(test_net, "run_test", run_test)
    return seen


def _eval(data, out, *flags):
    return test_net.main(["--config-file", CONFIG, "--data-root", data,
                          "--device", "cpu", *flags, "OUTPUT_DIR", str(out),
                          *TINY])


def test_test_net_evaluates_the_last_checkpoint(data, tmp_path, evaluated):
    _train(data, tmp_path, 1)
    with open(tmp_path / "last_checkpoint") as f:
        last = f.read().strip()
    _eval(data, tmp_path)
    want = load_model_weights(last)
    assert evaluated["state"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(evaluated["state"][k], v), k
    # without a checkpoint: the seeded random init, which differs
    _eval(data, tmp_path / "fresh")
    assert any(not torch.equal(evaluated["state"][k], v)
               for k, v in want.items())


def test_test_net_ckpt_names_a_checkpoint(data, tmp_path, evaluated):
    _train(data, tmp_path, 2)
    first = str(tmp_path / "model_0000001.pt")
    _eval(data, tmp_path, "--ckpt", first)
    for k, v in load_model_weights(first).items():
        assert torch.equal(evaluated["state"][k], v), k
    with pytest.raises(ValueError, match="not both"):
        _eval(data, tmp_path, "--ckpt", first, "--weights", first)


def test_test_net_int8_sets_the_three_keys(data, tmp_path, evaluated):
    _eval(data, tmp_path, "--int8")
    t = evaluated["cfg"].TPU
    assert t.INT8_EVAL and t.INT8_EVAL_CONVS and t.INT8_STATIC
    _eval(data, tmp_path)
    t = evaluated["cfg"].TPU
    assert not (t.INT8_EVAL or t.INT8_EVAL_CONVS or t.INT8_STATIC)


def test_test_net_vis_writes_jpgs(data, tmp_path):
    res = test_net.main(["--config-file", CONFIG, "--data-root", data,
                         "--device", "cpu", "--vis", "OUTPUT_DIR",
                         str(tmp_path), *TINY])
    (name,) = res
    jpgs = sorted(glob.glob(str(tmp_path / "inference" / name / "vis" /
                                "*.jpg")))
    assert [os.path.basename(p) for p in jpgs] == ["vis_000000.jpg",
                                                   "vis_000001.jpg"]
