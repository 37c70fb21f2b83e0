"""The port's CLIs on the JAX package's Orbax checkpoints, on the CPU.

tests/data/orbax_wsod_small (tests/make_orbax_fixture.py: the WSOD
detector of configs/voc/voc07_contra_db_b8_lr0.01_mcg.yaml at narrow widths,
3 JAX train steps, saved by the JAX package's ``Checkpointer.save``) on a
synthetic VOC split, with configs/voc/voc07_synth_smoke.yaml (the same
model tree) and the fixture's ``MLP_HEAD_DIM``:
- ``test_net --ckpt <the Orbax directory>`` evaluates the same model as
  ``--weights`` of its params as an ``.npz`` (written from orbax's restore)
  and as ``test_net`` with neither on an ``OUTPUT_DIR`` whose
  ``last_checkpoint`` names the directory: the same detections, equal (no
  tolerance), and the same mAP;
- ``train_net`` resumes from a JAX ``OUTPUT_DIR`` (the checkpoint and a
  ``last_checkpoint`` naming it by absolute path, as the JAX package
  writes it): its first iteration is the saved step + 1; and from one
  whose ``last_checkpoint`` names the path the directory had on another
  machine (the same name inside ``OUTPUT_DIR`` is used).
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import odwscl_tpu_torch.models.vgg16 as tvgg
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.tools import test_net, train_net
from odwscl_tpu_torch.utils.from_jax import save_npz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_wsod_small")
with open(os.path.join(FIXTURE, "fixture.json")) as _f:
    FX = json.load(_f)
CONFIG = os.path.join(ROOT, "configs", "voc", "voc07_synth_smoke.yaml")
OPTS = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM",
        FX["opts"][FX["opts"].index("MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM") + 1],
        "TPU.COMPUTE_DTYPE", "float32"]


@pytest.fixture()
def data(tmp_path, monkeypatch):
    monkeypatch.setitem(tvgg.VGG_CFGS, "VGG16-OICR", FX["VGG16-OICR"])
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    root = str(tmp_path / "voc")
    write_synthetic_voc(root, n_test=4, seed=0, img_hw=(96, 128), n_props=16,
                        test_proposal_file=cfg.PROPOSAL_FILES.TEST[0],
                        n_trainval=4,
                        train_proposal_file=cfg.PROPOSAL_FILES.TRAIN[0])
    return root


def _jax_output_dir(dst, named=None):
    """A copy of the fixture as a JAX run's OUTPUT_DIR: the checkpoint and
    ``last_checkpoint`` (``named``, else the copy's absolute path)."""
    os.makedirs(dst)
    ckpt = os.path.join(dst, FX["checkpoint"])
    shutil.copytree(os.path.join(FIXTURE, FX["checkpoint"]), ckpt)
    with open(os.path.join(dst, "last_checkpoint"), "w") as f:
        f.write(named or os.path.abspath(ckpt))
    return ckpt


def _predictions(out, dataset):
    path = os.path.join(out, "inference", dataset, "predictions.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)


def test_test_net_evaluates_the_orbax_checkpoint_as_its_npz(data, tmp_path):
    ckpt = _jax_output_dir(str(tmp_path / "jax_run"))
    npz = str(tmp_path / "params.npz")
    params = ocp.StandardCheckpointer().restore(ckpt)["params"]
    save_npz(npz, jax.tree_util.tree_map(np.asarray, params))
    runs = {"ckpt": ["--ckpt", ckpt], "npz": ["--weights", npz],
            "last_checkpoint": []}
    results, preds = {}, {}
    for name, args in runs.items():
        out = (str(tmp_path / "jax_run") if name == "last_checkpoint"
               else str(tmp_path / name))
        res = test_net.main(["--config-file", CONFIG, "--data-root", data,
                             "--device", "cpu", *args, "OUTPUT_DIR", out,
                             *OPTS])
        ((dataset, results[name]),) = res.items()
        preds[name] = _predictions(out, dataset)
    for name in ("npz", "last_checkpoint"):
        assert results[name]["map"] == results["ckpt"]["map"], name
        assert len(preds[name]) == len(preds["ckpt"]) == 4
        for a, b in zip(preds[name], preds["ckpt"]):
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), \
                    (name, k)


@pytest.mark.parametrize("moved", [False, True])
def test_train_net_resumes_a_jax_run(data, tmp_path, moved):
    out = str(tmp_path / "jax_run")
    named = ("/elsewhere/jax_run/" + FX["checkpoint"]) if moved else None
    _jax_output_dir(out, named)
    timing = {}
    train_net.main(["--config-file", CONFIG, "--data-root", data,
                    "--device", "cpu", "--skip-test", "OUTPUT_DIR", out,
                    "SOLVER.MAX_ITER", str(FX["step"] + 2),
                    "SOLVER.CHECKPOINT_PERIOD", "100", *OPTS],
                   timing_out=timing)
    steps = timing["train"]["steps"]
    assert [s["iter"] for s in steps] == [FX["step"] + 1, FX["step"] + 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    final = torch.load(os.path.join(out, "model_final.pt"),
                       weights_only=True)
    assert final["step"] == FX["step"] + 2
    opt = final["optimizer"]
    assert {g["count"] for g in opt["param_groups"]} == {FX["step"] + 2}
    assert all("momentum_buffer" in s for s in opt["state"].values())
