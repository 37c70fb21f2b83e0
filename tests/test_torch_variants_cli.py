"""The port's CLIs on the WSOD training variants, on the CPU, at a tiny
size (mlp_dim 64, f32, 2 iterations, synthetic VOC).

- ``train_net`` on configs/voc/voc07_faster_rcnn_cam_smoke.yaml (CAM
  proposals, no proposal files, ``SOLVER.CONTRA False``, DB none): every
  loss finite, ``loss_cam`` among them, the CAM trained.
- ``train_net`` on the synthetic smoke config with ``DB.METHOD concrete``
  (the checkpoint's optimizer holds the CDB's two ascending groups and
  their momentum buffers, which the gradients reached), with ``PREDICTOR
  WSDDNPredictor`` and with ``PREDICTOR OICRPredictor`` (both
  ``REGRESS_ON False``, ``SOLVER.CONTRA False``); then ``test_net`` from the WSDDN and OICR checkpoints: a finite mAP.
"""

import math
import os

import pytest
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.tools import test_net, train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")
CAM = os.path.join(REPO, "configs", "voc", "voc07_faster_rcnn_cam_smoke.yaml")
TINY = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
        "float32", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
        "DATALOADER.NUM_WORKERS", "1"]
VARIANTS = {
    "concrete": ["DB.METHOD", "concrete"],
    "wsddn": ["MODEL.ROI_WEAK_HEAD.PREDICTOR", "WSDDNPredictor",
              "MODEL.ROI_WEAK_HEAD.REGRESS_ON", "False",
              "SOLVER.CONTRA", "False"],
    "oicr": ["MODEL.ROI_WEAK_HEAD.PREDICTOR", "OICRPredictor",
             "MODEL.ROI_WEAK_HEAD.REGRESS_ON", "False",
             "SOLVER.CONTRA", "False"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    write_synthetic_voc(root, n_test=2, seed=0, img_hw=(120, 144),
                        n_props=64, n_trainval=4)
    return root


def _train(config, data, out, opts):
    timing = {}
    train_net.main(["--config-file", config, "--data-root", data,
                    "--device", "cpu", "--skip-test", "OUTPUT_DIR", str(out),
                    *TINY, *opts], timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    assert all(math.isfinite(v) for st in steps for v in st.values())
    return steps, torch.load(os.path.join(out, "model_final.pt"),
                             weights_only=True)


def test_train_net_cam_config(data, tmp_path):
    steps, ckpt = _train(CAM, data, tmp_path, [])
    assert "loss_cam" in steps[0] and "loss_sim" not in steps[0]
    assert ckpt["model"]["cam.cam_conv.weight"].abs().max() > 0
    assert "loss_ref_cls0" in steps[0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_net_variant_then_test_net(variant, data, tmp_path):
    opts = VARIANTS[variant]
    steps, ckpt = _train(SYNTH, data, tmp_path, opts)
    groups = ckpt["optimizer"]["param_groups"]
    if variant == "concrete":
        assert [g["scale"] for g in groups] == [1.0, 1.0, -0.01, -0.01]
        state = ckpt["optimizer"]["state"]
        bufs = [state[i]["momentum_buffer"] for g in groups[2:]
                for i in g["params"]]
        assert len(bufs) == 7 and any(b.abs().max() > 0 for b in bufs)
        return
    assert len(groups) == 2
    assert ("loss_ref_cls0" in steps[0]) == (variant == "oicr")
    res = test_net.main(["--config-file", SYNTH, "--data-root", data,
                         "--device", "cpu", "--weights",
                         str(tmp_path / "model_final.pt"),
                         "OUTPUT_DIR", str(tmp_path / "test"),
                         *TINY, *opts])
    (r,) = res.values()
    assert math.isfinite(r["map"])
