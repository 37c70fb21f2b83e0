"""The pooler configurations through the port's CLIs, on the CPU, at a tiny
size (mlp_dim 64, f32, 2 iterations).

- The synthetic VOC smoke config with ``POOLER_METHOD ROIAlign`` and with
  ``POOLER_RESOLUTION 14`` (ROIPool): ``train_net`` for 2 steps (every
  loss finite; the checkpoint's fc6 over r * r * 512), then ``test_net``
  on its checkpoint with the device-resize TTA (two scales, flipped, AVG):
  a finite mAP; then int8 serving from the same checkpoint
  (``TPU.INT8_EVAL``, ``INT8_EVAL_CONVS``, ``INT8_STATIC``): the engine
  calibrates, writes ``int8_scales.npz`` and gives a finite mAP.
- configs/coco/coco_mask_rcnn_smoke.yaml at ``POOLER_RESOLUTION 14`` with
  ``ROI_MASK_HEAD.RESOLUTION 28`` on a synthetic ``coco17`` layout:
  ``train_net`` 2 steps, ``test_net`` bbox and segm, every stat in [0, 1]
  (or -1 where an area range holds no GT).
"""

import math
import os

import pytest
import torch

from odwscl_tpu_torch.data.synthetic import (write_synthetic_coco,
                                             write_synthetic_voc)
from odwscl_tpu_torch.tools import test_net, train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")
MASK = os.path.join(REPO, "configs", "coco", "coco_mask_rcnn_smoke.yaml")
CUT = ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
       "DATALOADER.NUM_WORKERS", "1"]
TINY = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
        "float32", *CUT]
TTA = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.HEUR", "AVG",
       "TEST.BBOX_AUG.H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(96, 112)",
       "TEST.BBOX_AUG.MAX_SIZE", "144", "TPU.EVAL_DEVICE_RESIZE", "True"]
INT8 = ["TPU.INT8_EVAL", "True", "TPU.INT8_EVAL_CONVS", "True",
        "TPU.INT8_STATIC", "True"]
POOLERS = {"roialign": ["MODEL.ROI_BOX_HEAD.POOLER_METHOD", "ROIAlign"],
           "roipool_r14": ["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "14"]}
STATS = ("AP", "AP50", "AP75", "AR", "AP_s", "AP_m", "AP_l")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    write_synthetic_voc(root, n_test=2, seed=0, img_hw=(120, 144),
                        n_props=64, n_trainval=4)
    return root


@pytest.mark.parametrize("pooler", list(POOLERS))
def test_voc_train_then_tta_and_int8_eval(voc, tmp_path, pooler):
    opts = [*TINY, *POOLERS[pooler]]
    out = tmp_path / "train"
    timing = {}
    train_net.main(["--config-file", SYNTH, "--data-root", voc, "--device",
                    "cpu", "--skip-test", "OUTPUT_DIR", str(out), *opts],
                   timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    assert all(math.isfinite(v) for st in steps for v in st.values())
    weights = str(out / "model_final.pt")
    r = 14 if pooler == "roipool_r14" else 7
    sd = torch.load(weights, weights_only=True)["model"]
    assert sd["neck.fc6.weight"].shape[1] == r * r * 512
    for mode, extra in (("tta", []), ("int8", INT8)):
        eval_out = tmp_path / mode
        res = test_net.main(["--config-file", SYNTH, "--data-root", voc,
                             "--device", "cpu", "--weights", weights,
                             "OUTPUT_DIR", str(eval_out), *opts, *TTA,
                             *extra])
        (m,) = res.values()
        assert math.isfinite(m["map"]), (mode, m)
    assert os.path.exists(tmp_path / "int8" / "int8_scales.npz")


def test_mask_rcnn_smoke_config_at_r14(tmp_path):
    root = str(tmp_path / "coco17")
    write_synthetic_coco(root, 4, 2, seed=0, img_hw=(100, 130), n_props=40,
                         layout="coco17")
    opts = [*CUT, "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "14",
            "MODEL.ROI_MASK_HEAD.RESOLUTION", "28"]
    out = str(tmp_path / "out")
    timing = {}
    train_net.main(["--config-file", MASK, "--data-root", root, "--device",
                    "cpu", "--skip-test", "OUTPUT_DIR", out, *opts],
                   timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    for st in steps:
        assert {"loss_classifier", "loss_box_reg", "loss_mask"} <= set(st)
        assert all(math.isfinite(v) for v in st.values()), st
    res = test_net.main(["--config-file", MASK, "--data-root", root,
                         "--device", "cpu", "--weights",
                         os.path.join(out, "model_final.pt"),
                         "OUTPUT_DIR", str(tmp_path / "eval"), *opts])
    (r,) = res.values()
    keys = STATS + tuple("segm_" + k for k in STATS)
    assert set(r) == set(keys)
    for k in keys:
        assert r[k] == -1.0 or 0.0 <= r[k] <= 1.0, (k, r[k])
