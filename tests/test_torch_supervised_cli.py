"""The port's CLIs on the two shipped supervised configs, on the CPU.

configs/coco/coco_retinanet_smoke.yaml (RetinaNet, R-18-FPN-RETINANET)
and configs/coco/coco_mask_rcnn_smoke.yaml (Mask R-CNN, R-18-FPN, ROIPool
at P2-P5, polygon and RLE masks) as shipped, on a synthetic ``coco17``
layout of 96x128-scale images (the configs' own size), with only the
iteration count cut to 2 (and the checkpoint period with it):
``train_net`` trains and writes its checkpoint, then ``test_net``
evaluates that checkpoint: bbox, and bbox + segm for the Mask R-CNN.
The Mask R-CNN config also runs with ``MODEL.KEYPOINT_ON True`` (the
synthetic annotations carry 3x3 keypoint grids; bbox + segm evaluated,
as the JAX package has no keypoint evaluation) and as an FBNet-default
Fast R-CNN (``MODEL.BACKBONE.CONV_BODY FBNet-default``, its stride-16
``POOLER_SCALES (0.0625,)``, ``MODEL.MASK_ON False``). Every loss finite;
every COCO stat a number in [0, 1] (or -1 where an area range holds no
GT, the evaluator's convention).
"""

import math
import os

import pytest
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
from odwscl_tpu_torch.tools import test_net, train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("AP", "AP50", "AP75", "AR", "AP_s", "AP_m", "AP_l")
CUT = ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
       "DATALOADER.NUM_WORKERS", "1"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coco17"))
    write_synthetic_coco(out, 4, 2, seed=0, img_hw=(100, 130), n_props=40,
                         layout="coco17")
    return out


KEYPOINTS = ["MODEL.KEYPOINT_ON", "True"]
FBNET = ["MODEL.BACKBONE.CONV_BODY", "FBNet-default",
         "MODEL.ROI_BOX_HEAD.POOLER_SCALES", "(0.0625,)",
         "MODEL.MASK_ON", "False"]


@pytest.mark.parametrize("name,opts,losses,segm", [
    ("coco_retinanet_smoke", [], ("loss_retina_cls", "loss_retina_reg"),
     False),
    ("coco_mask_rcnn_smoke", [], ("loss_classifier", "loss_box_reg",
                                  "loss_mask"), True),
    ("coco_mask_rcnn_smoke", KEYPOINTS, ("loss_classifier", "loss_box_reg",
                                         "loss_mask", "loss_kp"), True),
    ("coco_mask_rcnn_smoke", FBNET, ("loss_classifier", "loss_box_reg"),
     False)], ids=["coco_retinanet_smoke-losses0-False",
                   "coco_mask_rcnn_smoke-losses1-True", "keypoint_rcnn",
                   "fbnet"])
def test_smoke_config_trains_and_evaluates(root, tmp_path, name, opts,
                                           losses, segm):
    config = os.path.join(REPO, "configs", "coco", name + ".yaml")
    out = str(tmp_path / "out")
    timing = {}
    train_net.main(["--config-file", config, "--data-root", root,
                    "--device", "cpu", "--skip-test", "OUTPUT_DIR", out,
                    *CUT, *opts], timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    for st in steps:
        assert set(losses) <= set(st)
        assert all(math.isfinite(v) for v in st.values()), st
    weights = os.path.join(out, "model_final.pt")
    res = test_net.main(["--config-file", config, "--data-root", root,
                         "--device", "cpu", "--weights", weights,
                         "OUTPUT_DIR", str(tmp_path / "eval"), *opts])
    (r,) = res.values()
    keys = STATS + tuple("segm_" + k for k in STATS) if segm else STATS
    assert set(r) == set(keys)
    for k in keys:
        assert r[k] == -1.0 or 0.0 <= r[k] <= 1.0, (k, r[k])
