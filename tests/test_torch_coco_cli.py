"""The port's CLIs on the shipped COCO configs, on the CPU, at a tiny size.

``train_net`` runs 2 iterations of configs/coco/coco14_contra_db_b8_lr0.01_
mcg.yaml and of coco17's on the synthetic ``coco14`` / ``coco17_mcg``
layouts (81 classes, MCG proposal names as shipped) and then evaluates
with the config's AVG TTA into COCO AP; scales, batch, width and proposal
bucket are cut to CPU size (``TINY``). Then 2 iterations each of the
COCO14 config with ``PARTIAL_LABELS point`` and ``scribble`` (with
``ROI_LOSS_REFINE``), with two training datasets (``coco_2014_train``,
``coco_2014_valminusminival``), with ``SOLVER.CLASS_BATCH``, and on the web
dataset ``flickr_coco``. Every loss finite; the stats finite.
"""

import math
import os

import pytest
import torch

from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
from odwscl_tpu_torch.tools import test_net, train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {y: os.path.join(REPO, "configs", "coco",
                           f"coco{y}_contra_db_b8_lr0.01_mcg.yaml")
           for y in ("14", "17")}
TINY = ["MODEL.WEIGHT", "", "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
        "TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_ITER", "2",
        "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.IMS_PER_BATCH", "2",
        "INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "120",
        "INPUT.MIN_SIZE_TEST", "80", "INPUT.MAX_SIZE_TEST", "120",
        "TEST.BBOX_AUG.SCALES", "(64,)", "TEST.BBOX_AUG.MAX_SIZE", "120",
        "TEST.IMS_PER_BATCH", "2", "TPU.PROPOSAL_BUCKETS", "(64,)",
        "TPU.BANK_CAPACITY", "64", "DATALOADER.NUM_WORKERS", "1"]
TRAIN14 = ("proposal/MCG/coco/MCG-coco14_train.pkl",
           "proposal/MCG/coco/MCG-coco14_valminusminival.pkl")
VARIANTS = {
    "point": ["MODEL.ROI_WEAK_HEAD.PARTIAL_LABELS", "point",
              "MODEL.ROI_WEAK_HEAD.ROI_LOSS_REFINE", "True",
              "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32"],
    "scribble": ["MODEL.ROI_WEAK_HEAD.PARTIAL_LABELS", "scribble",
                 "MODEL.ROI_WEAK_HEAD.ROI_LOSS_REFINE", "True",
                 "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32"],
    "two_datasets": ["DATASETS.TRAIN",
                     "('coco_2014_train', 'coco_2014_valminusminival')",
                     "PROPOSAL_FILES.TRAIN", str(TRAIN14)],
    "class_batch": ["SOLVER.CLASS_BATCH", "True"],
    "web": ["DATASETS.TRAIN", "('flickr_coco',)", "PROPOSAL_FILES.TRAIN",
            "('proposal/flickr_coco.pkl',)"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    roots = {}
    for year, layout in (("14", "coco14"), ("17", "coco17_mcg")):
        roots[year] = str(tmp_path_factory.mktemp(layout))
        write_synthetic_coco(roots[year], 4, 2, seed=0, img_hw=(100, 130),
                             n_props=40, layout=layout,
                             n_valminusminival=2 if year == "14" else 0,
                             partial=year == "14", web=year == "14")
    return roots


def _train(config, root, out, opts, skip_test=True):
    timing = {}
    flags = ["--skip-test"] if skip_test else []
    res = train_net.main(["--config-file", config, "--data-root", root,
                          "--device", "cpu", *flags, "OUTPUT_DIR", str(out),
                          *TINY, *opts], timing_out=timing)
    steps = timing["train"]["steps"]
    assert len(steps) == 2
    assert all(math.isfinite(v) for st in steps for v in st.values())
    return res, steps


def _assert_stats(res):
    (r,) = res.values()
    assert set(r) == {"AP", "AP50", "AP75", "AR", "AP_s", "AP_m", "AP_l"}
    assert all(math.isfinite(v) for v in r.values())


@pytest.mark.parametrize("year", ["14", "17"])
def test_train_net_then_test_net_coco(data, tmp_path, year):
    res, steps = _train(CONFIGS[year], data[year], tmp_path, [],
                        skip_test=False)
    assert "loss_sim" in steps[0] and "loss_ref_reg0" in steps[0]
    _assert_stats(res)
    res = test_net.main(["--config-file", CONFIGS[year], "--data-root",
                         data[year], "--device", "cpu", "--weights",
                         str(tmp_path / "model_final.pt"), "OUTPUT_DIR",
                         str(tmp_path / "test"), *TINY])
    _assert_stats(res)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_net_coco14_variant(data, tmp_path, variant):
    _, steps = _train(CONFIGS["14"], data["14"], tmp_path, VARIANTS[variant])
    assert "loss_ref_cls0" in steps[0]
