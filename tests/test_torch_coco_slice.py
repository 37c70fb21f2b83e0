"""The COCO slice as a whole against the JAX package, on the CPU: an
81-class detector (MLP_HEAD_DIM 64, f32, VGG16 frozen whole as in
tests/torch_variant_parity.py, whose harness and tolerances apply:
losses 1e-5 relative, gradients 1e-4 of each tensor's largest) on a batch
of the synthetic ``coco14`` layout made by the port's data path.

- ``train_forward`` against JAX's ``value_and_grad`` for the contrastive
  default, ``PARTIAL_LABELS point`` and ``PARTIAL_LABELS scribble`` (both
  with ``ROI_LOSS_REFINE`` and a 32-proposal subsample, so that the
  balanced draw selects); integer metrics equal. The two images each hold
  objects of one class (the harness's rule: stage B's chain then compares
  no rows of other classes).
- ``eval_forward`` plus the per-class NMS and top-K of both packages on the
  val batch: the same detections, scores within 1e-5, boxes within 1e-3 px
  (heads scaled x300 as in training, which the f32 drift of the two
  frameworks' convolutions and GEMMs crosses).
- Both packages' COCO evaluators on the port's detections (mapped to the
  original frame) give equal stats.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.data.coco_dataset import COCODataset as JCOCODataset
from odwscl_tpu.engine import postprocess as jpost
from odwscl_tpu.evaluation import coco_eval as jeval
from odwscl_tpu_torch.data.build import build_dataset
from odwscl_tpu_torch.data.collate import BatchCollator
from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
from odwscl_tpu_torch.data.transforms import EvalTransform, TrainTransform
from odwscl_tpu_torch.engine import postprocess as tpost
from odwscl_tpu_torch.evaluation import coco_eval as teval

import torch_variant_parity as tvp

torch.set_num_threads(2)

C = 81
VARIANTS = {
    "contrastive": {},
    "point": dict(partial_labels="point", roi_refine=True,
                  roi_batch_size=32),
    "scribble": dict(partial_labels="scribble", roi_refine=True,
                     roi_batch_size=32),
}
FIELDS = ("images", "image_sizes", "boxes", "box_mask", "labels", "clicks",
          "click_labels", "click_mask", "scribbles", "scribble_labels",
          "scribble_mask")
SCORE_ATOL = 1e-5
BOX_ATOL_PX = 1e-3


def _arrays(batch):
    return tuple(None if getattr(batch, f) is None
                 else getattr(batch, f).numpy() for f in FIELDS)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco14"))
    write_synthetic_coco(root, 16, 4, seed=1, img_hw=(100, 130), n_props=40,
                         layout="coco14", partial=True)
    return root


@pytest.fixture(scope="module")
def train_arrays(coco):
    """Two training images whose objects are all of one class, through the
    train transform and the collator."""
    ds = build_dataset("coco_2014_train",
                       "proposal/MCG/coco/MCG-coco14_train.pkl", coco,
                       is_train=True)
    picks = [i for i in range(len(ds))
             if len(np.unique(ds.get_groundtruth(i)[1])) == 1][:2]
    assert len(picks) == 2
    tr = TrainTransform((80,), 120)
    samples = [tr(ds[i], np.random.RandomState(i)) for i in picks]
    batch = BatchCollator(C, proposal_buckets=(64,))(samples)
    assert batch.clicks is not None and batch.scribbles is not None
    return _arrays(batch)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_forward_81_classes_matches_jax(train_arrays, variant):
    kw = dict(num_classes=C, **VARIANTS[variant])
    losses, metrics, _ = tvp.assert_train_matches(kw, train_arrays)
    assert metrics["n_pos0"] > 0
    if variant == "contrastive":
        assert metrics["n_bank"] > 0 and metrics["n_mined"] > 0


@pytest.fixture(scope="module")
def eval_run(coco):
    ds = build_dataset("coco_2014_val", "proposal/MCG/coco/MCG-coco14_val.pkl",
                       coco)
    tr = EvalTransform(80, 120)
    samples = [tr(ds[i]) for i in range(len(ds))]
    arrays = _arrays(BatchCollator(C, proposal_buckets=(64,))(samples))
    params = tvp.init_params(dict(num_classes=C), arrays)
    jmodel = tvp.jdet.WSODDetector(**{**tvp.KW, "num_classes": C})
    jscores, jboxes = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, train=False))(params, tvp.jax_batch(arrays))
    b, p = arrays[3].shape
    jdets = jpost.detections_to_host(*jpost.finalize_detections_device(
        jboxes.reshape(b, p, C, 4), jscores, jnp.asarray(arrays[3]), 0.4,
        0.0, 100))
    model = tvp.port_model(params, dict(num_classes=C)).eval()
    scores, boxes = model.eval_forward(tvp.port_batch(arrays))
    dets = tpost.detections_to_host(*tpost.finalize_detections_device(
        boxes.reshape(b, p, C, 4), scores, torch.from_numpy(arrays[3]), 0.4,
        0.0, 100))
    return ds, samples, dets, jdets


def test_eval_81_classes_matches_jax(eval_run):
    _, _, dets, jdets = eval_run
    assert len(dets) == len(jdets) == 4
    for d, jd in zip(dets, jdets):
        assert len(d["scores"]) == len(jd["scores"]) > 0
        o = np.lexsort((-d["scores"], d["labels"]))
        jo = np.lexsort((-jd["scores"], jd["labels"]))
        np.testing.assert_array_equal(d["labels"][o], jd["labels"][jo])
        np.testing.assert_allclose(d["scores"][o], jd["scores"][jo], rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(d["boxes"][o], jd["boxes"][jo], rtol=0,
                                   atol=BOX_ATOL_PX)


def test_both_evaluators_agree_on_port_detections(eval_run):
    ds, samples, dets, _ = eval_run
    preds = []
    for d, s, i in zip(dets, samples, range(len(ds))):
        info = ds.get_img_info(i)
        preds.append(tpost.resize_detections(
            d, s.size, (info["width"], info["height"])))
    jds = JCOCODataset(os.path.join(os.path.dirname(ds.root), "annotations",
                                    "instances_val2014.json"), ds.root, False)
    got = teval.do_coco_evaluation(ds, preds)
    want = jeval.do_coco_evaluation(jds, preds)
    assert got == want
    assert all(np.isfinite(v) for v in got.values())
