"""The port's eval path end to end against the JAX package's, on the CPU.

A synthetic VOC test split (4 images of 120x144, 64 proposals each) is
written once; JAX's ``engine.inference.inference()`` and the port's
``inference()`` then evaluate it with the same parameters (carried over by
utils/from_jax.py), TTA on (identity + one extra scale, each with its
flip, AVG merge), per-class NMS 0.4, f32 compute, tasks det and corloc.
The score heads are scaled (x2000) so that detections rank by clear
margins instead of near-uniform random-init scores.

Bounds: every image keeps the same number of detections with the same
labels; scores agree to 5e-5 and boxes (in original image pixels) to
1e-3 px: the f32 summation-order drift of test_torch_detector.py,
carried through the AVG merge of 4 forwards and the rescale to the
original frame. mAP and CorLoc agree to 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data import make_eval_loaders as jax_loaders
from odwscl_tpu.engine.inference import inference as jax_inference
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models.detector import detector_from_cfg as jax_detector
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.build import make_eval_loaders
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.engine.inference import inference
from odwscl_tpu_torch.models.detector import detector_from_cfg
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "voc", "voc07_synth_smoke.yaml")
OPTS = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.HEUR", "AVG",
        "TEST.BBOX_AUG.H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(128,)",
        "TEST.BBOX_AUG.MAX_SIZE", "160", "TEST.BBOX_AUG.SCALE_H_FLIP", "True",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
        "TPU.COMPUTE_DTYPE", "float32", "TPU.PROPOSAL_BUCKETS", "(64,)",
        "TPU.IMAGE_PAD_MULTIPLE", "32", "DATALOADER.NUM_WORKERS", "1"]
HEAD_SCALE = 2000.0
SCORE_ATOL = 5e-5
BOX_ATOL_PX = 1e-3


def _cfg(get_default, out_dir):
    cfg = get_default()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(out_dir)])
    cfg.freeze()
    return cfg


def _jax_params(cfg):
    model = jax_detector(cfg)
    rng = np.random.RandomState(0)
    batch = JBatch(jnp.asarray(rng.randn(1, 64, 64, 3), jnp.float32),
                   jnp.array([[64.0, 64.0]]),
                   jnp.array([[[0.0, 0.0, 31.0, 31.0]] * 4]),
                   jnp.ones((1, 4), bool), jnp.zeros((1, 21), jnp.float32))
    v = jax.jit(lambda r, bb: model.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= HEAD_SCALE
    return model, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    data = str(root / "data")
    write_synthetic_voc(data, n_test=4, seed=0, img_hw=(120, 144), n_props=64)

    jcfg = _cfg(jax_cfg, root / "jax")
    jmodel, params = _jax_params(jcfg)
    (name, jloader), = jax_loaders(jcfg, data)
    jout = str(root / "jax" / name)
    os.makedirs(jout)
    jres = {task: jax_inference(jmodel, {"params": params}, jcfg, jloader,
                                jloader.dataset, jout, task=task)
            for task in ("det", "corloc")}

    cfg = _cfg(get_default_cfg, root / "torch")
    model = detector_from_cfg(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    (name, loader), = make_eval_loaders(cfg, data)
    out = str(root / "torch" / name)
    os.makedirs(out)
    timing = {}
    res = {task: inference(model, cfg, loader, loader.dataset, out,
                           task=task, device="cpu", timing_out=timing)
           for task in ("det", "corloc")}
    return jres, res, jout, out, timing


def _predictions(folder):
    import pickle
    with open(os.path.join(folder, "predictions.pkl"), "rb") as f:
        return pickle.load(f)


def test_detections_match_jax(runs):
    _, _, jout, out, timing = runs
    assert timing["n_images"] == 4 and timing["n_forwards"] == 2 * 4
    jpreds, preds = _predictions(jout), _predictions(out)
    assert len(preds) == len(jpreds) == 4
    for d, jd in zip(preds, jpreds):
        assert len(d["scores"]) == len(jd["scores"]) > 0
        # same detections, ordered by (label, score) to be robust to the
        # order of near-equal scores of different classes
        o = np.lexsort((-d["scores"], d["labels"]))
        jo = np.lexsort((-jd["scores"], jd["labels"]))
        np.testing.assert_array_equal(d["labels"][o], jd["labels"][jo])
        np.testing.assert_allclose(d["scores"][o], jd["scores"][jo], rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(d["boxes"][o], jd["boxes"][jo], rtol=0,
                                   atol=BOX_ATOL_PX)


def test_map_and_corloc_match_jax(runs):
    jres, res, _, _, _ = runs
    assert np.isfinite(res["det"]["map"])
    assert abs(res["det"]["map"] - jres["det"]["map"]) <= 1e-6
    np.testing.assert_allclose(res["det"]["ap"], jres["det"]["ap"], rtol=0,
                               atol=1e-6)
    assert abs(res["corloc"]["mean_corloc"]
               - jres["corloc"]["mean_corloc"]) <= 1e-6
