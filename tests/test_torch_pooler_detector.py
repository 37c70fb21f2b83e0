"""The WSOD detector with the pooler configurations against the JAX
package's, on the CPU, f32: ROIAlign with sampling 0 (the adaptive grid,
capped at ``SMAX`` 16 samples an axis) and 2, and ROIPool at R = 6 and 14.

The JAX ``WSODDetector`` pools ROIAlign and every ROIPool but a 7x7 one on
a TPU with XLA (``odwscl_tpu/models/detector.py:pool``); the port pools
ROIAlign with plain torch and ROIPool at R through ``RoIPoolFunction`` (on
the CPU its plain versions). Both get the same flax parameters through
utils/from_jax.py (the necks' fc6 at r*r*512) and the same numpy batch
(tests/torch_variant_parity.py: real VGG16 widths, mlp_dim 64, rois within
the JAX CPU pooler's exact 32 cells, the score heads scaled x300, the
backbone frozen whole).

In the train step the port takes the JAX backbone's features
(``train_forward(features=...)``; the backbone's parity is held in
tests/test_torch_train_step.py and test_torch_resnet.py), so that the
pool sees the same map in both packages, and the score heads are scaled
x100 (``TRAIN_HEAD_SCALE``) instead of the harness's x300. The f32 drift
of the two packages (XLA's and PyTorch's CPU GEMMs and convolutions sum
in other orders) is amplified by both: a softmax saturated by a head
scale s moves a small probability, and a loss weighted by it, by s times
the logits' drift. At R = 14 with the Concrete DropBlock (CPU runs,
seed 0): with each package's own backbone the ``cdb/bn1/bias`` gradient
drifted 2.5e-4 of its largest (the gumbel at tau 0.01 scales the drift by
100); with the same features and x300, the branch-0 regression loss (1.5e-5)
drifted 1.2e-5 relative; with x30 a cell of the gumbel stayed unsaturated
and the CDB's downsample gradient was a residue of 1e-8 on one side. With
the same features and x100 every case holds the bounds.

- ``eval_forward``: scores within 1e-5, boxes within 1e-3 px (the bounds
  of tests/test_torch_supervised_models.py).
- One train step through the harness's ``assert_train_matches``, with the
  JAX draws handed over at R x R: the main path (MIST, contrastive mining,
  DropBlock) and the Concrete DropBlock path. Losses 1e-5 relative,
  gradients 1e-4 of each tensor's largest, integer metrics equal.
"""

import jax
import numpy as np
import pytest
import torch

import odwscl_tpu.models.detector as jdet
import torch_variant_parity as tvp

torch.set_num_threads(2)

SCORE_ATOL = 1e-5
BOX_ATOL = 1e-3
TRAIN_HEAD_SCALE = 100.0
POOLERS = {"align_s0": dict(pooler_method="ROIAlign", pooler_sampling=0),
           "align_s2": dict(pooler_method="ROIAlign", pooler_sampling=2),
           "pool_r6": dict(pooler_resolution=6),
           "pool_r14": dict(pooler_resolution=14)}


@pytest.mark.parametrize("pooler", list(POOLERS))
def test_eval_forward_matches_jax(pooler):
    kw = POOLERS[pooler]
    arrays = tvp.inputs()
    params = tvp.init_params(kw, arrays)
    jmodel = jdet.WSODDetector(**{**tvp.KW, **kw})
    want_scores, want_boxes = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False))({"params": params}, tvp.jax_batch(arrays))
    model = tvp.port_model(params, kw)
    r = model.pooler_resolution
    assert model.neck.fc6.in_features == r * r * 512
    batch = tvp.port_batch(arrays)
    with torch.no_grad():
        pooled = model.pool(model.backbone(batch.images), batch.boxes,
                            batch.box_mask)
    assert pooled.shape == (2, 16, r, r, 512)
    scores, boxes = model.eval_forward(batch)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               atol=BOX_ATOL, rtol=0)
    # the scores spread: not a comparison of near-uniform softmaxes (1/6)
    assert np.asarray(want_scores).max() > 0.3


@pytest.mark.parametrize("variant", ["contra", "concrete"])
@pytest.mark.parametrize("pooler", list(POOLERS))
def test_train_step_matches_jax(pooler, variant):
    kw = dict(POOLERS[pooler])
    if variant == "concrete":
        kw["db_method"] = "concrete"
    arrays = tvp.inputs()
    params = tvp.init_params(kw, arrays, TRAIN_HEAD_SCALE)
    losses, metrics, model = tvp.assert_train_matches(kw, arrays, params,
                                                      same_features=True)
    assert "loss_sim" in losses and float(metrics["n_bank"]) > 0
