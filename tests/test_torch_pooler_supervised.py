"""The supervised R-18-FPN Mask R-CNN with ROIPool at R = 14 and a 28x28
mask (the usual Mask R-CNN mask size: the mask head shares the box pool at
twice its side) against the JAX package's, on the CPU, f32.

The setting of tests/test_torch_supervised_models.py, whose helpers this
file uses: the flax parameters (FrozenBN leaves randomized) through
utils/from_jax.py, the seeded batch whose backbone ReLUs keep the 1e-6
margin (checked), the images as an NHWC view of NCHW memory, the Fast
R-CNN sample's JAX uniforms handed over, the mask logits scaled to O(1).
The JAX model pools R = 14 on each level with its XLA pooler (rois within
its 32-cell window), the port with ``RoIPoolFunction`` at R = 14 (on the
CPU its plain versions), four calls a pass (``multilevel_roi_pool``).

Bounds (that file's): scores and mask probabilities 1e-5, boxes 1e-3 px,
losses 1e-5 relative, every trainable tensor's gradient 1e-4 of its
largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import odwscl_tpu.models.roi_heads as jroi_heads
import test_torch_supervised_models as tsm
from odwscl_tpu.models import SupervisedRCNN as JRCNN
from odwscl_tpu_torch.models import SupervisedRCNN

torch.set_num_threads(2)

RES, MASK_RES = 14, 28


@functools.lru_cache(maxsize=None)
def _mask_rcnn_r14():
    jb, tb = tsm._batch(tsm.MASK_SEED)
    common = dict(mask_on=True, mask_conv_layers=(32, 32), mlp_dim=64,
                  roi_batch_size=32, mask_raster_stride=4.0,
                  pooler_resolution=RES, mask_resolution=MASK_RES,
                  compute_dtype="float32")
    jm = JRCNN(num_classes=7, backbone_arch="R-18-FPN", **common)
    params = tsm._jax_params(jm, jb)
    params["roi_heads"]["mask"]["predictor"]["mask_fcn_logits"]["kernel"] \
        *= tsm.MASK_LOGIT_SCALE
    tm = tsm._port(SupervisedRCNN(7, "R-18-FPN", **common), params)
    return jm, params, jb, tm, tb


def test_mask_rcnn_r14_eval_and_masks_match():
    jm, params, jb, tm, tb = _mask_rcnn_r14()
    assert tm.roi_heads.neck.fc6.in_features \
        == RES * RES * 256
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params}, jb)
    got = tm.eval_forward(tb)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]),
                               atol=tsm.SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]),
                               atol=tsm.BOX_ATOL, rtol=0)
    det = tb.boxes[:, 5:15].contiguous()
    lab = torch.from_numpy(np.random.RandomState(3).randint(1, 7, (2, 10)))
    want_p = jax.jit(lambda v, b, d, l: jm.apply(
        v, b, d, l, method="predict_masks"))(
        {"params": params}, jb, jnp.asarray(det.numpy()),
        jnp.asarray(lab.numpy().astype(np.int32)))
    for feats in (got["features"], None):
        probs = tm.predict_masks(tb, det, lab, feats)
        assert probs.shape == (2, 10, MASK_RES, MASK_RES)
        np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                                   atol=tsm.SCORE_ATOL, rtol=0)


def test_mask_rcnn_r14_train_step_matches(monkeypatch):
    jm, params, jb, tm, tb = _mask_rcnn_r14()
    assert tsm._relu_margin(tm, tb) >= 1e-6
    real = jroi_heads.prepare_fast_rcnn_targets
    monkeypatch.setattr(jroi_heads, "prepare_fast_rcnn_targets",
                        lambda rng, *a, **k: real(tsm.KEY, *a, **k))

    def loss_fn(p):
        losses, _ = jm.apply({"params": p}, jb, train=True,
                             rngs={"augment": jax.random.PRNGKey(5)})
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    losses, _ = tm.train_forward(tb, draws=tsm._draws(tb))
    assert set(losses) == set(want) == {"loss_classifier", "loss_box_reg",
                                        "loss_mask"}
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]),
                                   rtol=tsm.LOSS_RTOL, err_msg=k)
    sum(losses.values()).backward()
    assert tsm._check_grads(tm, grads) >= 30
