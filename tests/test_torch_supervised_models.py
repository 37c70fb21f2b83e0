"""The port's whole R-18-FPN Mask R-CNN and Mask + Keypoint R-CNN
(``SupervisedRCNN``) and R-18 RetinaNet (``RetinaNetDetector``) against
the JAX package's, on the CPU.

The flax parameters (FrozenBN leaves randomized) reach the port through
utils/from_jax.py; the same numpy batch goes through both, f32. The images
are handed over as an NHWC view of NCHW memory (PyTorch's CPU convolutions
then drift least, tests/test_torch_resnet.py), and each test first checks
that every ReLU's pre-activation lies at least 1e-6 of its layer's largest
magnitude from 0 in a float64 pass of the port (``_relu_margin``): a unit
within the f32 drift of 0 could take opposite signs in the two packages
and move the gradients below it by percents.

Mask R-CNN: rois stay within the JAX CPU pooler's 32-cell window at their
assigned level (its ``TPU.POOLER_WIN`` subsamples wider rois, the port
pools every roi exactly: ROADMAP Queue 3). ``test_pooling_window_
difference`` shows that difference on one wider roi. The Fast R-CNN
sample draws the JAX keys' uniforms (``draws["fast_rcnn"]``), its JAX side
wrapped to a fixed key.

Sizes: 32x64 images (unit normals x 20), P = 48 rois of 6-30 px, 4 GT
boxes with random bitmasks at stride 4 (and, for the keypoint model, 5
keypoints each, the head's full 8x512 tower). The mask logits are scaled by
``MASK_LOGIT_SCALE`` (the random FPN features put them at O(100), where
a probability's bound would read 100 times the logits' f32 drift).

Tolerances: scores, mask probabilities and keypoint logits (over their
largest) 1e-5; boxes 1e-3 px; losses
1e-5 relative; every trainable tensor's gradient within 1e-4 of its
largest magnitude; the sampled rois and the anchor labels equal (checked
through the targets the loss reads); RetinaNet's decode: valid masks
equal, scores 1e-5 and labels equal on the valid entries, boxes 1e-3 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.roi_heads as jroi_heads
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models import RetinaNetDetector as JRetina
from odwscl_tpu.models import SupervisedRCNN as JRCNN
from odwscl_tpu_torch.models import Batch, RetinaNetDetector, SupervisedRCNN
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

torch.set_num_threads(2)

SCORE_ATOL = 1e-5
BOX_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
KEY = jax.random.PRNGKey(11)
H, W, P, G = 32, 64, 48, 4
IMG_SCALE = 20.0
# inputs whose ReLUs keep the 1e-6 margin (found by a seed search; at
# 64x96 few seeds do, the stem alone holding ~200k pre-activations)
MASK_SEED, RETINA_SEED = 15, 25
MASK_LOGIT_SCALE = 0.01


def _batch(seed, h=H, w=W, p=P, g=G, max_wh=30.0, keypoints=0):
    """The seeded batch; ``keypoints`` > 0 adds that many GT keypoints per
    instance (drawn from their own seed, inside and around each GT box,
    visibility 0-2), leaving every other field as without them."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(2, h, w, 3) * IMG_SCALE).astype(np.float32)
    x1y1 = rng.uniform(0, [w - 12, h - 12], (2, p, 2))
    wh = rng.uniform(6, max_wh, (2, p, 2))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, [w - 1, h - 1])],
                           -1).astype(np.float32)
    box_mask = np.ones((2, p), bool)
    box_mask[1, -6:] = False
    gt = boxes[:, :g] + rng.uniform(-3, 3, (2, g, 4)).astype(np.float32)
    gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 4)
    gt_labels = rng.randint(1, 7, (2, g))
    gt_mask = np.ones((2, g), bool)
    gt_mask[1, -1] = False
    bit = (rng.rand(2, g, h // 4, w // 4) > 0.5).astype(np.float32)
    sizes = np.float32([[h, w], [h - 8, w - 16]])
    fields = dict(images=images, image_sizes=sizes, boxes=boxes,
                  box_mask=box_mask, labels=np.ones((2, 7), np.float32),
                  gt_boxes=gt, gt_labels=gt_labels, gt_mask=gt_mask,
                  gt_bitmasks=bit)
    if keypoints:
        kr = np.random.RandomState(seed + 1000)
        kp = np.zeros((2, g, keypoints, 3), np.float32)
        span = gt[..., 2:] - gt[..., :2]
        kp[..., :2] = gt[:, :, None, :2] + kr.uniform(
            -0.2, 1.2, (2, g, keypoints, 2)) * span[:, :, None]
        kp[..., 2] = kr.randint(0, 3, (2, g, keypoints))
        fields["gt_keypoints"] = kp
    jb = JBatch(**{k: jnp.asarray(v.astype(np.int32) if k == "gt_labels"
                                  else v) for k, v in fields.items()})
    tb = {k: torch.from_numpy(v) for k, v in fields.items()}
    # NHWC view of NCHW memory
    tb["images"] = tb["images"].permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    return jb, Batch(**tb)


def _randomize_bn(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            c = v["scale"].shape
            v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_bn(v, rng)
    return tree


def _jax_params(model, batch):
    v = jax.jit(lambda r, b: model.init(r, b, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch)
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               v["params"])
    return _randomize_bn(p, np.random.RandomState(2))


def _port(model, params):
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _relu_margin(model, batch):
    """The smallest non-zero |pre-activation| of any ReLU of the backbone
    (and RetinaNet's towers) in a float64 pass of ``model`` on ``batch``,
    each relative to its tensor's largest. A flip there moves every
    gradient below it; one in the roi heads moves one roi's term only."""
    import copy

    margins = []
    relu = torch.nn.functional.relu

    def record(t, *args, **kw):
        # exact zeros (masked rois' features, zero biases) give 0 in both
        nz = t[t != 0].abs()
        if nz.numel():
            margins.append((nz.min() / nz.max()).item())
        return relu(t, *args, **kw)

    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", record)
        with torch.no_grad():
            feats = m64.backbone(batch.images.double())
            if isinstance(m64, RetinaNetDetector):
                m64.head(feats)
    return min(margins)


def _draws(batch):
    b, p = batch.boxes.shape[:2]
    u = np.stack([np.stack([np.array(jax.random.uniform(r, (p,)))
                            for r in jax.random.split(k)])
                  for k in jax.random.split(KEY, b)])
    return {"fast_rcnn": torch.from_numpy(u)}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _check_grads(model, jgrads, zero=()):
    """Every trainable tensor's gradient against JAX's, within GRAD_REL of
    its largest magnitude; ``zero``: tensors whose exact gradient is 0
    (both sides within GRAD_REL of the model's largest gradient)."""
    got = _leaves(jax_params_from_state_dict(
        {n: p.grad for n, p in model.named_parameters() if p.requires_grad}))
    want = _leaves(jgrads)
    assert got and set(got) <= set(want)
    top = max(np.abs(v).max() for v in want.values())
    for k in got:
        if k in zero:
            assert max(np.abs(got[k]).max(), np.abs(want[k]).max()) \
                <= GRAD_REL * top, k
            continue
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        assert err <= GRAD_REL * max(scale, 1e-6), (k, err, scale)
    return len(got)


@functools.lru_cache(maxsize=None)
def _mask_rcnn(seed=MASK_SEED):
    """(JAX model, flax params, JAX batch, port model, port batch), built
    once for the module's tests."""
    jb, tb = _batch(seed)
    jm = JRCNN(num_classes=7, backbone_arch="R-18-FPN", mask_on=True,
               mask_conv_layers=(32, 32), mlp_dim=64, roi_batch_size=32,
               mask_raster_stride=4.0, compute_dtype="float32")
    params = _jax_params(jm, jb)
    # mask logits of O(1), where a probability's 1e-5 bound means the
    # logits' f32 drift (random FPN features put them at O(100))
    params["roi_heads"]["mask"]["predictor"]["mask_fcn_logits"]["kernel"] \
        *= MASK_LOGIT_SCALE
    tm = _port(SupervisedRCNN(7, "R-18-FPN", mask_on=True,
                              mask_conv_layers=(32, 32), mlp_dim=64,
                              roi_batch_size=32, mask_raster_stride=4.0,
                              compute_dtype="float32"), params)
    return jm, params, jb, tm, tb


def test_mask_rcnn_eval_matches():
    jm, params, jb, tm, tb = _mask_rcnn()
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params}, jb)
    got = tm.eval_forward(tb)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=SCORE_ATOL)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), atol=BOX_ATOL)
    # the detections' mask pass, with and without the eval pass's features
    det = tb.boxes[:, 5:15].contiguous()
    lab = torch.from_numpy(np.random.RandomState(3).randint(1, 7, (2, 10)))
    want_p = jax.jit(lambda v, b, d, l: jm.apply(
        v, b, d, l, method="predict_masks"))(
        {"params": params}, jb, jnp.asarray(det.numpy()),
        jnp.asarray(lab.numpy().astype(np.int32)))
    for feats in (got["features"], None):
        probs = tm.predict_masks(tb, det, lab, feats)
        assert probs.shape == (2, 10, 14, 14)
        np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                                   atol=SCORE_ATOL)


def test_mask_rcnn_train_step_matches(monkeypatch):
    jm, params, jb, tm, tb = _mask_rcnn()
    assert _relu_margin(tm, tb) >= 1e-6
    real = jroi_heads.prepare_fast_rcnn_targets
    monkeypatch.setattr(jroi_heads, "prepare_fast_rcnn_targets",
                        lambda rng, *a, **k: real(KEY, *a, **k))

    def loss_fn(p):
        losses, _ = jm.apply({"params": p}, jb, train=True,
                             rngs={"augment": jax.random.PRNGKey(5)})
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    losses, metrics = tm.train_forward(tb, draws=_draws(tb))
    assert set(losses) == set(want) == {"loss_classifier", "loss_box_reg",
                                        "loss_mask"}
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert 0.0 <= float(metrics["accuracy_cls"]) <= 1.0
    sum(losses.values()).backward()
    n = _check_grads(tm, grads)
    assert n >= 30           # body convs, FPN, neck, box and mask heads


KP_LOGIT_MAX = 4.0
KP_BIAS_MARGIN = 0.1


def _active_tower(tm, params, tb):
    """Set the keypoint tower's biases so that every pre-activation over
    the batch's pooled rois lies at least KP_BIAS_MARGIN of its channel's
    range above 0 (f64 pass of the port), and scale the deconv's kernel
    so the logits peak at KP_LOGIT_MAX. Its 8 x 512 units over 96 rois
    (19M pre-activations) cannot keep the 1e-6 ReLU margin, and one flip
    moves every gradient below it by a permille; with every unit active
    the train step reads the f32 drift. The tower's ReLUs with units on
    both sides are held to JAX in the eval test here and on a small tower
    in tests/test_torch_keypoints.py."""
    import copy

    import torch.nn.functional as F

    m64 = copy.deepcopy(tm).double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    kp = params["roi_heads"]["keypoint"]
    with torch.no_grad():
        pooled = m64.pooled(m64.backbone(tb.images.double()), tb.boxes,
                            tb.box_mask)
        x = pooled.reshape(-1, *pooled.shape[2:]).permute(0, 3, 1, 2)
        ext = m64.roi_heads.keypoint.extractor
        for i in range(1, ext.n + 1):
            pre = F.conv2d(x, getattr(ext, f"conv_fcn{i}").weight, padding=1)
            lo = pre.amin(dim=(0, 2, 3))
            hi = pre.amax(dim=(0, 2, 3))
            bias = -lo + KP_BIAS_MARGIN * (hi - lo)
            kp["extractor"][f"conv_fcn{i}"]["bias"] = bias.numpy().astype(
                np.float32)
            x = pre + bias[None, :, None, None]
        dec = m64.roi_heads.keypoint.predictor.kps_score_lowres
        logits = F.conv_transpose2d(x, dec.weight, None, stride=2, padding=1)
    kp["predictor"]["kps_score_lowres"]["kernel"] *= np.float32(
        KP_LOGIT_MAX / logits.abs().max().item())
    return params


@functools.lru_cache(maxsize=None)
def _keypoint_rcnn(seed=MASK_SEED, active=False):
    """A Mask + Keypoint R-CNN (5 keypoints) on the Mask R-CNN's batch
    with GT keypoints added (its images, and so its ReLU margin, kept);
    ``active``: the keypoint tower all active (``_active_tower``)."""
    import copy

    jb, tb = _batch(seed, keypoints=5)
    kw = dict(num_classes=7, backbone_arch="R-18-FPN", mask_on=True,
              keypoint_on=True, num_keypoints=5, mask_conv_layers=(32, 32),
              mlp_dim=64, roi_batch_size=32, mask_raster_stride=4.0,
              compute_dtype="float32")
    jm = JRCNN(**kw)
    params = _jax_params(jm, jb)
    params["roi_heads"]["mask"]["predictor"]["mask_fcn_logits"]["kernel"] \
        *= MASK_LOGIT_SCALE
    tm = _port(SupervisedRCNN(**kw), params)
    if active:
        params = _active_tower(tm, copy.deepcopy(params), tb)
        tm = _port(SupervisedRCNN(**kw), params)
    return jm, params, jb, tm, tb


def test_keypoint_rcnn_eval_matches():
    jm, params, jb, tm, tb = _keypoint_rcnn()
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params}, jb)
    got = tm.eval_forward(tb)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=SCORE_ATOL)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), atol=BOX_ATOL)
    det = tb.boxes[:, 5:15].contiguous()
    want_hm = np.asarray(jax.jit(lambda v, b, d: jm.apply(
        v, b, d, method="predict_kp_heatmaps"))(
        {"params": params}, jb, jnp.asarray(det.numpy())))
    for feats in (got["features"], None):
        hm = tm.predict_kp_heatmaps(tb, det, feats).numpy()
        assert hm.shape == want_hm.shape == (2, 10, 28, 28, 5)
        assert np.abs(hm - want_hm).max() <= SCORE_ATOL * np.abs(
            want_hm).max()
    # every roi's aux logits (the JAX init_all pass)
    aux = tm.roi_heads.forward_eval(
        tm.pooled(got["features"], tb.boxes, tb.box_mask), tb.boxes,
        include_aux=True)
    assert aux["kp_logits"].shape == (2, P, 28, 28, 5)
    assert aux["mask_logits"].shape == (2, P, 14, 14, 7)


def test_keypoint_rcnn_train_step_matches(monkeypatch):
    jm, params, jb, tm, tb = _keypoint_rcnn(active=True)
    assert _relu_margin(tm, tb) >= 1e-6
    real = jroi_heads.prepare_fast_rcnn_targets
    monkeypatch.setattr(jroi_heads, "prepare_fast_rcnn_targets",
                        lambda rng, *a, **k: real(KEY, *a, **k))

    def loss_fn(p):
        losses, _ = jm.apply({"params": p}, jb, train=True,
                             rngs={"augment": jax.random.PRNGKey(5)})
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    losses, _ = tm.train_forward(tb, draws=_draws(tb))
    assert set(losses) == set(want) == {"loss_classifier", "loss_box_reg",
                                        "loss_mask", "loss_kp"}
    assert float(want["loss_kp"]) > 0
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    sum(losses.values()).backward()
    # the deconv's bias gradient is exactly 0: a per-map constant through
    # the bilinear x2 and a softmax over the map
    n = _check_grads(tm, grads,
                     zero={"roi_heads/keypoint/predictor/kps_score_lowres/"
                           "bias"})
    assert n >= 48                    # + the 8 tower convs, the deconv


def test_pooling_window_difference():
    """A roi over 32 cells wide at its level: the JAX CPU pooler samples
    every other cell, the port (and the kernel) takes the exact maximum;
    the two differ on that roi only. Here at P5 (stride 32) of a 1280 px
    wide image: a 1200 px roi covers 38 cells."""
    from odwscl_tpu.ops.roi_pool import roi_pool as jroi_pool
    from odwscl_tpu_torch.ops.roi_pool import roi_pool_plain

    rng = np.random.RandomState(4)
    feat = rng.randn(1, 30, 40, 8).astype(np.float32)
    rois = np.float32([[[10, 10, 1210, 900], [0, 0, 300, 300]]])
    mask = np.ones((1, 2), bool)
    want = np.asarray(jroi_pool(jnp.asarray(feat), jnp.asarray(rois),
                                jnp.asarray(mask), 1 / 32, 7, 32))
    got = roi_pool_plain(torch.from_numpy(feat), torch.from_numpy(rois),
                         torch.from_numpy(mask), 1 / 32).numpy()
    np.testing.assert_array_equal(got[0, 1], want[0, 1])
    differ = (got[0, 0] != want[0, 0]).mean()
    assert differ > 0 and (got[0, 0] >= want[0, 0]).all()
    print(f"pooling window: {differ:.0%} of the 38-cell roi's outputs "
          "differ (the port's are the exact maxima)")


@functools.lru_cache(maxsize=None)
def _retina(seed=RETINA_SEED):
    jb, tb = _batch(seed)
    kw = dict(num_classes=7, num_convs=2, pre_nms_top_n=200,
              score_thresh=0.7)
    jm = JRetina(depth="R-18", compute_dtype="float32", **kw)
    params = _jax_params(jm, jb)
    tm = _port(RetinaNetDetector(depth="R-18", compute_dtype="float32", **kw),
               params)
    return jm, params, jb, tm, tb


def test_retinanet_eval_matches():
    jm, params, jb, tm, tb = _retina()
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params}, jb)
    got = tm.eval_forward(tb)
    wv = np.asarray(want["valid"])
    gv = got["valid"].numpy()
    np.testing.assert_array_equal(gv, wv)
    assert 0 < gv.sum() < gv.size
    np.testing.assert_allclose(got["scores"].numpy()[gv],
                               np.asarray(want["scores"])[wv],
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(got["labels"].numpy()[gv],
                                  np.asarray(want["labels"])[wv])
    np.testing.assert_allclose(got["boxes"].numpy()[gv],
                               np.asarray(want["boxes"])[wv], atol=BOX_ATOL)


def test_retinanet_train_step_matches():
    jm, params, jb, tm, tb = _retina()
    assert _relu_margin(tm, tb) >= 1e-6

    def loss_fn(p):
        losses, mets = jm.apply({"params": p}, jb, train=True)
        return sum(losses.values()), (losses, mets)

    (_, (want, wmets)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    losses, metrics = tm.train_forward(tb)
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    # the anchor labels: their positive count
    assert float(metrics["n_pos_anchors"]) == float(wmets["n_pos_anchors"])
    assert float(metrics["n_pos_anchors"]) > 0
    sum(losses.values()).backward()
    assert _check_grads(tm, grads) >= 20
