"""The port's CAM path (``MODEL.FASTER_RCNN``: odwscl_tpu_torch/models/
cam.py, cam_proposals.py) and the weight bridge's new leaves against the
JAX package, on the CPU, in f32.

- ``CAMModule``: attention logits and the BCE loss within 1e-6 of their
  largest magnitude, the parameters' gradients within 1e-5 of theirs;
  ``cam_proposals``' objectness within 1e-6 (XLA divides by the range in
  another way: ulps), at most one cell on the other side of the
  threshold.
- ``_anchors`` equal.
- ``cam_to_proposals``, exact: attention on a dyadic grid (multiples of
  1/64 under 1), where every partial sum of the integral image is exact in
  f32, so both packages read the same box sums: boxes, mask and
  objectness equal. Two images of different sizes (per-image clipping;
  clipped corner anchors tie exactly and the lower index goes first), a
  pre-NMS cut below the anchor count, and padding past the survivors.
- ``cam_to_proposals``, random attention: XLA's and torch's cumulative sums
  add in other orders, so the objectness may differ by ulps: within 1e-6,
  the same count kept, and the same kept boxes wherever the objectness
  lies more than 1e-6 above the cut.
- ``train_forward`` with ``faster_rcnn`` (CAM proposals, ``oicr_layer``,
  ``RPN_POST_NMS`` 64, ``loss_cam``) against JAX's ``value_and_grad``: the
  harness and tolerances of tests/torch_variant_parity.py.
- The bridge round-trips the CDB, CAM and WSDDN/OICR head leaves exactly,
  and rejects unknown CDB and CAM leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.cam as jcam
import odwscl_tpu.models.cam_proposals as jcp
from odwscl_tpu.models import WSODDetector as JWSODDetector
from odwscl_tpu_torch.models import WSODDetector
from odwscl_tpu_torch.models import cam as tcam
from odwscl_tpu_torch.models import cam_proposals as tcp
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

import torch_variant_parity as tvp

torch.set_num_threads(2)

OUT_REL = 1e-6
GRAD_REL = 1e-5
OBJ_ATOL = 1e-6


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale, err_msg=what)


def test_cam_module_matches_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 8, 12, 32).astype(np.float32) * 4
    labels = np.zeros((2, 6), np.float32)
    labels[0, [0, 2]] = labels[1, [3, 5]] = 1.0      # column 0 is ignored
    g = rng.randn(2, 8, 12, 6).astype(np.float32)
    jm = jcam.CAMModule(num_classes=6, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), feats, labels)["params"])
    params["cam_conv_bias"] = rng.randn(6).astype(np.float32)

    def jloss(p):
        atten, loss = jm.apply({"params": p}, feats, labels)
        return jnp.vdot(atten, g) + loss

    want_atten, want_loss = jm.apply({"params": params}, feats, labels)
    want_grads = jax.grad(jloss)(params)
    tm = tcam.CAMModule(32, 6, torch.float32)
    tm.load_state_dict({k[len("cam."):]: v for k, v in state_dict_from_jax(
        {"cam": params}).items()})
    atten, loss = tm(torch.from_numpy(feats), torch.from_numpy(labels))
    ((atten * torch.from_numpy(g)).sum() + loss).backward()
    _close(atten.detach().numpy(), want_atten, OUT_REL, "atten")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=OUT_REL)
    got = jax_params_from_state_dict({f"cam.{k}": p.grad for k, p in
                                      tm.named_parameters()})["cam"]
    for k in params:
        _close(got[k], want_grads[k], GRAD_REL, k)
    assert tm(torch.from_numpy(feats))[1] is None

    want_obj, want_on = jcam.cam_proposals(want_atten, jnp.asarray(labels))
    got_obj, got_on = tcam.cam_proposals(atten.detach(),
                                         torch.from_numpy(labels))
    _close(got_obj.numpy(), want_obj, OUT_REL, "objectness")
    assert (got_on.numpy() != np.asarray(want_on)).sum() <= 1


def test_anchors_match_jax():
    for args in ((4, 6, 8), (7, 5, 16)):
        np.testing.assert_array_equal(tcp._anchors(*args),
                                      jcp._anchors(*args))


def _proposals(atten, sizes, stride, **kw):
    want = jcp.cam_to_proposals(jnp.asarray(atten), jnp.asarray(sizes),
                                stride, **kw)
    got = tcp.cam_to_proposals(torch.from_numpy(atten),
                               torch.from_numpy(sizes), stride, **kw)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


@pytest.mark.parametrize("kw", [dict(out_p=32, pre_nms=256),
                                dict(out_p=600, pre_nms=512),
                                dict(out_p=64)])
def test_cam_to_proposals_exact(kw):
    rng = np.random.RandomState(1)
    fh, fw, stride = 10, 14, 8
    atten = (rng.randint(-48, 49, (2, fh, fw)) / 64.0).astype(np.float32)
    sizes = np.array([[fh * stride, fw * stride],
                      [fh * stride - 21, fw * stride - 37]], np.float32)
    (wb, wm, wo), (gb, gm, go) = _proposals(atten, sizes, stride, **kw)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(go, wo)
    assert wm.sum(axis=1).min() > 0
    if kw["out_p"] == 600:
        assert not wm.all(axis=1).any()        # padded past the survivors


def test_cam_to_proposals_random():
    rng = np.random.RandomState(2)
    fh, fw, stride = 12, 16, 8
    atten = rng.randn(2, fh, fw).astype(np.float32)
    sizes = np.array([[fh * stride, fw * stride],
                      [fh * stride - 30, fw * stride - 50]], np.float32)
    (wb, wm, wo), (gb, gm, go) = _proposals(atten, sizes, stride, out_p=48)
    assert (gm.sum(1) == wm.sum(1)).all()
    for i in range(2):
        np.testing.assert_allclose(np.sort(go[i][gm[i]]),
                                   np.sort(wo[i][wm[i]]), rtol=0,
                                   atol=OBJ_ATOL)
        cut = max(wo[i][wm[i]].min(), go[i][gm[i]].min()) + OBJ_ATOL
        want = {tuple(b) for b, o in zip(wb[i][wm[i]], wo[i][wm[i]])
                if o > cut}
        got = {tuple(b) for b, o in zip(gb[i][gm[i]], go[i][gm[i]])
               if o > cut}
        assert got == want and len(want) > 10


def test_train_forward_faster_rcnn_matches_jax():
    losses, metrics, model = tvp.assert_train_matches(dict(
        faster_rcnn=True, contra=False, db_method="none", rpn_post_nms=64))
    assert "loss_cam" in losses and float(metrics["n_pos0"]) > 0
    assert model.cam.cam_conv.weight.grad.abs().max() > 0


@pytest.mark.parametrize("predictor", ["WSDDNPredictor", "OICRPredictor",
                                       "MISTPredictor"])
def test_bridge_round_trips_new_leaves(predictor):
    kw = dict(predictor=predictor, db_method="concrete", faster_rcnn=True)
    arrays = tvp.inputs()
    jm = JWSODDetector(**tvp.KW, **kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, bb: jm.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        tvp.jax_batch(arrays))["params"])
    sd = state_dict_from_jax(params)
    model = WSODDetector(**tvp.KW, **kw)
    model.load_state_dict(sd)                  # strict: the whole tree
    assert sd["cdb.conv1.weight"].shape == (512, 512, 3, 3)
    assert sd["cdb.bn1.scale"].shape == (512,)
    assert sd["cam.cam_conv.weight"].shape == (6, 512)
    back = dict(jax.tree_util.tree_leaves_with_path(
        jax_params_from_state_dict(model.state_dict())))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf)


@pytest.mark.parametrize("leaf", [("cdb", "bn3", "scale"),
                                  ("cdb", "conv1", "kernel", "x"),
                                  ("cam", "cam_conv_weight"),
                                  ("neck", "cam_conv_kernel")])
def test_bridge_rejects_unknown_new_leaves(leaf):
    tree = node = {}
    for k in leaf[:-1]:
        node = node.setdefault(k, {})
    node[leaf[-1]] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(tree)
