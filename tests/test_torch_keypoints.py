"""Keypoint R-CNN's parts in the port against the JAX package, on the CPU.

The same numpy inputs (seeded) go through ``odwscl_tpu`` and
``odwscl_tpu_torch``: the keypoint structures (resize, flip, ``Click``, the
vertical flip's refusal), ``keypoints_to_heatmap`` (boundary points, zero-
size and padded rois, points far off their roi, NaN and infinite scales),
the head (through the weight bridge, with a deconv kernel made
non-symmetric so that a missed flip shows), the loss, the decode (the
JAX package's cv2 INTER_CUBIC against the port's bicubic
``F.interpolate``, rois smaller and larger than the 28-cell heatmap) and
COCO ``load_keypoints`` through the transforms and the collator.

Tolerances: structures, heatmap indices, COCO arrays and collated batches
exact; head logits within 1e-5 of their largest (f32 reassociation); the
head and loss gradients (a small tower whose ReLUs keep a 1e-6 margin)
within 1e-4 of each tensor's largest; the loss within 1e-5 relative; the
decode's scores within 1e-5 and its xy equal wherever both argmaxes pick
the same cell (at least 90% of them here; the rest are cells that tie
within the resize's float drift).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from odwscl_tpu.data import transforms as jtr
from odwscl_tpu.data.coco_dataset import COCODataset as JCOCODataset
from odwscl_tpu.data.collate import BatchCollator as JCollator
from odwscl_tpu.models import keypoint_head as jkh
from odwscl_tpu.structures import keypoints as jkp
from odwscl_tpu_torch.data import transforms as ttr
from odwscl_tpu_torch.data.coco_dataset import COCODataset
from odwscl_tpu_torch.data.collate import BatchCollator
from odwscl_tpu_torch.models import keypoint_head as tkh
from odwscl_tpu_torch.structures import keypoints as tkp
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

LOGIT_REL = 1e-5
LOSS_RTOL = 1e-5
SCORE_ATOL = 1e-5


def _kps(rng, n=3, k=17, size=(80, 60)):
    kp = np.zeros((n, k, 3), np.float32)
    kp[..., 0] = rng.uniform(0, size[0] - 1, (n, k))
    kp[..., 1] = rng.uniform(0, size[1] - 1, (n, k))
    kp[..., 2] = rng.randint(0, 3, (n, k))
    return kp


def test_keypoints_resize_and_flip_match():
    kp = _kps(np.random.RandomState(0))
    t = tkp.PersonKeypoints(kp, (80, 60))
    j = jkp.PersonKeypoints(kp, (80, 60))
    np.testing.assert_array_equal(t.resize((120, 45)).keypoints,
                                  j.resize((120, 45)).keypoints)
    tf, jf = t.transpose(tkp.FLIP_LEFT_RIGHT), j.transpose(jkp.FLIP_LEFT_RIGHT)
    np.testing.assert_array_equal(tf.keypoints, jf.keypoints)
    np.testing.assert_array_equal(tkp.PersonKeypoints.FLIP_INDS,
                                  jkp.PersonKeypoints.FLIP_INDS)
    # left and right swapped, invisible points zeroed
    assert (tf.keypoints[kp[:, tkp.PersonKeypoints.FLIP_INDS, 2] == 0]
            == 0).all()
    assert tf.size == (80, 60) and len(tf[1:]) == 2
    with pytest.raises(NotImplementedError):
        t.transpose(tkp.FLIP_TOP_BOTTOM)


def test_click_flip_matches():
    pts = np.float32([[[3.0, 4.0, 1.0]], [[70.5, 2.0, 1.0]]])
    t = tkp.Click(pts, (80, 60)).transpose(tkp.FLIP_LEFT_RIGHT)
    j = jkp.Click(pts, (80, 60)).transpose(jkp.FLIP_LEFT_RIGHT)
    np.testing.assert_array_equal(t.keypoints, j.keypoints)
    np.testing.assert_array_equal(t.keypoints[:, 0, 0], [76.0, 8.5])


def test_vflip_with_keypoints_raises():
    img = Image.fromarray(np.zeros((60, 80, 3), np.uint8))
    kp = _kps(np.random.RandomState(1))
    for tr, mod in ((ttr, tkp), (jtr, jkp)):
        s = tr.Sample(image=img, size=(80, 60),
                      gt_keypoints=mod.PersonKeypoints(kp, (80, 60)))
        with pytest.raises(NotImplementedError, match="vflip"):
            tr.vflip(s)


def _heatmap_inputs():
    """Rois: ordinary, one of zero width, a padded one of zeros, a tiny
    one; keypoints: random inside and around each roi, plus points exactly
    on the right and bottom edges, far off (1e12), NaN-free but giving
    0 * inf, and invisible ones."""
    rng = np.random.RandomState(2)
    rois = np.float32([[10, 20, 50, 70], [5, 5, 5, 30], [0, 0, 0, 0],
                       [30.5, 12.25, 31.0, 12.5], [0, 0, 100, 100],
                       [-20, -10, 15, 40]])
    n, k = len(rois), 9
    kp = np.zeros((n, k, 3), np.float32)
    kp[..., 0] = rois[:, None, 0] + rng.uniform(-0.3, 1.3, (n, k)) * (
        rois[:, None, 2] - rois[:, None, 0] + 1)
    kp[..., 1] = rois[:, None, 1] + rng.uniform(-0.3, 1.3, (n, k)) * (
        rois[:, None, 3] - rois[:, None, 1] + 1)
    kp[..., 2] = rng.randint(0, 3, (n, k))
    kp[:, 0, :2] = rois[:, 2:4]                 # on the right/bottom edge
    kp[:, 1, 0] = rois[:, 2]                    # x on the right edge only
    kp[:, 2, :2] = 1e12                         # far off: overflows int32
    kp[:, 3, :2] = -1e12
    kp[:, 4, :2] = rois[:, :2]                  # on the top-left corner:
    # 0 * inf = NaN for the zero-size rois
    kp[:, :5, 2] = 2
    return kp, rois


@pytest.mark.parametrize("size", [28, 56])
def test_keypoints_to_heatmap_matches(size):
    kp, rois = _heatmap_inputs()
    want_ind, want_valid = jkp.keypoints_to_heatmap(
        jnp.asarray(kp), jnp.asarray(rois), size)
    with np.errstate(all="ignore"):
        ind, valid = tkp.keypoints_to_heatmap(torch.from_numpy(kp),
                                              torch.from_numpy(rois), size)
    assert ind.dtype == valid.dtype == torch.int32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(ind.numpy(), np.asarray(want_ind))
    v = valid.numpy().astype(bool)
    assert v.sum() >= 10 and (~v).sum() >= 10
    assert (ind.numpy()[v] == size * size - 1).any()     # the edge point


def test_saturating_cast_is_xla_s():
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9,
                      2147483520.0, -2.7, 2.7], dtype=torch.float32)
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32))
    np.testing.assert_array_equal(tkp.saturating_int32(x).numpy(), want)
    assert want.tolist()[:3] == [0, 2 ** 31 - 1, -2 ** 31]


def _head_params(jm, x, rng):
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    k = params["predictor"]["kps_score_lowres"]["kernel"]
    k[0, 1] += 0.5              # no spatial symmetry the flip could hide
    k[3, 0] -= 0.3
    params["predictor"]["kps_score_lowres"]["bias"][:] = rng.randn(
        k.shape[-1])
    return params


def test_keypoint_head_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 7, 7, 24).astype(np.float32)
    jm = jkh.KeypointHead(num_keypoints=5, conv_layers=(16, 12),
                          compute_dtype=jnp.float32)
    params = _head_params(jm, x, rng)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tkh.KeypointHead(24, 5, (16, 12), compute_dtype=torch.float32)
    sd = state_dict_from_jax({"roi_heads": {"keypoint": params}})
    prefix = "roi_heads.keypoint."
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (6, 28, 28, 5)
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    # without the flip the deconv disagrees
    flipped = dict(tm.state_dict())
    w = flipped["predictor.kps_score_lowres.weight"]
    tm.predictor.kps_score_lowres.weight.data = w.flip(2, 3)
    wrong = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(wrong - want).max() > 100 * LOGIT_REL * np.abs(want).max()
    back = jax_params_from_state_dict(
        {prefix + n: t for n, t in flipped.items()})
    np.testing.assert_array_equal(
        back["roi_heads"]["keypoint"]["predictor"]["kps_score_lowres"][
            "kernel"], params["predictor"]["kps_score_lowres"]["kernel"])


def test_keypoint_head_and_loss_gradients_match():
    """The head and the loss in one train step on a small tower (16, 12
    channels): every ReLU's pre-activation keeps 1e-6 of its layer's
    largest from 0 (a float64 pass), so the gradients of the input and of
    every parameter read the f32 drift; within GRAD_REL = 1e-4 of each
    tensor's largest."""
    rng = np.random.RandomState(9)
    x = rng.randn(6, 7, 7, 24).astype(np.float32)
    targets = rng.randint(0, 784, (6, 5)).astype(np.int32)
    valid = (rng.rand(6, 5) > 0.3).astype(np.int32)
    jm = jkh.KeypointHead(num_keypoints=5, conv_layers=(16, 12),
                          compute_dtype=jnp.float32)
    params = _head_params(jm, x, rng)

    def jloss(p, xx):
        return jkh.keypoint_rcnn_loss(jm.apply({"params": p}, xx),
                                      jnp.asarray(targets),
                                      jnp.asarray(valid))

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = tkh.KeypointHead(24, 5, (16, 12), compute_dtype=torch.float32)
    prefix = "roi_heads.keypoint."
    tm.load_state_dict({k[len(prefix):]: v for k, v in state_dict_from_jax(
        {"roi_heads": {"keypoint": params}}).items()})
    pre = torch.from_numpy(x).double().permute(0, 3, 1, 2)
    for i in (1, 2):
        conv = getattr(tm.extractor, f"conv_fcn{i}")
        pre = torch.nn.functional.conv2d(pre, conv.weight.double(),
                                         conv.bias.double(), padding=1)
        assert (pre.abs().min() / pre.abs().max()).item() >= 1e-6
        pre = pre.clamp(min=0)
    xt = torch.from_numpy(x).requires_grad_()
    tkh.keypoint_rcnn_loss(tm(xt), torch.from_numpy(targets),
                           torch.from_numpy(valid)).backward()
    got = {prefix + n: q.grad for n, q in tm.named_parameters()}
    got_p = jax_params_from_state_dict(got)["roi_heads"]["keypoint"]
    pairs = [(xt.grad.numpy(), np.asarray(want_x))] + [
        (got_p[a][b][c], np.asarray(want_p[a][b][c]))
        for a in want_p for b in want_p[a] for c in want_p[a][b]
        if c != "bias" or b != "kps_score_lowres"]
    assert len(pairs) == 1 + 5        # x, two convs, the deconv kernel
    for g, w in pairs:
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    # the deconv's bias: a constant per map through a softmax, exactly 0
    assert np.abs(got_p["predictor"]["kps_score_lowres"]["bias"]).max() \
        <= 1e-6


def test_keypoint_loss_matches():
    rng = np.random.RandomState(4)
    logits = (rng.randn(5, 28, 28, 7) * 3).astype(np.float32)
    targets = rng.randint(0, 784, (5, 7)).astype(np.int32)
    valid = (rng.rand(5, 7) > 0.4).astype(np.int32)
    want = float(jkh.keypoint_rcnn_loss(jnp.asarray(logits),
                                        jnp.asarray(targets),
                                        jnp.asarray(valid)))
    got = tkh.keypoint_rcnn_loss(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 torch.from_numpy(valid)).item()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    empty = tkh.keypoint_rcnn_loss(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   torch.zeros(5, 7, dtype=torch.int32))
    assert empty.item() == 0.0


def test_heatmap_decode_matches_cv2():
    pytest.importorskip("cv2")
    rng = np.random.RandomState(5)
    # smooth maps with one peak per keypoint (the decode's use), plus noise
    n, k = 6, 5
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    centers = rng.uniform(2, 26, (n, k, 2))
    maps = np.exp(-((xx[None, None] - centers[..., 0, None, None]) ** 2
                    + (yy[None, None] - centers[..., 1, None, None]) ** 2)
                  / 18.0) * 8
    maps = (maps + rng.randn(n, k, 28, 28) * 0.05).astype(np.float32)
    maps = maps.transpose(0, 2, 3, 1).copy()                 # [N, H, H, K]
    # rois smaller than, equal to and larger than the 28-cell map
    rois = np.float32([[3, 4, 15.5, 12], [10, 10, 38, 38], [0, 0, 200, 90],
                       [5.5, 7.25, 60.75, 120.5], [2, 2, 2, 2],
                       [20, 30, 45, 300]])
    want_xy, want_sc = jkh.heatmaps_to_keypoints(maps, rois)
    got_xy, got_sc = tkh.heatmaps_to_keypoints(torch.from_numpy(maps),
                                               torch.from_numpy(rois))
    assert got_xy.shape == want_xy.shape == (n, k, 3)
    assert got_sc.shape == want_sc.shape == (n, k)
    np.testing.assert_allclose(got_sc, want_sc, atol=SCORE_ATOL)
    same = (got_xy == want_xy).all(-1)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(got_xy[..., 2], 1)


@pytest.fixture(scope="module")
def coco_kp(tmp_path_factory):
    """Two 60x80 images: person annotations with 17 keypoints (some
    invisible), one annotation without keypoints, a crowd one."""
    root = tmp_path_factory.mktemp("coco_kp")
    (root / "imgs").mkdir()
    rng = np.random.RandomState(6)
    for i in (1, 2):
        Image.fromarray(rng.randint(0, 255, (60, 80, 3), np.uint8)).save(
            root / "imgs" / f"{i}.jpg")
    anns = []
    for aid, (img, box, crowd) in enumerate(
            [(1, [10, 20, 30, 25], 0), (1, [40, 5, 30, 30], 0),
             (1, [50, 40, 20, 15], 1), (2, [8, 8, 40, 30], 0),
             (2, [30, 20, 20, 20], 0)], 1):
        x, y, w, h = box
        kps = np.zeros((17, 3))
        kps[:, 0] = rng.uniform(x, x + w, 17).round(1)
        kps[:, 1] = rng.uniform(y, y + h, 17).round(1)
        kps[:, 2] = rng.randint(0, 3, 17)
        kps[kps[:, 2] == 0, :2] = 0
        ann = {"id": aid, "image_id": img, "category_id": 1,
               "bbox": box, "area": w * h, "iscrowd": crowd,
               "segmentation": [[x, y, x + w, y, x + w, y + h]]}
        if aid != 5:
            ann["keypoints"] = kps.reshape(-1).tolist()
        anns.append(ann)
    data = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 60,
                        "width": 80} for i in (1, 2)],
            "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}
    path = root / "ann.json"
    path.write_text(json.dumps(data))
    return str(path), str(root / "imgs")


def test_coco_load_keypoints_and_collator_match(coco_kp):
    ann, imgs = coco_kp
    ds = COCODataset(ann, imgs, load_keypoints=True)
    jds = JCOCODataset(ann, imgs, load_keypoints=True)
    samples, jsamples = [], []
    for i, flip in ((0, True), (1, False)):
        s, js = ds[i], jds[i]
        np.testing.assert_array_equal(s.gt_keypoints.keypoints,
                                      js.gt_keypoints.keypoints)
        assert s.gt_keypoints.keypoints.shape[1:] == (17, 3)
        s, js = ttr.resize(s, 45, 100), jtr.resize(js, 45, 100)
        if flip:
            s, js = ttr.hflip(s), jtr.hflip(js)
        np.testing.assert_array_equal(s.gt_keypoints.keypoints,
                                      js.gt_keypoints.keypoints)
        samples.append(ttr.to_array(s))
        jsamples.append(jtr.to_array(js))
    kw = dict(num_classes=2, size_divisibility=32, image_pad_multiple=32,
              proposal_buckets=(16,), include_gt=True, gt_pad=4)
    got, want = BatchCollator(**kw)(samples), JCollator(**kw)(jsamples)
    assert got.gt_keypoints.shape == (2, 4, 17, 3)
    np.testing.assert_array_equal(got.gt_keypoints.numpy(),
                                  np.asarray(want.gt_keypoints))
    assert got.gt_keypoints[..., 2].sum() > 0
    # an annotation without keypoints: 17 zero points
    assert not got.gt_keypoints[1, 1].any()
