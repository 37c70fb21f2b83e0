"""The port's Mask R-CNN pieces against the JAX package's, on the CPU:
``roi_align``, the Fast R-CNN targets and loss, the mask head, its
targets, loss and Masker, the polygon / RLE rasters and mask containers,
the COCO masks through the dataset, transforms and collator, the segm
evaluator, and ``build_model``'s family dispatch.

The same numpy inputs from a seed go through both. Tolerances:
- ``roi_align`` 1e-5 of the output's largest magnitude (the port sums
  each roi as two weight matrices, JAX sample by sample), its gradient
  1e-5 too;
- the Fast R-CNN matches, labels and sampled masks equal (the sample
  draws the JAX keys' uniforms, handed in); reg targets 1e-5; losses and
  accuracy 1e-5 relative;
- the mask head's logits 1e-5 of their largest (the bridge flips flax's
  ConvTranspose kernel, held here on a non-symmetric kernel); crop-resized
  targets 1e-6; the mask loss 1e-5 relative; mask labels and positives
  equal;
- polygon rasters equal (both fill with PIL); RLE equal;
  ``BinaryMasks.resize`` against cv2 within 1e-5 (the port resizes with
  ``F.interpolate``), and the thresholded masks equal except at pixels
  within 1e-5 of 0.5;
- the Masker's pasted masks equal except pixels whose resized
  probability lies within 1e-5 of the 0.5 threshold (counted and
  reported: ROADMAP Queue 3);
- the collator's GT boxes, labels and rasters equal;
- the segm evaluator: AP 1.0 on the GT's own masks, and the same stats
  as the JAX evaluator on shifted masks within 1e-12.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data.coco_dataset import COCODataset as JCOCODataset
from odwscl_tpu.data import transforms as jtr
from odwscl_tpu.data.collate import BatchCollator as JCollator
from odwscl_tpu.evaluation import coco_eval as jeval
from odwscl_tpu.losses import fast_rcnn as jfr
from odwscl_tpu.models import build_model as jbuild
from odwscl_tpu.models import mask_head as jmh
from odwscl_tpu.ops.roi_align import roi_align as jroi_align
from odwscl_tpu.structures import masks as jmasks
from odwscl_tpu.structures import rle as jrle
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data import transforms as ttr
from odwscl_tpu_torch.data.coco_dataset import COCODataset
from odwscl_tpu_torch.data.collate import BatchCollator
from odwscl_tpu_torch.evaluation import coco_eval as teval
from odwscl_tpu_torch.losses import fast_rcnn as tfr
from odwscl_tpu_torch.models import (RetinaNetDetector, SupervisedRCNN,
                                     WSODDetector, build_model)
from odwscl_tpu_torch.models import mask_head as tmh
from odwscl_tpu_torch.ops.roi_align import roi_align
from odwscl_tpu_torch.structures import masks as tmasks
from odwscl_tpu_torch.structures import rle as trle
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESH_EPS = 1e-5


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-30)


@pytest.mark.parametrize("sampling,scale", [(0, 0.25), (2, 0.125),
                                            (0, 0.0625)])
def test_roi_align_matches(sampling, scale):
    rng = np.random.RandomState(sampling + int(1 / scale))
    feat = rng.randn(2, 24, 30, 8).astype(np.float32)
    x1y1 = rng.uniform(-20, 100 / scale * 0.25, (2, 20, 2))
    wh = rng.uniform(1, 60 / scale * 0.25, (2, 20, 2))
    rois = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    rois[0, 0] = [10, 10, 9, 9]                  # malformed
    rois[1, 1] = [1000, 1000, 1200, 1200]        # off the map
    mask = rng.uniform(size=(2, 20)) > 0.2
    g = rng.randn(2, 20, 7, 7, 8).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jroi_align(f, jnp.asarray(rois),
                                             jnp.asarray(mask), scale, 7,
                                             sampling), jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_()
    got = roi_align(tf, torch.from_numpy(rois), torch.from_numpy(mask),
                    scale, 7, sampling)
    assert _rel_err(got.detach().numpy(), want) <= 1e-5
    assert not got[torch.from_numpy(~mask)].any()
    got.backward(torch.from_numpy(g))
    (want_g,) = vjp(jnp.asarray(g))
    assert _rel_err(tf.grad.numpy(), want_g) <= 1e-5


def _proposals(rng, b=2, p=64, g=5):
    gt = np.concatenate([rng.uniform(0, 50, (b, g, 2)),
                         rng.uniform(60, 120, (b, g, 2))], -1)
    jitter = rng.uniform(-15, 15, (b, p, 4))
    props = gt[:, rng.randint(0, g, p)][np.arange(b)[:, None], np.arange(p)]
    props = props + jitter
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2)
    labels = rng.randint(1, 7, (b, g)).astype(np.int32)
    gmask = np.ones((b, g), bool)
    gmask[1, 3:] = False
    pmask = np.ones((b, p), bool)
    pmask[1, -10:] = False
    return (props.astype(np.float32), pmask, gt.astype(np.float32), labels,
            gmask)


def _jax_uniform(key, b, p):
    """The uniforms JAX's balanced_sample draws: [B, 2, P]."""
    return np.stack([np.stack([np.array(jax.random.uniform(r, (p,)))
                               for r in jax.random.split(k)])
                     for k in jax.random.split(key, b)])


def test_fast_rcnn_targets_and_loss_match():
    rng = np.random.RandomState(0)
    props, pmask, gt, labels, gmask = _proposals(rng)
    key = jax.random.PRNGKey(3)
    want = jfr.prepare_fast_rcnn_targets(
        key, *(jnp.asarray(v) for v in (props, pmask, gt, labels, gmask)),
        0.5, 0.5, 16, 0.25)
    got = tfr.prepare_fast_rcnn_targets(
        *(torch.from_numpy(v) for v in (props, pmask, gt)),
        torch.from_numpy(labels).long(), torch.from_numpy(gmask), 0.5, 0.5,
        16, 0.25, uniform=torch.from_numpy(_jax_uniform(key, 2, 64)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.pos_mask.numpy(),
                                  np.asarray(want.pos_mask))
    np.testing.assert_array_equal(got.neg_mask.numpy(),
                                  np.asarray(want.neg_mask))
    assert got.pos_mask.sum() > 0 and got.neg_mask.sum() > 0
    assert int(got.pos_mask[0].sum()) <= 4       # 16 x 0.25
    pos = got.pos_mask.numpy()
    np.testing.assert_allclose(got.reg_targets.numpy()[pos],
                               np.asarray(want.reg_targets)[pos], atol=1e-5)
    logits = (rng.randn(2, 64, 7) * 2).astype(np.float32)
    deltas = rng.randn(2, 64, 28).astype(np.float32)
    for agn in (False, True):
        d = deltas[..., :8] if agn else deltas
        w = jfr.fast_rcnn_loss(jnp.asarray(logits), jnp.asarray(d), want, agn)
        t = tfr.fast_rcnn_loss(torch.from_numpy(logits), torch.from_numpy(d),
                               got, agn)
        for a, bb in zip(t, w):
            np.testing.assert_allclose(float(a), float(bb), rtol=1e-5)


def test_mask_head_matches_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(5, 7, 7, 24).astype(np.float32)
    jm = jmh.MaskHead(num_classes=6, conv_layers=(16, 12),
                      compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    k = params["predictor"]["conv5_mask"]["kernel"]
    k[0, 1] += 0.5              # no spatial symmetry the flip could hide
    params["predictor"]["conv5_mask"]["bias"][:] = rng.randn(12)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tmh.MaskHead(24, 6, (16, 12), compute_dtype=torch.float32)
    sd = state_dict_from_jax({"roi_heads": {"mask": params}})
    tm.load_state_dict({k[len("roi_heads.mask."):]: v for k, v in sd.items()})
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (5, 14, 14, 6)
    assert _rel_err(got, want) <= 1e-5
    assert set(tm.state_dict()) == {
        "extractor.mask_fcn1.weight", "extractor.mask_fcn1.bias",
        "extractor.mask_fcn2.weight", "extractor.mask_fcn2.bias",
        "predictor.conv5_mask.weight", "predictor.conv5_mask.bias",
        "predictor.mask_fcn_logits.weight", "predictor.mask_fcn_logits.bias"}
    # the bridge's inverse gives the flax kernel back
    from odwscl_tpu_torch.utils.from_jax import jax_params_from_state_dict
    back = jax_params_from_state_dict(
        {"roi_heads.mask." + n: t for n, t in tm.state_dict().items()})
    np.testing.assert_array_equal(
        back["roi_heads"]["mask"]["predictor"]["conv5_mask"]["kernel"], k)


def test_mask_targets_and_loss_match():
    rng = np.random.RandomState(2)
    props, pmask, gt, labels, gmask = _proposals(rng, p=40)
    bitmasks = (rng.rand(2, 5, 32, 40) > 0.5).astype(np.float32)
    for i in range(2):
        tl, tt, tp = tmh.mask_head_targets(
            *(torch.from_numpy(v[i]) for v in (props, pmask, gt)),
            torch.from_numpy(labels[i]).long(), torch.from_numpy(gmask[i]),
            torch.from_numpy(bitmasks[i]), 14, 0.5, 0.5, raster_stride=4.0)
        wl, wt, wp = jmh.mask_head_targets(
            *(jnp.asarray(v[i]) for v in (props, pmask, gt, labels, gmask,
                                          bitmasks)), 14, 0.5, 0.5,
            raster_stride=4.0)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))
        np.testing.assert_allclose(tt.numpy(), np.asarray(wt), atol=1e-6)
        assert tp.sum() > 0
    # crop-resize on boxes reaching past the raster
    boxes = np.float32([[-5, -3, 20, 18], [30, 25, 60, 50], [3, 3, 3.5, 3.2]])
    idx = np.int32([0, 2, 4])
    np.testing.assert_allclose(
        tmh.crop_resize_bitmasks(torch.from_numpy(bitmasks[0]),
                                 torch.from_numpy(idx).long(),
                                 torch.from_numpy(boxes), 8).numpy(),
        np.asarray(jmh.crop_resize_bitmasks(jnp.asarray(bitmasks[0]),
                                            jnp.asarray(idx),
                                            jnp.asarray(boxes), 8)),
        atol=1e-6)
    n, m, c = 9, 14, 6
    logits = (rng.randn(n, m, m, c) * 3).astype(np.float32)
    lab = rng.randint(0, c, n)
    tgt = rng.rand(n, m, m).astype(np.float32)
    pos = (lab > 0).astype(np.float32)
    want = jmh.mask_rcnn_loss(jnp.asarray(logits), jnp.asarray(lab),
                              jnp.asarray(tgt), jnp.asarray(pos))
    got = tmh.mask_rcnn_loss(torch.from_numpy(logits),
                             torch.from_numpy(lab), torch.from_numpy(tgt),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    zero = tmh.mask_rcnn_loss(torch.from_numpy(logits),
                              torch.from_numpy(lab), torch.from_numpy(tgt),
                              torch.zeros(n))
    assert float(zero) == 0.0


def test_masker_matches_cv2():
    """The port's paste (F.interpolate) against the JAX package's (cv2):
    equal except pixels within THRESH_EPS of the threshold."""
    rng = np.random.RandomState(3)
    masks = rng.rand(40, 14, 14).astype(np.float32)
    masks[:5] = np.float32(0.5)                  # ties at the threshold
    x1y1 = rng.uniform(-10, 80, (40, 2))
    wh = rng.uniform(1, 90, (40, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    got = tmh.Masker()(masks, boxes, 96, 120)
    want = jmh.Masker()(masks, boxes, 96, 120)
    assert got.shape == want.shape == (40, 96, 120)
    diff = got != want
    near = np.zeros_like(diff)
    for i, (m, b) in enumerate(zip(masks, boxes)):
        if diff[i].any():
            # the port's own resized probabilities at the differing pixels
            near[i] = np.abs(_paste_probs(m, b, 96, 120) - 0.5) <= THRESH_EPS
    assert not (diff & ~near).any()
    print(f"Masker: {int(diff.sum())} of {diff.size} pasted pixels differ, "
          "all within 1e-5 of the threshold")
    np.testing.assert_array_equal(
        tmh.select_class_masks(np.stack([masks[:3], 1 - masks[:3]], -1),
                               np.array([1, 0, 1])),
        jmh.select_class_masks(np.stack([masks[:3], 1 - masks[:3]], -1),
                               np.array([1, 0, 1])))
    assert tmh.Masker()(masks[:0], boxes[:0], 9, 9).shape == (0, 9, 9)


def _paste_probs(mask, box, im_h, im_w):
    """The resized padded probabilities placed on the image (NaN outside)."""
    padded = np.pad(mask, 1)
    scale = 16.0 / 14
    box = tmh._expand_box(np.asarray(box, np.float32), scale).astype(np.int32)
    w = max(int(box[2] - box[0] + 1), 1)
    h = max(int(box[3] - box[1] + 1), 1)
    res = tmasks.resize_bilinear(padded, w, h)
    out = np.full((im_h, im_w), np.nan, np.float32)
    x0, x1 = max(box[0], 0), min(box[2] + 1, im_w)
    y0, y1 = max(box[1], 0), min(box[3] + 1, im_h)
    if x1 > x0 and y1 > y0:
        out[y0:y1, x0:x1] = res[y0 - box[1]:y1 - box[1],
                                x0 - box[0]:x1 - box[0]]
    return out


POLYS = [
    [[10, 20, 39, 20, 39, 39, 10, 39]],                     # a rectangle
    [[5.5, 3.2, 30.7, 8.9, 18.1, 27.4]],                     # a triangle
    [[2, 2, 20, 2, 20, 20, 2, 20], [25, 5, 35, 5, 30, 15]],  # two groups
    [[0, 0, 50, 10, 10, 50, 45, 45, 30, 0]],                 # self-crossing
    [[1, 1, 2, 2]],                                         # < 3 points
]


@pytest.mark.parametrize("i", range(len(POLYS)))
def test_polygons_match(i):
    poly = POLYS[i]
    np.testing.assert_array_equal(tmasks.rasterize_polygons(poly, 48, 60),
                                  jmasks.rasterize_polygons(poly, 48, 60))
    np.testing.assert_array_equal(
        trle.rasterize_segmentation(poly, 48, 60),
        jrle.rasterize_segmentation(poly, 48, 60))
    tp, jp = tmasks.PolygonMasks([poly], (60, 48)), \
        jmasks.PolygonMasks([poly], (60, 48))
    for t, j in ((tp, jp), (tp.transpose(0), jp.transpose(0)),
                 (tp.transpose(1), jp.transpose(1)),
                 (tp.crop([4.3, 2.6, 40.2, 33.9]),
                  jp.crop([4.3, 2.6, 40.2, 33.9])),
                 (tp.resize((37, 29)), jp.resize((37, 29))),
                 (tp.crop([-5, -5, 100, 100]).resize((90, 61)),
                  jp.crop([-5, -5, 100, 100]).resize((90, 61)))):
        assert t.size == j.size
        np.testing.assert_array_equal(t.to_bitmasks(), j.to_bitmasks())


def test_binary_masks_match():
    rng = np.random.RandomState(4)
    m = (rng.rand(3, 30, 44) > 0.5).astype(np.uint8)
    tb, jb = tmasks.BinaryMasks(m, (44, 30)), jmasks.BinaryMasks(m, (44, 30))
    for size in ((60, 41), (17, 11), (44, 30), (88, 15)):
        t, j = tb.resize(size), jb.resize(size)
        np.testing.assert_allclose(t.masks, j.masks, atol=1e-5)
        near = np.abs(j.masks - 0.5) <= THRESH_EPS
        assert ((t.to_bitmasks() == j.to_bitmasks()) | near).all()
    for t, j in ((tb.transpose(0), jb.transpose(0)),
                 (tb.transpose(1), jb.transpose(1)),
                 (tb.crop([3.4, 2.6, 30.5, 20.2]),
                  jb.crop([3.4, 2.6, 30.5, 20.2])), (tb[1], jb[1]),
                 (tb[[0, 2]], jb[[0, 2]])):
        assert t.size == j.size
        np.testing.assert_array_equal(t.masks, j.masks)
    rles = [trle.rle_encode(x) for x in m]
    np.testing.assert_array_equal(tmasks.BinaryMasks(rles, (44, 30)).masks,
                                  m)
    tf = tmasks.Masks([POLYS[0], POLYS[2]], (60, 48))
    jf = jmasks.Masks([POLYS[0], POLYS[2]], (60, 48))
    np.testing.assert_array_equal(tf[1].to_bitmasks(), jf[1].to_bitmasks())
    assert len(list(tf)) == 2 and tf.mode == "poly"


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    """One 60x80 image: a polygon rectangle, an RLE strip, a triangle and
    a crowd polygon; a second image with polygons only."""
    root = tmp_path_factory.mktemp("coco_masks")
    (root / "imgs").mkdir()
    rng = np.random.RandomState(5)
    for i in (1, 2):
        Image.fromarray(rng.randint(0, 255, (60, 80, 3), np.uint8)).save(
            root / "imgs" / f"{i}.jpg")
    strip = np.zeros((60, 80), np.uint8)
    strip[:, :5] = 1
    anns = [
        {"id": 1, "image_id": 1, "category_id": 5,
         "bbox": [10.0, 20.0, 30.0, 20.0], "area": 600.0, "iscrowd": 0,
         "segmentation": [[10, 20, 39, 20, 39, 39, 10, 39]]},
        {"id": 2, "image_id": 1, "category_id": 3,
         "bbox": [0.0, 0.0, 5.0, 60.0], "area": 300.0, "iscrowd": 0,
         "segmentation": trle.rle_encode(strip)},
        {"id": 3, "image_id": 1, "category_id": 5,
         "bbox": [40.0, 5.0, 30.0, 30.0], "area": 450.0, "iscrowd": 0,
         "segmentation": [[40, 5, 70, 5, 55, 35]]},
        {"id": 4, "image_id": 1, "category_id": 3,
         "bbox": [50.0, 40.0, 20.0, 15.0], "area": 300.0, "iscrowd": 1,
         "segmentation": [[50, 40, 70, 40, 70, 55, 50, 55]]},
        {"id": 5, "image_id": 2, "category_id": 1,
         "bbox": [8.0, 8.0, 40.0, 30.0], "area": 1200.0, "iscrowd": 0,
         "segmentation": [[8, 8, 48, 8, 48, 38], [8, 8, 8, 38, 48, 38]]},
    ]
    data = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 60,
                        "width": 80} for i in (1, 2)],
            "annotations": anns,
            "categories": [{"id": i, "name": f"c{i}"} for i in range(1, 7)]}
    path = root / "ann.json"
    path.write_text(json.dumps(data))
    return str(path), str(root / "imgs")


def _datasets(coco_json):
    ann, imgs = coco_json
    return (COCODataset(ann, imgs, load_masks=True),
            JCOCODataset(ann, imgs, load_masks=True))


def test_dataset_transforms_and_collator_match(coco_json):
    ds, jds = _datasets(coco_json)
    for i in range(len(ds)):
        s, js = ds[i], jds[i]
        np.testing.assert_array_equal(s.gt_masks.to_bitmasks(),
                                      js.gt_masks.to_bitmasks())
        assert s.gt_masks.mode == js.gt_masks.mode
    # train-style: resize + flip, then the collator's rasters at stride 2
    samples, jsamples = [], []
    for i, flip in ((0, True), (1, False)):
        s = ttr.resize(ds[i], 45, 100)
        js = jtr.resize(jds[i], 45, 100)
        if flip:
            s, js = ttr.hflip(s), jtr.hflip(js)
        s = ttr.normalize(ttr.to_array(s), (102.98, 115.95, 122.77),
                          (1, 1, 1))
        js = jtr.normalize(jtr.to_array(js), (102.98, 115.95, 122.77),
                           (1, 1, 1))
        samples.append(s)
        jsamples.append(js)
    kw = dict(num_classes=7, size_divisibility=32, image_pad_multiple=32,
              proposal_buckets=(16,), include_gt=True, gt_pad=4,
              mask_raster_stride=2)
    got, want = BatchCollator(**kw)(samples), JCollator(**kw)(jsamples)
    for name in ("gt_boxes", "gt_labels", "gt_mask", "gt_bitmasks",
                 "images"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.gt_bitmasks.shape[1:] == (4, 32, 32)     # 64x64 canvas / 2
    assert got.gt_bitmasks.sum() > 0
    # the WSOD collator keeps its surface
    assert BatchCollator(7, proposal_buckets=(16,))(samples).gt_boxes is None
    # keypoints load (annotations without any: 17 invisible points each)
    ann, imgs = coco_json
    kp = COCODataset(ann, imgs, load_keypoints=True)[0].gt_keypoints
    assert kp.keypoints.shape == (3, 17, 3) and not kp.keypoints.any()


def _gt_predictions(ds, shift=0):
    """The GT as predictions: boxes (+1 convention), masks rolled by
    ``shift`` px."""
    from odwscl_tpu_torch.structures.rle import rasterize_segmentation

    preds = []
    for i in range(len(ds)):
        info = ds.get_img_info(i)
        anns = [a for a in ds.coco.img_to_anns[ds.id_to_img_map[i]]
                if not a.get("iscrowd", 0)]
        boxes, labels, _ = ds.get_groundtruth(i)
        masks = np.stack([np.roll(rasterize_segmentation(
            a["segmentation"], info["height"], info["width"]), shift,
            axis=1).astype(bool) for a in anns])
        preds.append({"boxes": boxes, "labels": labels, "masks": masks,
                      "scores": np.linspace(1, 0.5, len(labels))})
    return preds


@pytest.mark.parametrize("shift", [0, 3])
def test_segm_evaluator_matches(coco_json, shift):
    ds, jds = _datasets(coco_json)
    preds = _gt_predictions(ds, shift)
    got = teval.do_coco_evaluation(ds, preds, iou_types=("bbox", "segm"))
    want = jeval.do_coco_evaluation(jds, preds, iou_types=("bbox", "segm"))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    if shift == 0:
        assert got["segm_AP"] == got["segm_AP50"] == 1.0
    else:
        assert got["segm_AP"] < 1.0 and got["AP"] == 1.0


def _jcfg(body, **kw):
    cfg = jax_cfg()
    cfg.MODEL.WSOD_ON = False
    cfg.MODEL.BACKBONE.CONV_BODY = body
    for k, v in kw.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


def _tcfg(body, **kw):
    cfg = get_default_cfg()
    cfg.MODEL.WSOD_ON = False
    cfg.MODEL.BACKBONE.CONV_BODY = body
    for k, v in kw.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


@pytest.mark.parametrize("body", ["VGG16-OICR", "R-50-C5", "R-18-C4",
                                  "R-18-FPN"])
def test_wsod_off_builds_the_supervised_model(body):
    """WSOD_ON False builds the supervised R-CNN in both packages, whatever
    the body (the port's detector_from_cfg used to ignore the key)."""
    kw = {"MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM": 16,
          "MODEL.ROI_BOX_HEAD.NUM_CLASSES": 5}
    assert type(jbuild(_jcfg(body, **kw))).__name__ == "SupervisedRCNN"
    with torch.device("meta"):
        model = build_model(_tcfg(body, **kw))
    assert isinstance(model, SupervisedRCNN)
    assert model.is_fpn == body.endswith("FPN")


def test_build_model_dispatch():
    with torch.device("meta"):
        assert isinstance(build_model(get_default_cfg()), WSODDetector)
        cfg = get_default_cfg()
        cfg.MODEL.RETINANET_ON = True
        cfg.MODEL.BACKBONE.CONV_BODY = "R-18-FPN-RETINANET"
        assert isinstance(build_model(cfg), RetinaNetDetector)
        with pytest.raises(ValueError, match="RESOLUTION"):
            build_model(_tcfg("R-18-FPN", **{"MODEL.MASK_ON": True,
                                             "MODEL.ROI_MASK_HEAD.RESOLUTION":
                                             28}))
        # the FBNet bodies and the keypoint head build, as in JAX
        fb = build_model(_tcfg("FBNet-default"))
        assert isinstance(fb, SupervisedRCNN)
        assert fb.backbone.out_channels == 96
        kp = build_model(_tcfg("R-18-FPN", **{"MODEL.KEYPOINT_ON": True}))
        assert kp.keypoint_on and kp.roi_heads.keypoint is not None
        for f in ("coco_mask_rcnn_smoke.yaml", "coco_retinanet_smoke.yaml"):
            cfg = get_default_cfg()
            cfg.merge_from_file(os.path.join(REPO, "configs", "coco", f))
            assert not isinstance(build_model(cfg), WSODDetector)
