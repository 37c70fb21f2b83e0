"""Box geometry, NMS and detection post-processing of the port against the
JAX package, on the CPU.

Tolerances:
- box decode / clip / flip / resize: 1e-5 px plus 1e-6 of the coordinate
  (``atol=1e-5, rtol=1e-6``). Both sides compute the same f32
  expressions; XLA may contract a multiply-add into one rounding where
  torch rounds twice, which moves a corner by an ulp (6e-5 px at 700 px).
- NMS keep masks: identical. The inputs are drawn so that no IoU lies
  within 1e-6 of the threshold, so that an ulp of IoU cannot flip a
  suppression. The NMS IoU has NO +1 offset (torchvision's convention).
- finalize (NMS + top-K): identical kept sets and labels, scores equal
  (they are copied, not computed), boxes as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.engine import postprocess as jpost
from odwscl_tpu.ops import nms as jnms
from odwscl_tpu.structures import boxes as jboxes
from odwscl_tpu_torch.engine import postprocess as tpost
from odwscl_tpu_torch.ops import nms as tnms
from odwscl_tpu_torch.structures import boxes as tboxes

torch.set_num_threads(1)

NMS_THRESH = 0.4


def _boxes(rng, shape, lo=0.0, hi=120.0, min_wh=4.0, max_wh=60.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _iou_np(b):
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area[:, None] + area[None, :] - inter)


def _clustered(rng, n_sets, p, thresh):
    """Sets of clustered boxes (plenty of overlaps) whose pairwise IoUs all
    stay at least 1e-6 away from the threshold."""
    out = []
    while len(out) < n_sets:
        centers = rng.uniform(20, 100, (4, 2))
        c = centers[rng.randint(0, 4, p)] + rng.randn(p, 2) * 6
        wh = rng.uniform(10, 30, (p, 2))
        b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        if np.all(np.abs(_iou_np(b.astype(np.float64)) - thresh) > 1e-6):
            out.append(b)
    return np.stack(out)


def test_decode_clip_flip_resize_match_jax():
    rng = np.random.RandomState(0)
    b, p, k = 2, 16, 21
    boxes = _boxes(rng, (b, p))
    codes = (rng.randn(b, p, 4 * k) * 2.0).astype(np.float32)
    codes[0, 0, 2:4] = 50.0       # exercises the BBOX_XFORM_CLIP clamp
    sizes = np.array([[100, 130], [90, 150]], np.float32)

    want = np.asarray(jboxes.decode_boxes(jnp.asarray(codes),
                                          jnp.asarray(boxes)))
    got = tboxes.decode_boxes(torch.from_numpy(codes), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)

    dec = np.array(want).reshape(b, p, k, 4)
    want_c = np.asarray(jboxes.clip_to_image(jnp.asarray(dec),
                                             jnp.asarray(sizes)[:, None, None]))
    got_c = tboxes.clip_to_image(torch.from_numpy(dec),
                                 torch.from_numpy(sizes)[:, None, None])
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-6, atol=1e-5)

    np.testing.assert_allclose(
        tboxes.flip_boxes_horizontal(torch.from_numpy(boxes), 150.0).numpy(),
        np.asarray(jboxes.flip_boxes_horizontal(jnp.asarray(boxes), 150.0)),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        tboxes.resize_boxes(torch.from_numpy(boxes), 1.5, 0.75).numpy(),
        np.asarray(jboxes.resize_boxes(jnp.asarray(boxes), 1.5, 0.75)),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        tboxes.box_iou(torch.from_numpy(boxes[0]),
                       torch.from_numpy(boxes[1])).numpy(),
        np.asarray(jboxes.box_iou(jnp.asarray(boxes[0]),
                                  jnp.asarray(boxes[1]))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_mask_matches_jax_and_numpy(seed):
    rng = np.random.RandomState(seed)
    p = 48
    boxes = _clustered(rng, 1, p, NMS_THRESH)[0]
    scores = rng.uniform(size=p).astype(np.float32)
    mask = rng.uniform(size=p) > 0.15

    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(mask), NMS_THRESH).numpy()
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(mask), NMS_THRESH))
    np.testing.assert_array_equal(got, want)

    sel = np.nonzero(mask)[0]
    keep_np = sel[jnms.nms_numpy(boxes[sel], scores[sel], NMS_THRESH)]
    np.testing.assert_array_equal(np.nonzero(got)[0], np.sort(keep_np))


def test_batched_nms_mask_matches_jax():
    rng = np.random.RandomState(5)
    b, c, p = 2, 3, 40
    boxes = _clustered(rng, b * c, p, NMS_THRESH).reshape(b, c, p, 4)
    scores = rng.uniform(size=(b, c, p)).astype(np.float32)
    scores[0, 1, :5] = scores[0, 1, 5]          # ties resolve by index
    mask = rng.uniform(size=(b, c, p)) > 0.2
    mask[1, 2] = False                          # a fully masked set
    got = tnms.batched_nms_mask(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(mask), NMS_THRESH).numpy()
    want = np.asarray(jnms.batched_nms_mask(jnp.asarray(boxes),
                                            jnp.asarray(scores),
                                            jnp.asarray(mask), NMS_THRESH))
    np.testing.assert_array_equal(got, want)
    assert not got[1, 2].any()


@pytest.mark.parametrize("per_class", [True, False])
def test_finalize_detections_matches_jax(per_class):
    rng = np.random.RandomState(7)
    b, p, c, k = 2, 32, 6, 20
    base = _clustered(rng, b, p, NMS_THRESH)
    if per_class:
        jit = rng.randn(b, p, c, 4).astype(np.float32) * 0.5
        boxes = base[:, :, None, :] + jit
        for i in range(b):
            for j in range(c):
                ious = _iou_np(boxes[i, :, j].astype(np.float64))
                assert np.all(np.abs(ious - NMS_THRESH) > 1e-6)
    else:
        boxes = base
    logits = rng.randn(b, p, c).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = np.ones((b, p), bool)
    mask[1, -5:] = False

    want = [np.asarray(x) for x in jpost.finalize_detections_device(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask),
        NMS_THRESH, 0.05, k)]
    got = [x.numpy() for x in tpost.finalize_detections_device(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(mask), NMS_THRESH, 0.05, k)]
    np.testing.assert_array_equal(got[3], want[3])             # valid
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_array_equal(got[1][got[3]], want[1][want[3]])
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], rtol=1e-6,
                               atol=1e-5)

    dets = tpost.detections_to_host(*(torch.from_numpy(x) for x in got))
    jdets = jpost.detections_to_host(*want)
    for d, jd in zip(dets, jdets):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(d[key], jd[key])
        r = tpost.resize_detections(d, (100, 80), (500, 375))
        jr = jpost.resize_detections(jd, (100, 80), (500, 375))
        np.testing.assert_array_equal(r["boxes"], jr["boxes"])
