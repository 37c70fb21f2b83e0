"""The port's loss terms, pseudo-labels and augmentations against the JAX
package's, on the CPU.

Same numpy inputs through both. Tolerances: values 1e-6 (f32; the same
elementwise formulas, reductions in another order over at most a few
hundred terms); SupCon gradients and regression targets 1e-5 (scaled by
1/T = 5 and by the box-coder weights 10 and 5); integer outputs
(pseudo-labels, argmax routes, masks) exact.

The random ops: the test draws the uniforms and normals with the very
``jax.random`` call and key that the JAX function makes and hands them to
the port's arithmetic. Then masks are exact and values within 1e-6. The
port's own draws are checked statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.losses import pseudo_labels as jpl
from odwscl_tpu.losses import supcon as jsup
from odwscl_tpu.losses import weak_loss as jwl
from odwscl_tpu.ops import dropblock as jdb
from odwscl_tpu.ops import losses as jops
from odwscl_tpu_torch.losses import pseudo_labels as tpl
from odwscl_tpu_torch.losses import supcon as tsup
from odwscl_tpu_torch.losses import weak_loss as twl
from odwscl_tpu_torch.models.vgg16 import VGGRoINeck
from odwscl_tpu_torch.ops import dropblock as tdb
from odwscl_tpu_torch.ops import losses as tops

ATOL = 1e-6
T = torch.from_numpy


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _scores(rng, b=2, p=24, c=6):
    cls = rng.randn(b, p, c).astype(np.float32) * 3
    det = rng.randn(b, p, c).astype(np.float32) * 3
    mask = rng.uniform(size=(b, p)) > 0.25
    mask[:, 0] = True
    labels = np.zeros((b, c), np.float32)
    labels[0, [1, 3]] = 1
    labels[1, 2] = 1
    return cls, det, mask, labels


def test_elementwise_losses_match_jax():
    rng = np.random.RandomState(0)
    pred, target = rng.randn(2, 50, 4).astype(np.float32) * 2, \
        rng.randn(2, 50, 4).astype(np.float32)
    np.testing.assert_allclose(_np(tops.smooth_l1_loss(T(pred), T(target))),
                               jops.smooth_l1_loss(pred, target), atol=ATOL)
    probs = np.concatenate([rng.uniform(size=40), [0.0, 1.0]]).astype(
        np.float32)
    tg = (rng.uniform(size=42) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(tops.binary_cross_entropy(T(probs), T(tg))),
        jops.binary_cross_entropy(probs, tg), atol=ATOL)
    logits = rng.randn(3, 20, 7).astype(np.float32) * 5
    lab = rng.randint(0, 7, (3, 20))
    np.testing.assert_allclose(
        _np(tops.cross_entropy_with_logits(T(logits), T(lab))),
        jops.cross_entropy_with_logits(logits, lab), atol=ATOL)


def test_weak_losses_match_jax():
    rng = np.random.RandomState(1)
    cls, det, mask, labels = _scores(rng)
    final = twl.wsddn_final_score(T(cls), T(det), T(mask))
    jfinal = jwl.wsddn_final_score(cls, det, mask)
    np.testing.assert_allclose(_np(final), jfinal, atol=ATOL)
    np.testing.assert_allclose(float(twl.mil_loss(final, T(labels))),
                               float(jwl.mil_loss(jfinal, labels)), atol=ATOL)

    ref = rng.randn(2, 24, 6).astype(np.float32) * 3
    pl_lab = rng.randint(0, 6, (2, 24))
    w = rng.uniform(size=(2, 24)).astype(np.float32)
    bbox = rng.randn(2, 24, 24).astype(np.float32)
    reg = rng.randn(2, 24, 4).astype(np.float32)
    np.testing.assert_allclose(
        float(twl.refinement_cls_loss(T(ref), T(pl_lab), T(w), T(mask))),
        float(jwl.refinement_cls_loss(ref, pl_lab, w, mask)), atol=ATOL)
    for agnostic in (False, True):
        bb = bbox[..., :8] if agnostic else bbox
        np.testing.assert_allclose(
            float(twl.refinement_reg_loss(T(bb), T(pl_lab), T(w), T(reg),
                                          T(mask), agnostic)),
            float(jwl.refinement_reg_loss(bb, pl_lab, w, reg, mask,
                                          agnostic)), atol=ATOL)
    # ties in the scores: the stable sort keeps class order
    sc = np.round(rng.uniform(size=(4, 6)) * 2).astype(np.float32)
    lb = (rng.uniform(size=(4, 6)) > 0.5).astype(np.float32)
    assert float(twl.avg_image_accuracy(T(lb), T(sc))) == pytest.approx(
        float(jwl.avg_image_accuracy(lb, sc)), abs=0)


@pytest.mark.parametrize("loss", ["supconv2", "supcon"])
def test_supcon_matches_jax(loss):
    rng = np.random.RandomState(2)
    e = 40
    z = rng.randn(e, 16).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    z[7] = z[3]                                   # a duplicated slot
    lab = rng.randint(0, 4, e)
    hard = rng.uniform(size=e).astype(np.float32)
    valid = rng.uniform(size=e) > 0.2
    zt = T(z).requires_grad_()
    if loss == "supconv2":
        got = tsup.supcon_v2_loss(zt, T(lab), T(hard), T(valid), 0.2)
        fn = lambda f: jsup.supcon_v2_loss(f, lab, hard, valid, 0.2)
    else:
        got = tsup.supcon_loss(zt, T(lab), T(valid), 0.2)
        fn = lambda f: jsup.supcon_loss(f, lab, valid, 0.2)
    want, jgrad = jax.value_and_grad(fn)(jnp.asarray(z))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)
    np.testing.assert_allclose(_np(zt.grad), np.asarray(jgrad), atol=1e-5)


@pytest.mark.parametrize("case", ["random", "ties", "empty_sets"])
def test_od_layer_matches_jax(case):
    """Integer pseudo-labels exact, weights and targets 1e-6; ``ties``
    quantizes the scores so that argmaxes, the within-class order and the
    cross-class row zeroing all see equal values; the rows zeroed for one
    class leak into the next as in the reference."""
    rng = np.random.RandomState({"random": 3, "ties": 4, "empty_sets": 5}[case])
    b, p, c1 = 2, 30, 5
    xy = rng.uniform(0, 60, (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (b, p, 2))],
                           -1).astype(np.float32)
    boxes[:, 5] = boxes[:, 4]                      # duplicate boxes: IoU ties
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, :6] = True
    scores = rng.uniform(size=(b, p, c1)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 3) / 3
    labels_fg = np.zeros((b, c1), bool)
    labels_fg[0, [0, 2, 3]] = True
    labels_fg[1, [1, 4]] = True
    pgt = rng.uniform(size=(b, c1, p)) > (0.7 if case != "empty_sets" else 1)
    want = jpl.od_layer(boxes, mask, scores, labels_fg, pgt, 0.5, 16)
    got = tpl.od_layer(T(boxes), T(mask), T(scores), T(labels_fg), T(pgt),
                       0.5, 16)
    np.testing.assert_array_equal(_np(got.labels), np.asarray(want.labels))
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_allclose(_np(got.weights), want.weights, atol=ATOL)
    np.testing.assert_allclose(_np(got.reg_targets), want.reg_targets,
                               atol=1e-5)
    assert (np.asarray(want.labels) > 0).sum() > 5


def test_sequential_scan_leaks_rows_across_classes():
    """One proposal tops two classes: the first class zeroes its row, so
    the second class falls back to its next-best proposal."""
    scores = np.zeros((1, 4, 2), np.float32)
    scores[0, 1] = [0.9, 0.8]
    scores[0, 2, 1] = 0.5
    mask = np.ones((1, 4), bool)
    lab = np.ones((1, 2), bool)
    gm, gs = tpl._sequential_gt_scan(T(scores), T(mask), T(lab), None)
    jgm, jgs = jpl._sequential_gt_scan(scores, mask, lab, None)
    np.testing.assert_array_equal(_np(gm), np.asarray(jgm))
    np.testing.assert_array_equal(_np(gs), np.asarray(jgs))
    assert bool(gm[0, 1, 2]) and not bool(gm[0, 1, 1])


@pytest.mark.parametrize("block,valid", [(3, True), (1, True), (2, False)])
def test_dropblock_matches_jax_with_same_draws(block, valid):
    rng = np.random.RandomState(6)
    x = rng.randn(12, 7, 7, 8).astype(np.float32)
    v = rng.uniform(size=12) > 0.3 if valid else None
    key = jax.random.PRNGKey(7)
    want = jdb.dropblock_2d(key, jnp.asarray(x), 0.3, block,
                            valid=None if v is None else jnp.asarray(v))
    uniform = np.array(jax.random.uniform(key, (12, 7, 7)))
    got = tdb.dropblock_2d(T(x), 0.3, block, None if v is None else T(v),
                           uniform=T(uniform))
    np.testing.assert_array_equal(_np(got) == 0, np.asarray(want) == 0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_noise_augment_matches_jax_with_same_draws():
    x = np.random.RandomState(8).randn(5, 7, 7, 8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jdb.noise_augment(key, jnp.asarray(x))
    normal = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = tdb.noise_augment(T(x), normal=T(normal))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_port_draws_statistics():
    """The port's own draws: DropBlock drops about gamma * block^2 of the
    cells (blocks overlap a little, so a little less; 0.3 drop prob ->
    0.3 x (1 - overlap)), rescales over the valid rows to keep the mean;
    the neck's keep masks keep 1 - p of the units, and the same rows give
    the same masks to the clean pass and the recompute."""
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 7, 7, 2)
    valid = torch.rand(4000, generator=gen) > 0.25
    out = tdb.dropblock_2d(x, 0.3, 3, valid, generator=gen)
    dropped = (out[..., 0] == 0).float()
    rate = dropped[valid].mean().item()
    assert 0.20 < rate < 0.30, rate
    assert out[valid].mean().item() == pytest.approx(1.0, abs=1e-4)
    out1 = tdb.dropblock_2d(x, 0.3, 1, valid, generator=gen)
    assert (out1[..., 0] == 0).float()[valid].mean().item() == \
        pytest.approx(0.3, abs=0.01)

    neck = VGGRoINeck(in_dim=8, hidden_dim=512, compute_dtype=torch.float32,
                      dropout_rate=0.5)
    keep = neck.draw_keep(300, gen, "cpu")
    assert keep[0].float().mean().item() == pytest.approx(0.5, abs=0.01)
    feats = torch.randn(300, 8, generator=gen)
    full = neck(feats, keep)
    rows = torch.tensor([5, 17, 17, 299])
    again = neck(feats[rows], tuple(k[rows] for k in keep))
    # the same units dropped; values equal up to GEMM blocking ulps
    assert not again[~keep[1][rows]].any() and not full[~keep[1]].any()
    np.testing.assert_allclose(_np(again), _np(full[rows]), atol=ATOL)
    assert neck.draw_keep(3, gen, "cpu") is not None
    assert VGGRoINeck(8, 16, torch.float32, 0.0).draw_keep(3, gen,
                                                           "cpu") is None
