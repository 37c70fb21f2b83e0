"""The port's partial-label modules against the JAX package's, on the CPU.

On the same numpy inputs (seeded; boxes, clicks and scribbles on a coarse
grid so that ties and borders occur; padded slots masked; an image
without any valid click or scribble):
- ``match_proposals`` with and without low-quality matches, and with no
  GT at all: equal indices and sentinels;
- ``balanced_sample`` and ``subsample_proposals`` with the JAX draws'
  uniforms handed to the port: equal masks, indices and boxes;
- ``match_labels_point`` / ``match_labels_scribble`` and
  ``filter_pseudo_labels_point`` / ``_scribble``: equal labels;
- ``box_iou_async``: within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.losses import partial_labels as jpl
from odwscl_tpu.models import matcher as jmatcher
from odwscl_tpu.models import roi_sampler as jsampler
from odwscl_tpu.structures.boxes import box_iou_async as jiou_async
from odwscl_tpu_torch.losses import partial_labels as tpl
from odwscl_tpu_torch.models import matcher as tmatcher
from odwscl_tpu_torch.models import roi_sampler as tsampler
from odwscl_tpu_torch.structures.boxes import box_iou_async

import torch_variant_parity as tvp

IOU_ATOL = 1e-6


def _inputs(seed, b=3, p=60, k=7, c=81):
    rng = np.random.RandomState(seed)
    x1y1 = rng.randint(0, 40, (b, p, 2)) * 2.0
    wh = rng.randint(1, 30, (b, p, 2)) * 2.0
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    boxes[:, 5] = boxes[:, 4]                    # duplicated proposals
    mask = rng.rand(b, p) > 0.2
    clicks = (rng.randint(0, 50, (b, k, 2)) * 2.0).astype(np.float32)
    clicks[:, 0] = boxes[:, 0, :2]               # on a border: not inside
    click_labels = rng.randint(1, c, (b, k)).astype(np.int64)
    click_labels[:, 2] = click_labels[:, 1]
    click_mask = rng.rand(b, k) > 0.3
    click_mask[-1] = False                       # no click at all
    s1 = rng.randint(0, 40, (b, k, 2)) * 2.0
    scribbles = np.concatenate([s1, s1 + rng.randint(0, 25, (b, k, 2)) * 2.0],
                               -1).astype(np.float32)
    scribbles[:, 1] = [1, 2, 3, 4]               # the empty-scribble box
    scribble_labels = rng.randint(1, c, (b, k)).astype(np.int64)
    scribble_mask = rng.rand(b, k) > 0.3
    scribble_mask[-1] = False
    pseudo = rng.randint(0, c, (b, p)).astype(np.int64)
    return dict(boxes=boxes, mask=mask, clicks=clicks,
                click_labels=click_labels, click_mask=click_mask,
                scribbles=scribbles, scribble_labels=scribble_labels,
                scribble_mask=scribble_mask, pseudo=pseudo)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("seed", range(3))
def test_box_iou_async_matches_jax(seed):
    d = _inputs(seed)
    got = box_iou_async(_t(d["scribbles"]), _t(d["boxes"]))
    want = jax.vmap(jiou_async)(_j(d["scribbles"]), _j(d["boxes"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=IOU_ATOL)


@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_match_proposals_matches_jax(seed, low_quality):
    d = _inputs(seed)
    q = np.asarray(jax.vmap(jiou_async)(_j(d["scribbles"]), _j(d["boxes"])))
    q = np.round(q * 8) / 8                       # ties between GTs
    for i in range(q.shape[0]):
        want = jmatcher.match_proposals(_j(q[i]), _j(d["scribble_mask"][i]),
                                        0.5, 0.25, low_quality)
        got = tmatcher.match_proposals(_t(q[i]), _t(d["scribble_mask"][i]),
                                       0.5, 0.25, low_quality)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tmatcher.match_proposals(_t(q), _t(d["scribble_mask"]), 0.5, 0.25,
                                   low_quality)
    assert (got[-1] == tmatcher.BELOW_LOW_QUALITY).all()   # no GT
    assert {-2, -1}.issubset(set(got.unique().tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_balanced_sample_matches_jax(seed):
    rng = np.random.RandomState(seed)
    p = 80
    labels = rng.choice([-1, 0, 0, 0, 3, 7], p).astype(np.int64)
    valid = rng.rand(p) > 0.1
    key = jax.random.PRNGKey(seed)
    want = jmatcher.balanced_sample(key, _j(labels), _j(valid), 16, 0.25)
    uniform = np.stack([np.array(jax.random.uniform(r, (p,)))
                        for r in jax.random.split(key)])
    got = tmatcher.balanced_sample(_t(labels), _t(valid), 16, 0.25,
                                   uniform=_t(uniform))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() == 4 and got[1].sum() == 12


@pytest.mark.parametrize("mode", ["point", "scribble"])
@pytest.mark.parametrize("size", [16, 512])
@pytest.mark.parametrize("seed", range(3))
def test_labels_and_subsample_match_jax(seed, size, mode):
    d = _inputs(seed)
    if mode == "point":
        args = (d["boxes"], d["clicks"], d["click_labels"], d["click_mask"])
        want = jsampler.match_labels_point(*map(_j, args))
        got = tsampler.match_labels_point(*map(_t, args))
    else:
        args = (d["boxes"], d["scribbles"], d["scribble_labels"],
                d["scribble_mask"])
        want = jsampler.match_labels_scribble(*map(_j, args), 0.5, 0.3)
        got = tsampler.match_labels_scribble(*map(_t, args), 0.5, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any() and (got == 0).any()
    if mode == "scribble":
        assert (got == -1).any()

    key = jax.random.PRNGKey(100 + seed)
    b, p = d["mask"].shape
    jout = jsampler.subsample_proposals(key, _j(d["boxes"]), _j(d["mask"]),
                                        want, size, 0.25)
    out = tsampler.subsample_proposals(
        _t(d["boxes"]), _t(d["mask"]), got, size, 0.25,
        uniform=_t(tvp.subsample_uniforms(key, b, p)))
    for g, w in zip(out, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert out[1].shape == (b, min(size, p))


@pytest.mark.parametrize("seed", range(4))
def test_pseudo_label_filters_match_jax(seed):
    d = _inputs(seed)
    # every other proposal's pseudo label is that of a click inside it
    clicked = np.asarray(jsampler.match_labels_point(
        *map(_j, (d["boxes"], d["clicks"], d["click_labels"],
                  d["click_mask"]))))
    d["pseudo"][:, ::2] = clicked[:, ::2]
    args = (d["pseudo"], d["boxes"], d["clicks"], d["click_labels"],
            d["click_mask"])
    want = jpl.filter_pseudo_labels_point(*map(_j, args))
    got = tpl.filter_pseudo_labels_point(*map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any()
    args = (d["pseudo"], d["boxes"], d["scribbles"], d["scribble_labels"],
            d["scribble_mask"])
    want = jpl.filter_pseudo_labels_scribble(*map(_j, args))
    got = tpl.filter_pseudo_labels_scribble(*map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
