"""The port's FPN, RetinaNet pieces, focal loss and ``masked_iou`` against
the JAX package's, on the CPU (odwscl_tpu_torch/models/fpn.py,
models/retinanet.py, ops/losses.py, structures/boxes.py).

The same numpy inputs from a seed, f32 on both sides; flax parameters go
to the port through utils/from_jax.py. Tolerances:
- anchors: equal (the same float32 arithmetic);
- FPN outputs (both top blocks, P3-P7's skipped lateral) and the head's
  outputs: within 1e-5 of each output's largest magnitude (the
  convolutions sum in another order);
- ``assign_levels``, the anchor labels and matches: equal (decisions);
- the focal loss 1e-5 relative elementwise (1e-7 absolute at least);
  ``masked_iou`` 1e-6; the RetinaNet reg targets 1e-5; the loss 1e-5
  relative;
- ``retinanet_decode``: the valid masks equal; on the valid entries
  scores 1e-6, labels equal, boxes 1e-3 px. Its top-K breaks ties towards
  the lower flat index as ``lax.top_k`` does: a case with every score
  tied (all below the threshold) and one with tied valid scores check
  the order itself.
- ``multilevel_roi_pool``: the four-call masked design against the JAX
  function with the same stand-in pooler (equal), and with the real
  poolers within 32 cells (equal: both take every roi's exact maximum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models import fpn as jfpn
from odwscl_tpu.models import retinanet as jret
from odwscl_tpu.ops import losses as jlosses
from odwscl_tpu.ops.roi_pool import roi_pool as jroi_pool
from odwscl_tpu.structures import boxes as jboxes
from odwscl_tpu_torch.models import fpn as tfpn
from odwscl_tpu_torch.models import retinanet as tret
from odwscl_tpu_torch.ops import losses as tlosses
from odwscl_tpu_torch.ops.roi_pool import RoIPoolFunction
from odwscl_tpu_torch.structures import boxes as tboxes
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(2)

REL = 1e-5


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-30)


def _params(module, *args, seed=0):
    p = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)


def _load(module, params):
    """A flax sub-tree into a port module, through the bridge."""
    sd = state_dict_from_jax({"backbone": params})
    module.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return module


@pytest.mark.parametrize("stride,size,ratios,octave,spo", [
    (8, 32, (0.5, 1.0, 2.0), 2.0, 3), (16, 64, (1.0,), 2.0, 1),
    (128, 512, (0.5, 1.0, 2.0), 2.0, 3), (32, 100, (0.25, 4.0), 1.5, 2)])
def test_cell_anchors_match(stride, size, ratios, octave, spo):
    np.testing.assert_array_equal(
        tret.cell_anchors(stride, size, ratios, octave, spo),
        jret.cell_anchors(stride, size, ratios, octave, spo))


def test_grid_and_pyramid_anchors_match():
    grids = [(12, 17), (6, 9), (3, 5), (2, 3), (1, 2)]
    got = tret.pyramid_anchors(grids)
    want = jret.pyramid_anchors(grids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cell = jret.cell_anchors(16, 64, (1.0,), 2.0, 1)
    np.testing.assert_array_equal(
        tret.grid_anchors(cell, 16, 2, 3).numpy(),
        np.asarray(jret.grid_anchors(cell, 16, 2, 3)))


def _feats(rng, chans, h=32, w=40):
    return tuple(rng.randn(2, -(-h // s), -(-w // s), c).astype(np.float32)
                 for s, c in zip((1, 2, 4, 8), chans))


@pytest.mark.parametrize("chans,top,on_c5", [
    ((32, 64, 128, 256), "maxpool", True),
    ((0, 64, 128, 256), "p6p7", True),
    ((0, 64, 128, 256), "p6p7", False),
    ((32, 64, 128, 256), None, True)])
def test_fpn_matches_flax(chans, top, on_c5):
    rng = np.random.RandomState(1)
    feats = _feats(rng, [c or 16 for c in chans], h=30, w=41)
    jm = jfpn.FPN(chans, 16, top_block=top, p6p7_on_c5=on_c5,
                  compute_dtype=jnp.float32)
    params = _params(jm, tuple(jnp.asarray(f) for f in feats))
    for k in params:     # non-zero biases
        params[k]["bias"] = rng.randn(*params[k]["bias"].shape).astype(
            np.float32)
    want = jax.jit(jm.apply)({"params": params},
                             tuple(jnp.asarray(f) for f in feats))
    tm = _load(tfpn.FPN(chans, 16, top, on_c5, torch.float32), params)
    got = tm(tuple(torch.from_numpy(f) for f in feats))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g.detach().numpy(), w) <= REL


@pytest.mark.parametrize("kind", ["fpn", "p3p7"])
def test_resnet_fpn_bodies_match_flax(kind):
    x = (np.random.RandomState(2).randn(1, 64, 96, 3) * 50).astype(
        np.float32)
    if kind == "fpn":
        jm = jfpn.ResNetFPNBackbone("R-18", compute_dtype=jnp.float32)
        tm = tfpn.ResNetFPNBackbone("R-18", 256, torch.float32)
    else:
        jm = jfpn.ResNetFPNP3P7Backbone("R-18", compute_dtype=jnp.float32)
        tm = tfpn.ResNetFPNP3P7Backbone("R-18", 256, True, torch.float32)
    params = _params(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    got = _load(tm, params)(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel_err(g.detach().numpy(), w) <= REL
    # the stride-32 C5: strides double level to level
    hs = [g.shape[1] for g in got]
    assert all(hs[i] == -(-hs[i - 1] // 2) for i in range(1, len(hs)))


def test_c5_stride_one_unchanged():
    """The C5 bodies keep their stride-16 C5; return_stages gives C2-C5."""
    from odwscl_tpu_torch.models.resnet import ResNetBackbone

    x = torch.from_numpy(np.random.RandomState(3).randn(1, 64, 64, 3)
                         .astype(np.float32))
    m = ResNetBackbone("R-18", 5, torch.float32)
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert m(x).shape == (1, 4, 4, 512)      # stride 16
    stages = ResNetBackbone("R-18", 5, torch.float32, c5_stride_one=False,
                            return_stages=True)
    stages.load_state_dict(m.state_dict())
    out = stages(x)
    assert [tuple(o.shape[1:3]) for o in out] == [(16, 16), (8, 8), (4, 4),
                                                  (2, 2)]
    m.return_stages = True
    np.testing.assert_array_equal(m(x)[2].detach().numpy(),
                                  out[2].detach().numpy())


def test_assign_levels_match():
    rng = np.random.RandomState(4)
    x1y1 = rng.uniform(0, 500, (400, 2))
    wh = np.exp(rng.uniform(np.log(1), np.log(900), (400, 2)))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    # boxes at the level boundaries (sqrt(area) = 224 * 2^k - 1)
    edge = np.float32([[0, 0, 111, 111], [0, 0, 110, 110], [0, 0, 223, 223],
                       [0, 0, 447, 447], [0, 0, 446, 446], [5, 5, 4, 4]])
    boxes = np.concatenate([boxes, edge])
    got = tfpn.assign_levels(torch.from_numpy(boxes), 2, 5).numpy()
    want = np.asarray(jfpn.assign_levels(jnp.asarray(boxes), 2, 5))
    np.testing.assert_array_equal(got, want)
    assert set(got) == {2, 3, 4, 5}


def test_multilevel_roi_pool_routes_like_jax():
    """A stand-in pooler returning its level's constant: routing equal."""
    feats = [np.full((1, 8, 8, 4), float(i), np.float32) for i in range(4)]
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    boxes = np.float32([[[0, 0, 20, 20], [0, 0, 230, 230], [0, 0, 900, 900],
                         [0, 0, 150, 150], [3, 3, 60, 60]]])
    mask = np.array([[True, True, True, True, False]])

    def jpool(feat, b, m, s):
        v = jnp.broadcast_to(feat[0, 0, 0, 0], (1, 5, 7, 7, 4))
        return jnp.where(m[..., None, None, None], v, 0.0)

    def tpool(feat, b, m, s, level):
        assert level in ("P2", "P3", "P4", "P5")
        v = feat[0, 0, 0, 0].expand(1, 5, 7, 7, 4)
        return torch.where(m[..., None, None, None], v, 0.0)

    want = jfpn.multilevel_roi_pool(jpool, [jnp.asarray(f) for f in feats],
                                    scales, jnp.asarray(boxes),
                                    jnp.asarray(mask))
    got = tfpn.multilevel_roi_pool(tpool, [torch.from_numpy(f) for f in feats],
                                   scales, torch.from_numpy(boxes),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, :, 0, 0, 0].numpy(),
                                  [0.0, 2.0, 3.0, 1.0, 0.0])


def test_multilevel_roi_pool_with_the_poolers():
    """Real poolers: the port's plain ROIPool at each level (what the
    kernel is held to on the card) against the JAX CPU pooler, rois no
    wider than 32 cells at their level; masked rois 0, gradient equal."""
    rng = np.random.RandomState(5)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
    feats = [rng.randn(2, int(128 * s), int(160 * s), 8).astype(np.float32)
             for s in scales]
    x1y1 = rng.uniform(0, 100, (2, 40, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(120), (2, 40, 2)))
    boxes = np.concatenate([x1y1, np.minimum(x1y1 + wh, [159, 127])],
                           -1).astype(np.float32)
    mask = rng.uniform(size=(2, 40)) > 0.2
    g = rng.randn(2, 40, 7, 7, 8).astype(np.float32)

    def jfn(fs):
        return jfpn.multilevel_roi_pool(
            lambda f, b, m, s: jroi_pool(f, b, m, s, 7, 32), fs, scales,
            jnp.asarray(boxes), jnp.asarray(mask))

    want, vjp = jax.vjp(jfn, [jnp.asarray(f) for f in feats])
    (want_g,) = vjp(jnp.asarray(g))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    got = tfpn.multilevel_roi_pool(
        lambda f, b, m, s, lv: RoIPoolFunction.apply(f, b, m, s, lv), tf,
        scales, torch.from_numpy(boxes), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert not got[torch.from_numpy(~mask)].any()
    got.backward(torch.from_numpy(g))
    for t, w in zip(tf, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6)


def test_focal_loss_matches():
    rng = np.random.RandomState(6)
    logits = (rng.randn(300, 9) * 4).astype(np.float32)
    targets = rng.randint(-1, 10, 300).astype(np.int32)
    want = np.asarray(jlosses.sigmoid_focal_loss(jnp.asarray(logits),
                                                 jnp.asarray(targets)))
    got = tlosses.sigmoid_focal_loss(torch.from_numpy(logits),
                                     torch.from_numpy(targets).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert not got[targets < 0].any()       # ignored anchors cost nothing


def test_masked_iou_matches():
    rng = np.random.RandomState(7)
    a = np.concatenate([rng.uniform(0, 50, (3, 6, 2)),
                        rng.uniform(50, 99, (3, 6, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 50, (3, 9, 2)),
                        rng.uniform(50, 99, (3, 9, 2))], -1).astype(np.float32)
    ma, mb = rng.uniform(size=(3, 6)) > 0.3, rng.uniform(size=(3, 9)) > 0.3
    want = np.asarray(jboxes.masked_iou(jnp.asarray(a), jnp.asarray(ma),
                                        jnp.asarray(b), jnp.asarray(mb)))
    got = tboxes.masked_iou(*(torch.from_numpy(v) for v in (a, ma, b, mb)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_head_matches_flax():
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, h, w, 32).astype(np.float32)
             for h, w in ((8, 10), (4, 5), (2, 3))]
    jm = jret.RetinaNetHead(num_classes=7, num_anchors=9, num_convs=2,
                            compute_dtype=jnp.float32)
    params = _params(jm, [jnp.asarray(f) for f in feats])
    jl, jb = jax.jit(jm.apply)({"params": params},
                               [jnp.asarray(f) for f in feats])
    tm = _load(tret.RetinaNetHead(7, 32, 9, 2, compute_dtype=torch.float32),
               params)
    tl, tb = tm([torch.from_numpy(f) for f in feats])
    fl, fb = tret.flatten_head_outputs(tl, tb, 6)
    wl, wb = jret.flatten_head_outputs(jl, jb, 6)
    assert fl.shape == wl.shape == (2, (80 + 20 + 6) * 9, 6)
    assert _rel_err(fl.detach().numpy(), wl) <= REL
    assert _rel_err(fb.detach().numpy(), wb) <= REL
    g = torch.Generator().manual_seed(0)
    tm.reset_parameters(g)
    np.testing.assert_allclose(tm.cls_logits.bias.detach().numpy(),
                               params["cls_logits"]["bias"], rtol=1e-6)


def _gt(rng, b=2, g=5):
    x1y1 = rng.uniform(0, 60, (b, g, 2))
    wh = rng.uniform(10, 70, (b, g, 2))
    gt = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    labels = rng.randint(1, 7, (b, g)).astype(np.int32)
    mask = np.ones((b, g), bool)
    mask[1, 3:] = False
    return gt, labels, mask


def test_targets_and_loss_match():
    rng = np.random.RandomState(9)
    anchors = np.concatenate(
        [np.asarray(a) for a in jret.pyramid_anchors([(8, 12), (4, 6),
                                                      (2, 3)],
                                                     strides=(8, 16, 32),
                                                     sizes=(32, 64, 128))])
    gt, labels, gmask = _gt(rng)
    jl, jr = jax.vmap(lambda gb, gl, gm: jret.retinanet_targets(
        jnp.asarray(anchors), gb, gl, gm))(jnp.asarray(gt),
                                           jnp.asarray(labels),
                                           jnp.asarray(gmask))
    tl, tr = tret.retinanet_targets(torch.from_numpy(anchors),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(labels).long(),
                                    torch.from_numpy(gmask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert set(np.unique(tl.numpy())) >= {-1, 0} and (tl.numpy() > 0).any()
    pos = tl.numpy() > 0
    np.testing.assert_allclose(tr.numpy()[pos], np.asarray(jr)[pos],
                               rtol=1e-5, atol=1e-5)
    logits = (rng.randn(2, len(anchors), 6) * 3).astype(np.float32)
    deltas = rng.randn(2, len(anchors), 4).astype(np.float32)
    want = jret.retinanet_loss(jnp.asarray(logits), jnp.asarray(deltas), jl,
                               jr)
    got = tret.retinanet_loss(torch.from_numpy(logits),
                              torch.from_numpy(deltas), tl, tr)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("case", ["random", "all_tied", "tied_valid"])
def test_decode_matches(case):
    rng = np.random.RandomState(10)
    p, cf = 60, 5
    anchors = np.concatenate([rng.uniform(0, 200, (p, 2)),
                              rng.uniform(210, 400, (p, 2))],
                             -1).astype(np.float32)
    logits = (rng.randn(2, p, cf) * 2 - 3).astype(np.float32)
    if case == "all_tied":
        logits[:] = -8.0            # every score below the threshold
    elif case == "tied_valid":
        logits[:, ::3, 1] = 1.5     # 20 equal valid scores an image
    deltas = (rng.randn(2, p, 4) * 0.5).astype(np.float32)
    sizes = np.float32([[420, 380], [300, 410]])     # (w, h)
    want = jret.retinanet_decode(jnp.asarray(anchors), jnp.asarray(logits),
                                 jnp.asarray(deltas), jnp.asarray(sizes),
                                 0.05, 40)
    got = tret.retinanet_decode(torch.from_numpy(anchors),
                                torch.from_numpy(logits),
                                torch.from_numpy(deltas),
                                torch.from_numpy(sizes), 0.05, 40)
    wb, ws, wl, wv = (np.asarray(w) for w in want)
    gb, gs, gl, gv = (g.numpy() for g in got)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gs[gv], ws[wv], atol=1e-6)
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gb[gv], wb[wv], atol=1e-3)
    if case != "random":
        # the order itself: ties go to the lower flat index
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gb, wb, atol=1e-3)
    if case == "all_tied":
        assert not gv.any()
    else:
        assert gv.any()


def test_topk_lower_index():
    v = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.25, 0.0, 1.0]])
    vals, idx = tret.topk_lower_index(v, 5)
    assert idx.tolist() == [[6, 1, 3, 4, 0]]
    assert vals.tolist() == [[1.0, 0.5, 0.5, 0.25, 0.0]]
