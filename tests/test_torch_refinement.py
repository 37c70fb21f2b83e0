"""The port's non-contrastive refinement and its other predictors against
the JAX package, on the CPU, in f32.

- ``oicr_layer`` and ``mist_layer`` (odwscl_tpu_torch/losses/
  pseudo_labels.py) on the same numpy inputs: random scores; forced ties
  (scores on a 4-level grid and duplicated boxes, where the first argmax
  and MIST's lower-index-first top-k decide); a ``gt_cap`` overflow; masked
  padding holding the highest scores. Labels, weights and the overflow
  equal; regression targets within 1e-6.
- The WSDDN and OICR heads through the weight bridge, train mode (logits)
  and eval mode (softmaxes): within 1e-6.
- ``train_forward`` and its gradients against JAX's ``value_and_grad``
  (harness and tolerances: tests/torch_variant_parity.py): WSDDN alone,
  OICR with ``contra`` False (``oicr_layer``), MIST with ``oicr_p`` 0.15
  and ``contra`` False (``mist_layer``), OICR with ``contra`` True and
  ``regress_on`` False (mining, no regression).
- ``eval_forward`` of WSDDN (``cls * det`` whatever the heuristic) and of
  OICR without regression (the CLS-AVG branch), test_torch_detector.py's
  bounds. OICR with ``regress_on`` True under AVG: the JAX package
  crashes (``jnp.stack(None)``), the port raises a ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.losses.pseudo_labels as jpl
import odwscl_tpu.models.predictors as jpred
from odwscl_tpu.models import WSODDetector as JWSODDetector
from odwscl_tpu_torch.losses import mist_layer, oicr_layer
from odwscl_tpu_torch.models import predictors as tpred
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

import torch_variant_parity as tvp

torch.set_num_threads(2)

REG_ATOL = 1e-6
HEAD_ATOL = 1e-6
SCORE_ATOL = 5e-5
BOX_ATOL = 1e-4


def _layer_inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    b, p, c1 = 2, 48, 5
    x1y1 = rng.uniform(0, 200, (b, p, 2))
    wh = rng.uniform(10, 150, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    scores = rng.dirichlet(np.ones(c1 + 1), (b, p))[..., 1:].astype(
        np.float32)
    mask = rng.uniform(size=(b, p)) > 0.15
    labels_fg = np.zeros((b, c1), bool)
    labels_fg[0, [0, 3]] = labels_fg[1, [1, 2, 4]] = True
    if case == "ties":
        scores = (rng.randint(0, 4, (b, p, c1)) / 4.0).astype(np.float32)
        boxes[:, 1::3] = boxes[:, 0:-1:3]           # duplicated boxes
    elif case == "masked":
        mask[:, p // 2:] = False
        scores[:, p // 2:] += 1.0                   # padding scores highest
    elif case == "overflow":
        labels_fg[:] = True
    return boxes, mask, scores, labels_fg


@pytest.mark.parametrize("case", ["random", "ties", "overflow", "masked"])
@pytest.mark.parametrize("layer", ["oicr", "mist"])
def test_pseudo_label_layer_matches_jax(layer, case):
    boxes, mask, scores, labels_fg = _layer_inputs(case)
    kw = {}
    if layer == "mist":
        kw = dict(portion=0.3 if case == "overflow" else 0.15)
        if case == "overflow":
            kw["gt_cap"] = 8
        jfn, tfn = jpl.mist_layer, mist_layer
    else:
        if case == "overflow":
            kw["gt_cap"] = 3
        jfn, tfn = jpl.oicr_layer, oicr_layer
    want = jfn(*(jnp.asarray(a) for a in (boxes, mask, scores, labels_fg)),
               **kw)
    got = tfn(*(torch.from_numpy(a) for a in (boxes, mask, scores,
                                               labels_fg)), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_allclose(got.reg_targets.numpy(),
                               np.asarray(want.reg_targets), rtol=0,
                               atol=REG_ATOL)
    assert (got.labels > 0).any()
    if case == "overflow":
        assert int(want.overflow) > 0
    if case == "masked":
        assert not (got.labels.numpy()[~mask]).any()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ["WSDDNPredictor", "OICRPredictor"])
def test_predictor_heads_match_jax(name, train):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 32).astype(np.float32)
    mask = rng.uniform(size=(2, 12)) > 0.3
    jm = jpred.PREDICTORS[name](num_classes=6, compute_dtype=jnp.float32)
    params = jax.jit(lambda r: jm.init(r, x, mask, train=True))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(lambda a: np.array(a) * 100.0, params)
    want = jm.apply({"params": params}, x, mask, train=train)
    kw = {} if name == "WSDDNPredictor" else {"num_refs": 3}
    tm = tpred.PREDICTORS[name](32, 6, compute_dtype=torch.float32, **kw)
    tm.load_state_dict({k[len("pred."):]: v for k, v in state_dict_from_jax(
        {"pred": params}).items()})
    got = tm(torch.from_numpy(x), torch.from_numpy(mask), train=train)
    assert (got[2] is None) == (want[2] is None) and got[3] is None
    pairs = [(got[0], want[0]), (got[1], want[1])]
    if want[2] is not None:
        assert len(got[2]) == len(want[2]) == 3
        pairs += list(zip(got[2], want[2]))
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=HEAD_ATOL)
    if not train:
        assert np.asarray(want[1]).max() > 2.0 / 12  # the det softmax spreads


PATHS = {
    "wsddn": dict(predictor="WSDDNPredictor", contra=False,
                  regress_on=False),
    "oicr": dict(predictor="OICRPredictor", contra=False, regress_on=False),
    "mist_p0.15": dict(contra=False, oicr_p=0.15),
    "oicr_contra": dict(predictor="OICRPredictor", regress_on=False),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_train_forward_matches_jax(path):
    losses, metrics, _ = tvp.assert_train_matches(PATHS[path])
    if path == "wsddn":
        assert list(losses) == ["loss_img"]
    else:
        assert float(metrics["n_pos0"]) > 0
        assert ("loss_sim" in losses) == (path == "oicr_contra")
        assert ("loss_ref_reg0" in losses) == (path == "mist_p0.15")


@pytest.mark.parametrize("name,heur", [("WSDDNPredictor", "AVG"),
                                       ("OICRPredictor", "AVG")])
def test_eval_forward_matches_jax(name, heur):
    kw = dict(predictor=name, regress_heur=heur, regress_on=False)
    arrays = tvp.inputs()
    params = tvp.init_params(kw, arrays)
    jm = JWSODDetector(**tvp.KW, **kw)
    want_s, want_b = jax.jit(lambda p, bt: jm.apply(
        {"params": p}, bt, train=False))(params, tvp.jax_batch(arrays))
    model = tvp.port_model(params, kw)
    got_s, got_b = model.eval_forward(tvp.port_batch(arrays))
    want_s, want_b = np.asarray(want_s), np.asarray(want_b)
    assert got_s.shape == want_s.shape and got_b.shape == want_b.shape
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=BOX_ATOL)


def test_oicr_with_regression_raises():
    """REGRESS_ON True under AVG needs box deltas, which OICR has not."""
    kw = dict(predictor="OICRPredictor", regress_heur="AVG", regress_on=True)
    arrays = tvp.inputs()
    params = tvp.init_params(kw, arrays)
    jm = JWSODDetector(**tvp.KW, **kw)
    with pytest.raises(TypeError):            # the JAX package's fault
        jm.apply({"params": params}, tvp.jax_batch(arrays), train=False)
    model = tvp.port_model(params, kw)
    with pytest.raises(ValueError, match="REGRESS_ON"):
        model.eval_forward(tvp.port_batch(arrays))
