"""The port's eval forward (odwscl_tpu_torch/models) against the JAX
``WSODDetector.apply(train=False)``, with the same parameters carried over
by the weight bridge (odwscl_tpu_torch/utils/from_jax.py), on the CPU.

Widths are the real VGG16 widths (fixed by VGG_CFGS) with mlp_dim 64, and
f32 compute on both sides. Rois stay within 32 feature cells, where the
JAX CPU pooler is exact.

The score heads' weights are scaled up (x2000) so that the softmaxes
spread over (0, 1) and the comparison is not one of near-uniform scores.

Tolerance: scores 5e-5 absolute (probabilities), boxes 1e-4 px. Both
sides run the same f32 algorithm, but XLA's and torch's CPU kernels sum
the convolutions and GEMMs in another order: a few ulps per layer, ~1e-7
relative at the logits. On logits of tens that is ~1e-5 on a probability
(observed 1.2e-5, on the WSDDN product cls * det) and ~1e-5 px on the
decoded boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models import WSODDetector as JWSODDetector
from odwscl_tpu_torch.models import Batch, WSODDetector
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             save_npz, state_dict_from_jax)

torch.set_num_threads(1)

SCORE_ATOL = 5e-5
BOX_ATOL = 1e-4
HEAD_SCALE = 2000.0


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, h, w, p = 2, 64, 96, 16
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    sizes = np.array([[64, 96], [56, 80]], np.float32)
    x1y1 = rng.uniform(0, 40, (b, p, 2))
    wh = rng.uniform(8, 50, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, 0] = True
    return images, sizes, boxes, mask


def _jax_params(s2d_stem):
    images, sizes, boxes, mask = _inputs()
    model = JWSODDetector(compute_dtype="float32", mlp_dim=64,
                          s2d_stem=s2d_stem)
    batch = JBatch(jnp.asarray(images), jnp.asarray(sizes),
                   jnp.asarray(boxes), jnp.asarray(mask),
                   jnp.zeros((2, 21), jnp.float32))
    v = jax.jit(lambda r, bb: model.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= HEAD_SCALE
    return params, batch


@pytest.fixture(scope="module")
def jax_setup():
    return {s2d: _jax_params(s2d) for s2d in (False, True)}


@pytest.mark.parametrize("s2d_stem,heur", [
    (False, "AVG"), (True, "AVG"), (False, "UNION"), (False, "WSDDN"),
    (False, "CLS-AVG")])
def test_eval_forward_matches_jax(jax_setup, s2d_stem, heur):
    params, batch = jax_setup[s2d_stem]
    jmodel = JWSODDetector(compute_dtype="float32", mlp_dim=64,
                           s2d_stem=s2d_stem, regress_heur=heur)
    want_s, want_b = jax.jit(lambda v, bt: jmodel.apply(v, bt, train=False))(
        {"params": params}, batch)

    model = WSODDetector(mlp_dim=64, compute_dtype="float32",
                         regress_heur=heur)
    model.load_state_dict(state_dict_from_jax(params))
    images, sizes, boxes, mask = _inputs()
    got_s, got_b = model.eval_forward(Batch(
        torch.from_numpy(images), torch.from_numpy(sizes),
        torch.from_numpy(boxes), torch.from_numpy(mask)))

    want_s, want_b = np.asarray(want_s), np.asarray(want_b)
    assert got_s.shape == want_s.shape and got_b.shape == want_b.shape
    assert want_s.max() > 0.5          # the scores are spread, not uniform
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=BOX_ATOL)


def test_bridge_round_trip_and_npz(jax_setup, tmp_path):
    params, _ = jax_setup[False]
    sd = state_dict_from_jax({"params": params})
    model = WSODDetector(mlp_dim=64, compute_dtype="float32")
    model.load_state_dict(sd)          # strict: covers the whole tree
    assert sd["backbone.conv0.weight"].shape == (64, 3, 3, 3)
    assert sd["neck.fc6.weight"].shape == (64, 7 * 7 * 512)
    back = jax_params_from_state_dict(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)

    path = tmp_path / "params.npz"
    save_npz(str(path), {"params": params})
    sd_npz = state_dict_from_jax(str(path))
    assert sd_npz.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd_npz[k], sd[k])


def test_bridge_rejects_unknown_leaves(jax_setup):
    params, _ = jax_setup[False]
    with pytest.raises(KeyError):
        state_dict_from_jax({**params, "cdb": {"conv": {"kernel":
                                                        np.zeros((1, 1))}}})
