"""The port's FBNet bodies against the JAX package's, on the CPU.

The arch expansion, ``_divisible`` and ``_parse_op`` must be equal; each
inverted-residual variant (kernel 3 and 5, expansion 1 and 6, the ``_s4``
grouped 1x1s with the channel shuffle, squeeze-excite, a negative stride
as a nearest upsample, ``skip`` with a stride, the residual), the
"default" trunk and a trunk from a JSON arch def run through both packages
on the same seeded input with the flax parameters (frozen-norm leaves
randomized) handed over by utils/from_jax.py; then a whole FBNet-default
``SupervisedRCNN`` (81 classes, stride-16 single-level pool): the eval
box pass and one train step with the JAX keys' sampler draws.

Tolerances: the block and trunk outputs within 1e-5 of their largest
magnitude (f32 reassociation; the depthwise and grouped convolutions sum
in other orders); the model's scores 1e-5, boxes 1e-3 px, losses 1e-5
relative, every trainable tensor's gradient within 1e-4 of its largest
magnitude (the input keeps every backbone ReLU's pre-activation 1e-6 of
its layer's largest from 0, as in tests/test_torch_supervised_models.py).
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.fbnet as jfb
import odwscl_tpu.models.roi_heads as jroi_heads
from odwscl_tpu.models import SupervisedRCNN as JRCNN
from odwscl_tpu_torch.models import SupervisedRCNN
from odwscl_tpu_torch.models import fbnet as tfb
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_supervised_models import (KEY, _batch, _check_grads, _draws,
                                          _jax_params, _randomize_bn,
                                          _relu_margin)

torch.set_num_threads(2)

OUT_REL = 1e-5
SCORE_ATOL = 1e-5
BOX_ATOL = 1e-3
LOSS_RTOL = 1e-5
# an input whose backbone ReLUs keep the 1e-6 margin (a seed search)
MODEL_SEED = 118

CUSTOM = {
    "block_op_type": [["ir_k3", "skip"], ["ir_k5_e3"], ["skip"]],
    "block_cfg": {"first": [8, 2],
                  "stages": [[[1, 8, 2, 1]], [[3, 16, 1, 2]],
                             [[1, 24, 1, 2]]],
                  "backbone": [0, 1, 2]},
}


def test_arch_expansion_matches():
    for raw in (jfb.MODEL_ARCH["default"], CUSTOM):
        want = jfb.unify_arch_def(raw)
        got = tfb.unify_arch_def(raw)
        assert got == want
        for stages in (None, [0], [1, 2]):
            assert tfb.get_blocks(got, stages) == jfb.get_blocks(want,
                                                                 stages)
        assert tfb.get_blocks(got, block_indices=[0]) == jfb.get_blocks(
            want, block_indices=[0])
    assert tfb.MODEL_ARCH == jfb.MODEL_ARCH
    bad = copy.deepcopy(CUSTOM)
    bad["block_op_type"][0].append("skip")
    with pytest.raises(ValueError, match="op types"):
        tfb.unify_arch_def(bad)


def test_divisible_and_round_match():
    for num in (0.0, 7.5, 8.0, 12.4999, 16.5, 31.0, 48.0, 95.9, 144.0):
        assert tfb._py2_round(num) == jfb._py2_round(num)
        assert tfb._py2_round(-num) == jfb._py2_round(-num)
        for div in (1, 4, 8, 16):
            for lo in (1, 8):
                assert tfb._divisible(num, div, lo) == jfb._divisible(
                    num, div, lo), (num, div, lo)


def test_parse_op_matches():
    for op in ("skip", "ir_k3", "ir_k5_e3", "ir_k3_s4", "ir_k5_e6_se",
               "ir_k7_e1_s4_se", "ir_k1_e6", "shuffle"):
        assert tfb._parse_op(op) == jfb._parse_op(op), op
    with pytest.raises(ValueError, match="unknown op"):
        tfb._parse_op("conv_k3")


def _flax(module, x, seed=0):
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x))[
            "params"])
    return _randomize_bn(params, np.random.RandomState(seed + 1))


def _load(module, params):
    """The flax tree through the bridge (under ``backbone``) into the port's
    module."""
    sd = state_dict_from_jax({"backbone": params})
    module.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return module


def _nhwc(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= OUT_REL * scale, (
        np.abs(got - want).max(), scale)


# (op, [t, c, n, s]) pairs, each a variant of the IRF block or skip
VARIANTS = {
    "k3_e6_residual": [("ir_k3", [6, 16, 1, 1])],
    "k5_e1_stride2": [("ir_k5_e1", [6, 24, 1, 2])],
    "s4_shuffle": [("ir_k3_s4", [4, 32, 1, 1])],
    "se": [("ir_k3_e3_se", [6, 16, 1, 1])],
    "negative_stride": [("ir_k3_e1", [1, 16, 1, -2])],
    "k1_no_depthwise": [("ir_k1_e6", [6, 16, 1, 1])],
    "skip_stride": [("skip", [1, 24, 1, 2]), ("skip", [1, 24, 1, 1])],
    "shuffle_op": [("shuffle", [2, 32, 1, 1])],
}


@pytest.mark.parametrize("skip_dw", [False, True])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_block_variant_matches(name, skip_dw):
    blocks = tuple((op, tuple(b)) for op, b in VARIANTS[name])
    x = np.random.RandomState(7).randn(2, 10, 12, 16).astype(np.float32)
    jm = jfb.FBNetBlocks(blocks, dw_skip_bn=skip_dw, dw_skip_relu=skip_dw,
                         compute_dtype=jnp.float32)
    params = _flax(jm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tfb.FBNetBlocks(16, blocks, dw_skip_bn=skip_dw,
                         dw_skip_relu=skip_dw)
    _load(tm, params)
    got = tm(_nhwc(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    assert tm.out_channels == want.shape[-1]
    _close(got, want)


@pytest.mark.parametrize("arch", ["default", "json"])
def test_trunk_matches(arch):
    kw = ({"arch": "default"} if arch == "default"
          else {"arch_def": json.dumps(CUSTOM)})
    x = np.random.RandomState(8).randn(2, 48, 64, 3).astype(np.float32)
    jm = jfb.FBNetTrunk(compute_dtype=jnp.float32, **kw)
    params = _flax(jm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = _load(tfb.FBNetTrunk(compute_dtype=torch.float32, **kw), params)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == ((2, 3, 4, 96) if arch == "default"
                                       else (2, 6, 8, 24))
    _close(got, want)


def test_trunk_width_scaling():
    m = tfb.FBNetTrunk(scale_factor=0.5, width_divisor=8)
    assert m.out_channels == jfb._divisible(96 * 0.5, 8, 8)


@functools.lru_cache(maxsize=None)
def _model(seed=MODEL_SEED):
    jb, tb = _batch(seed, h=48, w=96, max_wh=40.0)
    kw = dict(num_classes=81, backbone_arch="FBNet-default",
              pooler_scale=0.0625, mlp_dim=64, roi_batch_size=32,
              compute_dtype="float32")
    jm = JRCNN(**kw)
    params = _jax_params(jm, jb)
    tm = SupervisedRCNN(**kw)
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, jb, tm, tb


def test_fbnet_rcnn_eval_matches():
    jm, params, jb, tm, tb = _model()
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params}, jb)
    got = tm.eval_forward(tb)
    assert got["features"].shape == (2, 3, 6, 96)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=SCORE_ATOL)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), atol=BOX_ATOL)


def test_fbnet_rcnn_train_step_matches(monkeypatch):
    jm, params, jb, tm, tb = _model()
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
    assert set(losses) == set(want) == {"loss_classifier", "loss_box_reg"}
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    sum(losses.values()).backward()
    assert _check_grads(tm, grads) >= 45     # first, 17 blocks, the heads
