"""The port's ResNet (odwscl_tpu_torch/models/resnet.py) and the ResNet
detector against the JAX package's, on the CPU.

The same flax parameters (carried over by utils/from_jax.py, FrozenBN
leaves included) and the same numpy inputs go through both. Every
``FrozenBatchNorm`` gets random scale, bias, mean and var (var in [0.5,
1.5]) so that the norms are not identities. f32 on both sides.

- Blocks (``Bottleneck`` with and without the projection, strided,
  ``BasicBlock``) and an R-50-C5 backbone on a 32x32 image: within 1e-5 of
  each output's largest magnitude (both run the same f32 algorithm; the
  convolutions sum in another order, ~1e-7 relative per layer).
- The R-18-C5 backbone's parameter gradients under a dense random
  cotangent: within 1e-4 of each tensor's largest magnitude (observed
  1e-6). A ReLU unit whose pre-activation lies within the f32 drift of 0
  (~1e-6 of its layer's largest magnitude) may take opposite signs in the
  two frameworks, and one such unit moves the gradients below it by
  several percent (seed 5's image has a unit at 3e-9 of its layer's
  largest: channels_last flips it, a contiguous NCHW layout happens not
  to). So the test's image is one whose every pre-activation lies at
  least 1e-6 of its layer's largest magnitude from 0 in a float64 pass
  of the port, which the test checks first.
- The R-18-C5 detector, ``eval_forward`` and one training step, with the
  images handed over as an NHWC view of NCHW memory, so that PyTorch's
  CPU convolutions run on contiguous NCHW tensors: their f32 drift from
  float64 is about a third of channels_last's (6e-7 against 2.2e-6 of the
  largest R-18 output, observed), and on these 128x160 images, whose
  smallest pre-activations lie within 1e-8 of 0, no unit on the
  gradient's path then flips against XLA (in channels_last one does, and
  moves layer2_0.conv1's gradient by 20%). The
  detector's neck is narrowed to fc6 = 64 on both sides (the JAX model
  builds it at 2048 with dropout 0.5, so the test swaps in its own
  ``ResNetRoINeck`` with dropout 0), mlp_dim 64; rois stay within the JAX
  CPU pooler's 32 cells; the heads are scaled (x30: the ResNet's random
  features are large, and a larger factor saturates the softmaxes) and
  the DropBlock and noise draws are handed over as in
  tests/test_torch_train_step.py. Scores 5e-5 absolute, boxes 1e-4 px
  (test_torch_detector.py's bounds); losses 1e-4 relative or 1e-6
  absolute (the refinement losses reach ~1e-4, where the f32 drift of
  ~4e-8 is 3e-4 relative); gradients of every trainable tensor within
  1e-4 of its largest magnitude (observed <= 3.2e-5), 1e-8 absolute at
  least (the det_score bias gets no gradient, only an f32 residue);
  parameters after one step of the port's optimizer against the JAX
  optimizer's update from JAX's gradients (FREEZE_CONV_BODY_AT 2) 1e-5
  absolute, the frozen ones exactly unchanged.
- The freeze rules at FREEZE_CONV_BODY_AT 0, 1 and 2 against the JAX
  optimizer labels given the conv count the JAX CLI passes; R-50-C5 and
  R-101-C5 parameter shapes from the shipped configs against
  ``jax.eval_shape`` (no compute; the port model lives on the meta
  device).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import odwscl_tpu.models.detector as jdet
import odwscl_tpu.models.resnet as jresnet
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models.vgg16 import FREEZE_CONV_COUNTS
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu.solver.build import param_labels
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.engine.trainer import train_step
from odwscl_tpu_torch.models import Batch, WSODDetector, detector_from_cfg
from odwscl_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                            ResNetBackbone, ResNetRoINeck)
from odwscl_tpu_torch.solver import make_optimizer
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)
from tests.test_torch_train_step import _draws, _fixed_key_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_REL = 1e-5
SCORE_ATOL = 5e-5
BOX_ATOL = 1e-4
LOSS_RTOL = 1e-4
LOSS_ATOL = 1e-6
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
MID = 64
HEAD_SCALE = 30.0
KW = dict(backbone_arch="R-18-C5", pooler_scale=0.0625, num_classes=6,
          mlp_dim=64, cap_a=64, cap_b=32, gt_cap=16, compute_dtype="float32")
INT_METRICS = ("n_bank", "n_mined", "bank_overflow", "n_pos0", "n_pos1",
               "n_pos2", "pgt_overflow0", "pgt_overflow1", "pgt_overflow2")


def _randomize_bn(tree, rng):
    """Random FrozenBN leaves, in place; returns the tree."""
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
            c = v["scale"].shape
            v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(v, dict):
            _randomize_bn(v, rng)
    return tree


def _init(module, x, rng_seed=0):
    params = jax.jit(module.init)(jax.random.PRNGKey(rng_seed),
                                  jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    params)
    return _randomize_bn(params, np.random.RandomState(rng_seed + 1))


def _port_sub(params, module):
    """Load a flax sub-tree into a port module via the weight bridge."""
    sd = state_dict_from_jax({"backbone": params})
    module.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return module


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind,cin,cout,stride", [
    ("bottleneck", 256, 256, 1), ("bottleneck", 64, 256, 1),
    ("bottleneck", 256, 512, 2), ("basic", 64, 64, 1), ("basic", 64, 128, 2)])
def test_blocks_match_flax(kind, cin, cout, stride):
    x = np.random.RandomState(3).randn(2, 12, 10, cin).astype(np.float32)
    if kind == "bottleneck":
        jm = jresnet.Bottleneck(cout, cout // 4, stride,
                                compute_dtype=jnp.float32)
        tm = Bottleneck(cin, cout, cout // 4, stride)
    else:
        jm = jresnet.BasicBlock(cout, stride, compute_dtype=jnp.float32)
        tm = BasicBlock(cin, cout, stride)
    params = _init(jm, x)
    assert ("downsample" in params) == (cin != cout or stride != 1)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    _port_sub(params, tm)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel_err(got.detach().numpy(), want) <= BLOCK_REL


def test_r50_backbone_matches_flax():
    x = (np.random.RandomState(4).randn(1, 32, 32, 3) * 50).astype(np.float32)
    jm = jresnet.ResNetBackbone("R-50", 5, compute_dtype=jnp.float32)
    params = _init(jm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = _port_sub(params, ResNetBackbone("R-50", 5, torch.float32))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (1, 2, 2, 2048)   # stride 16, C5
    assert _rel_err(got, want) <= BLOCK_REL


def _relu_margin(params, x):
    """The smallest |pre-activation| of any ReLU in a float64 pass of the
    port's R-18-C5 backbone with ``params`` on ``x``, each relative to its
    layer's largest."""
    margins = []
    relu = torch.nn.functional.relu

    def record(t, *args, **kw):
        margins.append((t.abs().min() / t.abs().max()).item())
        return relu(t, *args, **kw)

    m64 = _port_sub(params, ResNetBackbone("R-18", 5, torch.float64))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", record)
        m64.double()(torch.from_numpy(x).double())
    return min(margins)


def test_r18_backbone_vjp_matches_flax():
    """The backbone's parameter gradients under a dense random
    cotangent."""
    rng = np.random.RandomState(13)
    x = (rng.randn(2, 64, 96, 3) * 50).astype(np.float32)
    jm = jresnet.ResNetBackbone("R-18", 5, compute_dtype=jnp.float32)
    params = _init(jm, x)
    assert _relu_margin(params, x) >= 1e-6
    g = rng.randn(2, 4, 6, 512).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.vdot(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(g))))(params)
    tm = _port_sub(params, ResNetBackbone("R-18", 5, torch.float32))
    torch.vdot(tm(torch.from_numpy(x)).reshape(-1),
               torch.from_numpy(g).reshape(-1)).backward()
    got = _leaves(jax_params_from_state_dict(
        {"backbone." + n: p.grad for n, p in tm.named_parameters()
         if p.requires_grad}))
    want = _leaves({"backbone": want})
    assert len(got) == 20                     # every conv of R-18
    for k in got:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=GRAD_REL * scale)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, h, w, p = 2, 128, 160, 16
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    sizes = np.array([[128, 160], [120, 150]], np.float32)
    x1y1 = rng.uniform(0, 80, (b, p, 2))
    wh = rng.uniform(16, 70, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, 0] = True
    labels = np.zeros((b, 6), np.float32)
    labels[0, 2] = labels[1, 4] = 1.0
    return images, sizes, boxes, mask, labels


def _narrow_neck(mid_dim, out_dim, compute_dtype):
    return _ORIG_NECK(mid_dim=MID, out_dim=out_dim,
                      compute_dtype=compute_dtype, dropout_rate=0.0)


_ORIG_NECK = jresnet.ResNetRoINeck


@pytest.fixture(scope="module")
def r18():
    """JAX's R-18-C5 eval outputs, train losses and gradients, and the JAX
    optimizer's first update from those gradients, all with the narrowed
    neck. (The update is applied to ``value_and_grad``'s gradients rather
    than through ``make_train_step``: on the CPU, XLA's train-step program
    computes layer2's gradients far off its own ``value_and_grad``.)"""
    arrays = _inputs()
    batch = JBatch(*(jnp.asarray(a) for a in arrays))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "ResNetRoINeck", _narrow_neck)
        _fixed_key_draws(mp)
        jmodel = jdet.WSODDetector(**KW)
        v = jax.jit(lambda r, bb: jmodel.init(r, bb, method="init_all"))(
            {"params": jax.random.PRNGKey(0),
             "augment": jax.random.PRNGKey(1)}, batch)
        params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                        v["params"])
        _randomize_bn(params, np.random.RandomState(7))
        for name, head in params["pred"].items():
            if not name.startswith("bbox_pred"):
                head["linear"]["kernel"] *= HEAD_SCALE
        out["eval"] = jax.jit(lambda p, bt: jmodel.apply(
            {"params": p}, bt, train=False))(params, batch)

        def loss_fn(p):
            losses, metrics = jmodel.apply(
                {"params": p}, batch, train=True,
                rngs={"dropout": jax.random.PRNGKey(3),
                      "augment": jax.random.PRNGKey(4)})
            return jnp.sum(jnp.stack(list(losses.values()))), (losses,
                                                               metrics)

        out["train"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)
        cfg = jax_cfg()
        cfg.merge_from_list(["SOLVER.BASE_LR", "0.002", "SOLVER.WARMUP_ITERS",
                             "0"])
        # the JAX CLI passes FREEZE_CONV_COUNTS[at - 1] (at = 2 by default)
        tx, _ = jax_make_optimizer(cfg.SOLVER, params, FREEZE_CONV_COUNTS[1])
        grads = out["train"][1]
        out["step"] = jax.jit(lambda p, g: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(params, grads)
    return params, arrays, cfg, out


def _port_r18(params, freeze_at=2):
    model = WSODDetector(**KW, neck_dropout=0.0, freeze_at=freeze_at)
    model.neck = ResNetRoINeck(512 * 49, MID, KW["mlp_dim"], torch.float32,
                               0.0)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _port_batch(arrays):
    """The port's Batch, its images an NHWC view of NCHW memory."""
    images = torch.from_numpy(np.ascontiguousarray(
        arrays[0].transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    return Batch(images, *(torch.from_numpy(a) for a in arrays[1:]))


def test_r18_eval_forward_matches_jax(r18):
    params, arrays, _, out = r18
    want_s, want_b = (np.asarray(a) for a in out["eval"])
    model = _port_r18(params)
    got_s, got_b = model.eval_forward(_port_batch(arrays[:4]))
    assert got_s.shape == want_s.shape and got_b.shape == want_b.shape
    assert want_s.max() > 0.5          # the scores are spread, not uniform
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=BOX_ATOL)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_r18_train_step_matches_jax(r18):
    params, arrays, cfg, out = r18
    (_, (want_losses, want_metrics)), want_grads = out["train"]
    model = _port_r18(params)
    tbatch = _port_batch(arrays)
    draws = _draws(arrays[2].shape[0] * arrays[2].shape[1], KW["cap_a"])
    losses, metrics = model.train_forward(tbatch, draws=draws)
    torch.stack(list(losses.values())).sum().backward()

    assert set(losses) == set(want_losses)
    for k in INT_METRICS:
        assert float(metrics[k]) == float(want_metrics[k]), k
    assert float(metrics["n_bank"]) > 0 and float(metrics["n_mined"]) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want_losses[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    trainable = {n: p.grad for n, p in model.named_parameters()
                 if p.requires_grad}
    assert all(g is not None for g in trainable.values())
    got = _leaves(jax_params_from_state_dict(trainable))
    want = _leaves(want_grads)
    for k in got:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=max(GRAD_REL * scale, 1e-8))

    model = _port_r18(params)
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    logs = train_step(model, optimizer, tbatch, draws=draws)
    for k in want_losses:
        np.testing.assert_allclose(float(logs[k]), float(want_losses[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    want_params = out["step"]
    before = _leaves(params)
    got = _leaves(jax_params_from_state_dict(model.state_dict()))
    want = _leaves(want_params)
    frozen = {k for k, lab in _leaves(param_labels(
        params, FREEZE_CONV_COUNTS[1])).items() if lab == "frozen"}
    assert any("['stem_conv']" in k for k in frozen)
    for k in want:
        if k in frozen:
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def _port_key(path):
    """A flax leaf path -> (the port's state_dict key, its shape map)."""
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[0] == "pred":
        keys = [keys[0], keys[1], keys[3]]
    if keys[-1] == "kernel":
        keys[-1] = "weight"
    return ".".join(keys)


def _torch_shape(shape):
    if len(shape) == 4:                         # HWIO -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(shape[::-1])


def _jax_shapes(kw, batch_hw=64):
    model = jdet.WSODDetector(**kw)
    batch = JBatch(jnp.zeros((1, batch_hw, batch_hw, 3)),
                   jnp.full((1, 2), float(batch_hw)),
                   jnp.array([[[0.0, 0.0, 40.0, 40.0]] * 4]),
                   jnp.ones((1, 4), bool),
                   jnp.zeros((1, kw.get("num_classes", 21))))
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="init_all"))["params"]


@pytest.mark.parametrize("at", [0, 1, 2])
def test_freeze_rules_match_jax_labels(at):
    kw = dict(backbone_arch="R-18-C5", pooler_scale=0.0625, mlp_dim=64)
    shapes = _jax_shapes(kw)
    labels = param_labels(shapes, FREEZE_CONV_COUNTS[at - 1] if at else 0)
    want = {_port_key(p) for p, lab in
            jax.tree_util.tree_leaves_with_path(labels) if lab == "frozen"}
    with torch.device("meta"):
        model = WSODDetector(**kw, freeze_at=at)
    got = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert got == want
    assert any(k.startswith("backbone.stem_conv") for k in got) == (at > 0)
    assert any(k.startswith("backbone.layer2_0.conv1") for k in got) is False


@pytest.mark.parametrize("name", ["voc07_r50_c5_contra_db_b8_lr0.02_ss",
                                  "voc07_r101_c5_contra_db_b8_lr0.02_ss"])
def test_shipped_resnet_configs_build_with_jax_shapes(name):
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "voc", name + ".yaml"))
    with torch.device("meta"):
        model = detector_from_cfg(cfg)
    assert model.pooler_scale == 0.0625
    assert model.neck.fc6.weight.shape == (2048, 7 * 7 * 2048)
    assert model.neck.fc7.weight.shape == (4096, 2048)
    depth = cfg.MODEL.BACKBONE.CONV_BODY
    shapes = _jax_shapes(dict(backbone_arch=depth, pooler_scale=0.0625))
    want = {_port_key(p): _torch_shape(s.shape) for p, s in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    n_blocks = sum(k.endswith(".conv1.weight") for k in got)
    assert n_blocks == {"R-50-C5": 16, "R-101-C5": 33}[depth]
