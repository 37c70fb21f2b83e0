"""The port's training step against the JAX package's, on the CPU.

The same flax parameters (carried over by utils/from_jax.py) and the same
batch go through the JAX ``WSODDetector.apply(train=True)`` with
``jax.value_and_grad`` and through the port's ``train_forward`` plus
``backward``; then three SGD steps of ``make_train_step`` +
``make_optimizer`` run against the port's ``train_step`` +
``make_optimizer``, with a warmup and a milestone inside the three steps.

Size as tests/test_detector.py: 6 classes, mlp_dim 64, cap_a 64, cap_b 32,
gt_cap 16, f32 compute, neck dropout 0; the real VGG16 widths. Rois stay
within 32 feature cells, where the JAX CPU pooler is exact, and the images
are random f32 (no ties), where its VJP routes as the first argmax does.
The score heads are scaled up (x300) so that every argmax of the mining
and the pseudo-labels is separated by a clear margin.

The draws: in this test process only, the JAX detector's
``dropblock_2d`` and ``noise_augment`` are wrapped to use fixed keys; the
test draws the same uniforms and normals with ``jax.random`` and hands them
to the port. Each image has one positive class: stage B's boolean chain
then compares no rows of other classes. That chain compares 1.0 against a
self-similarity |z|^2 that rounds to either side of 1 with the summation
order of each framework; tests/test_torch_mining.py covers it with
embeddings whose dot products are exact.

Checks: the integer metrics (bank size, mined set, positives, overflows)
are equal at every step. Tolerances come from the f32 summation-order
drift of the two frameworks' convolutions and GEMMs (~3e-6 relative at the
feature map, observed):
- losses of one step 1e-4 relative (observed <= 2e-6); of the later
  trajectory steps 2e-3, where the gradient gaps below have moved the
  parameters apart (observed 3e-4 on loss_sim, the smallest loss);
- gradients of the heads, neck, SimNet and the dilated conv5 block 1e-4 of
  each tensor's largest magnitude (observed <= 1.3e-5);
- gradients of conv0-conv9 3e-2 of their largest magnitude (observed
  1e-2): a ReLU unit whose pre-activation lies within the drift of 0 takes
  opposite signs in the two frameworks, and under the sparse cotangent of
  the RoI max pool one such unit moves a weight gradient by up to ~1% (the
  same backbone under a dense random cotangent agrees to 3e-6);
- the det_score bias gets no gradient (the softmax over proposals is
  shift-invariant): its f32 residue, ~1e-9, is held to 1e-8 absolute;
- parameters after three steps 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.detector as jdet
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.engine.trainer import TrainState, make_train_step
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu_torch.engine.trainer import train_step
from odwscl_tpu_torch.models import Batch, WSODDetector
from odwscl_tpu_torch.solver import make_optimizer
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

torch.set_num_threads(2)

HEAD_SCALE = 300.0
LOSS_RTOL = 1e-4
TRAJ_LOSS_RTOL = 2e-3
GRAD_REL = 1e-4
GRAD_REL_BELOW_CONV5 = 3e-2
GRAD_ATOL_FLOOR = 1e-8
PARAM_ATOL = 1e-5
INT_METRICS = ("n_bank", "n_mined", "bank_overflow", "n_pos0", "n_pos1",
               "n_pos2", "pgt_overflow0", "pgt_overflow1", "pgt_overflow2")
KW = dict(num_classes=6, mlp_dim=64, cap_a=64, cap_b=32, gt_cap=16,
          compute_dtype="float32", neck_dropout=0.0)
KEYS = {3: jax.random.PRNGKey(11), 1: jax.random.PRNGKey(12),
        "noise": jax.random.PRNGKey(13)}
SOLVER_OPTS = ["SOLVER.BASE_LR", "0.002", "SOLVER.WARMUP_ITERS", "2",
               "SOLVER.STEPS", "(2,)", "SOLVER.GAMMA", "0.1"]


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
    labels = np.zeros((b, 6), np.float32)
    labels[0, 2] = labels[1, 4] = 1.0
    return images, sizes, boxes, mask, labels


def _draws(n_rows, cap_a):
    return {"dropblock": torch.from_numpy(np.array(
                jax.random.uniform(KEYS[3], (n_rows, 7, 7)))),
            "sim_drop": torch.from_numpy(np.array(
                jax.random.uniform(KEYS[1], (cap_a, 7, 7)))),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                KEYS["noise"], (cap_a, 7, 7, 512), jnp.float32)))}


def _fixed_key_draws(monkeypatch):
    orig_db, orig_noise = jdet.dropblock_2d, jdet.noise_augment

    def dropblock(rng, x, p, block, deterministic=False, valid=None):
        return orig_db(KEYS[block], x, p, block, deterministic, valid)

    monkeypatch.setattr(jdet, "dropblock_2d", dropblock)
    monkeypatch.setattr(jdet, "noise_augment",
                        lambda rng, x: orig_noise(KEYS["noise"], x))


def _grads_tree(model):
    return jax_params_from_state_dict({
        n: (p.grad if p.grad is not None else torch.zeros_like(p))
        for n, p in model.named_parameters()})


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    images, sizes, boxes, mask, labels = _inputs()
    batch = JBatch(*(jnp.asarray(a) for a in (images, sizes, boxes, mask,
                                              labels)))
    tbatch = Batch(*(torch.from_numpy(a) for a in (images, sizes, boxes,
                                                   mask, labels)))
    init = jdet.WSODDetector(**KW)
    v = jax.jit(lambda r, bb: init.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= HEAD_SCALE
    draws = _draws(images.shape[0] * boxes.shape[1], KW["cap_a"])
    with pytest.MonkeyPatch.context() as mp:
        _fixed_key_draws(mp)
        out = {}
        for freeze in (0, 4):
            jmodel = jdet.WSODDetector(**KW, freeze_convs=freeze)

            def loss_fn(p, jmodel=jmodel):
                losses, metrics = jmodel.apply(
                    {"params": p}, batch, train=True,
                    rngs={"dropout": jax.random.PRNGKey(3),
                          "augment": jax.random.PRNGKey(4)})
                return jnp.sum(jnp.stack(list(losses.values()))), (losses,
                                                                   metrics)

            (total, (losses, metrics)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
            out[freeze] = (jmodel, float(total), losses, metrics, grads)

        cfg = jax_cfg()
        cfg.merge_from_list(SOLVER_OPTS)
        jmodel = out[4][0]
        tx, _ = jax_make_optimizer(cfg.SOLVER, params, 4)
        state = TrainState(step=jnp.zeros([], jnp.int32), params=params,
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(5))
        jstep = jax.jit(make_train_step(jmodel, tx))
        traj = []
        for _ in range(3):
            state, logs = jstep(state, batch)
            traj.append({k: float(v) for k, v in logs.items()})
    return params, tbatch, draws, out, cfg, traj, state.params


def _port_model(params, freeze):
    """``freeze``: the JAX model's frozen-conv count (0 or 4, i.e.
    FREEZE_CONV_BODY_AT 0 or 2)."""
    model = WSODDetector(**KW, freeze_at={0: 0, 4: 2}[freeze])
    model.load_state_dict(state_dict_from_jax(params))
    return model


@pytest.mark.parametrize("freeze", [0, 4])
def test_train_forward_and_grads_match_jax(setup, freeze):
    params, tbatch, draws, out, _, _, _ = setup
    _, want_total, want_losses, want_metrics, want_grads = out[freeze]
    model = _port_model(params, freeze)
    losses, metrics = model.train_forward(tbatch, draws=draws)
    total = torch.stack(list(losses.values())).sum()
    total.backward()

    assert set(losses) == set(want_losses)
    for k in INT_METRICS:
        assert float(metrics[k]) == float(want_metrics[k]), k
    assert float(metrics["n_bank"]) > 0 and float(metrics["n_mined"]) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want_losses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(total), want_total, rtol=LOSS_RTOL)

    got, want = _leaves(_grads_tree(model)), _leaves(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        below = any(f"['conv{i}']" in k for i in range(10))
        rel = GRAD_REL_BELOW_CONV5 if below else GRAD_REL
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=max(rel * scale, GRAD_ATOL_FLOOR))
    frozen = [k for k in want if np.abs(want[k]).max() == 0.0]
    if freeze:
        assert sorted(frozen) == sorted(
            f"['backbone']['conv{i}']['{t}']" for i in range(4)
            for t in ("kernel", "bias"))
        for i in range(4):
            assert model.backbone.get_submodule(f"conv{i}").weight.grad is None
    else:
        assert not frozen


def test_three_step_trajectory_matches_jax(setup):
    params, tbatch, draws, _, cfg, traj, want_params = setup
    model = _port_model(params, 4)
    optimizer, _ = make_optimizer(cfg.SOLVER, model)
    for step, want in enumerate(traj):
        logs = train_step(model, optimizer, tbatch, draws=draws)
        for k in INT_METRICS:
            assert float(logs[k]) == want[k], (step, k)
        for k in ("loss", "loss_img", "loss_sim", "loss_ref_cls0",
                  "loss_ref_reg0"):
            np.testing.assert_allclose(
                float(logs[k]), want[k], err_msg=f"{step} {k}",
                rtol=LOSS_RTOL if step == 0 else TRAJ_LOSS_RTOL)
    got = _leaves(jax_params_from_state_dict(model.state_dict()))
    want = _leaves(want_params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
