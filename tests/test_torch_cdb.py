"""The port's Concrete DropBlock (odwscl_tpu_torch/models/cdb.py) and its
adversarial optimizer (solver/build.py) against the JAX package, on the
CPU, in f32.

- ``gumbel_softmax`` (soft and straight-through hard), ``_MaskedBatchNorm``
  (masked rows, random scale and bias) and ``ConvConcreteDB`` (block sizes
  3 and 2, the even size cropping its trailing row and column; masked
  rows), fed JAX's own uniforms: outputs within 1e-6 and the gradients of
  the parameters (and of the inputs where they reach them) within 1e-5,
  each of its tensor's largest magnitude (a few f32 ulps of the outputs).
  ``ConvConcreteDB``'s convs read a detached copy, so its input's
  gradient is the cotangent times the drop mask's multiplier alone.
- ``train_forward`` with ``DB.METHOD concrete`` on the main path (MIST,
  contrastive mining) against JAX's ``value_and_grad``: the harness and
  tolerances of tests/torch_variant_parity.py.
- The optimizer with the CDB's groups: ``make_optimizer(SOLVER, model,
  SOLVER_CDB, DB.WEIGHT)`` against JAX's ``make_optimizer(..., SOLVER_CDB,
  DB.WEIGHT)`` (in ``optax.MultiSteps`` for ITER_SIZE 2), 3 updates with a
  warmup and a milestone on each schedule: parameters within 1e-6
  relative. The CDB's norm ``scale`` sits in the bias group (no weight
  decay, twice the LR), and the first CDB update is +DB.WEIGHT * lr *
  (g + wd * p): the weight decay ascends with the gradient.
- A checkpoint restores the CDB groups' momentum buffers, schedule, scale
  and count: one update after a save and a restore equals one update
  without them, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import odwscl_tpu.models.cdb as jcdb
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.models import cdb as tcdb
from odwscl_tpu_torch.solver import make_optimizer
from odwscl_tpu_torch.utils.checkpoint import Checkpointer
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

import torch_variant_parity as tvp

torch.set_num_threads(2)

OUT_REL = 1e-6
GRAD_REL = 1e-5
PARAM_RTOL = 1e-6
KEY = jax.random.PRNGKey(21)


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("hard,tau", [(False, 0.5), (True, 0.5),
                                      (True, 0.01)])
def test_gumbel_softmax_matches_jax(hard, tau):
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 2).astype(np.float32)
    g = rng.randn(40, 2).astype(np.float32)
    uniform = np.array(jax.random.uniform(KEY, logits.shape))

    def jloss(lg):
        return jnp.vdot(jcdb.gumbel_softmax(KEY, lg, tau=tau, hard=hard), g)

    want = jcdb.gumbel_softmax(KEY, jnp.asarray(logits), tau=tau, hard=hard)
    want_grad = jax.grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tcdb.gumbel_softmax(lt, tau=tau, hard=hard,
                              uniform=torch.from_numpy(uniform))
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach().numpy(), want, OUT_REL, "output")
    if hard:
        assert set(np.unique(got.detach().numpy().round(5))) <= {0.0, 1.0}
    _close(lt.grad.numpy(), want_grad, GRAD_REL, "d logits")
    assert np.abs(np.asarray(want_grad)).max() > 0


def test_masked_batch_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(6, 7, 7, 8).astype(np.float32) * 3 + 1
    valid = np.array([True, True, False, True, False, True])
    g = rng.randn(*x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32)}
    jm = jcdb._MaskedBatchNorm()
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(valid))
    want_gp, want_gx = jax.grad(lambda p, xx: jnp.vdot(jm.apply(
        {"params": p}, xx, jnp.asarray(valid)), g), argnums=(0, 1))(
        params, jnp.asarray(x))

    tm = tcdb._MaskedBatchNorm(8)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = tm(xt, torch.from_numpy(valid))
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    _close(out.permute(0, 2, 3, 1).detach().numpy(), want, OUT_REL, "output")
    for k in params:
        _close(getattr(tm, k).grad.numpy(), want_gp[k], GRAD_REL, k)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx, GRAD_REL, "d x")


@pytest.mark.parametrize("block_size", [3, 2])
def test_conv_concrete_db_matches_jax(block_size):
    rng = np.random.RandomState(2)
    n, c = 8, 16
    x = rng.randn(n, 7, 7, c).astype(np.float32)
    valid = np.array([True] * 6 + [False] * 2)
    g = rng.randn(*x.shape).astype(np.float32)
    jm = jcdb.ConvConcreteDB(drop_prob=0.3, block_size=block_size)
    params = jax.jit(lambda r: jm.init(r, x, valid, train=True))(
        {"params": jax.random.PRNGKey(0),
         "augment": jax.random.PRNGKey(1)})["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def jloss(p):
        return jnp.vdot(jm.apply({"params": p}, jnp.asarray(x),
                                 jnp.asarray(valid), train=True,
                                 rngs={"augment": KEY}), g)

    with pytest.MonkeyPatch.context() as mp:
        orig = jcdb.gumbel_softmax
        mp.setattr(jcdb, "gumbel_softmax",
                   lambda rng_, lg, *a, **k: orig(KEY, lg, *a, **k))
        want = jm.apply({"params": params}, jnp.asarray(x),
                        jnp.asarray(valid), train=True,
                        rngs={"augment": KEY})
        want_grads = jax.grad(jloss)(params)

    tm = tcdb.ConvConcreteDB(c, block_size)
    tm.load_state_dict({k[len("cdb."):]: v for k, v in state_dict_from_jax(
        {"cdb": params}).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(valid), uniform=torch.from_numpy(
        np.array(jax.random.uniform(KEY, (n, 7, 7, 2)))))
    (out * torch.from_numpy(g)).sum().backward()
    want = np.asarray(want)
    _close(out.detach().numpy(), want, OUT_REL, "output")
    dropped = (want == 0).all(axis=-1)
    assert dropped[valid].any() and not dropped[valid].all()
    got = jax_params_from_state_dict({f"cdb.{k}": p.grad for k, p in
                                      tm.named_parameters()})["cdb"]
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        key = jax.tree_util.keystr(path)
        gv = got
        for k in path:
            gv = gv[k.key]
        assert np.abs(np.asarray(w)).max() > 0, key
        _close(gv, w, GRAD_REL, key)
    # the convs read a detached copy: x's gradient is g times the mask's
    # multiplier alone
    np.testing.assert_allclose(xt.grad.numpy(), g * (want / x), rtol=1e-5,
                               atol=1e-7)


def test_train_forward_concrete_matches_jax():
    losses, metrics, model = tvp.assert_train_matches(
        dict(db_method="concrete"))
    assert "loss_sim" in losses and float(metrics["n_bank"]) > 0
    # every CDB parameter is reached; at this size the gumbel (tau 0.01)
    # leaves a handful of cells unsaturated, and the 1x1 downsample's
    # gradient can be exactly 0 (in JAX too)
    assert all(p.grad is not None for p in model.cdb.parameters())
    assert model.cdb.conv1.weight.grad.abs().max() > 0


class _Params(torch.nn.Module):
    """A neck layer and CDB leaves, named as the detector's."""

    def __init__(self, arrays):
        super().__init__()
        for path, v in arrays.items():
            mod = self
            *parents, leaf = path.split(".")
            for name in parents:
                if not hasattr(mod, name):
                    mod.add_module(name, torch.nn.Module())
                mod = getattr(mod, name)
            mod.register_parameter(
                leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


SHAPES = {"neck.fc6.weight": (5, 3), "neck.fc6.bias": (3,),
          "cdb.conv1.weight": (2, 3), "cdb.bn1.scale": (3,),
          "cdb.bn1.bias": (3,)}
OPTS = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "2",
        "SOLVER.STEPS", "(3,)", "SOLVER_CDB.BASE_LR", "0.05",
        "SOLVER_CDB.WARMUP_ITERS", "1", "SOLVER_CDB.STEPS", "(2,)",
        "SOLVER_CDB.WEIGHT_DECAY", "0.01", "DB.WEIGHT", "0.5",
        "DB.METHOD", "concrete"]


def _jax_tree(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node["kernel" if leaf == "weight" else leaf] = v
    return tree


def _get(tree, path):
    *parents, leaf = path.split(".")
    for name in parents:
        tree = tree[name]
    return tree["kernel" if leaf == "weight" else leaf]


@pytest.mark.parametrize("iter_size", [1, 2])
def test_cdb_optimizer_matches_jax(iter_size):
    rng = np.random.RandomState(3)
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    opts = OPTS + ["SOLVER.ITER_SIZE", str(iter_size)]
    cfg, jcfg = get_default_cfg(), jax_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    model = _Params(arrays)
    opt, _ = make_optimizer(cfg.SOLVER, model, cfg.SOLVER_CDB, cfg.DB.WEIGHT)
    cdb_bias = [g for g in opt.param_groups if g["schedule"] == 1
                and g["lr_factor"] != 1.0]
    assert [len(g["params"]) for g in cdb_bias] == [2]   # scale and bias
    assert cdb_bias[0]["weight_decay"] == 0.0

    jparams = _jax_tree(arrays)
    tx, _ = jax_make_optimizer(jcfg.SOLVER, jparams, 0, jcfg.SOLVER_CDB,
                               jcfg.DB.WEIGHT)
    if iter_size > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=iter_size)
    jstate = tx.init(jparams)
    for step in range(3 * iter_size):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in SHAPES.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        upd, jstate = tx.update(_jax_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n in SHAPES:
            np.testing.assert_allclose(
                model.get_parameter(n).detach().numpy(),
                np.asarray(_get(jparams, n)), rtol=PARAM_RTOL, atol=1e-7,
                err_msg=f"{step} {n}")
    assert opt.count == 3


def test_cdb_first_update_ascends_with_weight_decay():
    """The first CDB update against its closed form."""
    rng = np.random.RandomState(4)
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = get_default_cfg()
    cfg.merge_from_list(OPTS)
    model = _Params(arrays)
    opt, _ = make_optimizer(cfg.SOLVER, model, cfg.SOLVER_CDB, cfg.DB.WEIGHT)
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    opt.step()
    lr = opt.schedules[1](1)
    wd = cfg.SOLVER_CDB.WEIGHT_DECAY
    want = arrays["cdb.conv1.weight"] + cfg.DB.WEIGHT * lr * (
        grads["cdb.conv1.weight"] + wd * arrays["cdb.conv1.weight"])
    np.testing.assert_allclose(model.cdb.conv1.weight.detach().numpy(), want,
                               rtol=1e-6)
    # the bias group (scale included): twice the LR, no weight decay
    for leaf in ("scale", "bias"):
        key = f"cdb.bn1.{leaf}"
        want = arrays[key] + cfg.DB.WEIGHT * lr * float(
            cfg.SOLVER_CDB.BIAS_LR_FACTOR) * grads[key]
        np.testing.assert_allclose(model.get_parameter(key).detach().numpy(),
                                   want, rtol=1e-6)


def test_checkpoint_restores_cdb_optimizer_state(tmp_path):
    rng = np.random.RandomState(5)
    arrays = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    cfg = get_default_cfg()
    cfg.merge_from_list(OPTS)

    def build():
        model = _Params(arrays)
        return model, make_optimizer(cfg.SOLVER, model, cfg.SOLVER_CDB,
                                     cfg.DB.WEIGHT)[0]

    def step(model, opt, g):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()

    model, opt = build()
    for g in grads[:2]:
        step(model, opt, g)
    Checkpointer(str(tmp_path)).save(2, model, opt)
    model2, opt2 = build()
    assert Checkpointer(str(tmp_path)).load(model2, opt2) == 2
    assert opt2.count == 2
    assert [(g["schedule"], g["scale"]) for g in opt2.param_groups] == [
        (g["schedule"], g["scale"]) for g in opt.param_groups]
    step(model, opt, grads[2])
    step(model2, opt2, grads[2])
    for n in SHAPES:
        assert torch.equal(model.get_parameter(n), model2.get_parameter(n)), n
