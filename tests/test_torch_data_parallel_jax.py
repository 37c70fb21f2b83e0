"""A 2-process data-parallel training step of the port against the JAX
package's ``make_train_step`` under a 2-device ``data`` mesh
(``make_mesh``, ``shard_batch``, the state replicated) on the same batch
and weights.

The setup is tests/test_torch_train_step.py's (its inputs, its flax init
carried over by utils/from_jax.py with the score heads x300, its fixed
DropBlock and noise draws handed to the port, FREEZE_CONV_BODY_AT 2, its
solver options); each of the 2 ``gloo`` processes takes one image of the
batch of 2. The bounds are that test's single-step ones: the integer
metrics equal, every loss within 1e-4 relative, the parameters after the
step within 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.models.detector as jdet
import test_torch_train_step as ts
from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.engine.trainer import TrainState, make_train_step
from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.parallel import make_mesh, replicate, shard_batch
from odwscl_tpu.solver import make_optimizer as jax_make_optimizer
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)
from torch_dp_workers import run_ranks


@pytest.mark.skipif(jax.device_count() < 2, reason="needs 2 JAX devices")
def test_two_process_step_matches_jax_data_mesh(tmp_path):
    arrays = ts._inputs()
    names = ("images", "image_sizes", "boxes", "box_mask", "labels")
    batch = JBatch(*(jnp.asarray(a) for a in arrays))
    init = jdet.WSODDetector(**ts.KW)
    v = jax.jit(lambda r, bb: init.init(r, bb, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        batch)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= ts.HEAD_SCALE
    cfg = jax_cfg()
    cfg.merge_from_list(ts.SOLVER_OPTS)
    with pytest.MonkeyPatch.context() as mp:
        ts._fixed_key_draws(mp)
        jmodel = jdet.WSODDetector(**ts.KW, freeze_convs=4)
        tx, _ = jax_make_optimizer(cfg.SOLVER, params, 4)
        state = TrainState(step=jnp.zeros([], jnp.int32), params=params,
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(5))
        mesh = make_mesh(("data",), jax.devices()[:2])
        state, logs = jax.jit(make_train_step(jmodel, tx))(
            replicate(mesh, state), shard_batch(mesh, batch))
        want = {k: float(x) for k, x in logs.items()}
    want_params = {jax.tree_util.keystr(k): np.asarray(x)
                   for k, x in jax.tree_util.tree_leaves_with_path(
                       state.params)}

    path = str(tmp_path / "init.pt")
    torch.save(state_dict_from_jax(params), path)
    draws = {k: x.numpy() for k, x in ts._draws(
        arrays[0].shape[0] * arrays[2].shape[1], ts.KW["cap_a"]).items()}
    ranks = run_ranks(2, tmp_path, "step_jax_batch", ts.KW, 2, path,
                      dict(zip(names, arrays)), draws, ts.SOLVER_OPTS)
    (got, sd), (got1, _) = ranks
    assert got == got1
    for k in ts.INT_METRICS:
        assert got[k] == want[k], k
    assert got["n_bank"] > 0 and got["n_mined"] > 0
    assert set(got) == set(want)
    for k in want:
        if k not in ts.INT_METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=ts.LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
    got_params = {jax.tree_util.keystr(k): np.asarray(x)
                  for k, x in jax.tree_util.tree_leaves_with_path(
                      jax_params_from_state_dict(sd))}
    assert got_params.keys() == want_params.keys()
    for k in want_params:
        np.testing.assert_allclose(got_params[k], want_params[k], rtol=0,
                                   atol=ts.PARAM_ATOL, err_msg=k)
