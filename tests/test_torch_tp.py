"""The port's tensor-parallel neck (odwscl_tpu_torch/parallel/tp.py)
against the JAX package's (odwscl_tpu/parallel/tp.py:tp_neck_apply) and
against the single neck.

The same random neck (fc6 512 -> 256, fc7 256 -> 256, f32) and rows go
through the port on tp = 2 and 4 ``gloo`` processes (each holding its
shard from ``shard_neck_params``) and through the JAX function on a
(data, tp) mesh of the 8 virtual CPU devices ((4, 2) and (2, 4)). Every
rank must return the same output, within 2e-5 of JAX's and of the plain
neck (``tp_neck_plain``, and fc6/fc7 written out in numpy), as
tests/test_tp.py holds the JAX one. Removing the all-reduce must break
the agreement (each rank then returns only its partial product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from odwscl_tpu.parallel import tp_neck_apply as jax_tp_neck_apply
from odwscl_tpu_torch.parallel.tp import shard_neck_params, tp_neck_plain
from torch_dp_workers import run_ranks

TOL = 2e-5


def _neck(seed=0, k=512, h=256):
    rng = np.random.RandomState(seed)
    return {"fc6.weight": (rng.randn(h, k) * 0.02).astype(np.float32),
            "fc6.bias": (rng.randn(h) * 0.01).astype(np.float32),
            "fc7.weight": (rng.randn(h, h) * 0.02).astype(np.float32),
            "fc7.bias": (rng.randn(h) * 0.01).astype(np.float32)}, \
        rng.randn(16, 2, 2, 128).astype(np.float32)


def _numpy_neck(p, x):
    h = np.maximum(x.reshape(len(x), -1) @ p["fc6.weight"].T
                   + p["fc6.bias"], 0)
    return np.maximum(h @ p["fc7.weight"].T + p["fc7.bias"], 0)


def _jax(p, x, tp):
    devs = np.asarray(jax.devices()[:8]).reshape(8 // tp, tp)
    params = {n: {"kernel": jnp.asarray(p[f"{n}.weight"].T),
                  "bias": jnp.asarray(p[f"{n}.bias"])}
              for n in ("fc6", "fc7")}
    return np.asarray(jax_tp_neck_apply(Mesh(devs, ("data", "tp")), params,
                                        jnp.asarray(x), jnp.float32))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_neck_matches_jax_and_the_single_neck(tmp_path, tp):
    p, x = _neck()
    outs = run_ranks(tp, tmp_path, "tp", p, x)
    want_jax, want_np = _jax(p, x, tp), _numpy_neck(p, x)
    np.testing.assert_allclose(want_jax, want_np, rtol=TOL, atol=TOL)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out, outs[0], err_msg=f"rank {r}")
        np.testing.assert_allclose(out, want_jax, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, want_np, rtol=TOL, atol=TOL)


def test_tp_without_the_all_reduce_fails(tmp_path):
    p, x = _neck(1)
    outs = run_ranks(2, tmp_path, "tp", p, x, False)
    want = _numpy_neck(p, x)
    for out in outs:
        assert np.abs(out - want).max() > 100 * TOL


def test_shards_split_the_hidden_units_and_plain_is_the_neck():
    from torch import nn

    p, x = _neck(2)
    neck = nn.ModuleDict({"fc6": nn.Linear(512, 256),
                          "fc7": nn.Linear(256, 256)})
    neck.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    shards = [shard_neck_params(neck, r, 4) for r in range(4)]
    assert all(s["fc6"]["weight"].shape == (64, 512) for s in shards)
    assert all(s["fc7"]["weight"].shape == (256, 64) for s in shards)
    np.testing.assert_array_equal(
        torch.cat([s["fc6"]["weight"] for s in shards]).numpy(),
        p["fc6.weight"])
    np.testing.assert_array_equal(
        torch.cat([s["fc7"]["weight"] for s in shards], 1).numpy(),
        p["fc7.weight"])
    got = tp_neck_plain(neck, torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_allclose(got, _numpy_neck(p, x), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="do not split"):
        shard_neck_params(neck, 0, 3)
