"""The port's spatially-parallel VGG16 backbone
(odwscl_tpu_torch/parallel/sp.py) against the JAX package's
(odwscl_tpu/parallel/sp.py:sp_backbone_apply) and the unsharded backbone.

One random VGG16-OICR body (flax init, carried over: HWIO -> OIHW) and
one batch go through the port on sp = 2 and 4 ``gloo`` processes and
through the JAX function on (data, sp) meshes of the 8 virtual CPU
devices, at H = 128 and at H = 104 (not a multiple of 8 x 4, as
tests/test_sp.py's uneven case). f32: every rank's gathered features
within 1e-5 of JAX's and of the unsharded port backbone. A hook on
``torch.nn.functional.conv2d`` shows that each rank's conv1 input is its
band plus the halo rows only (at H = 128, sp = 4: 32 + 2 of 128 rows),
and ``gather=False`` leaves each rank its band of the features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models.vgg16 import VGGBackbone as JaxVGG
from odwscl_tpu.parallel import make_sp_mesh, sp_backbone_apply
from odwscl_tpu_torch.models.vgg16 import VGGBackbone
from odwscl_tpu_torch.parallel.sp import sp_bands
from torch_dp_workers import run_ranks

TOL = 1e-5


def _setup(h, seed=0, b=2, w=96):
    x = np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)
    bb = JaxVGG(arch="VGG16-OICR", compute_dtype=jnp.float32)
    params = jax.jit(bb.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    state = {}
    for name, leaf in params["params"].items():
        state[f"{name}.weight"] = np.asarray(leaf["kernel"]).transpose(
            3, 2, 0, 1).copy()
        state[f"{name}.bias"] = np.array(leaf["bias"])
    return bb, params, x, state


def _plain(state, x):
    bb = VGGBackbone("VGG16-OICR", torch.float32)
    bb.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        return bb(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("h, sp", [(128, 2), (128, 4), (104, 4)])
def test_sp_backbone_matches_jax_and_unsharded(tmp_path, h, sp):
    bb, params, x, state = _setup(h)
    want_jax = np.asarray(sp_backbone_apply(make_sp_mesh(8 // sp, sp),
                                            params, jnp.asarray(x), bb))
    want = _plain(state, x)
    np.testing.assert_allclose(want_jax, want, rtol=TOL, atol=TOL)
    outs = run_ranks(sp, tmp_path, "sp", "VGG16-OICR", state, x)
    bands = sp_bands(h, 8, sp)
    for r, (feats, rows) in enumerate(outs):
        assert feats.shape == want.shape, feats.shape
        np.testing.assert_allclose(feats, want, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(feats, want_jax, rtol=TOL, atol=TOL)
        # conv1's input: the band and one halo row on each side
        start, stop = bands[r]
        assert rows[0] == stop - start + 2, (r, rows)
        assert len(rows) == 13
    if (h, sp) == (128, 4):
        assert max(rows[0] for _, rows in outs) == 34


def test_gather_false_keeps_the_bands(tmp_path):
    _, _, x, state = _setup(104, seed=1)
    want = _plain(state, x)
    outs = run_ranks(2, tmp_path, "sp", "VGG16-OICR", state, x, False)
    (a, b), = [sp_bands(104, 8, 2)]
    got = [feats for feats, _ in outs]
    assert [g.shape[1] for g in got] == [(a[1] - a[0]) // 8, 13 - a[1] // 8]
    np.testing.assert_allclose(np.concatenate(got, 1), want, rtol=TOL,
                               atol=TOL)


def test_bands_and_refusals():
    assert sp_bands(128, 8, 4) == [(0, 32), (32, 64), (64, 96), (96, 128)]
    assert sp_bands(104, 8, 4) == [(0, 32), (32, 64), (64, 96), (96, 104)]
    assert sp_bands(107, 8, 2) == [(0, 56), (56, 107)]
    with pytest.raises(ValueError, match="empty"):
        sp_bands(40, 8, 4)          # 5 feature rows: 2, 2, 1, 0
