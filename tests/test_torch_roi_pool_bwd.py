"""The port's ROIPool backward against the JAX package's Pallas backward.

``roi_pool_backward_plain`` (odwscl_tpu_torch/ops/roi_pool.py, the CPU
path and the CUDA kernel's oracle) and the Pallas ``_bwd_kernel`` behind
``roi_pool_tpu``'s custom_vjp, run in interpret mode on the CPU with the
fixture of tests/test_roi_pool_pallas.py (the package is not changed).
Both route each bin's cotangent whole to the bin's first row-major
maximum.

Bounds: the routing is exact. With strictly positive cotangents both
gradients are non-zero on the same cells. Values agree to f32 reordering:
a cell that n bins route to sums n cotangents in another order, so
|diff| <= n * 2^-23 * sum|g| per cell, held here as 1e-6 relative (n <=
49 on these maps, sums of a few terms). In bf16 the f32 sums are cast, so
a reordering may move the cast by one bf16 ulp: 2^-8 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.ops.roi_pool_pallas as jrp
from odwscl_tpu_torch.ops import roi_pool as rp

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    for name in ("_run_fwd", "_run_bwd"):
        monkeypatch.setattr(jrp, name, functools.partial(getattr(jrp, name),
                                                         interpret=True))
    monkeypatch.setattr(jrp, "CHUNK", 2)


def _pallas_grad(feat, rois, mask, g):
    _, vjp = jax.vjp(lambda f: jrp.roi_pool_tpu(f, jnp.asarray(rois),
                                                jnp.asarray(mask), 0.125),
                     jnp.asarray(feat))
    return np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))


def _port_grad(feat, rois, mask, g, dtype):
    d = rp.roi_pool_backward_plain(
        torch.from_numpy(feat).to(dtype), torch.from_numpy(rois),
        torch.from_numpy(mask), torch.from_numpy(g).to(dtype), 0.125)
    assert d.dtype == dtype
    return d.to(torch.float32).numpy()


# every size class of the pooler on a 24x32 map: small, map-spanning,
# off the top-left corner, beyond the map, malformed (x2 < x1), one cell,
# all bins off the map
ROIS = np.array([[[16.0, 8.0, 100.0, 90.0], [0.0, 0.0, 255.0, 191.0],
                  [-40.0, -40.0, 50.0, 60.0], [0.0, 0.0, 500.0, 500.0],
                  [130.0, 90.0, 120.0, 80.0], [56.0, 56.0, 56.0, 56.0],
                  [3000.0, 3000.0, 3100.0, 3100.0], [40.0, 16.0, 47.0, 23.0]],
                 [[8.0, 8.0, 119.0, 119.0], [3.0, 5.0, 30.0, 100.0],
                  [0.0, 0.0, 255.0, 191.0], [5.0, 5.0, 230.0, 110.0],
                  [0.0, 0.0, 8.0, 8.0], [40.0, 40.0, 47.9, 47.9],
                  [100.0, 30.0, 250.0, 180.0], [0.0, 0.0, 255.0, 191.0]]],
                np.float32)
MASK = np.ones((2, 8), bool)
MASK[0, 1] = MASK[1, 7] = False        # masked rois route nothing


@pytest.mark.parametrize("case", ["random_f32", "ties_f32", "ties_bf16"])
def test_backward_matches_pallas(case):
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 24, 32, 8).astype(np.float32)
    if case != "random_f32":
        # a handful of values: exact ties inside nearly every bin
        feat = np.round(feat * 1.5).astype(np.float32)
    g = (rng.uniform(size=(2, 8, 7, 7, 8)) + 0.1).astype(np.float32)
    dtype = torch.bfloat16 if case == "ties_bf16" else torch.float32
    if dtype == torch.bfloat16:
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    want = _pallas_grad(feat if dtype == torch.float32 else
                        jnp.asarray(feat, jnp.bfloat16), ROIS, MASK,
                        g if dtype == torch.float32 else
                        jnp.asarray(g, jnp.bfloat16))
    got = _port_grad(feat, ROIS, MASK, g, dtype)
    np.testing.assert_array_equal(got != 0, want != 0)       # routing
    assert (want != 0).sum() > 100
    np.testing.assert_allclose(got, want, atol=0, rtol=(
        BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL))


def test_masked_and_offmap_rois_route_nothing():
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 24, 32, 8).astype(np.float32)
    g = np.ones((2, 8, 7, 7, 8), np.float32)
    mask = np.zeros((2, 8), bool)
    mask[0, 6] = True                  # all of its bins lie off the map
    d = _port_grad(feat, ROIS, mask, g, torch.float32)
    assert not d.any()


def test_autograd_function_gradcheck():
    """The Function's backward is the derivative of its forward (f64, no
    ties), on the CPU path."""
    rng = np.random.RandomState(0)
    feat = torch.tensor(rng.randn(2, 6, 8, 2), dtype=torch.float64,
                        requires_grad=True)
    rois = torch.tensor([[[0.0, 0.0, 60.0, 40.0], [-8.0, 8.0, 30.0, 30.0]],
                         [[20.0, 10.0, 10.0, 5.0], [8.0, 0.0, 63.0, 47.0]]])
    mask = torch.tensor([[True, True], [True, False]])
    assert torch.autograd.gradcheck(
        lambda f: rp.RoIPoolFunction.apply(f, rois, mask, 0.125), (feat,))


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    feat = torch.zeros(1, 4, 4, 8)
    rois = torch.tensor([[[0.0, 0.0, 12.0, 12.0]]])     # 4x4 cells at 0.25
    mask = torch.ones(1, 1, dtype=torch.bool)
    g = torch.ones(1, 1, 7, 7, 8)
    before = (rp.roi_pool.launches, rp.roi_pool_backward.launches)
    out = rp.RoIPoolFunction.apply(feat.requires_grad_(), rois, mask,
                                     0.25)
    out.backward(g)
    assert (rp.roi_pool.launches, rp.roi_pool_backward.launches) == before
    assert feat.grad.sum() == g.sum()   # every bin live: all of g arrives
    with pytest.raises(ValueError):
        rp.roi_pool_backward(torch.zeros(1, 4, 4, 8, device="meta"),
                             rois.to("meta"), mask.to("meta"),
                             g.to("meta"), 0.25)
