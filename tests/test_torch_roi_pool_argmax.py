"""The training forward's stored argmax and the backward from it.

``roi_pool_argmax_plain`` (odwscl_tpu_torch/ops/roi_pool.py) returns the
forward's output with one int16 code per output element: the offset of the
bin's first row-major maximum inside the bin, or -1. The backward
``roi_pool_backward_argmax_plain`` routes by the codes alone. Both are the
CPU path of ``RoIPoolFunction`` and the oracles of the CUDA kernels
(csrc/roi_pool_fwd.cu with ARGMAX, csrc/roi_pool_bwd.cu), which chip_smoke.py
holds against them on the card.

References: a literal numpy scan of every bin (numpy's argmax over the
bin's cells flattened row-major returns the first maximum); the map-rescan
``roi_pool_backward_plain``; the Pallas ``_bwd_kernel`` behind
``roi_pool_tpu``'s custom_vjp in interpret mode, with the fixture of
tests/test_torch_roi_pool_bwd.py (the JAX package is not changed).

Tolerances: codes and forward outputs exact (integers; max selects an
input). Gradients: routing exact; values within F32_RTOL = 1e-6 relative in
f32 (the sums of a few cotangents in another order) and BF16_RTOL = 2^-8 in
bf16 (one bf16 ulp of the cast of a reordered f32 sum), as in
tests/test_torch_roi_pool_bwd.py.
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
SCALE = 0.125

# every size class on a 24x32 map: small, map-spanning, off the top-left
# corner, beyond the map, malformed (x2 < x1), one cell, all bins off the
# map, narrower than 7 cells
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
MASK[0, 1] = MASK[1, 7] = False


@pytest.fixture
def interpret_mode(monkeypatch):
    for name in ("_run_fwd", "_run_bwd"):
        monkeypatch.setattr(jrp, name, functools.partial(getattr(jrp, name),
                                                         interpret=True))
    monkeypatch.setattr(jrp, "CHUNK", 2)


def _feat(case, seed=3):
    feat = np.random.RandomState(seed).randn(2, 24, 32, 8).astype(np.float32)
    if case != "random_f32":
        # a handful of values: exact ties inside nearly every bin
        feat = np.round(feat * 1.5).astype(np.float32)
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    return torch.from_numpy(feat).to(dtype), dtype


def _literal_codes(feat, rois, mask, scale=SCALE):
    """The first row-major maximum of every bin by a numpy scan: codes
    [B, P, 7, 7, C] int64, -1 where no cell routes."""
    f = feat.to(torch.float32).numpy()
    b, h, w, c = f.shape
    p = rois.shape[1]
    codes = np.full((b, p, 7, 7, c), -1, np.int64)
    cells = np.floor(rois.astype(np.float32) * np.float32(scale)
                     + np.float32(0.5)).astype(np.int64)
    for i in range(b):
        for j in range(p):
            if not mask[i, j]:
                continue
            x1, y1, x2, y2 = cells[i, j]
            rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
            for ph in range(7):
                hs = min(max(ph * rh // 7 + y1, 0), h)
                he = min(max(-(-(ph + 1) * rh // 7) + y1, 0), h)
                for pw in range(7):
                    ws = min(max(pw * rw // 7 + x1, 0), w)
                    we = min(max(-(-(pw + 1) * rw // 7) + x1, 0), w)
                    if he <= hs or we <= ws:
                        continue
                    vals = f[i, hs:he, ws:we].reshape(-1, c)
                    codes[i, j, ph, pw] = vals.argmax(axis=0)
    return codes


@pytest.mark.parametrize("case", ["random_f32", "ties_f32", "ties_bf16"])
def test_codes_name_the_cells_backward_plain_routes_to(case):
    feat, dtype = _feat(case)
    rois, mask = torch.from_numpy(ROIS), torch.from_numpy(MASK)
    _, codes = rp.roi_pool_argmax_plain(feat, rois, mask, SCALE)
    assert codes.dtype == torch.int16 and codes.shape == (2, 8, 7, 7, 8)
    decoded = rp.decode_cells(codes).numpy()
    want = _literal_codes(feat, ROIS, MASK)
    np.testing.assert_array_equal(np.where(decoded == 0xFFFF, -1, decoded),
                                  want)
    g = (torch.rand(codes.shape, generator=torch.Generator().manual_seed(0))
         + 0.1).to(dtype)
    got = rp.roi_pool_backward_argmax_plain(codes, rois, mask, g, SCALE,
                                            (24, 32)).float().numpy()
    ref = rp.roi_pool_backward_plain(feat, rois, mask, g,
                                     SCALE).float().numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert (ref != 0).sum() > 100
    np.testing.assert_allclose(got, ref, atol=0, rtol=(
        BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_equals_roi_pool_plain(dtype):
    feat, _ = _feat("random_f32", seed=7)
    feat = feat.to(dtype)
    rois, mask = torch.from_numpy(ROIS), torch.from_numpy(MASK)
    out, _ = rp.roi_pool_argmax_plain(feat, rois, mask, SCALE)
    want = rp.roi_pool_plain(feat, rois, mask, SCALE)
    assert out.dtype == dtype
    assert torch.equal(out, want)


def _pallas_grad(feat, g):
    _, vjp = jax.vjp(lambda f: jrp.roi_pool_tpu(f, jnp.asarray(ROIS),
                                                jnp.asarray(MASK), SCALE),
                     jnp.asarray(feat))
    return np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))


@pytest.mark.parametrize("case", ["random_f32", "ties_f32", "ties_bf16"])
def test_composite_gradient_matches_pallas(case, interpret_mode):
    feat, dtype = _feat(case)
    g = (np.random.RandomState(4).uniform(size=(2, 8, 7, 7, 8))
         + 0.1).astype(np.float32)
    g_t = torch.from_numpy(g).to(dtype)
    if dtype == torch.bfloat16:
        want = _pallas_grad(jnp.asarray(feat.float().numpy(), jnp.bfloat16),
                            jnp.asarray(g, jnp.bfloat16))
    else:
        want = _pallas_grad(feat.numpy(), g)
    rois, mask = torch.from_numpy(ROIS), torch.from_numpy(MASK)
    _, codes = rp.roi_pool_argmax_plain(feat, rois, mask, SCALE)
    got = rp.roi_pool_backward_argmax_plain(codes, rois, mask, g_t, SCALE,
                                            (24, 32))
    assert got.dtype == dtype
    got = got.float().numpy()
    np.testing.assert_array_equal(got != 0, want != 0)       # routing
    np.testing.assert_allclose(got, want, atol=0, rtol=(
        BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL))


def test_masked_offmap_and_empty_bins_get_no_cell():
    feat, _ = _feat("random_f32", seed=5)
    rois, mask = torch.from_numpy(ROIS), torch.from_numpy(MASK)
    out, codes = rp.roi_pool_argmax_plain(feat, rois, mask, SCALE)
    none = codes == rp.NO_CELL
    assert none[0, 1].all() and none[1, 7].all()            # masked
    assert none[0, 6].all()                                  # off the map
    # a roi past the map's bottom edge: its lower row bins are empty
    tall = torch.tensor([[[5.0, 5.0, 60.0, 500.0]]])
    _, c_tall = rp.roi_pool_argmax_plain(feat[:1], tall,
                                         torch.ones(1, 1, dtype=torch.bool),
                                         SCALE)
    empty_rows = (c_tall[0, 0] == rp.NO_CELL).all(dim=(1, 2))
    assert empty_rows.any() and not empty_rows.all()
    # codes of -1 route nothing, even with a cotangent everywhere
    d = rp.roi_pool_backward_argmax_plain(
        torch.full_like(codes, rp.NO_CELL), rois, mask,
        torch.ones(codes.shape), SCALE, (24, 32))
    assert not d.any()
    assert (out[none] == 0).all()


def test_code_encoding_is_unsigned_16_bit():
    off = torch.tensor([0, 1, 32767, 32768, 65534, rp.NO_CELL],
                       dtype=torch.int32)
    codes = rp.encode_cells(off)
    assert codes.dtype == torch.int16
    assert rp.decode_cells(codes).tolist() == [0, 1, 32767, 32768, 65534,
                                               0xFFFF]


def test_oversized_map_raises_before_allocating():
    """A bin may span the whole map, so a map of more than 65535 cells
    takes int32 codes: at 256x257 (65,792 cells) codes past 65,535 encode,
    decode and route the plain backward exactly, while a 255x257 map
    (65,535 cells) keeps the int16 codes. Only a map past the kernels'
    2^31 - 1 cells raises, before anything is allocated (meta tensors)."""
    assert rp.code_dtype(255, 257) == torch.int16
    assert rp.code_dtype(256, 257) == torch.int32
    assert rp.code_dtype(200, 336) == torch.int32     # FPN P2 of 800x1344
    h, w, c = 256, 257, 8
    rng = np.random.RandomState(11)
    f = rng.randn(1, h, w, c).astype(np.float32)
    f[0, h - 1, w - 7, :4] = 10.0         # offset 65,785 in a whole-map bin
    feat = torch.from_numpy(f)
    # a roi 7 times the map (its first bin is the whole map), a roi hanging
    # off the map, a small one, a masked one; stride 1
    rois = torch.tensor([[[0.0, 0.0, 7.0 * w - 1, 7.0 * h - 1],
                          [-20.0, -30.0, w - 1.0, h - 1.0],
                          [10.0, 20.0, 40.0, 33.0],
                          [0.0, 0.0, 10.0, 10.0]]])
    mask = torch.tensor([[True, True, True, False]])
    out, codes = rp.roi_pool_argmax(feat, rois, mask, 1.0)
    assert codes.dtype == torch.int32
    assert torch.equal(out, rp.roi_pool_plain(feat, rois, mask, 1.0))
    decoded = rp.decode_cells(codes)
    assert int(decoded[decoded != rp.UNSIGNED_NO_CELL[torch.int32]].max()) \
        > rp.NARROW_MAP_CELLS
    want = _literal_codes(feat, rois.numpy(), mask.numpy(), scale=1.0)
    np.testing.assert_array_equal(
        np.where(decoded.numpy() == 0xFFFFFFFF, -1, decoded.numpy()), want)
    g = torch.rand(codes.shape, generator=torch.Generator().manual_seed(1)) \
        + 0.1
    got = rp.roi_pool_backward(codes, rois, mask, g, 1.0, (h, w))
    ref = rp.roi_pool_backward_plain(feat, rois, mask, g, 1.0)
    assert torch.equal(got != 0, ref != 0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0,
                               rtol=F32_RTOL)
    # past what the kernels address: raises before allocating
    big = torch.empty((1, 46341, 46341, 8), device="meta")
    meta_rois = torch.empty((1, 2, 4), device="meta")
    meta_mask = torch.empty((1, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="P2.*2147483647"):
        rp.roi_pool_argmax(big, meta_rois, meta_mask, SCALE, level="P2")
    with pytest.raises(ValueError, match="2147483647"):
        rp.roi_pool_backward(torch.empty((1, 2, 7, 7, 8), dtype=torch.int32,
                                         device="meta"), meta_rois, meta_mask,
                             torch.empty((1, 2, 7, 7, 8), device="meta"),
                             SCALE, (46341, 46341))


def test_wide_code_encoding_is_int32():
    off = torch.tensor([0, 1, 65535, 65536, 67199, 2 ** 31 - 2, rp.NO_CELL],
                       dtype=torch.int64)
    codes = rp.encode_cells(off, torch.int32)
    assert codes.dtype == torch.int32
    assert rp.decode_cells(codes).tolist() == [0, 1, 65535, 65536, 67199,
                                               2 ** 31 - 2, 0xFFFFFFFF]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_routes_a_wide_map_without_a_flag(dtype):
    """``RoIPoolFunction`` on a 256x260 map saves int32 codes, and its
    gradient equals the map-rescan backward's."""
    rng = np.random.RandomState(12)
    feat = torch.from_numpy(rng.randn(1, 256, 260, 8).astype(
        np.float32)).to(dtype).requires_grad_()
    rois = torch.tensor([[[0.0, 0.0, 2079.0, 2047.0],
                          [400.0, 320.0, 1900.0, 1800.0]]])
    mask = torch.ones(1, 2, dtype=torch.bool)
    out = rp.RoIPoolFunction.apply(feat, rois, mask, SCALE, "P2")
    assert out.grad_fn.saved_tensors[0].dtype == torch.int32
    g = (torch.rand(out.shape, generator=torch.Generator().manual_seed(2))
         + 0.1).to(dtype)
    out.backward(g)
    ref = rp.roi_pool_backward_plain(feat.detach(), rois, mask, g, SCALE)
    assert torch.equal(feat.grad != 0, ref != 0)
    np.testing.assert_allclose(feat.grad.float().numpy(), ref.float().numpy(),
                               atol=0, rtol=(BF16_RTOL if dtype ==
                                             torch.bfloat16 else F32_RTOL))


def test_function_keeps_argmax_only_when_a_gradient_is_needed(monkeypatch):
    calls = []
    real = rp.roi_pool_argmax

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(rp, "roi_pool_argmax", counting)
    feat, _ = _feat("random_f32")
    feat.requires_grad_()
    rois, mask = torch.from_numpy(ROIS), torch.from_numpy(MASK)
    with torch.no_grad():
        out = rp.RoIPoolFunction.apply(feat, rois, mask, SCALE)
    assert out.grad_fn is None and not calls
    out = rp.RoIPoolFunction.apply(feat.detach(), rois, mask, SCALE)
    assert out.grad_fn is None and not calls
    out = rp.RoIPoolFunction.apply(feat, rois, mask, SCALE)
    assert len(calls) == 1
    assert [t.dtype for t in out.grad_fn.saved_tensors] == [
        torch.int16, torch.float32, torch.bool]
    assert torch.equal(out, rp.roi_pool_plain(feat.detach(), rois, mask,
                                              SCALE))


def test_gradcheck_through_the_argmax():
    """f64, distinct values: the backward from the stored argmax is the
    derivative of the forward on a map with bins of several cells."""
    feat = torch.tensor(np.random.RandomState(2).randn(1, 9, 11, 2),
                        dtype=torch.float64, requires_grad=True)
    rois = torch.tensor([[[0.0, 0.0, 87.0, 71.0], [16.0, 8.0, 60.0, 50.0],
                          [-8.0, 4.0, 40.0, 90.0]]])
    mask = torch.tensor([[True, True, True]])
    assert torch.autograd.gradcheck(
        lambda f: rp.RoIPoolFunction.apply(f, rois, mask, SCALE), (feat,))
