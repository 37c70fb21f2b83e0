"""Static int8 serving with the next conv's quantize fused into the
producing conv, and the quantize kernel's (``csrc/quant_int8.cu``) plain
modes, on the CPU.

- The fused static ``VGGBackbone`` (32x32 and 30x34 inputs: the latter
  gives conv3 an odd 15x17 map before its pool; f32 and bf16 compute;
  per-channel scales with a calibrated-dead channel, per-tensor scales, a
  layer of ``int8_bf16_layers``) equals ``unfused_int8_forward``, the chain
  of ``ops/quant.py`` calls with a quantize before each int8 conv, exactly;
  and its layer plan quantizes on its own only the inputs after a float
  layer.
- The quantize modes equal the JAX package's expressions on the same
  arrays exactly: per channel (``odwscl_tpu/ops/quant.py:97``), dynamic
  per tensor (:100-103, floor then divide) and per row (:128-131, divide
  then floor), with exact half-way ties (half to even), values past
  +-127 s, an all-zero tensor and an all-zero row.
- Max-pooling int8 codes equals quantizing the max-pooled values.

No tolerance: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu_torch.models import vgg16
from odwscl_tpu_torch.models.vgg16 import VGGBackbone, unfused_int8_forward
from odwscl_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _backbone(dtype, seed=0, **kw):
    bb = VGGBackbone(compute_dtype=dtype, int8_eval=True, int8_static=True,
                     **kw)
    bb.reset_parameters(torch.Generator().manual_seed(seed))
    return bb


def _images(h, w, seed=1):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(2, h, w, 3).astype(np.float32) * 50)


class _Plan:
    """Counts the backbone's quantize passes and its conv launches by output
    (fused codes, pooled codes, floats)."""

    def __init__(self, monkeypatch):
        self.quantize = 0
        self.codes = self.pooled = self.floats = 0
        quantize, conv = vgg16.quantize_act, vgg16.conv_int8_nhwc

        def count_quantize(*a, **k):
            self.quantize += 1
            return quantize(*a, **k)

        def count_conv(*a, out_scale=None, pool=False, **k):
            if out_scale is None:
                self.floats += 1
            else:
                self.codes += 1
                self.pooled += pool
            return conv(*a, out_scale=out_scale, pool=pool, **k)

        monkeypatch.setattr(vgg16, "quantize_act", count_quantize)
        monkeypatch.setattr(vgg16, "conv_int8_nhwc", count_conv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scales", ["channel", "tensor"])
@pytest.mark.parametrize("hw", [(32, 32), (30, 34)])
def test_fused_static_backbone_equals_unfused_chain(monkeypatch, dtype,
                                                    scales, hw):
    bb = _backbone(dtype)
    img = _images(*hw)
    with torch.no_grad():
        bb(img, fast_eval=True, calibrate=True)
    if scales == "channel":
        # 90% of the calibrated range (the top codes saturate), and one
        # calibrated-dead channel (the repaired scale feeds the epilogue)
        bb.act_amax = {i: v * 0.9 for i, v in bb.act_amax.items()}
        bb.act_amax[7][3] = 0.0
    else:
        bb.act_amax = {i: v.max() * 0.9 for i, v in bb.act_amax.items()}
    want = unfused_int8_forward(bb, img)
    plan = _Plan(monkeypatch)
    with torch.no_grad():
        got = bb(img, fast_eval=True)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all() and got.abs().max() > 0
    assert torch.equal(got, want)
    # conv2's input is the one quantize; conv2-conv11 write the next
    # conv's codes (conv3 and conv6 pooled), conv12 its float features
    assert (plan.quantize, plan.codes, plan.pooled, plan.floats) == (
        1, 10, 2, 1)


@pytest.mark.parametrize("bf16_layers", [(8,), (3,), (2, 12)])
def test_fused_static_backbone_with_float_layers(monkeypatch, bf16_layers):
    """A layer of ``int8_bf16_layers`` breaks the chain: the int8 conv
    before it writes floats, the int8 conv after it quantizes its input on
    its own."""
    bb = _backbone(torch.bfloat16, seed=2, int8_bf16_layers=bf16_layers)
    img = _images(30, 34, seed=3)
    with torch.no_grad():
        bb(img, fast_eval=True, calibrate=True)
    want = unfused_int8_forward(bb, img)
    plan = _Plan(monkeypatch)
    with torch.no_grad():
        got = bb(img, fast_eval=True)
    assert torch.equal(got, want)
    int8 = bb.int8_convs()
    starts = sum(1 for i in int8 if i - 1 not in int8)
    ends = sum(1 for i in int8 if i + 1 not in int8)
    assert plan.quantize == starts
    assert plan.floats == ends
    assert plan.codes == len(int8) - ends


def test_dynamic_backbone_quantizes_every_int8_input(monkeypatch):
    bb = _backbone(torch.float32, seed=4)
    bb.int8_static = False
    plan = _Plan(monkeypatch)
    with torch.no_grad():
        bb(_images(32, 32), fast_eval=True)
    assert (plan.quantize, plan.codes, plan.floats) == (11, 0, 11)


def _bf16(a):
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float())


def _jax_map(x, s):
    xf = jnp.asarray(x, jnp.float32)
    return np.asarray(jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8))


def _tie_inputs(seed):
    """bf16-exact values: exact half-way ties (k + 0.5) s at s = 1/16, values
    past 127 s, random values; the largest magnitude is 127 s = 7.9375, so a
    dynamic scale is exactly 1/16 too."""
    rng = np.random.RandomState(seed)
    s = np.float32(1 / 16)
    ties = (rng.randint(-127, 127, (2, 5, 6, 64)) + 0.5) * s
    x = _bf16(np.where(rng.rand(2, 5, 6, 64) < 0.5, ties,
                       rng.randn(2, 5, 6, 64) * 3))
    x = np.clip(x, -127 * s, 127 * s)
    x[0, 0, 0, 0] = 127 * s
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_modes_match_jax(dtype):
    x = _tie_inputs(0)
    xt = torch.from_numpy(x).to(dtype)
    before = (tq.quantize_act.launches, tq.quantize_rows.launches)
    # per channel, given scales (some far below the values: +-127)
    amax = np.abs(x).max(axis=(0, 1, 2)) * np.linspace(0.05, 1.0, 64)
    amax = amax.astype(np.float32)
    sa = np.maximum(amax, np.float32(1e-12)) / np.float32(127)
    got, xs = tq.quantize_act(xt, torch.from_numpy(sa))
    assert xs is None
    np.testing.assert_array_equal(got.numpy(), _jax_map(x, jnp.asarray(sa)))
    assert (got.numpy() == 127).any() and (got.numpy() == -127).any()
    # per tensor, dynamic: floor, then divide; ties round half to even
    got, xs = tq.quantize_act(xt)
    js = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12) / 127.0
    assert float(xs) == float(js) == 1 / 16
    want = _jax_map(x, js)
    np.testing.assert_array_equal(got.numpy(), want)
    odd = np.abs(x / (1 / 16) - np.round(x / (1 / 16))) == 0.5
    assert odd.sum() > 100 and (want[odd] % 2 == 0).all()
    # a calibrated per-tensor scale past the values
    got, xs = tq.quantize_act(xt, None, torch.tensor(2.0))
    np.testing.assert_array_equal(
        got.numpy(), _jax_map(x, jnp.maximum(jnp.float32(2.0), 1e-12) / 127.0))
    # per row: divide, then floor
    rows = x.reshape(60, 64).copy()
    rows[3] = 0.0
    rows[4] = _bf16(rows[4] * 1e-12)   # max |row| / 127 below the floor
    rt = torch.from_numpy(rows).to(dtype)
    got, xs = tq.quantize_rows(rt)
    jr = jnp.asarray(rows, jnp.float32)
    jxs = jnp.maximum(jnp.max(jnp.abs(jr), axis=-1, keepdims=True) / 127.0,
                      1e-12)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(got.numpy(), _jax_map(rows, jxs))
    assert float(xs[3, 0]) == float(xs[4, 0]) == np.float32(1e-12)
    assert not got[3].any()
    # the conv's order on the same tiny values differs: floor, then divide
    _, xs_t = tq.quantize_act(torch.from_numpy(rows[4:5]).to(dtype))
    assert float(xs_t) == float(jnp.maximum(jnp.max(jnp.abs(jr[4])), 1e-12)
                                / 127.0) < 1e-12
    # an all-zero tensor: every code 0, the scale at its floor
    got, xs = tq.quantize_act(torch.zeros((1, 2, 3, 8), dtype=dtype))
    assert not got.any()
    assert float(xs) == float(jnp.float32(1e-12) / 127.0)
    # the CPU takes the plain versions and launches nothing
    assert (tq.quantize_act.launches, tq.quantize_rows.launches) == before


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)])
def test_pooling_codes_equals_quantizing_pooled_values(hw):
    rng = np.random.RandomState(5)
    y = torch.from_numpy(rng.randn(2, *hw, 16).astype(np.float32) * 4).to(
        torch.bfloat16)
    s = torch.from_numpy(rng.uniform(0.01, 0.05, 16).astype(np.float32))
    codes = tq.quantize_conv_act(y, s)[0]
    pooled = tq.pool_codes(codes)
    want = tq.quantize_conv_act(tq.max_pool_nhwc(y), s)[0]
    assert pooled.shape == (2, hw[0] // 2, hw[1] // 2, 16)
    assert torch.equal(pooled, want)
    assert (pooled.abs() == 127).any()


def test_fused_conv_output_is_the_unfused_chain():
    """``conv_int8_nhwc``'s ``out_scale`` on the CPU: the plain dequantize,
    the ReLU, the optional pool, then the plain quantize."""
    rng = np.random.RandomState(6)
    xq = torch.from_numpy(rng.randint(-127, 128, (1, 9, 7, 64)).astype(
        np.int8))
    kq = torch.from_numpy(rng.randint(-127, 128, (128, 3, 3, 64)).astype(
        np.int8))
    scale = torch.from_numpy(rng.rand(128).astype(np.float32) * 1e-4)
    bias = torch.from_numpy(rng.randn(128).astype(np.float32) * 0.1)
    s_out = torch.from_numpy(rng.uniform(0.002, 0.02, 128).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        y = tq.conv_int8_nhwc(xq, kq, scale, bias, 1, 1, dt, True)
        got = tq.conv_int8_nhwc(xq, kq, scale, bias, 1, 1, dt, True,
                                out_scale=s_out)
        assert torch.equal(got, tq.quantize_conv_act(y, s_out)[0])
        got = tq.conv_int8_nhwc(xq, kq, scale, bias, 1, 1, dt, True,
                                out_scale=s_out, pool=True)
        assert torch.equal(got, tq.pool_codes(tq.quantize_conv_act(
            y, s_out)[0]))
    with pytest.raises(ValueError, match="pools only"):
        tq.conv_int8_nhwc(xq, kq, scale, bias, pool=True)
