"""The port's int8 ops (odwscl_tpu_torch/ops/quant.py) against the JAX
package's (odwscl_tpu/ops/quant.py) on the CPU, on the same numpy inputs.

- ``quantize_weights``: codes and scales equal.
- ``conv2d_int8`` in the three activation-scale modes (dynamic, a
  calibrated scalar, calibrated per-channel) at both dilations, and
  ``dense_int8``: the codes equal, the int32 accumulators equal to JAX's
  ``conv_general_dilated`` / ``dot_general`` with
  ``preferred_element_type=int32`` on those codes, and the outputs within
  1 ulp in f32 and 1 bf16 ulp in bf16 (observed: equal). The port's plain
  accumulator is a float64 convolution / product of the codes, exact
  because every partial sum is an integer below 2^53.
- The dead-channel repair (a calibrated channel at exactly 0, ROADMAP
  Queue 3): the live channels' codes, the weight scales and the result
  equal the JAX package's when the serving input is 0 there; a non-zero
  value there passes through within the quantization error in the port,
  where the JAX package gives ~0.

The card's kernel (csrc/conv_int8.cu) is held to the same plain versions,
bit for bit, by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.ops import quant as jq
from odwscl_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _conv_inputs(seed, b=2, h=11, w=13, cin=64, cout=128, spread=1.5):
    rng = np.random.RandomState(seed)
    # post-ReLU activations, channel magnitudes over 10^spread
    x = np.maximum(rng.randn(b, h, w, cin), 0).astype(np.float32)
    x *= np.logspace(0, spread, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)   # HWIO
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, k, bias


def _to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _act_scale(mode, x):
    if mode == "dynamic":
        return None
    if mode == "scalar":                 # a pre-per-channel scales file
        return np.float32(np.abs(x).max() * 0.8)
    return (np.abs(x).max(axis=(0, 1, 2)) * 0.9).astype(np.float32)


def _jax_codes(x, k, act):
    """The JAX conv2d_int8's quantize, step by step (ops/quant.py:85-103)."""
    xf = jnp.asarray(x)
    kernel = jnp.asarray(k)
    if act is not None and np.ndim(act) == 1:
        sa = jnp.maximum(jnp.asarray(act), 1e-12) / 127.0
        kernel = kernel * sa[None, None, :, None]
        xq = jnp.clip(jnp.round(xf / sa), -127, 127).astype(jnp.int8)
        xs = 1.0
    else:
        amax = jnp.max(jnp.abs(xf)) if act is None else jnp.asarray(act)
        xs = jnp.maximum(amax, 1e-12) / 127.0
        xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    ks = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)) / 127.0, 1e-12)
    kq = jnp.clip(jnp.round(kernel / ks), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(kq), np.asarray(xs * ks)


def _jax_acc(xq, kq, dil, pad):
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (1, 1), [(pad, pad), (pad, pad)],
        rhs_dilation=(dil, dil), dimension_numbers=dn,
        preferred_element_type=jnp.int32))


def _ulps(got, want, dtype):
    """Largest distance in units of the last place of ``want``'s dtype."""
    g = torch.from_numpy(np.asarray(got, np.float32)).to(dtype)
    w = torch.from_numpy(np.asarray(want, np.float32)).to(dtype)
    spacing = torch.nextafter(w.abs(), torch.tensor(float("inf"), dtype=dtype)
                              ) - w.abs()
    return ((g.float() - w.float()).abs() / spacing.float()).max().item()


def test_quantize_weights_equal():
    rng = np.random.RandomState(0)
    k = rng.randn(96, 40).astype(np.float32)      # [K, N], JAX layout
    k[:, 3] = 0.0                                 # a column at the floor
    jcodes, jscale = jq.quantize_weights(jnp.asarray(k))
    codes, scale = tq.quantize_weights(torch.from_numpy(k.T.copy()))
    assert codes.dtype == torch.int8 and codes.shape == (40, 96)
    np.testing.assert_array_equal(codes.numpy().T, np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale)[0])


@pytest.mark.parametrize("mode", ["dynamic", "scalar", "channel"])
@pytest.mark.parametrize("dil", [1, 2])
def test_conv2d_int8_matches_jax(mode, dil):
    x, k, bias = _conv_inputs(1 + dil)
    act = _act_scale(mode, x)
    jxq, jkq, jscale = _jax_codes(x, k, act)
    t_act = None if act is None else torch.tensor(act)
    xq, kq, scale = tq.quantize_conv_input(torch.from_numpy(x), _to_oihw(k),
                                           t_act)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(kq.numpy(), jkq.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(scale.numpy(),
                                  np.broadcast_to(jscale, scale.shape))
    # the int32 accumulator: exact
    acc = tq.conv2d_int8_acc_plain(xq, kq, dil, dil)
    want_acc = _jax_acc(jxq, jkq, dil, dil)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert np.abs(want_acc).max() > 2 ** 14      # a real range of sums
    # the whole function, f32 and bf16 outputs
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.conv2d_int8(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), dilation=dil,
            padding=dil, out_dtype=jdt,
            act_scale=None if act is None else jnp.asarray(act)
        ).astype(jnp.float32))
        got = tq.conv2d_int8(torch.from_numpy(x), _to_oihw(k),
                             torch.from_numpy(bias), dil, dil, tdt, t_act)
        assert got.dtype == tdt and got.shape == want.shape
        got = got.float().numpy()
        ulps = _ulps(got, want, tdt)
        print(f"{mode} dil {dil} {tdt}: {ulps} ulp, "
              f"{int((got != want).sum())} values differ")
        assert ulps <= 1.0


def test_conv2d_int8_relu_is_the_cast_then_relu():
    x, k, bias = _conv_inputs(4)
    want = np.maximum(np.asarray(jq.conv2d_int8(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
        out_dtype=jnp.bfloat16).astype(jnp.float32)), 0)
    got = tq.conv2d_int8(torch.from_numpy(x), _to_oihw(k),
                         torch.from_numpy(bias), relu=True)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("rows", [5, 40])
def test_dense_int8_matches_jax(rows):
    rng = np.random.RandomState(6)
    x = rng.randn(rows, 256).astype(np.float32)
    x *= np.logspace(-2, 2, rows)[:, None].astype(np.float32)
    k = rng.randn(256, 64).astype(np.float32)            # [K, N]
    bias = rng.randn(64).astype(np.float32)
    jkq, jks = jq.quantize_weights(jnp.asarray(k))
    xs = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=-1,
                             keepdims=True) / 127.0, 1e-12)
    jxq = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8)
    want_acc = np.asarray(jax.lax.dot_general(
        jxq, jkq, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    kq, _ = tq.quantize_weights(torch.from_numpy(k.T.copy()))
    acc = tq.int_mm(torch.from_numpy(np.asarray(jxq)), kq.t())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.dense_int8(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(bias), jdt
                                        ).astype(jnp.float32))
        got = tq.dense_int8(torch.from_numpy(x), torch.from_numpy(k.T.copy()),
                            torch.from_numpy(bias), tdt)
        assert _ulps(got.float().numpy(), want, tdt) <= 1.0
    # pre-quantized weights give the same result
    wq = tq.quantize_weights(torch.from_numpy(k.T.copy()))
    a = tq.dense_int8(torch.from_numpy(x), torch.from_numpy(k.T.copy()), None,
                      torch.float32)
    b = tq.dense_int8(torch.from_numpy(x), torch.from_numpy(k.T.copy()), None,
                      torch.float32, wq=wq)
    assert torch.equal(a, b)


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the kernel wrappers are the plain versions and count
    no launch."""
    rng = np.random.RandomState(7)
    xq = torch.from_numpy(rng.randint(-127, 128, (1, 9, 7, 64)).astype(np.int8))
    kq = torch.from_numpy(rng.randint(-127, 128, (128, 3, 3, 64)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(128).astype(np.float32) * 1e-4)
    before = (tq.conv_int8_nhwc.launches, tq.conv_int8_acc.launches)
    acc = tq.conv_int8_acc(xq, kq, 2, 2)
    assert torch.equal(acc, tq.conv2d_int8_acc_plain(xq, kq, 2, 2))
    y = tq.conv_int8_nhwc(xq, kq, scale, None, 2, 2, torch.bfloat16, True)
    assert torch.equal(y, tq.dequantize_plain(acc, scale, None,
                                              torch.bfloat16, True))
    assert (tq.conv_int8_nhwc.launches, tq.conv_int8_acc.launches) == before


def test_int_mm_pads_small_row_counts_exactly():
    """``int_mm`` pads to torch._int_mm's 17 rows on CUDA; the padding rows
    are zeros and are sliced off, so a row's result never depends on the
    row count (checked here through the plain path the card is held to)."""
    rng = np.random.RandomState(8)
    a = torch.from_numpy(rng.randint(-127, 128, (40, 64)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (64, 16)).astype(np.int8))
    full = tq.int_mm_plain(a, b)
    padded = torch.nn.functional.pad(a[:3], (0, 0, 0, 14))
    assert torch.equal(tq.int_mm_plain(padded, b)[:3], full[:3])
    assert torch.equal(tq.int_mm(a[:3], b), full[:3])


def test_cuda_tensors_never_take_the_plain_path():
    """A tensor on neither the CPU nor CUDA raises in the kernel wrapper:
    the device decides the path, and nothing falls back."""
    xq = torch.zeros((1, 4, 4, 64), dtype=torch.int8, device="meta")
    kq = torch.zeros((128, 3, 3, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="neither a CPU"):
        tq.conv_int8_acc(xq, kq)
    with pytest.raises(ValueError, match="neither a CPU"):
        tq.conv_int8_nhwc(xq, kq, torch.ones(128))


def test_dead_channel_repair():
    """A calibrated channel at exactly 0: the JAX package scales it by
    ~7.9e-15 and serves any value there as ~0; the port gives it the
    layer's largest abs-max and keeps it out of the weight scales."""
    x, k, bias = _conv_inputs(9, cin=64, cout=128, spread=0.0)
    dead = [5, 17]
    x[..., dead] = 0.0
    amax = np.abs(x).max(axis=(0, 1, 2)).astype(np.float32)
    assert (amax[dead] == 0).all()
    jxq, jkq, jscale = _jax_codes(x, k, amax)
    xq, kq, scale = tq.quantize_conv_input(torch.from_numpy(x), _to_oihw(k),
                                           torch.from_numpy(amax))
    live = np.setdiff1d(np.arange(64), dead)
    # live codes and the weight scales equal JAX's; the inputs' codes too
    np.testing.assert_array_equal(kq.numpy()[..., live],
                                  jkq.transpose(3, 0, 1, 2)[..., live])
    np.testing.assert_array_equal(scale.numpy(), jscale)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    # with 0 in the dead channels, the results are equal
    want = np.asarray(jq.conv2d_int8(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(bias),
                                     out_dtype=jnp.float32,
                                     act_scale=jnp.asarray(amax)))
    got = tq.conv2d_int8(torch.from_numpy(x), _to_oihw(k),
                         torch.from_numpy(bias), 1, 1, torch.float32,
                         torch.from_numpy(amax)).numpy()
    np.testing.assert_array_equal(got, want)
    # a non-zero value served in a dead channel: the port passes it through
    x2 = x.copy()
    x2[..., dead] = np.float32(amax.max() * 0.5)
    exact = np.asarray(jq.conv2d_ref(jnp.asarray(x2), jnp.asarray(k),
                                     jnp.asarray(bias),
                                     out_dtype=jnp.float32))
    without = np.asarray(jq.conv2d_ref(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(bias),
                                       out_dtype=jnp.float32))
    contrib = np.abs(exact - without).max()
    got2 = tq.conv2d_int8(torch.from_numpy(x2), _to_oihw(k),
                          torch.from_numpy(bias), 1, 1, torch.float32,
                          torch.from_numpy(amax)).numpy()
    jax2 = np.asarray(jq.conv2d_int8(jnp.asarray(x2), jnp.asarray(k),
                                     jnp.asarray(bias),
                                     out_dtype=jnp.float32,
                                     act_scale=jnp.asarray(amax)))
    port_err = np.abs(got2 - exact).max()
    jax_err = np.abs(jax2 - exact).max()
    print(f"dead-channel value: its contribution {contrib:.3e}, port error "
          f"{port_err:.3e}, JAX error {jax_err:.3e}")
    # the JAX package drops the dead channels' contribution whole
    assert jax_err > 0.5 * contrib
    # the port keeps it: the error is the quantization error plus the clip
    # of the dead channels' folded weights that exceed the live channels'
    # largest (here 1.3% of them), each at +-127 codes. The same conv
    # calibrated on these inputs errs by 1.3% of the largest output, the
    # port by 5.7% (the clip), a fifth of what JAX drops: bounds 10% and a
    # quarter.
    scale_out = np.abs(exact).max()
    assert port_err < 0.1 * scale_out and port_err < 0.25 * contrib


@pytest.mark.parametrize("mode", ["dynamic", "scalar", "channel"])
def test_conv2d_int8_bf16_input_matches_jax(mode):
    """The serving path's input is bf16: the quantize promotes it to f32
    inside the division, as the JAX package's ``astype(f32)``."""
    x, k, bias = _conv_inputs(10)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    act = _act_scale(mode, np.asarray(xb.astype(jnp.float32)))
    want = np.asarray(jq.conv2d_int8(
        xb, jnp.asarray(k), jnp.asarray(bias), out_dtype=jnp.bfloat16,
        act_scale=None if act is None else jnp.asarray(act)
    ).astype(jnp.float32))
    got = tq.conv2d_int8(torch.from_numpy(x).to(torch.bfloat16), _to_oihw(k),
                         torch.from_numpy(bias), 1, 1, torch.bfloat16,
                         None if act is None else torch.tensor(act))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_tuner_layer_table_is_vgg16s_int8_convs():
    """The int8 layer shapes that tools/tune_conv_int8.py and chip_smoke.py
    time are VGG16-OICR's conv2-conv12 (channels, stride, dilation), and
    the tuner refuses to run without a card."""
    from odwscl_tpu_torch.models.vgg16 import VGGBackbone
    from odwscl_tpu_torch.tools import tune_conv_int8 as tune

    bb = VGGBackbone()
    stride, want = 1, []
    for layer in bb._layers:
        if layer == "M":
            stride *= 2
            continue
        i, dil = layer
        conv = getattr(bb, f"conv{i}")
        if i >= 2:
            want.append((i, stride, conv.in_channels, conv.out_channels, dil))
    assert bb.num_convs == 13
    assert tune.INT8_LAYERS == want
    for cin in (64, 128, 256, 512):
        assert tune.tiles_for(cin)
        assert tq.conv_tile(cin) in tune.tiles_for(cin)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tune.main([])
