"""int8 serving: quantized 3x3 convolutions and the quantized fc6/fc7 dense.

Counterpart of ``odwscl_tpu/ops/quant.py`` (``quantize_weights``,
``conv2d_int8``, ``dense_int8``; its ``conv2d_ref``, the plain conv of the
calibration pass, is ``models/vgg16.py``'s own cuDNN conv), with the same
int8 codes and scales on the same inputs:
- weights: per-output-channel symmetric int8, ``s = max|w| / 127`` floored
  at 1e-12; the port's weights are ``nn.Conv2d`` OIHW and ``nn.Linear``
  [out, in], so the abs-max runs over the input axes;
- conv activations: per-tensor symmetric, from the batch's abs-max
  (dynamic) or a calibrated scalar, ``s = max(amax, 1e-12) / 127``; or
  per input channel from a calibrated ``[Cin]`` abs-max, folded exactly into
  the f32 kernel's Cin axis before the weights are quantized;
- dense activations: per row, ``s = max|x_row| / 127`` floored at 1e-12;
- quantize: ``clip(round(x / s), -127, 127)``, a true division and
  round-half-to-even (``torch.round``, as ``jnp.round``);
- dequantize: ``f32(acc) * (xs * ks) + bias`` for the conv (the ``[Cout]``
  product first), ``(f32(acc) * xs[row]) * ks[col] + bias`` for the dense,
  then the cast to the output dtype.

One deliberate difference: a calibrated channel whose abs-max is exactly 0
(dead on the calibration data) gets the layer's largest calibrated
abs-max instead of a scale of ~7.9e-15, and each output channel's weight
scale is taken over the live channels' folded weights only. The JAX package
quantizes any value such a channel later carries to +-127 codes of 7.9e-15
(zero, in effect); the port passes it through within the quantization
error. Where the serving input is 0 in the dead channels, the live codes,
the weight scales and the result equal the JAX package's (``ROADMAP.md``
Queue 3).

The int8 convolution is the hand-written kernel of ``csrc/conv_int8.cu``
(an implicit GEMM on ``wgmma`` + TMA, the dequantize, bias and ReLU fused,
and in static serving the next conv's quantize too: ``conv_int8_nhwc``'s
``out_scale``) for CUDA tensors, and ``conv2d_int8_acc_plain`` (a float64
convolution of the codes: every partial sum is an integer below 2^53, so
it is exact in any order) plus the plain dequantize and quantize for CPU
tensors. The activation quantize that no conv epilogue takes (a conv input
after a float layer, the dynamic per-tensor scale, the dense's rows) is
the hand-written kernel of ``csrc/quant_int8.cu`` (``quantize_act``,
``quantize_rows``) for CUDA tensors and ``quantize_conv_act`` /
``quantize_rows_plain`` for CPU tensors. The dense's int8 product is a
library call, ``torch._int_mm`` (cuBLASLt, int32 accumulate), as the JAX
package leaves it to XLA's ``dot_general``; ``int_mm_plain`` (a float64
product, exact for the same reason) serves the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import CudaLibrary

QMAX = 127.0
SCALE_FLOOR = 1e-12
# torch._int_mm's shape limits on CUDA: more than 16 rows, K and N
# multiples of 8
INT_MM_MIN_ROWS = 17


def _quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s), -127, 127)`` as int8, with x bf16 or f32 and s
    an f32 tensor: the division promotes x to f32 (exact) inside one pass
    (a 0-d s is viewed as [1] so that it takes part in the promotion)."""
    q = x / (s if s.dim() else s.reshape(1))
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8)


def over_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division on every device, as XLA and the
    kernels divide: CUDA's ``tensor / python float`` multiplies by the
    float's reciprocal instead, which can be an ulp off."""
    return t / torch.full((), QMAX, dtype=t.dtype, device=t.device)


def per_tensor_scale(amax: torch.Tensor) -> torch.Tensor:
    """A conv's per-tensor activation scale, ``max(amax, 1e-12) / 127``
    (floor, then divide)."""
    return over_qmax(torch.clamp(amax.to(torch.float32), min=SCALE_FLOOR))


def quantize_weights(weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear`` weight [N, K] f32 -> (codes int8 [N, K], scales f32
    [N]): the JAX ``quantize_weights`` of the kernel ``weight.T``."""
    w = weight.to(torch.float32)
    s = torch.clamp(over_qmax(w.abs().amax(dim=1)), min=SCALE_FLOOR)
    return _quantize(w, s[:, None]), s


def channel_scales(act_amax: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrated per-input-channel abs-maxes [Cin] -> (activation scales
    [Cin], live-channel mask [Cin]). A channel at exactly 0 is dead and
    takes the layer's largest abs-max (the module docstring); a layer with
    every channel at 0 counts every channel as live and is left as it is.
    No host sync."""
    amax = act_amax.to(torch.float32)
    top = amax.max()
    live = (amax != 0) | (top == 0)
    amax = torch.where(live, amax, top)
    return per_tensor_scale(amax), live


def quantize_conv_weights(weight: torch.Tensor,
                          live: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW f32 kernel (already folded by the channel scales, if any) ->
    (codes int8 packed [Cout, 3, 3, Cin], scales f32 [Cout]); ``live``
    [Cin] restricts each output channel's abs-max to the live channels."""
    w = weight.to(torch.float32)
    wl = w if live is None else torch.where(live[None, :, None, None], w, 0.0)
    ks = torch.clamp(over_qmax(wl.abs().amax(dim=(1, 2, 3))),
                     min=SCALE_FLOOR)
    kq = _quantize(w, ks[:, None, None, None])
    return kq.permute(0, 2, 3, 1).contiguous(), ks


def conv_weight_codes(weight: torch.Tensor,
                      act_scale: Optional[torch.Tensor] = None):
    """The weight side of one int8 conv's quantize, which depends on the
    weights and the calibrated scales only (a serving model can keep it):
    weight OIHW f32 -> (codes int8 [Cout, 3, 3, Cin], ks f32 [Cout], the
    per-channel activation scales [Cin] folded into them, or None)."""
    if act_scale is not None and act_scale.dim() == 1:
        sa, live = channel_scales(act_scale.to(weight.device))
        kq, ks = quantize_conv_weights(weight.to(torch.float32)
                                       * sa[None, :, None, None], live)
        return kq, ks, sa
    kq, ks = quantize_conv_weights(weight)
    return kq, ks, None


def quantize_conv_act(x: torch.Tensor, sa: Optional[torch.Tensor] = None,
                      act_scale: Optional[torch.Tensor] = None):
    """The activation side: x NHWC float -> (codes int8 NHWC, the per-tensor
    scale xs, or None with per-channel scales ``sa``). ``act_scale`` None
    is dynamic (the batch's abs-max), a 0-d tensor a calibrated abs-max."""
    if sa is not None:
        return _quantize(x, sa).contiguous(), None
    if act_scale is None:
        lo, hi = torch.aminmax(x)
        amax = torch.maximum(-lo, hi).to(torch.float32)
    else:
        amax = act_scale.to(device=x.device, dtype=torch.float32)
    xs = per_tensor_scale(amax)
    return _quantize(x, xs).contiguous(), xs


def quantize_conv_input(x: torch.Tensor, weight: torch.Tensor,
                        act_scale: Optional[torch.Tensor] = None):
    """The whole quantize before one int8 conv: x NHWC float, weight OIHW
    f32, ``act_scale`` None (dynamic per-tensor), a 0-d calibrated abs-max
    or a [Cin] calibrated abs-max. Returns (x codes int8 NHWC, kernel codes
    int8 [Cout, 3, 3, Cin], dequantize scale f32 [Cout] = xs * ks)."""
    kq, ks, sa = conv_weight_codes(weight, act_scale)
    xq, xs = quantize_conv_act(x, sa, act_scale)
    return xq, kq, ks if xs is None else xs * ks


def conv2d_int8_acc_plain(xq: torch.Tensor, kq: torch.Tensor,
                          dilation: int = 1, padding: int = 1
                          ) -> torch.Tensor:
    """int32 accumulator NHWC [B, Ho, Wo, Cout] of the codes xq NHWC int8
    and kq [Cout, 3, 3, Cin] int8: a float64 convolution, exact."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64).contiguous(),
                   kq.permute(0, 3, 1, 2).to(torch.float64).contiguous(),
                   padding=padding, dilation=dilation)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def max_pool_nhwc(y: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC floats, floor mode: the backbone's ``M``."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def pool_codes(q: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC int8 codes, floor mode (an odd H or W loses its
    last row or column, as ``max_pool2d``'s): ``amax`` over a [B, H/2, 2,
    W/2, 2, C] view, since CUDA's ``max_pool2d`` takes no int8. The scales
    are positive and ``clip(rint(. / s))`` is monotone, so it equals the
    codes of the pooled values."""
    b, h, w, c = q.shape
    q = q[:, :h // 2 * 2, :w // 2 * 2]
    return q.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def quantize_rows_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense's activation quantize: x [N, K] float -> (codes int8,
    per-row scales f32 [N, 1]), ``s = max(max|x_row| / 127, 1e-12)``
    (divide, then floor)."""
    xf = x.to(torch.float32)
    xs = torch.clamp(over_qmax(xf.abs().amax(dim=-1, keepdim=True)),
                     min=SCALE_FLOOR)
    return _quantize(xf, xs), xs


def dequantize_plain(acc: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor], out_dtype,
                     relu: bool = False) -> torch.Tensor:
    """``out_dtype((f32(acc) * scale) + bias)``, then the ReLU, over the
    last axis: the kernel's epilogue."""
    y = acc.to(torch.float32) * scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = y.to(out_dtype)
    return F.relu(y) if relu else y


def _bind(lib: ctypes.CDLL) -> None:
    # (x, w, scale, bias, out_scale, out, out_kind, relu, round_bf16, B, H,
    # W, Cin, Cout, dil, pad, tile, stream)
    lib.conv_int8.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    lib.conv_int8.restype = ctypes.c_int


def _bind_quant(lib: ctypes.CDLL) -> None:
    # (x, x_bf16, n, C, scale, amax, xs, out, stream)
    lib.quant_int8_map.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_void_p] * 5
    # (x, x_bf16, n, amax, stream)
    lib.quant_int8_absmax.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p]
    # (x, x_bf16, rows, K, out, xs, stream)
    lib.quant_int8_rows.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    for fn in (lib.quant_int8_map, lib.quant_int8_absmax,
               lib.quant_int8_rows):
        fn.restype = ctypes.c_int


CONV_KERNEL = CudaLibrary("conv_int8", _bind)
QUANT_KERNEL = CudaLibrary("quant_int8", _bind_quant)
# the conv kernel's block tiles (csrc/conv_int8.cu), output pixels x output
# channels: "wg" the wgmma + TMA main loop (spatial blocks of 8 x 16 or
# 16 x 16 pixels), else mma.sync ("k128" for 128 input channels a stage,
# else 64), kept for the timing beside it
CONV_TILES = {"256x128": 0, "128x128k128": 1, "wg128x128": 2,
              "wg256x128": 3}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_CODES = 3


def tile_fits(tile: str, cin: int, cout: int) -> bool:
    """Whether the tile takes Cin input and Cout output channels."""
    step = 128 if tile.endswith("k128") else 64
    return cin % step == 0 and cout % 128 == 0


def conv_tile(cin: int, cout: int, codes: bool = False) -> str:
    """The tile for a Cin -> Cout conv writing floats, or the next conv's
    codes: 16 x 16 pixels, but 8 x 16 for codes at Cin 64 (conv2), whose
    epilogue is most of its time and has the registers there to overlap
    its quantize (tools/tune_conv_int8.py at the VGG16 int8 layers of the
    1200 scale)."""
    return "wg128x128" if codes and cin < 128 else "wg256x128"


def _conv_geometry(xq, kq, dilation, padding):
    """Check the kernel's operands; returns (B, H, W, Cin, Cout, Ho, Wo)."""
    if xq.device.type != "cuda":
        raise ValueError(f"conv_int8: x on {xq.device} is neither a CPU "
                         "tensor (plain path) nor a CUDA tensor (kernel)")
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError("conv_int8 kernel takes int8 codes")
    if xq.dim() != 4 or kq.dim() != 4 or tuple(kq.shape[1:3]) != (3, 3):
        raise ValueError("conv_int8 kernel takes x [B, H, W, Cin] and w "
                         "[Cout, 3, 3, Cin]")
    b, h, w, cin = xq.shape
    cout = kq.shape[0]
    if kq.shape[3] != cin or cin % 64 or cout % 128:
        raise ValueError(f"conv_int8 kernel takes Cin a multiple of 64 and "
                         f"Cout of 128 (Cin {cin}, w {tuple(kq.shape)})")
    if dilation not in (1, 2) or padding not in (1, 2):
        raise ValueError(f"conv_int8 kernel takes dilation and padding 1 or "
                         f"2, not {dilation}, {padding}")
    ho, wo = h + 2 * padding - 2 * dilation, w + 2 * padding - 2 * dilation
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_int8: empty output for a {h}x{w} map")
    for t in (xq, kq):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != xq.device:
            raise ValueError("conv_int8 kernel takes contiguous, 16-byte "
                             "aligned codes on one device")
    return b, h, w, cin, cout, ho, wo


def _tile_index(tile: Optional[str], cin: int, cout: int,
                codes: bool) -> int:
    tile = conv_tile(cin, cout, codes) if tile is None else tile
    if not tile_fits(tile, cin, cout):
        raise ValueError(f"conv_int8 tile {tile} does not take Cin {cin}, "
                         f"Cout {cout}")
    return CONV_TILES[tile]


def _check_raised(err: int, name: str = "conv_int8") -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _f32(t: torch.Tensor, device, n: int, what: str) -> torch.Tensor:
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.shape != (n,):
        raise ValueError(f"int8 kernels: {what} must be [{n}], not "
                         f"{tuple(t.shape)}")
    return t


def _launch_conv(xq, kq, dilation, padding, tile, out_dtype, scale=None,
                 bias=None, out_scale=None, relu=False):
    """One launch of the conv kernel; returns its output."""
    b, h, w, cin, cout, ho, wo = _conv_geometry(xq, kq, dilation, padding)
    ptrs = [0, 0, 0]
    if out_dtype != torch.int32:
        scale = _f32(scale, xq.device, cout, "scale")
        bias = (torch.zeros_like(scale) if bias is None
                else _f32(bias, xq.device, cout, "bias"))
        ptrs = [scale.data_ptr(), bias.data_ptr(), 0]
    kind = _OUT_KIND[out_dtype]
    if out_scale is not None:   # the scales and their reciprocals
        out_scale = _f32(out_scale, xq.device, cout, "out_scale")
        out_scale = torch.stack((out_scale, out_scale.reciprocal()))
        ptrs[2], kind = out_scale.data_ptr(), _CODES
    out = torch.empty((b, ho, wo, cout), device=xq.device,
                      dtype=torch.int8 if kind == _CODES else out_dtype)
    lib = CONV_KERNEL.get()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        _check_raised(lib.conv_int8(
            xq.data_ptr(), kq.data_ptr(), *ptrs, out.data_ptr(), kind,
            int(relu), int(out_dtype == torch.bfloat16), b, h, w, cin, cout,
            dilation, padding, _tile_index(tile, cin, cout, kind == _CODES),
            stream))
    return out


def conv_int8_acc(xq: torch.Tensor, kq: torch.Tensor, dilation: int = 1,
                  padding: int = 1, tile: Optional[str] = None
                  ) -> torch.Tensor:
    """The int32 accumulator of the int8 conv (the kernel's ``ACC`` output
    on CUDA, ``conv2d_int8_acc_plain`` on the CPU). Each launch adds one to
    ``conv_int8_acc.launches``."""
    if xq.device.type == "cpu":
        return conv2d_int8_acc_plain(xq, kq, dilation, padding)
    out = _launch_conv(xq, kq, dilation, padding, tile, torch.int32)
    conv_int8_acc.launches += 1
    return out


conv_int8_acc.launches = 0


def conv_int8_nhwc(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, dilation: int = 1,
                   padding: int = 1, out_dtype=torch.bfloat16,
                   relu: bool = False, tile: Optional[str] = None,
                   out_scale: Optional[torch.Tensor] = None,
                   pool: bool = False) -> torch.Tensor:
    """The int8 3x3 conv with its dequantize: codes xq NHWC int8 [B, H, W,
    Cin], kq [Cout, 3, 3, Cin] int8, f32 ``scale`` [Cout] (= xs * ks) and
    ``bias`` [Cout] -> NHWC [B, Ho, Wo, Cout] in ``out_dtype`` (bf16 or f32),
    ReLU'd if ``relu``.

    ``out_scale`` [Cout] (static serving): the output is instead the next
    conv's int8 codes of that value, ``_quantize(y, out_scale)``, and
    ``pool`` then max-pools them 2x2 (the ``M`` between two convs; exact,
    see ``pool_codes``).

    CPU tensors take the plain versions (the pool on the floats, before the
    quantize, as the JAX package orders them). CUDA tensors launch
    ``csrc/conv_int8.cu`` (Cin a multiple of 64, Cout of 128, dilation and
    padding 1 or 2, any H and W; ``tile``, a key of ``CONV_TILES``, by
    default ``conv_tile``'s) on the current stream or raise; each launch
    adds one to ``conv_int8_nhwc.launches``."""
    if pool and out_scale is None:
        raise ValueError("conv_int8_nhwc pools only the int8 codes")
    if xq.device.type == "cpu":
        y = dequantize_plain(conv2d_int8_acc_plain(xq, kq, dilation, padding),
                             scale, bias, out_dtype, relu)
        if out_scale is None:
            return y
        return quantize_conv_act(max_pool_nhwc(y) if pool else y,
                                 out_scale)[0]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_int8 kernel writes bf16 or f32, not "
                        f"{out_dtype}")
    out = _launch_conv(xq, kq, dilation, padding, tile, out_dtype, scale,
                       bias, out_scale, relu)
    conv_int8_nhwc.launches += 1
    return pool_codes(out) if pool else out


conv_int8_nhwc.launches = 0


def _quant_operand(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"quant_int8: x on {x.device} is neither a CPU "
                         "tensor (plain path) nor a CUDA tensor (kernel)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant_int8 kernel takes bf16 or f32, not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quant_int8 kernel takes contiguous, 16-byte "
                         "aligned values")


def quantize_act(x: torch.Tensor, sa: Optional[torch.Tensor] = None,
                 act_scale: Optional[torch.Tensor] = None):
    """A conv's activation quantize, as ``quantize_conv_act`` (which CPU
    tensors take): x NHWC float -> (codes int8 NHWC, the per-tensor scale
    xs, or None with per-channel scales ``sa`` [C]); ``act_scale`` None is
    dynamic (an abs-max pass, then the map), a 0-d tensor a calibrated
    abs-max. CUDA tensors launch ``csrc/quant_int8.cu`` (C a multiple of 8
    with ``sa``) on the current stream or raise; each kernel launched adds
    one to ``quantize_act.launches``."""
    if x.device.type == "cpu":
        return quantize_conv_act(x, sa, act_scale)
    _quant_operand(x)
    dev = x.device
    out = torch.empty(x.shape, dtype=torch.int8, device=dev)
    lib = QUANT_KERNEL.get()
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sa is not None:
            sa = _f32(sa, dev, x.shape[-1], "sa")
            args, xs, n = (x.shape[-1], sa.data_ptr(), None, None), None, 1
        elif act_scale is not None:
            xs = per_tensor_scale(act_scale.to(dev))
            args, n = (0, xs.data_ptr(), None, None), 1
        else:
            amax = torch.empty((), dtype=torch.float32, device=dev)
            xs = torch.empty((), dtype=torch.float32, device=dev)
            _check_raised(lib.quant_int8_absmax(x.data_ptr(), bf16, x.numel(),
                                                amax.data_ptr(), stream),
                          "quant_int8")
            args, n = (0, None, amax.data_ptr(), xs.data_ptr()), 2
        _check_raised(lib.quant_int8_map(x.data_ptr(), bf16, x.numel(), *args,
                                         out.data_ptr(), stream), "quant_int8")
    quantize_act.launches += n
    return out, xs


quantize_act.launches = 0


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense's per-row activation quantize, as ``quantize_rows_plain``
    (which CPU tensors take): x [N, K] float -> (codes int8 [N, K], scales
    f32 [N, 1]). CUDA tensors launch ``csrc/quant_int8.cu`` (one block a
    row, K a multiple of 8) on the current stream or raise; each launch
    adds one to ``quantize_rows.launches``."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    _quant_operand(x)
    if x.dim() != 2:
        raise ValueError(f"quant_int8 rows take x [N, K], not "
                         f"{tuple(x.shape)}")
    n, k = x.shape
    out = torch.empty((n, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = QUANT_KERNEL.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_raised(lib.quant_int8_rows(
            x.data_ptr(), int(x.dtype == torch.bfloat16), n, k,
            out.data_ptr(), xs.data_ptr(), stream), "quant_int8")
    quantize_rows.launches += 1
    return out, xs


quantize_rows.launches = 0


def conv2d_int8(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, dilation: int = 1,
                padding: int = 1, out_dtype=torch.bfloat16,
                act_scale: Optional[torch.Tensor] = None,
                relu: bool = False, wq=None) -> torch.Tensor:
    """3x3 conv with int8 math (eval/serving only): x NHWC [B, H, W, Cin]
    float, weight OIHW f32, bias [Cout] -> NHWC in ``out_dtype``.

    ``act_scale``: None quantizes x by its own abs-max (dynamic); a 0-d
    tensor is a calibrated abs-max (a scales file from before per-channel
    scales); a [Cin] tensor the calibrated per-channel abs-maxes, folded
    into the kernel. ``relu`` applies the ReLU after the cast (fused in
    the kernel; the JAX package applies it outside). ``wq`` optionally
    supplies ``conv_weight_codes(weight, act_scale)``."""
    kq, ks, sa = conv_weight_codes(weight, act_scale) if wq is None else wq
    xq, xs = quantize_act(x, sa, act_scale)
    return conv_int8_nhwc(xq, kq, ks if xs is None else xs * ks, bias,
                          dilation, padding, out_dtype, relu)


def int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], as a float64 product:
    every partial sum is an integer below 2^53, so it is exact."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32: ``int_mm_plain`` on the CPU,
    ``torch._int_mm`` on CUDA (K and N multiples of 8; up to 16 rows are
    padded with zero rows to its minimum of 17, which changes no row)."""
    if a.device.type == "cpu":
        return int_mm_plain(a, b)
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(a, b)[:m]


def dense_int8(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], out_dtype=torch.bfloat16,
               wq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """``x @ weight.T + bias`` with int8 math: x [N, K] (any float dtype),
    weight [out, K] f32 (``nn.Linear``); ``wq`` optionally the codes and
    scales of ``quantize_weights(weight)``. Per-row activation scales
    (``quantize_rows``)."""
    kq, ks = quantize_weights(weight) if wq is None else wq
    xq, xs = quantize_rows(x)
    acc = int_mm(xq, kq.t())
    y = acc.to(torch.float32) * xs * ks
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)
