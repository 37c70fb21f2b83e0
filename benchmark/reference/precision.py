"""The reference's matrix products in a stated precision.

``f32``: float32 with TF32 off (the reference). ``fp8``: fp8 training as
the card's fp8 recipes run it, one precision below the configurations'
bfloat16, the control that must come out as not correct: each product's
two forward operands rounded to float8 e4m3, and in the backward the
output's gradient rounded to float8 e5m2, each with a per-tensor scale
(its abs-max over the format's largest finite value); the products of
the rounded operands are taken in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 ``dtype`` at a per-tensor scale, in f32."""
    x = x.to(torch.float32)
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def e4m3(x):
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _round(x, torch.float8_e5m2, E5M2_MAX)


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = e4m3(x), e4m3(w)
        ctx.save_for_backward(xq, wq)
        return F.linear(xq, wq, b.to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = e5m2(g)
        dx = gq @ wq
        dw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return dx, dw, gq.reshape(-1, gq.shape[-1]).sum(0)


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dilation):
        xq, wq = e4m3(x), e4m3(w)
        ctx.save_for_backward(xq, wq)
        ctx.dilation = dilation
        return F.conv2d(xq, wq, b.to(torch.float32), padding=dilation,
                        dilation=dilation)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        d = ctx.dilation
        gq = e5m2(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, padding=d,
                                            dilation=d)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, padding=d,
                                             dilation=d)
        db = gq.sum((0, 2, 3)) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def linear(self, x, weight, bias):
        if self.mode == "fp8":
            return _Fp8Linear.apply(x, weight, bias)
        return F.linear(x.to(torch.float32), weight, bias)

    def conv(self, x, weight, bias, dilation: int):
        if self.mode == "fp8":
            return _Fp8Conv.apply(x, weight, bias, dilation)
        return F.conv2d(x.to(torch.float32), weight, bias,
                        padding=dilation, dilation=dilation)


@contextlib.contextmanager
def no_tf32():
    """True float32 products and convolutions on the card."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
