"""The port's deformable convolution (v1, v2) and deformable PS-RoI pooling
against the JAX package's, on the CPU.

Same seeded numpy inputs through ``odwscl_tpu.ops.deform_conv`` and
``odwscl_tpu_torch.ops.deform_conv``: offsets of up to several pixels
(taps landing off the map, on the -1 / H borders and between cells),
v2's masks, groups, deformable groups, stride, padding and dilation; the
gradients of a random cotangent's dot product with respect to the input,
the offsets, the masks, the weight and the bias against ``jax.grad``; and
``deform_psroi_pooling`` with and without the part offsets.

Tolerances: outputs and gradients within 1e-5 of their largest magnitude
(f32 reassociation of the contraction and of the gathers' sums). No
sample lands within 1e-4 of a cell edge (where the floor could differ
between the packages' float drift): offsets are drawn as integers plus a
fraction in [0.05, 0.95].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.ops import deform_conv as jdc
from odwscl_tpu_torch.ops import deform_conv as tdc

REL = 1e-5

CASES = {
    # (B, H, W, Cin, Cout, k, stride, pad, dil, groups, dg, v2)
    "v1": (2, 9, 11, 8, 6, 3, 1, 1, 1, 1, 1, False),
    "v2": (2, 9, 11, 8, 6, 3, 1, 1, 1, 1, 1, True),
    "groups": (1, 8, 10, 8, 6, 3, 1, 1, 1, 2, 1, True),
    "deformable_groups": (2, 7, 9, 8, 4, 3, 1, 1, 1, 1, 2, False),
    "stride_dilation": (1, 12, 13, 4, 5, 3, 2, 2, 2, 1, 2, True),
    "k1_no_pad": (1, 6, 7, 6, 3, 1, 1, 0, 1, 3, 3, False),
}


def _inputs(case, seed=0):
    b, h, w, cin, cout, k, s, p, d, g, dg, v2 = CASES[case]
    rng = np.random.RandomState(seed)
    ho = (h + 2 * p - (d * (k - 1) + 1)) // s + 1
    wo = (w + 2 * p - (d * (k - 1) + 1)) // s + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    whole = rng.randint(-4, 4, (b, ho, wo, dg * 2 * k * k))
    frac = rng.uniform(0.05, 0.95, whole.shape)
    offset = (whole + frac).astype(np.float32)
    weight = rng.randn(k, k, cin // g, cout).astype(np.float32) * 0.3
    bias = rng.randn(cout).astype(np.float32)
    mask = (rng.uniform(size=(b, ho, wo, dg * k * k)).astype(np.float32)
            if v2 else None)
    kw = dict(stride=s, padding=p, dilation=d, groups=g,
              deformable_groups=dg)
    return x, offset, weight, bias, mask, kw


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * scale, (err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_deform_conv_matches(case):
    x, offset, weight, bias, mask, kw = _inputs(case)
    want = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(offset),
                             jnp.asarray(weight), jnp.asarray(bias),
                             None if mask is None else jnp.asarray(mask),
                             **kw)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(x=x, offset=offset, weight=weight, bias=bias,
                          mask=mask).items()}
    got = tdc.deform_conv2d(t["x"], t["offset"], t["weight"], t["bias"],
                            t["mask"], **kw)
    assert got.shape == want.shape
    _close(got.numpy(), want)
    if mask is not None:
        mod = tdc.modulated_deform_conv2d(t["x"], t["offset"], t["mask"],
                                          t["weight"], t["bias"], **kw)
        assert torch.equal(mod, got)


@pytest.mark.parametrize("case", ["v1", "v2", "groups", "stride_dilation"])
def test_deform_conv_gradients_match(case):
    x, offset, weight, bias, mask, kw = _inputs(case, seed=1)
    out_shape = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(offset),
                                  jnp.asarray(weight), None,
                                  None if mask is None else jnp.asarray(mask),
                                  **kw).shape
    cot = np.random.RandomState(2).randn(*out_shape).astype(np.float32)
    args = [x, offset, weight, bias] + ([mask] if mask is not None else [])

    def jloss(*a):
        m = a[4] if len(a) > 4 else None
        return jnp.sum(jdc.deform_conv2d(*a[:4], m, **kw) * cot)

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    m = ts[4] if len(ts) > 4 else None
    (tdc.deform_conv2d(*ts[:4], m, **kw) * torch.from_numpy(cot)).sum(
    ).backward()
    for name, t, w in zip(("x", "offset", "weight", "bias", "mask"), ts,
                          want):
        assert t.grad is not None, name
        _close(t.grad.numpy(), w)


@pytest.mark.parametrize("trans", [False, True])
def test_deform_psroi_pooling_matches(trans):
    rng = np.random.RandomState(3)
    out_size, group, oc, part = 3, 3, 4, 3
    feat = rng.randn(16, 20, oc * group * group).astype(np.float32)
    # rois inside, overhanging and tiny; image pixels at stride 1/0.25
    rois = np.float32([[4, 6, 50, 40], [-10, -8, 30, 20], [60, 44, 90, 70],
                       [20, 20, 22, 21], [0, 0, 79, 63]])
    tr = (rng.randn(len(rois), 2, part, part).astype(np.float32)
          if trans else None)
    kw = dict(out_size=out_size, out_channels=oc, no_trans=not trans,
              spatial_scale=0.25, group_size=group, part_size=part,
              sample_per_part=2, trans_std=0.1)
    want = jdc.deform_psroi_pooling(jnp.asarray(feat), jnp.asarray(rois),
                                    None if tr is None else jnp.asarray(tr),
                                    **kw)
    got = tdc.deform_psroi_pooling(torch.from_numpy(feat),
                                   torch.from_numpy(rois),
                                   None if tr is None else torch.from_numpy(
                                       tr), **kw)
    assert got.shape == want.shape == (5, 3, 3, 4)
    _close(got.numpy(), want)
    # gradients with respect to the features and the part offsets
    cot = rng.randn(*want.shape).astype(np.float32)

    def jloss(f, t):
        return jnp.sum(jdc.deform_psroi_pooling(f, jnp.asarray(rois), t,
                                                **kw) * cot)

    jf = jnp.asarray(feat)
    jt = None if tr is None else jnp.asarray(tr)
    gf = jax.grad(jloss)(jf, jt)
    f_t = torch.from_numpy(feat).requires_grad_()
    t_t = None if tr is None else torch.from_numpy(tr).requires_grad_()
    (tdc.deform_psroi_pooling(f_t, torch.from_numpy(rois), t_t, **kw)
     * torch.from_numpy(cot)).sum().backward()
    _close(f_t.grad.numpy(), gf)
    if trans:
        _close(t_t.grad.numpy(), jax.grad(jloss, argnums=1)(jf, jt))
