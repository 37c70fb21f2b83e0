"""The reference's own ROIPool against the port's plain versions, and the
reference against the port in float32 on the CPU."""

import pytest
import torch

from benchmark.reference import ops


@pytest.mark.parametrize("trial", range(4))
def test_reference_roi_pool_equals_the_port_plain_version(trial):
    from odwscl_tpu_torch.ops.roi_pool import (roi_pool_backward_plain,
                                               roi_pool_plain)

    g = torch.Generator().manual_seed(trial)
    b, h, w, c, p = 2, 13 + 9 * trial, 17 + 6 * trial, 8, 40
    feat = torch.randn(b, h, w, c, generator=g)
    if trial % 2:
        feat = torch.round(feat * 1.5)           # ties: the first max wins
    xy = torch.rand(b, p, 2, generator=g) * torch.tensor(
        [w * 8. + 40, h * 8. + 40]) - 20         # some hang off the map
    wh = torch.rand(b, p, 2, generator=g) * torch.tensor([w * 10., h * 10.])
    rois = torch.cat([xy, xy + wh], -1)
    rois[0, 0] = torch.tensor([5., 5., 3., 2.])  # malformed: one cell
    mask = torch.rand(b, p, generator=g) > 0.2
    f = feat.clone().requires_grad_(True)
    out = ops.RoIPool.apply(f, rois, mask, 0.125, 7)
    cot = torch.randn(out.shape, generator=g)
    out.backward(cot)
    assert torch.equal(out, roi_pool_plain(feat, rois, mask, 0.125, 7))
    want = roi_pool_backward_plain(feat, rois, mask, cot, 0.125, 7)
    # the same routing; only the order of the f32 sums differs
    assert torch.allclose(f.grad, want, rtol=0, atol=1e-5)
