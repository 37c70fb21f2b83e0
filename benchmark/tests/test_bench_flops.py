"""The FLOP and byte counts of ``benchmark/flops.py``."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness, program

MODULES = ("VGGBackbone", "VGGRoINeck", "SimNet", "MISTPredictor")


def _port(tiny):
    cfg = program.build_cfg(
        harness.load_json(harness.HERE / "configs/voc07_vgg16.json"),
        harness.load_json(harness.HERE / "traffic/train.json"), tiny)
    return cfg, program.build_model(cfg, 3, torch.device("cpu"))


def _batch(b, h, w, p, seed=0):
    from odwscl_tpu_torch.models.detector import Batch

    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, p, 2, generator=g) * torch.tensor([w - 30., h - 30.])
    wh = torch.rand(b, p, 2, generator=g) * 20 + 8
    labels = torch.zeros(b, 21)
    labels[:, 3] = 1
    labels[1, 5] = 1
    return Batch(torch.randn(b, h, w, 3, generator=g) * 50,
                 torch.tensor([[h, w]] * b, dtype=torch.float32),
                 torch.cat([xy, xy + wh], -1), torch.ones(b, p, dtype=bool),
                 labels)


def _counted(fc):
    counts = fc.get_flop_counts()
    return sum(sum(counts[m].values()) for m in MODULES if m in counts)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_train_step_flops_equal_flop_counter(tiny, hw):
    cfg, model = _port(tiny)
    batch = _batch(2, *hw, 32)
    with FlopCounterMode(display=False) as fc:
        losses, _ = model.train_forward(batch, torch.Generator().manual_seed(1))
        torch.stack(list(losses.values())).sum().backward()
    m = program.model_shape(cfg)
    assert _counted(fc) == flops.train_step_flops(m, hw, 2, 32,
                                                  recomputed=True)
    # the bank's recomputed forward is all that the default leaves out
    bank = m["cap_a"] + m["cap_b"]
    d = m["mlp_dim"]
    recompute = 2 * bank * (512 * 49 * d + d * d + d * d + d * 128)
    assert flops.train_step_flops(m, hw, 2, 32) == _counted(fc) - recompute


def test_eval_forward_flops_equal_flop_counter(tiny):
    cfg, model = _port(tiny)
    batch = _batch(2, 64, 96, 32)
    with FlopCounterMode(display=False) as fc:
        model.eval_forward(batch)
    assert _counted(fc) == flops.eval_forward_flops(
        program.model_shape(cfg), (64, 96), 2, 32)


def test_roi_pool_bytes_against_a_literal_count():
    # a 1 x 8 x 8 x 2 map at scale 1; roi A covers rows 0-3 x cols 0-3 (16
    # cells), roi B rows 2-5 x cols 2-5 (16 cells, 4 shared with A), a
    # masked roi C reads nothing: 28 cells of 2 channels of 2 bytes
    rois = torch.tensor([[[0., 0., 3., 3.], [2., 2., 5., 5.],
                          [0., 0., 7., 7.]]])
    mask = torch.tensor([[True, True, False]])
    nbytes, ops = flops.roi_pool_work((1, 8, 8, 2), rois, mask, 1.0, 2, 2)
    out = 3 * 2 * 2 * 2 * 2          # all rois' outputs, 2 bytes each
    assert nbytes == out + 3 + 3 * 4 * 4 + 28 * 2 * 2
    # each roi's 2x2 bins of 2x2 cells: 16 values a channel, 2 channels
    assert ops == 2 * 16 * 2
    nbytes_a, _ = flops.roi_pool_work((1, 8, 8, 2), rois, mask, 1.0, 2, 2,
                                      argmax=True)
    assert nbytes_a == nbytes + 3 * 2 * 2 * 2 * 2    # int16 codes
    assert flops.roi_pool_bwd_bytes((1, 8, 8, 2), rois.shape, 2, 2) == (
        (2 * 128 + 24) * 2 + 3 * 16 + 3)
