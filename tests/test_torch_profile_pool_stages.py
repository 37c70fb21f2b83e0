"""The stage profiler's entry point (odwscl_tpu_torch/tools/
profile_pool_stages.py) on the CPU: a run of the plain versions at a tiny
shape, the work counts behind its bounds, and its refusal to fall back to
the CPU when the card it asks for by default is missing. No tolerance
applies: the checks are exact counts and printed lines.
"""

import json

import numpy as np
import pytest
import torch

from odwscl_tpu_torch.ops import roi_pool_stages as rs
from odwscl_tpu_torch.tools import profile_pool_stages as pps


def test_cpu_run_prints_one_plain_line_per_stage(capsys):
    before = dict(rs.roi_pool_stage.launches)
    result = pps.main(["--device", "cpu", "--shape", "2", "24", "40", "8",
                       "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rs.roi_pool_stage.launches == before
    for stage in rs.STAGES:
        (line,) = [ln for ln in lines if ln.split()[0] == stage]
        assert "plain (cpu)" in line and line.endswith(" ms")
    assert json.loads(lines[-1]) == result
    assert result["device"] == "cpu" and result["shape"] == [2, 24, 40, 8, 16]
    assert set(result["plain_cpu_ms"]) == set(pps.NAMES)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pps.main(["--shape", "1", "8", "8", "8", "2"])


def test_inputs_match_the_tpu_tool_draws():
    feat, rois, mask = pps.make_inputs(2, 8, 16, 4, 5)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(feat, rng.randn(2, 8, 16, 4).astype(
        np.float32))
    x1y1 = rng.uniform(0, 1000, (2, 5, 2))
    wh = rng.uniform(16, 300, (2, 5, 2))
    np.testing.assert_array_equal(rois[..., :2], x1y1.astype(np.float32))
    np.testing.assert_array_equal(rois[..., 2:], np.minimum(
        x1y1 + wh, [1332, 799]).astype(np.float32))
    assert mask.all()


def test_stage_work_counts():
    """Bytes and comparisons at the bench widths on three live rois
    (counted by hand from the integer bin edges): the output once, the
    rois and mask once, and each map cell the stage needs once (none for
    write), far fewer than the whole map here; masked rois read nothing."""
    b, h, w, c = 2, 104, 168, 512
    feat = torch.zeros((b, h, w, c), dtype=torch.bfloat16)
    rois = torch.tensor([[[0.0, 0.0, 55.0, 55.0],     # cells [0, 8)^2
                          [8.0, 16.0, 63.0, 47.0]],   # rows [2, 7), cols [1, 9)
                         [[0.0, 0.0, 7.0, 7.0],       # cells [0, 2)^2
                          [0.0, 0.0, 7.0, 7.0]]])     # masked
    mask = torch.tensor([[True, True], [True, False]])
    out, small = b * 2 * 49 * c * 2, 16 * 4 + 4

    def work(name):
        return rs.stage_work(name, feat, rois, mask, 0.125)

    def cells(n):
        return out + small + n * c * 2

    # every roi's window starts at column 0; bins' row extents sum to 14,
    # 11 and 8 cells, column extents to 14, 14 and 8. Cells read: image 0
    # 64 + 5 (column 8 of the second roi), image 1 4 (full); rows 0..7 and
    # 0..1 of columns 0..7 (rows) or column 0 (rows_col0); rows 0..6 of
    # columns 0..8 and 0..1 (cols)
    assert work("write") == (out + 4, 0)
    full = (cells(69 + 4), (14 * 14 + 11 * 14 + 8 * 8) * c)
    assert work("full") == full
    assert work("roi_pool") == full
    assert work("rows") == (cells(64 + 16), (14 + 11 + 8) * 8 * c)
    assert work("rows_col0") == (cells(8 + 2), (14 + 11 + 8) * c)
    assert work("cols") == (cells(7 * 9 + 7 * 2), 7 * (14 + 14 + 8) * c)
    assert full[0] < out + small + feat.numel() * 2


def test_cells_covered_counts_the_union_of_rectangles():
    """The difference-array count against a painted mask, on rectangles
    that overlap, are empty, malformed or partly off the map."""
    g = torch.Generator().manual_seed(0)
    b, h, w, n = 2, 9, 11, 6
    for _ in range(20):
        img = torch.randint(0, b, (n,), generator=g)
        r0 = torch.randint(-2, h + 2, (n,), generator=g)
        c0 = torch.randint(-2, w + 2, (n,), generator=g)
        r1 = r0 + torch.randint(-1, 6, (n,), generator=g)
        c1 = c0 + torch.randint(-1, 6, (n,), generator=g)
        painted = torch.zeros((b, h, w), dtype=torch.bool)
        for i in range(n):
            painted[img[i], max(int(r0[i]), 0):max(int(r1[i]), 0),
                    max(int(c0[i]), 0):max(int(c1[i]), 0)] = True
        assert rs._cells_covered(b, h, w, img, r0, r1, c0,
                                 c1) == int(painted.sum())
