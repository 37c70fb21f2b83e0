"""The port's native host library (odwscl_tpu_torch/csrc/host_ops.cpp via
utils/host_ops.py) against the JAX package's native pass
(odwscl_tpu/utils/host_ops.py, its own csrc/host_ops.cpp built with its
Makefile's flags) and the numpy plain versions.

- ``nms``: the same kept indices as the JAX native NMS and ``nms_plain``
  (and the JAX ``nms_numpy``), ties of equal scores included;
- ``iou_plus1``: within 1e-6 of the JAX native matrix (f32; its build may
  contract multiply-adds, the port's does not) and of the float64 numpy
  ``_iou_plus1``;
- ``clean_proposals``: equal to the JAX native pass, with duplicates,
  clipped, tiny and empty boxes and coordinates ending in .5, where the
  numpy plain version (half to even) keeps other duplicates: its hash
  rounds 0.5 to 0 and 1.5 to 2, the native one 0.5 to 1;
- the data path (``data/proposals.py:clean_proposals``) is the native one;
- a failed build raises (no fallback): a missing compiler.
"""

import os
import re
import subprocess

import numpy as np
import pytest

from odwscl_tpu.ops.nms import nms_numpy
from odwscl_tpu.utils import host_ops as jax_ops
from odwscl_tpu_torch.data import proposals
from odwscl_tpu_torch.evaluation.voc_eval import _iou_plus1
from odwscl_tpu_torch.utils import host_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's library, built from its source with its Makefile's
    flags into a directory of this test (so that no other test's build of
    odwscl_tpu/csrc/libhost_ops.so can race with it), loaded by its own
    module."""
    src = os.path.join(REPO, "odwscl_tpu", "csrc")
    with open(os.path.join(src, "Makefile")) as f:
        flags = re.search(r"CXXFLAGS \?= (.*)", f.read()).group(1).split()
    lib = str(tmp_path_factory.mktemp("jax_native") / "libhost_ops.so")
    subprocess.run(["g++", *flags, "-o", lib,
                    os.path.join(src, "host_ops.cpp")], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ops, "_LIB_PATH", lib)
        mp.setattr(jax_ops, "_lib", None)
        mp.setattr(jax_ops, "_tried", False)
        assert jax_ops._load() is not None
        yield


def _boxes(rng, n, lo=5, hi=60):
    x1y1 = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([x1y1, x1y1 + wh], 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 300).astype(np.float32)
    scores = rng.uniform(size=300).astype(np.float32)
    scores[::7] = scores[0]                     # ties keep index order
    for thresh in (0.3, 0.5, 0.7):
        got = host_ops.nms(boxes, scores, thresh)
        assert got == jax_ops.nms(boxes, scores, thresh)
        assert got == host_ops.nms_plain(boxes, scores, thresh)
        assert got == nms_numpy(boxes, scores, thresh)
    assert host_ops.nms(np.zeros((0, 4)), np.zeros(0), 0.5) == []


def test_iou_plus1_matches():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 41), _boxes(rng, 29)
    got = host_ops.iou_plus1(a, b)
    np.testing.assert_allclose(got, jax_ops.iou_plus1(a, b), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got, _iou_plus1(a, b), rtol=0, atol=1e-6)
    assert host_ops.iou_plus1(a, np.zeros((0, 4))).shape == (41, 0)


def _proposals(rng):
    boxes = _boxes(rng, 400)
    boxes[50:70] = boxes[:20]                   # exact duplicates
    boxes[100:110, 2] = boxes[100:110, 0] + 3   # small boxes
    boxes[200:210] += 500                       # off the image: clipped
    boxes[300:305, 2] = boxes[300:305, 0]       # empty
    # coordinates ending in .5: their rounded hashes differ by rounding
    half = np.round(boxes[320:360] * 2) / 2
    half[:, 0] = np.floor(half[:, 0]) + 0.5
    boxes[320:360] = half
    boxes[360:400] = half + np.array([0.6, 0, 0, 0])  # 0.5 vs 1.1 -> 1, 1
    return boxes


@pytest.mark.parametrize("min_size", [0.0, 2.0, 20.0])
def test_clean_proposals_matches_the_jax_native_pass(min_size):
    boxes = _proposals(np.random.RandomState(4))
    got = host_ops.clean_proposals(boxes, 160.0, 140.0, min_size)
    want = jax_ops.clean_proposals(boxes, 160.0, 140.0, min_size)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(proposals.clean_proposals(boxes, 160.0, 140.0,
                                                    min_size), got)
    plain = proposals.clean_proposals_plain(boxes, 160.0, 140.0, min_size)
    # without .5 coordinates the plain version is the same pass
    keep = np.ones(len(boxes), bool)
    keep[320:400] = False
    np.testing.assert_array_equal(
        host_ops.clean_proposals(boxes[keep], 160.0, 140.0, min_size),
        proposals.clean_proposals_plain(boxes[keep], 160.0, 140.0,
                                        min_size))
    # with them the native pass dedups as the JAX one: half away from zero
    if min_size == 0.0:
        assert len(got) != len(plain)


def test_half_coordinates_round_away_from_zero():
    a = np.array([[0.5, 10.0, 20.0, 30.0], [1.4, 10.0, 20.0, 30.0]])
    # native: round(0.5) = 1 = round(1.4): one box; numpy: 0 and 1: two
    assert len(host_ops.clean_proposals(a, 100.0, 100.0, 0.0)) == 1
    assert len(jax_ops.clean_proposals(a, 100.0, 100.0, 0.0)) == 1
    assert len(proposals.clean_proposals_plain(a, 100.0, 100.0, 0.0)) == 2


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(host_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_ops, "library_path",
                        lambda source=None: tmp_path / "libhost_ops-missing.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        host_ops.build()
