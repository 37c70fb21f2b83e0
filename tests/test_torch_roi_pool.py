"""The port's ROIPool (odwscl_tpu_torch/ops/roi_pool.py) against the JAX
package's golden and Pallas kernel, on the CPU.

Tolerance: bit-exact (atol 0, rtol 0) in f32 and bf16. Max pooling
selects one of its inputs and does no arithmetic on them, so every correct
implementation gives the same bits; bin edges are integer arithmetic.

The references are ``roi_pool_numpy`` (the literal CUDA transcription) and
``roi_pool_tpu`` in Pallas interpret mode, patched inside this file only,
as tests/test_roi_pool_pallas.py does. The XLA ``roi_pool`` is not used:
it subsamples rois wider than 32 cells.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against ``roi_pool_plain`` there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odwscl_tpu.ops.roi_pool_pallas as rp_tpu
from odwscl_tpu.ops.roi_pool import roi_pool_numpy
from odwscl_tpu_torch.ops import roi_pool as rp
from odwscl_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

SCALE = 0.125


def _sweep_rois():
    """Small, full-map, malformed, off-map and all-empty rois (stride 8)."""
    return np.array([
        [16.0, 8.0, 100.0, 90.0],        # small
        [40.0, 40.0, 47.9, 47.9],        # one cell
        [3.0, 5.0, 30.0, 100.0],         # fewer columns than bins
        [5.0, 5.0, 230.0, 110.0],        # wide
        [5.0, 5.0, 60.0, 500.0],         # tall, past the bottom edge
        [0.0, 0.0, 255.0, 191.0],        # the full map
        [0.0, 0.0, 1990.0, 1480.0],      # far beyond the map
        [-50.0, -30.0, 100.0, 80.0],     # hangs off the top-left corner
        [130.0, 90.0, 120.0, 80.0],      # malformed (x2 < x1) -> 1x1
        [56.0, 56.0, 56.0, 56.0],        # single cell
        [3000.0, 3000.0, 3100.0, 3100.0],  # off the map: every bin empty
        [8.0, 8.0, 119.0, 119.0],
    ], dtype=np.float32)


def _inputs(seed=0, h=24, w=32, c=8):
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, h, w, c).astype(np.float32)
    rois = _sweep_rois()
    rois = np.stack([rois, rois[::-1].copy()])
    mask = np.ones(rois.shape[:2], bool)
    mask[0, 3] = mask[1, 0] = False
    return feat, rois, mask


def _golden(feat, rois, mask):
    out = np.stack([roi_pool_numpy(feat[b], rois[b], SCALE)
                    for b in range(feat.shape[0])])
    out[~mask] = 0.0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_numpy_golden(dtype):
    feat, rois, mask = _inputs()
    f = torch.from_numpy(feat).to(dtype)
    got = rp.roi_pool_plain(f, torch.from_numpy(rois), torch.from_numpy(mask),
                            SCALE)
    assert got.dtype == dtype and got.shape == (2, 12, 7, 7, 8)
    # the golden on the dtype-rounded values (exact in f32)
    want = _golden(f.float().numpy(), rois, mask)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_plain_size_grid_matches_numpy_golden():
    """Dense sweep of roi extents 1..100 cells on a 104x136 map."""
    rng = np.random.RandomState(1)
    h, w = 104, 136
    feat = rng.randn(1, h, w, 4).astype(np.float32)
    sizes = [1, 2, 3, 7, 9, 15, 16, 17, 33, 64, 100]
    rois = []
    for i, sy in enumerate(sizes):
        sx = sizes[(i * 7 + 3) % len(sizes)]
        y0 = (i * 13) % max(h - sy, 1)
        x0 = (i * 29) % max(w - sx, 1)
        rois.append([x0 * 8.0, y0 * 8.0, (x0 + sx) * 8.0 - 1,
                     (y0 + sy) * 8.0 - 1])
    rois = np.array(rois, np.float32)[None]
    mask = np.ones(rois.shape[:2], bool)
    got = rp.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                      torch.from_numpy(mask), SCALE)
    np.testing.assert_array_equal(got.numpy(), _golden(feat, rois, mask))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(rp_tpu, "_run_fwd",
                        functools.partial(rp_tpu._run_fwd, interpret=True))
    monkeypatch.setattr(rp_tpu, "CHUNK", 2)


def test_plain_matches_pallas_interpret(pallas_interpret):
    feat, rois, mask = _inputs(seed=3, h=24, w=32, c=8)
    rois, mask = rois[:1, :6], mask[:1, :6]
    feat = feat[:1]
    want = np.asarray(rp_tpu.roi_pool_tpu(jnp.asarray(feat), jnp.asarray(rois),
                                          jnp.asarray(mask), SCALE))
    got = rp.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                      torch.from_numpy(mask), SCALE)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_dispatch_does_not_count_launches():
    feat, rois, mask = _inputs()
    before = rp.roi_pool.launches
    rp.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                torch.from_numpy(mask), SCALE)
    assert rp.roi_pool.launches == before


def test_non_cpu_tensor_never_takes_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which refuses what
    is not a CUDA tensor instead of pooling it another way."""
    feat = torch.empty((1, 4, 4, 8), device="meta")
    rois = torch.empty((1, 2, 4), device="meta")
    mask = torch.empty((1, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="neither a CPU tensor"):
        rp.roi_pool(feat, rois, mask, SCALE)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    lib = cuda_build.CudaLibrary("roi_pool_fwd", rp._bind)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.get()
