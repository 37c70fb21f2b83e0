"""The pooler configurations' ops on the CPU: ROIPool at any resolution R,
its CUDA wrappers' cap, the stage bound at R, the necks at r*r*C through
the weight bridge, and the config keys.

- ``roi_pool_plain`` at R in {1, 2, 3, 5, 6, 8, 14, 16} against the JAX
  package's XLA pooler (``odwscl_tpu/ops/roi_pool.py:roi_pool``, the one
  it runs for every R but 7 on any device), f32 and bf16: exact, with
  every roi within its ``POOLER_WIN`` of 32 cells (wider rois are a
  documented difference, ROADMAP Queue 3). A malformed roi (x2 < x1) is
  the other difference: the XLA pooler pools nothing from it (its window
  is empty), the port forces it to its 1x1 cell as the Pallas kernel and
  the reference CUDA ROIPool do (ROADMAP Queue 3); it is masked in the
  comparison and checked on its own.
- ``roi_pool_argmax_plain``'s codes at those R against a literal numpy
  scan of every bin (numpy's argmax over a bin flattened row-major returns
  the first maximum), and the backward from them
  (``roi_pool_backward_argmax_plain``) against the map-rescan
  ``roi_pool_backward_plain``, in f32, f32 with ties and bf16 with ties.
- ``RoIPoolFunction`` at R = 14: its saved R reaches the backward.
- The CUDA wrappers on meta tensors: R = 17 raises a ValueError that
  names the cap of 16 before any launch; R = 14 goes to the kernel
  wrapper (which refuses a tensor that is not on the card), never to the
  plain version.
- ``stage_work`` counts the R x R output; the stages refuse R != 7.
- The tensor-parallel neck on 14x14 rows (2 ``gloo`` processes) against
  the JAX one and numpy (tests/test_torch_tp.py's bound, 2e-5).
- The VGG16 neck (float and int8 fc6) and the R-18-C5 neck at R = 14 (fc6
  over 14 * 14 * 512) through ``utils/from_jax.py`` both ways, against the
  JAX modules; ``detector_from_cfg`` reads the pooler keys.

Tolerances: pooled outputs and codes exact (max selects an input; codes
are integers). Gradients: routing exact; values within 1e-6 relative in
f32 and 2^-8 in bf16 (tests/test_torch_roi_pool_bwd.py's). Necks: the
int8 path exact, the float path 1e-5 relative, 1e-6 absolute (as
tests/test_torch_int8_eval.py); the bridge round trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models.resnet import ResNetRoINeck as JResNetRoINeck
from odwscl_tpu.models.vgg16 import VGGRoINeck as JVGGRoINeck
from odwscl_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.models.detector import detector_from_cfg
from odwscl_tpu_torch.models.resnet import ResNetRoINeck
from odwscl_tpu_torch.models.vgg16 import VGGRoINeck
from odwscl_tpu_torch.ops import roi_pool as rp
from odwscl_tpu_torch.ops import roi_pool_stages as rs
from odwscl_tpu_torch.utils.from_jax import (jax_params_from_state_dict,
                                             state_dict_from_jax)

torch.set_num_threads(2)

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
SCALE = 0.125
RESOLUTIONS = (1, 2, 3, 5, 6, 8, 14, 16)
H, W, C = 24, 40, 8


def _rois(seed=0, p=12):
    """[2, P, 4] rois on the H x W map at 1/8: random ones of 1 to 32
    cells, one the width of the pooler window (32 cells), one narrower than
    any bin grid (2 cells), a malformed one, one hanging off the map, one
    off it, one cell; and the mask with two rois masked."""
    rng = np.random.RandomState(seed)
    x1y1 = rng.uniform(-16, 8 * W, (2, p, 2))
    wh = rng.uniform(0, 8 * 30, (2, p, 2))
    rois = np.concatenate([x1y1, x1y1 + wh], -1)
    rois[0, :6] = [[0, 0, 247, 191], [40, 40, 55, 55], [130, 90, 120, 80],
                   [-40, -40, 50, 60], [3000, 3000, 3100, 3100],
                   [56, 56, 56, 56]]
    mask = np.ones((2, p), bool)
    mask[0, 7] = mask[1, 3] = False
    return rois.astype(np.float32), mask


def _feat(case, seed=3):
    feat = np.random.RandomState(seed).randn(2, H, W, C).astype(np.float32)
    if case != "random_f32":
        # a handful of values: exact ties inside nearly every bin
        feat = np.round(feat * 1.5).astype(np.float32)
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    return torch.from_numpy(feat).to(dtype), dtype


def _literal_codes(feat, rois, mask, r, scale=SCALE):
    """The first row-major maximum of every bin of an r x r pool by a numpy
    scan: codes [B, P, r, r, C] int64, -1 where no cell routes."""
    f = feat.to(torch.float32).numpy()
    b, h, w, c = f.shape
    p = rois.shape[1]
    codes = np.full((b, p, r, r, c), -1, np.int64)
    cells = np.floor(rois.astype(np.float32) * np.float32(scale)
                     + np.float32(0.5)).astype(np.int64)
    for i in range(b):
        for j in range(p):
            if not mask[i, j]:
                continue
            x1, y1, x2, y2 = cells[i, j]
            rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
            for ph in range(r):
                hs = min(max(ph * rh // r + y1, 0), h)
                he = min(max(-(-(ph + 1) * rh // r) + y1, 0), h)
                for pw in range(r):
                    ws = min(max(pw * rw // r + x1, 0), w)
                    we = min(max(-(-(pw + 1) * rw // r) + x1, 0), w)
                    if he <= hs or we <= ws:
                        continue
                    vals = f[i, hs:he, ws:we].reshape(-1, c)
                    codes[i, j, ph, pw] = vals.argmax(axis=0)
    return codes


def test_rois_stay_within_the_jax_window():
    """Every live roi spans at most 32 cells a side, the JAX CPU pooler's
    exact window, and the set holds one of exactly 32 cells."""
    rois, mask = _rois()
    cells = np.floor(rois * np.float32(SCALE) + np.float32(0.5))
    span = np.maximum(cells[..., 2:] - cells[..., :2] + 1, 1)
    assert span[mask].max() == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", RESOLUTIONS)
def test_plain_pool_matches_jax(r, dtype):
    feat, _ = _feat("random_f32")
    feat = feat.to(dtype)
    rois, mask = _rois()
    # the malformed roi: 1x1 in the port (its cell at y1, x1 in every bin),
    # empty in the XLA pooler
    one = rp.roi_pool(feat[:1], torch.from_numpy(rois[:1, 2:3]),
                      torch.ones((1, 1), dtype=torch.bool), SCALE, r)
    assert torch.equal(one[0, 0], feat[0, 11, 16].expand(r, r, C))
    mask[0, 2] = False
    jfeat = jnp.asarray(feat.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax_roi_pool(jfeat, jnp.asarray(rois),
                                   jnp.asarray(mask), SCALE, r).astype(
                                       jnp.float32))
    got = rp.roi_pool(feat, torch.from_numpy(rois), torch.from_numpy(mask),
                      SCALE, r)
    assert got.shape == (2, 12, r, r, C) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    out, _ = rp.roi_pool_argmax(feat, torch.from_numpy(rois),
                                torch.from_numpy(mask), SCALE, r)
    assert torch.equal(out, got)


@pytest.mark.parametrize("case", ["random_f32", "ties_f32", "ties_bf16"])
@pytest.mark.parametrize("r", RESOLUTIONS)
def test_codes_and_backward_at_r(r, case):
    feat, dtype = _feat(case)
    rois_np, mask_np = _rois(seed=r)
    rois, mask = torch.from_numpy(rois_np), torch.from_numpy(mask_np)
    out, codes = rp.roi_pool_argmax_plain(feat, rois, mask, SCALE, r)
    assert codes.dtype == torch.int16 and codes.shape == (2, 12, r, r, C)
    decoded = rp.decode_cells(codes).numpy()
    np.testing.assert_array_equal(np.where(decoded == 0xFFFF, -1, decoded),
                                  _literal_codes(feat, rois_np, mask_np, r))
    assert torch.equal(out, rp.roi_pool_plain(feat, rois, mask, SCALE, r))
    g = (torch.rand(codes.shape, generator=torch.Generator().manual_seed(r))
         + 0.1).to(dtype)
    got = rp.roi_pool_backward(codes, rois, mask, g, SCALE, (H, W), r)
    ref = rp.roi_pool_backward_plain(feat, rois, mask, g, SCALE, r)
    assert got.dtype == ref.dtype == dtype
    got, ref = got.float().numpy(), ref.float().numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)        # routing
    assert (ref != 0).sum() > 50
    np.testing.assert_allclose(got, ref, atol=0, rtol=(
        BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL))


def test_function_saves_its_resolution():
    """``RoIPoolFunction`` at R = 14 keeps R for its backward: the
    gradient equals the map-rescan backward's at 14x14."""
    feat, _ = _feat("random_f32", seed=9)
    feat.requires_grad_()
    rois_np, mask_np = _rois(seed=4)
    rois, mask = torch.from_numpy(rois_np), torch.from_numpy(mask_np)
    out = rp.RoIPoolFunction.apply(feat, rois, mask, SCALE, None, 14)
    assert out.shape == (2, 12, 14, 14, C)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(5))
    out.backward(g)
    ref = rp.roi_pool_backward_plain(feat.detach(), rois, mask, g, SCALE,
                                     14)
    assert torch.equal(feat.grad != 0, ref != 0)
    np.testing.assert_allclose(feat.grad.numpy(), ref.numpy(), atol=0,
                               rtol=F32_RTOL)
    with torch.no_grad():
        assert torch.equal(rp.RoIPoolFunction.apply(
            feat, rois, mask, SCALE, None, 14), out.detach())


def _meta(r):
    feat = torch.empty((1, 16, 16, 8), device="meta")
    rois = torch.empty((1, 2, 4), device="meta")
    mask = torch.empty((1, 2), dtype=torch.bool, device="meta")
    codes = torch.empty((1, 2, r, r, 8), dtype=torch.int16, device="meta")
    grad = torch.empty((1, 2, r, r, 8), device="meta")
    return {"roi_pool": lambda: rp.roi_pool(feat, rois, mask, SCALE, r),
            "roi_pool_argmax": lambda: rp.roi_pool_argmax(
                feat, rois, mask, SCALE, r),
            "roi_pool_backward": lambda: rp.roi_pool_backward(
                codes, rois, mask, grad, SCALE, (16, 16), r)}


@pytest.mark.parametrize("name", ["roi_pool", "roi_pool_argmax",
                                  "roi_pool_backward"])
def test_wrapper_cap_and_no_plain_path(name):
    """Past the cap the wrapper raises and names it; at R = 14 a tensor
    off the CPU goes to the kernel wrapper, which refuses what is not on
    the card instead of pooling it with the plain version."""
    launches = (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                rp.roi_pool_backward.launches)
    with pytest.raises(ValueError, match="R from 1 to 16, not 17x17"):
        _meta(17)[name]()
    with pytest.raises(ValueError, match="R from 1 to 16, not 0x0"):
        _meta(0)[name]()
    with pytest.raises(ValueError, match="neither a CPU tensor"):
        _meta(14)[name]()
    assert launches == (rp.roi_pool.launches, rp.roi_pool_argmax.launches,
                        rp.roi_pool_backward.launches)


def test_stage_work_at_r():
    """#1's bytes at R count the R x R output once; the map cells it needs
    are those of the R x R bins (the same window, so the same cells); the
    comparisons sum the bins' cells. The stages keep 7x7."""
    feat = torch.zeros((1, 24, 40, 8), dtype=torch.bfloat16)
    rois = torch.tensor([[[0.0, 0.0, 103.0, 47.0]]])      # 14 x 7 cells
    mask = torch.ones((1, 1), dtype=torch.bool)
    b7, ops7 = rs.stage_work("roi_pool", feat, rois, mask, SCALE)
    b14, ops14 = rs.stage_work("roi_pool", feat, rois, mask, SCALE, 14)
    out7, out14 = 7 * 7 * 8 * 2, 14 * 14 * 8 * 2
    assert b14 - out14 == b7 - out7 == 1 + 16 + 14 * 7 * 8 * 2
    assert ops7 == 14 * 7 * 8
    # R = 14: 14 column bins of one column each; 14 row bins over 7 rows
    # hold every row twice
    assert ops14 == 2 * 14 * 7 * 8
    with pytest.raises(ValueError, match="stage 'rows' pools 7x7"):
        rs.stage_work("rows", feat, rois, mask, SCALE, 14)


def _neck_pair(kind, r, c, x):
    if kind == "VGG16":
        jneck = JVGGRoINeck(hidden_dim=64, compute_dtype=jnp.float32)
        port = VGGRoINeck(r * r * c, 64, torch.float32)
    else:
        jneck = JResNetRoINeck(mid_dim=32, out_dim=16,
                               compute_dtype=jnp.float32)
        port = ResNetRoINeck(r * r * c, 32, 16, torch.float32)
    params = jneck.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jneck, params, port


@pytest.mark.parametrize("kind", ["VGG16", "R-18-C5"])
def test_neck_at_r14_through_the_bridge(kind):
    """fc6 over 14 * 14 * 512 inputs flattened (h, w, c) in both packages:
    the JAX neck's parameters in the port give its outputs, and come back
    unchanged."""
    r, c = 14, 512
    x = np.random.RandomState(1).randn(6, r, r, c).astype(np.float32)
    jneck, params, port = _neck_pair(kind, r, c, x)
    sd = state_dict_from_jax({"neck": params["params"]})
    assert sd["neck.fc6.weight"].shape[1] == r * r * c
    port.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    want = np.asarray(jneck.apply(params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = jax_params_from_state_dict(
        {"neck." + k: v for k, v in port.state_dict().items()})["neck"]
    for layer in ("fc6", "fc7"):
        for leaf, v in params["params"][layer].items():
            np.testing.assert_array_equal(np.asarray(back[layer][leaf]),
                                          np.asarray(v))


def test_int8_neck_at_r14_matches_jax():
    """The int8 fc6 (``dense_int8`` over 14 * 14 * C) equals JAX's."""
    x = np.random.RandomState(3).randn(20, 14, 14, 8).astype(np.float32)
    jneck = JVGGRoINeck(hidden_dim=128, int8_eval=True,
                        compute_dtype=jnp.float32)
    params = jneck.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jneck.apply(params, jnp.asarray(x), train=False))
    sd = state_dict_from_jax({"neck": params["params"]})
    neck = VGGRoINeck(14 * 14 * 8, 128, torch.float32, int8_eval=True)
    neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = neck(torch.from_numpy(x), fast_eval=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,res,sampling", [("ROIAlign", 7, 0),
                                                 ("ROIAlign", 14, 2),
                                                 ("ROIPool", 14, 0)])
def test_detector_from_cfg_reads_the_pooler(method, res, sampling):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.POOLER_METHOD", method,
                         "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", res,
                         "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", sampling,
                         "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 8])
    with torch.device("meta"):
        model = detector_from_cfg(cfg)
    assert (model.pooler_method, model.pooler_resolution,
            model.pooler_sampling) == (method, res, sampling)
    assert model.neck.fc6.in_features == res * res * 512


def test_unknown_pooler_raises():
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.POOLER_METHOD", "ROIMax"])
    with pytest.raises(ValueError, match="unknown POOLER_METHOD 'ROIMax'"):
        with torch.device("meta"):
            detector_from_cfg(cfg)


def test_tuner_launches_at_the_outputs_resolution(monkeypatch):
    """``tools/tune_roi_pool.py`` (``--pooled R``) hands the kernels the R
    of the buffers it times: the forward's ``pooled`` argument is out's
    side, the backward's the cotangent's; the ordered variants' entry point
    (7x7 only) takes none."""
    from types import SimpleNamespace

    from odwscl_tpu_torch.tools import tune_roi_pool as tune

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(roi_pool_fwd_bf16=entry, roi_pool_bwd_bf16=entry,
                          roi_pool_fwd_ordered_bf16=entry)
    monkeypatch.setattr(tune.torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    feat = torch.zeros((2, 8, 8, 8), dtype=torch.bfloat16)
    rois = torch.zeros((2, 3, 4))
    mask = torch.ones((2, 3), dtype=torch.bool)
    out = torch.zeros((2, 3, 14, 14, 8), dtype=torch.bfloat16)
    codes = torch.zeros(out.shape, dtype=torch.int16)
    tune._fwd_call(lib, feat, rois, mask, out, codes)()
    tune._bwd_call(lib, codes, rois, mask, out, torch.zeros_like(feat))()
    tune._fwd_call(lib, feat, rois, mask, out, None,
                   torch.zeros(6, dtype=torch.int32))()
    fwd, bwd, ordered = calls
    assert fwd[5:11] == (2, 3, 8, 8, 8, 14) and fwd[11] == tune.SCALE
    assert bwd[5:11] == (2, 3, 8, 8, 8, 14) and bwd[11] == tune.SCALE
    assert ordered[6:11] == (2, 3, 8, 8, 8) and ordered[11] == tune.SCALE
    with pytest.raises(SystemExit):      # R is an integer
        tune.main(["--pooled", "x"])


def test_tp_neck_at_r14_matches_jax(tmp_path):
    """The tensor-parallel neck (``parallel/tp.py``) on [N, 14, 14, C]
    rows, 2 ``gloo`` processes, against the JAX one on a (4, 2) mesh and
    the neck written out in numpy, at tests/test_torch_tp.py's bound."""
    import test_torch_tp as ttp
    from torch_dp_workers import run_ranks

    p, _ = ttp._neck(k=14 * 14 * 8, h=64)
    x = np.random.RandomState(4).randn(16, 14, 14, 8).astype(np.float32)
    outs = run_ranks(2, tmp_path, "tp", p, x)
    want_jax, want_np = ttp._jax(p, x, 2), ttp._numpy_neck(p, x)
    np.testing.assert_allclose(want_jax, want_np, rtol=ttp.TOL, atol=ttp.TOL)
    for out in outs:
        np.testing.assert_array_equal(out, outs[0])
        np.testing.assert_allclose(out, want_jax, rtol=ttp.TOL, atol=ttp.TOL)
