"""The port's int8 serving paths against the JAX package's on the CPU:
``VGGBackbone`` (dynamic, calibrated, ``int8_bf16_layers``),
``VGGRoINeck`` (fc6/fc7 ``dense_int8``), a whole ``eval_forward`` with
``INT8_EVAL``, ``INT8_EVAL_CONVS`` and ``INT8_STATIC`` on, the scales
files of both packages, and a static eval of a batch larger than the
calibration one. Same numpy inputs and weights (utils/from_jax.py), f32
compute on both sides.

Tolerances:
- recorded scales within 1e-6 of the layer's largest: both take the max
  of |x| of the same layer input, which agrees to the f32 drift of the
  convs before it (observed up to 9.6e-7 of the largest at conv12; a
  small channel's own scale can then differ by 3.4e-6 of itself);
- backbone outputs within 1e-3 of their largest magnitude. XLA's and
  torch's CPU convs sum in other orders (a few ulps a layer), so a value
  that lies within that drift of a rounding boundary of x / s takes the
  other int8 code in the two packages; each such flip moves the layer's
  output by one quantization step of one input, far below 1e-3 of the
  largest (the count of flipped codes is printed: a handful in ~10^5);
- the neck: equal (its input is given, so the codes are equal and the
  integer sums exact);
- ``eval_forward``: scores 1e-3, boxes 1e-2 px (the backbone's 1e-3,
  carried through ROIPool, the neck and the softmaxes).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odwscl_tpu.models import Batch as JBatch
from odwscl_tpu.models import WSODDetector as JWSODDetector
from odwscl_tpu.models.vgg16 import VGGBackbone as JVGGBackbone
from odwscl_tpu.models.vgg16 import VGGRoINeck as JVGGRoINeck
from odwscl_tpu.ops import quant as jq
from odwscl_tpu_torch.models import Batch, WSODDetector
from odwscl_tpu_torch.models.vgg16 import VGGBackbone, VGGRoINeck
from odwscl_tpu_torch.ops import quant as tq
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax

# the engine packages export a function named ``inference``
jinf = importlib.import_module("odwscl_tpu.engine.inference")
tinf = importlib.import_module("odwscl_tpu_torch.engine.inference")

torch.set_num_threads(1)

SCALE_REL = 1e-5
FEAT_REL = 1e-3
SCORE_ATOL = 1e-3
BOX_ATOL = 1e-2


def _run(module, x, **kw):
    with torch.no_grad():
        return module(torch.from_numpy(x), **kw).numpy()


def _port_backbone(params, **kw):
    sd = state_dict_from_jax({"backbone": params["params"]})
    bb = VGGBackbone(compute_dtype=torch.float32, **kw)
    bb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return bb


@pytest.fixture(scope="module")
def backbone_params():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 32, 32, 3).astype(np.float32) * 50
    model = JVGGBackbone(arch="VGG16-OICR", compute_dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, params), x


class _Codes:
    """Records the activation codes of every int8 conv in both packages."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        orig_j, orig_t = jq.conv2d_int8, tq.quantize_conv_act

        def jax_conv(x, kernel, bias=None, dilation=1, padding=1,
                     out_dtype=jnp.bfloat16, act_scale=None):
            xf = np.asarray(x, np.float32)
            if act_scale is not None and np.ndim(act_scale) == 1:
                s = np.maximum(np.asarray(act_scale, np.float32),
                               np.float32(1e-12)) / np.float32(127)
            else:
                amax = (np.abs(xf).max() if act_scale is None
                        else np.asarray(act_scale, np.float32))
                s = np.maximum(amax, np.float32(1e-12)) / np.float32(127)
            self.jax.append(np.clip(np.round(xf / s), -127, 127))
            return orig_j(x, kernel, bias, dilation, padding, out_dtype,
                          act_scale)

        def port_quant(x, sa=None, act_scale=None):
            out = orig_t(x, sa, act_scale)
            self.port.append(out[0].numpy().astype(np.float32))
            return out

        monkeypatch.setattr(jq, "conv2d_int8", jax_conv)
        monkeypatch.setattr(tq, "quantize_conv_act", port_quant)

    def flipped(self):
        assert len(self.jax) == len(self.port) > 0
        n = sum(int((a != b).sum()) for a, b in zip(self.jax, self.port))
        total = sum(a.size for a in self.jax)
        return n, total, max(np.abs(a).max() for a in self.port)


def _rel_gap(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / (
        np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("bf16_layers", [(), (2, 3)])
def test_backbone_int8_dynamic_matches_jax(backbone_params, monkeypatch,
                                          bf16_layers):
    params, x = backbone_params
    codes = _Codes(monkeypatch)
    jb = JVGGBackbone(arch="VGG16-OICR", compute_dtype=jnp.float32,
                      int8_eval=True, int8_bf16_layers=bf16_layers)
    want = np.asarray(jb.apply(params, jnp.asarray(x), fast_eval=True))
    bb = _port_backbone(params, int8_eval=True, int8_bf16_layers=bf16_layers)
    got = _run(bb, x, fast_eval=True)
    n, total, _ = codes.flipped()
    gap = _rel_gap(got, want)
    print(f"dynamic, bf16 layers {bf16_layers}: {n} of {total} codes "
          f"differ; output gap {gap:.2e} of the largest")
    assert len(codes.port) == 11 - len(bf16_layers)
    assert gap < FEAT_REL
    # the training path never takes int8, and with every int8 conv on the
    # fallback list the serving path is the plain forward
    plain = _run(bb, x)
    all_fb = _port_backbone(params, int8_eval=True,
                            int8_bf16_layers=tuple(range(2, 13)))
    np.testing.assert_array_equal(
        _run(all_fb, x, fast_eval=True), plain)
    assert _rel_gap(plain, want) < 0.25       # int8 vs float, JAX's bound


def test_backbone_calibration_and_static_match_jax(backbone_params,
                                                   monkeypatch):
    params, x1 = backbone_params
    x2 = x1 * 3.0
    jb = JVGGBackbone(arch="VGG16-OICR", compute_dtype=jnp.float32,
                      int8_eval=True, int8_static=True)
    cal = lambda v, x: jb.apply(v, jnp.asarray(x), fast_eval=True,
                                calibrate=True, mutable=["quant"])
    y_cal, q1 = cal(params, x1)
    _, q12 = cal({**params, **q1}, x2)
    bb = _port_backbone(params, int8_eval=True, int8_static=True)
    got_cal = _run(bb, x1, fast_eval=True, calibrate=True)
    np.testing.assert_allclose(got_cal, np.asarray(y_cal),
                               rtol=1e-5, atol=1e-5 * np.abs(y_cal).max())
    recorded1 = {i: a.clone() for i, a in bb.act_amax.items()}
    _run(bb, x2, fast_eval=True, calibrate=True)
    only2 = _port_backbone(params, int8_eval=True, int8_static=True)
    _run(only2, x2, fast_eval=True, calibrate=True)
    assert sorted(bb.act_amax) == list(range(2, 13))
    grew = False
    for i, a in bb.act_amax.items():
        want1 = np.asarray(q1["quant"][f"conv{i}_act"])
        want12 = np.asarray(q12["quant"][f"conv{i}_act"])
        assert a.shape == want12.shape
        np.testing.assert_allclose(recorded1[i].numpy(), want1, rtol=0,
                                   atol=SCALE_REL * want1.max())
        np.testing.assert_allclose(a.numpy(), want12, rtol=0,
                                   atol=SCALE_REL * want12.max())
        # the running max over the two batches
        np.testing.assert_array_equal(
            a.numpy(), np.maximum(recorded1[i].numpy(),
                                  only2.act_amax[i].numpy()))
        grew |= bool((a > recorded1[i]).any())
    assert grew
    # the scales are no part of the state_dict: checkpoints load strictly
    assert not any("amax" in k or "act" in k for k in bb.state_dict())
    VGGBackbone(compute_dtype=torch.float32).load_state_dict(bb.state_dict())


def _only_dead_channels_differ(codes, dead):
    """The dead-channel repair (ROADMAP Queue 3) is the one difference of
    static serving on the same scales: on the int8 path a channel that
    calibrated to exactly 0 can carry a small value (the quantization error
    of the conv before it, past the ReLU), which the JAX package quantizes
    to +-127 codes of ~7.9e-15 and the port to codes of the layer's largest
    scale. Up to the first layer where that happens, codes differ by at
    most 1 (a rounding boundary under the stem's float drift); in that
    layer every larger difference lies in a dead channel. From there on
    the live channels carry it."""
    for i, (a, b) in enumerate(zip(codes.jax, codes.port), start=2):
        big = np.abs(a - b) > 1
        if big.any():
            channels = np.unique(np.nonzero(big)[-1])
            print(f"conv{i}: first layer with a dead channel's value "
                  f"({int(big.sum())} codes, channels {channels.tolist()})")
            assert dead[i][channels].all()
            return
    raise AssertionError("no dead channel carried a value")


def _scales(quant):
    """{conv index: tensor} from a "quant" collection's backbone level."""
    return {int(k[4:-4]): torch.from_numpy(np.array(v))
            for k, v in quant.items()}


def test_backbone_static_matches_jax(backbone_params, monkeypatch):
    """Static serving with the same scales in both packages (JAX's
    calibration). Each package's own calibration differs by the float drift
    above, which is enough to flip weight codes at rounding boundaries (the
    scales fold into the kernel) and move whole output channels by a step,
    so parity is held on one set of scales. With every channel at least
    1e-3 of its layer's largest (no dead channel) the two agree within
    FEAT_REL, on the calibration batch and on a batch 3x larger, whose
    codes past the calibrated range saturate at +-127 as in JAX; with JAX's
    own scales, where some channels calibrated to 0, they differ in the
    dead channels only (``_only_dead_channels_differ``)."""
    params, x1 = backbone_params
    jb = JVGGBackbone(arch="VGG16-OICR", compute_dtype=jnp.float32,
                      int8_eval=True, int8_static=True)
    _, q = jb.apply(params, jnp.asarray(x1), fast_eval=True, calibrate=True,
                    mutable=["quant"])
    q = jax.tree_util.tree_map(np.asarray, q["quant"])
    live = {k: np.maximum(v, np.float32(1e-3) * v.max()) for k, v in q.items()}
    bb = _port_backbone(params, int8_eval=True, int8_static=True)
    for label, scales, x in (("live scales", live, x1),
                             ("live scales, 3x batch", live, x1 * 3.0),
                             ("JAX's scales", q, x1)):
        bb.act_amax = _scales(scales)
        codes = _Codes(monkeypatch)
        want = np.asarray(jb.apply({**params, "quant": scales},
                                   jnp.asarray(x), fast_eval=True))
        got = _run(bb, x, fast_eval=True)
        n, total, top = codes.flipped()
        saturated = sum(int((np.abs(c) == 127).sum()) for c in codes.port)
        gap = _rel_gap(got, want)
        print(f"static, {label}: {saturated} codes at +-127, {n} of {total} "
              f"differ from JAX; gap {gap:.2e}")
        assert np.isfinite(got).all()
        if scales is live:
            assert gap < FEAT_REL
        if "3x" in label:
            assert top == 127 and saturated > 0
    _only_dead_channels_differ(codes, {i: v.numpy() == 0 for i, v in
                                       _scales(q).items()})


def test_backbone_without_scales_raises(backbone_params):
    params, x = backbone_params
    bb = _port_backbone(params, int8_eval=True, int8_static=True)
    with pytest.raises(RuntimeError, match="no calibrated scale"):
        _run(bb, x, fast_eval=True)


def test_neck_int8_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(20, 7, 7, 8).astype(np.float32)
    jneck = JVGGRoINeck(hidden_dim=128, int8_eval=True,
                        compute_dtype=jnp.float32)
    params = jneck.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jneck.apply(params, jnp.asarray(x), train=False))
    sd = state_dict_from_jax({"neck": params["params"]})
    neck = VGGRoINeck(7 * 7 * 8, 128, torch.float32, int8_eval=True)
    neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    got = _run(neck, x, fast_eval=True)
    np.testing.assert_array_equal(got, want)
    # without fast_eval (the training path) the neck stays in float
    jplain = JVGGRoINeck(hidden_dim=128, compute_dtype=jnp.float32)
    want_f = np.asarray(jplain.apply(params, jnp.asarray(x), train=False))
    np.testing.assert_allclose(_run(neck, x), want_f,
                               rtol=1e-5, atol=1e-6)


def _detector_inputs():
    rng = np.random.RandomState(0)
    b, h, w, p = 2, 64, 96, 16
    images = (rng.randn(b, h, w, 3) * 50).astype(np.float32)
    sizes = np.array([[64, 96], [56, 80]], np.float32)
    x1y1 = rng.uniform(0, 40, (b, p, 2))
    wh = rng.uniform(8, 50, (b, p, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.uniform(size=(b, p)) > 0.2
    mask[:, 0] = True
    return images, sizes, boxes, mask


@pytest.fixture(scope="module")
def detectors():
    images, sizes, boxes, mask = _detector_inputs()
    kw = dict(compute_dtype="float32", mlp_dim=64, int8_eval=True,
              int8_eval_convs=True, int8_static=True)
    jmodel = JWSODDetector(**kw)
    jbatch = JBatch(jnp.asarray(images), jnp.asarray(sizes),
                    jnp.asarray(boxes), jnp.asarray(mask),
                    jnp.zeros((2, 21), jnp.float32))
    v = jax.jit(lambda r, bt: jmodel.init(r, bt, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        jbatch)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    v["params"])
    for name, head in params["pred"].items():
        if not name.startswith("bbox_pred"):
            head["linear"]["kernel"] *= 2000.0
    model = WSODDetector(**kw)
    model.load_state_dict(state_dict_from_jax(params))
    batch = Batch(torch.from_numpy(images), torch.from_numpy(sizes),
                  torch.from_numpy(boxes), torch.from_numpy(mask))
    return jmodel, params, jbatch, model, batch


def test_eval_forward_int8_static_matches_jax(detectors):
    """The whole eval forward with the three keys on: the port's own
    calibration against JAX's, then both serving from one set of scales
    (JAX's, every channel at least 1e-3 of its layer's largest; see
    ``test_backbone_static_matches_jax`` for why)."""
    jmodel, params, jbatch, model, batch = detectors
    (_, _), quant = jmodel.apply({"params": params}, jbatch, train=False,
                                 calibrate=True, mutable=["quant"])
    q = jax.tree_util.tree_map(np.asarray, quant["quant"]["backbone"])
    model.backbone.act_amax = {}
    model.eval_forward(batch, calibrate=True)
    for i, a in model.backbone.act_amax.items():
        want = q[f"conv{i}_act"]
        np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                   atol=SCALE_REL * want.max())
    live = {k: np.maximum(v, np.float32(1e-3) * v.max()) for k, v in q.items()}
    want_s, want_b = jmodel.apply(
        {"params": params, "quant": {"backbone": live}}, jbatch, train=False)
    model.backbone.act_amax = _scales(live)
    got_s, got_b = model.eval_forward(batch)
    want_s, want_b = np.asarray(want_s), np.asarray(want_b)
    assert want_s.max() > 0.2          # spread, not uniform (1/21)
    print(f"eval_forward int8: max |d score| "
          f"{np.abs(got_s.numpy() - want_s).max():.2e}, max |d box| "
          f"{np.abs(got_b.numpy() - want_b).max():.2e} px")
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=BOX_ATOL)


def test_scales_files_cross_load(detectors, tmp_path):
    jmodel, params, jbatch, model, batch = detectors
    _, quant = jmodel.apply({"params": params}, jbatch, train=False,
                            calibrate=True, mutable=["quant"])
    model.backbone.act_amax = {}
    model.eval_forward(batch, calibrate=True)
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax_scales.npz")
    jinf.save_int8_scales(jpath, quant)
    with np.load(jpath) as z:
        keys = sorted(z.files)
    assert keys == sorted(f"backbone/conv{i}_act" for i in range(2, 13))
    loaded = tinf.load_int8_scales(jpath)
    assert sorted(loaded) == list(range(2, 13))
    for i, a in loaded.items():
        want = model.backbone.act_amax[i].numpy()
        np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                   atol=SCALE_REL * want.max())
    # the port writes, JAX reads: equal arrays
    tpath = str(tmp_path / "port_scales.npz")
    tinf.save_int8_scales(tpath, model)
    back = jinf.load_int8_scales(tpath)["quant"]["backbone"]
    assert sorted(back) == sorted(f"conv{i}_act" for i in range(2, 13))
    for i, a in model.backbone.act_amax.items():
        np.testing.assert_array_equal(np.asarray(back[f"conv{i}_act"]),
                                      a.numpy())
    # and the JAX model serves from the port's file as from its arrays
    s_file, _ = jmodel.apply({"params": params,
                              **jinf.load_int8_scales(tpath)}, jbatch,
                             train=False)
    s_mem, _ = jmodel.apply({"params": params, "quant": {"backbone": {
        f"conv{i}_act": jnp.asarray(a.numpy())
        for i, a in model.backbone.act_amax.items()}}}, jbatch, train=False)
    np.testing.assert_array_equal(np.asarray(s_file), np.asarray(s_mem))


def test_scalar_scales_file_loads(tmp_path):
    """A scales file from before per-channel scales holds 0-d scalars;
    both packages load it and the conv takes the scalar path."""
    path = str(tmp_path / "old.npz")
    np.savez(path, **{"backbone/conv2_act": np.float32(3.5)})
    loaded = tinf.load_int8_scales(path)
    assert loaded[2].dim() == 0 and loaded[2].item() == 3.5
    assert float(jinf.load_int8_scales(path)["quant"]["backbone"][
        "conv2_act"]) == 3.5


# ---------------------------------------------------------------------------
# the serving engine: the calibration sweep and its scales file
# ---------------------------------------------------------------------------

_E2E_OPTS = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.HEUR", "AVG",
             "TEST.BBOX_AUG.H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(128,)",
             "TEST.BBOX_AUG.MAX_SIZE", "160",
             "TEST.BBOX_AUG.SCALE_H_FLIP", "True",
             "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
             "TPU.COMPUTE_DTYPE", "float32", "TPU.PROPOSAL_BUCKETS", "(64,)",
             "TPU.IMAGE_PAD_MULTIPLE", "32", "DATALOADER.NUM_WORKERS", "1",
             "TEST.IMS_PER_BATCH", "2", "TPU.INT8_EVAL", "True",
             "TPU.INT8_EVAL_CONVS", "True", "TPU.INT8_STATIC", "True",
             "TPU.INT8_CALIB_BATCHES", "1"]


def _e2e_cfg(get_default, out_dir, extra=()):
    import os
    cfg = get_default()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "voc",
                                     "voc07_synth_smoke.yaml"))
    cfg.merge_from_list(_E2E_OPTS + list(extra) + ["OUTPUT_DIR", str(out_dir)])
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX package's and the port's ``inference()`` with the three
    int8 keys: each calibrates (1 batch of 2 images x 4 TTA transforms) and
    writes OUTPUT_DIR/int8_scales.npz; the port runs again from its file."""
    import os
    import shutil
    from odwscl_tpu.data import make_eval_loaders as jax_loaders
    from odwscl_tpu.models.detector import detector_from_cfg as jax_detector
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
    from odwscl_tpu_torch.models.detector import detector_from_cfg
    from odwscl_tpu.config import get_default_cfg as jax_cfg

    root = tmp_path_factory.mktemp("int8_e2e")
    data = str(root / "data")
    write_synthetic_voc(data, n_test=4, seed=0, img_hw=(120, 144), n_props=64)
    jcfg = _e2e_cfg(jax_cfg, root / "jax")
    os.makedirs(jcfg.OUTPUT_DIR)
    jmodel = jax_detector(jcfg)
    rng = np.random.RandomState(0)
    jb = JBatch(jnp.asarray(rng.randn(1, 64, 64, 3), jnp.float32),
                jnp.array([[64.0, 64.0]]),
                jnp.array([[[0.0, 0.0, 31.0, 31.0]] * 4]),
                jnp.ones((1, 4), bool), jnp.zeros((1, 21), jnp.float32))
    v = jax.jit(lambda r, bt: jmodel.init(r, bt, method="init_all"))(
        {"params": jax.random.PRNGKey(0), "augment": jax.random.PRNGKey(1)},
        jb)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    v["params"])
    (name, jloader), = jax_loaders(jcfg, data)
    os.makedirs(root / "jax" / name)
    jinf.inference(jmodel, {"params": params}, jcfg, jloader,
                   jloader.dataset, str(root / "jax" / name))

    runs = []
    for run in ("first", "second"):
        cfg = _e2e_cfg(get_default_cfg, root / run)
        os.makedirs(cfg.OUTPUT_DIR)
        if run == "second":
            shutil.copy(root / "first" / "int8_scales.npz", cfg.OUTPUT_DIR)
        model = detector_from_cfg(cfg)
        model.load_state_dict(state_dict_from_jax(params))
        (name, loader), = make_eval_loaders(cfg, data)
        timing = {}
        out = str(root / run / name)
        os.makedirs(out)
        tinf.inference(model, cfg, loader, loader.dataset, out,
                       device="cpu", timing_out=timing)
        with open(os.path.join(out, "predictions.pkl"), "rb") as f:
            runs.append((timing, pickle_load(f), model))
    return root, params, data, runs


def pickle_load(f):
    import pickle
    return pickle.load(f)


def test_inference_calibrates_once_and_reloads(served):
    root, _, _, runs = served
    (t1, p1, m1), (t2, p2, m2) = runs
    # the sweep: 1 batch x 4 transforms, then 2 batches x 4 forwards
    assert t1["n_calib_forwards"] == 4 and t1["calib_s"] > 0
    assert t2["n_calib_forwards"] == 0 and t2["calib_s"] == 0
    assert t1["n_forwards"] == t2["n_forwards"] == 2 * 4
    assert sorted(m2.backbone.act_amax) == list(range(2, 13))
    for i, a in m1.backbone.act_amax.items():
        assert torch.equal(a, m2.backbone.act_amax[i])
    # the second run serves from the file exactly as the first from memory
    assert len(p1) == len(p2) == 4
    for a, b in zip(p1, p2):
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(a[key], b[key])


def test_calibration_sweep_matches_jax(served):
    """Both packages sweep the same batch through the same 4 transforms:
    their scales files agree within the float drift (SCALE_REL)."""
    root, _, _, _ = served
    with np.load(root / "jax" / "int8_scales.npz") as z:
        want = {k: z[k] for k in z.files}
    got = tinf.load_int8_scales(str(root / "first" / "int8_scales.npz"))
    assert sorted(want) == sorted(f"backbone/conv{i}_act" for i in got)
    for i, a in got.items():
        w = want[f"backbone/conv{i}_act"]
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=SCALE_REL * w.max())


def test_device_resize_avg_calibrates_the_host_path(served):
    """An Inferencer used directly on the device-resize AVG path sweeps
    the host path's transforms once, on the first batch."""
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_eval_loaders
    from odwscl_tpu_torch.models.detector import detector_from_cfg

    root, params, data, _ = served
    cfg = _e2e_cfg(get_default_cfg, root / "direct",
                   ["TPU.EVAL_DEVICE_RESIZE", "True"])
    model = detector_from_cfg(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    inf = tinf.Inferencer(model, cfg, "cpu")
    assert inf.needs_calib
    (_, loader), = make_eval_loaders(cfg, data)
    _, samples, _ = next(iter(loader))
    dets = inf.predict_samples(samples)
    assert len(dets) == 2 and not inf.needs_calib
    assert inf.n_calib_forwards == 4 and inf.n_forwards == 4
    assert sorted(model.backbone.act_amax) == list(range(2, 13))


def test_resnet_ignores_the_int8_keys(caplog):
    """As the JAX package does for R-* backbones, with a warning."""
    import logging
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.models.detector import detector_from_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.BACKBONE.CONV_BODY", "R-18-C5",
                         "MODEL.ROI_BOX_HEAD.POOLER_SCALES", "(0.0625,)",
                         "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
                         "TPU.INT8_EVAL", "True", "TPU.INT8_EVAL_CONVS", "True",
                         "TPU.INT8_STATIC", "True"])
    with caplog.at_level(logging.WARNING, "odwscl_tpu_torch.detector"):
        model = detector_from_cfg(cfg)
    assert any("ignored" in r.message for r in caplog.records)
    assert not tinf.Inferencer(model, cfg, "cpu").needs_calib


def test_detector_from_cfg_reads_the_int8_keys():
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.models.detector import detector_from_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
                         "TPU.INT8_EVAL", "True", "TPU.INT8_EVAL_CONVS", "True",
                         "TPU.INT8_STATIC", "True",
                         "TPU.INT8_BF16_LAYERS", "(2, 12)"])
    model = detector_from_cfg(cfg)
    assert model.neck.int8_eval and model.backbone.int8_eval
    assert model.backbone.int8_static
    assert model.backbone.int8_convs() == tuple(range(3, 12))


def test_kept_weight_codes_follow_the_weights():
    """The serving modules keep their weights' int8 codes between forwards;
    an in-place update of a weight (an optimizer step, a load) renews
    them, and calibrated scales that change renew the folded conv codes."""
    rng = np.random.RandomState(4)
    neck = VGGRoINeck(7 * 7 * 8, 32, torch.float32, int8_eval=True)
    neck.reset_parameters(torch.Generator().manual_seed(0))
    x = rng.randn(20, 7, 7, 8).astype(np.float32)
    a = _run(neck, x, fast_eval=True)
    with torch.no_grad():
        neck.fc6.weight.mul_(-1.0)
    b = _run(neck, x, fast_eval=True)
    fresh = VGGRoINeck(7 * 7 * 8, 32, torch.float32, int8_eval=True)
    fresh.load_state_dict(neck.state_dict())
    np.testing.assert_array_equal(b, _run(fresh, x, fast_eval=True))
    assert not np.array_equal(a, b)

    bb = VGGBackbone(compute_dtype=torch.float32, int8_eval=True,
                     int8_static=True)
    bb.reset_parameters(torch.Generator().manual_seed(0))
    img = rng.randn(1, 32, 32, 3).astype(np.float32) * 50
    _run(bb, img, fast_eval=True, calibrate=True)
    y1 = _run(bb, img, fast_eval=True)
    bb.act_amax = {i: v * 2.0 for i, v in bb.act_amax.items()}
    y2 = _run(bb, img, fast_eval=True)
    other = VGGBackbone(compute_dtype=torch.float32, int8_eval=True,
                        int8_static=True)
    other.load_state_dict(bb.state_dict())
    other.act_amax = dict(bb.act_amax)
    np.testing.assert_array_equal(y2, _run(other, img, fast_eval=True))
    assert not np.array_equal(y1, y2)
