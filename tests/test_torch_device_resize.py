"""The port's device resize (odwscl_tpu_torch/ops/device_resize.py) and the
``TPU.EVAL_DEVICE_RESIZE`` branch of its Inferencer, against the JAX
package's and PIL, on the CPU. The cases and bounds of
tests/test_device_resize.py:

- against PIL's float ('F' mode) BILINEAR resize: rtol 1e-4, atol 2e-3
  (magnification, antialiased minification, non-integer ratios,
  identity); against the JAX function 1e-4 absolute (both f32, the sums
  in another order, on values up to 128);
- against the host path (PIL's uint8 resize, then normalize): at most
  1.01 BGR-255 units per pixel, 0.35 on average (the uint8 rounding);
- padded canvases stay zero beyond each target, and the valid region
  equals the unpadded resize to 1e-5;
- the weights: equal to JAX's to 1e-6, rows of the valid region sum to 1,
  the padded rows and columns are 0;
- boxes: equal to the host resize's to 1e-5 relative, and to JAX's;
- the Inferencer with ``EVAL_DEVICE_RESIZE True`` merges (AVG, 14-style
  TTA with flips) to its host path within rtol 1e-4 / atol 1e-2 (boxes)
  and rtol 0.05 / atol 5e-3 (scores), on a toy model whose scores read the
  resampled pixels;
- end to end: the port's ``inference()`` and the JAX package's, both with
  ``EVAL_DEVICE_RESIZE True`` (JAX's fused AVG step, the port's loop over
  the same transforms in the same order), on a synthetic VOC split with
  the same f32 detector: the detections within the bounds of
  tests/test_torch_eval_e2e.py (5e-5 scores, 1e-3 px), mAP to 1e-6; each
  batch's base upload is waited for once and counted in ``prep_wait_s``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data import make_eval_loaders as jax_loaders
from odwscl_tpu.engine.inference import inference as jax_inference
from odwscl_tpu.ops import device_resize as jdr
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.build import make_eval_loaders
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.data.transforms import Sample, resize
from odwscl_tpu_torch.engine import inference as inf_mod
from odwscl_tpu_torch.models.detector import detector_from_cfg
from odwscl_tpu_torch.ops.device_resize import (resize_image_batch,
                                                scale_boxes_batch,
                                                triangle_weights)
from odwscl_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.test_torch_eval_e2e import (BOX_ATOL_PX, CONFIG, SCORE_ATOL,
                                       _jax_params, _predictions)

torch.set_num_threads(1)

T = torch.from_numpy


def _pil_resize_float(img_hwc, th, tw):
    chans = []
    for c in range(img_hwc.shape[-1]):
        im = Image.fromarray(img_hwc[..., c].astype(np.float32), mode="F")
        chans.append(np.asarray(im.resize((tw, th), Image.BILINEAR)))
    return np.stack(chans, -1)


def _port_resize(img, in_hw, out_hw, canvas):
    f32 = torch.float32
    return resize_image_batch(T(img)[None], torch.tensor([in_hw], dtype=f32),
                              torch.tensor([out_hw], dtype=f32),
                              canvas)[0].numpy()


@pytest.mark.parametrize("shape,target", [
    ((40, 56), (80, 112)), ((40, 56), (60, 84)), ((40, 56), (20, 28)),
    ((48, 32), (13, 9)), ((40, 56), (40, 56))])
def test_matches_pil_float_mode_and_jax(shape, target):
    rng = np.random.RandomState(0)
    img = rng.uniform(-128, 128, shape + (3,)).astype(np.float32)
    got = _port_resize(img, shape, target, target)
    np.testing.assert_allclose(got, _pil_resize_float(img, *target),
                               rtol=1e-4, atol=2e-3)
    want = np.asarray(jdr.resize_image_batch(
        jnp.asarray(img)[None], jnp.array([shape], jnp.float32),
        jnp.array([target], jnp.float32), target))[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_uint8_host_path_bound():
    rng = np.random.RandomState(1)
    h, w, th, tw = 50, 66, 80, 106
    raw = rng.randint(0, 256, (h, w, 3), np.uint8)
    mean = np.array([102.98, 115.95, 122.77], np.float32)
    host = np.asarray(Image.fromarray(raw).resize((tw, th), Image.BILINEAR),
                      np.float32) / 255.0
    host = host[..., ::-1] * 255.0 - mean
    base = (raw.astype(np.float32) / 255.0)[..., ::-1] * 255.0 - mean
    dev = _port_resize(np.ascontiguousarray(base), (h, w), (th, tw), (th, tw))
    assert np.abs(dev - host).max() <= 1.01
    assert np.abs(dev - host).mean() <= 0.35


def test_padding_stays_zero_and_valid_region_matches():
    rng = np.random.RandomState(2)
    img = rng.uniform(-50, 50, (40, 56, 3)).astype(np.float32)
    padded = np.zeros((64, 64, 3), np.float32)
    padded[:40, :56] = img
    out = _port_resize(padded, (40, 56), (30, 42), (64, 64))
    ref = _port_resize(img, (40, 56), (30, 42), (30, 42))
    np.testing.assert_allclose(out[:30, :42], ref, rtol=1e-5, atol=1e-5)
    assert np.all(out[30:] == 0.0) and np.all(out[:, 42:] == 0.0)


def test_weights_match_jax_and_sum_to_one():
    w = triangle_weights(32, 48, 41.0, 23.0).numpy()
    np.testing.assert_allclose(
        w, np.asarray(jdr.triangle_weights(32, 48, 41.0, 23.0)), atol=1e-6)
    np.testing.assert_allclose(w[:23].sum(1), 1.0, atol=1e-5)
    assert np.all(w[23:] == 0.0) and np.all(w[:, 41:] == 0.0)
    # batched sizes give each image its own matrix
    wb = triangle_weights(32, 48, torch.tensor([41.0, 30.0]),
                          torch.tensor([23.0, 32.0])).numpy()
    np.testing.assert_array_equal(wb[0], w)
    np.testing.assert_allclose(
        wb[1], np.asarray(jdr.triangle_weights(32, 48, 30.0, 32.0)),
        atol=1e-6)


def test_scale_boxes_matches_host_resize_and_jax():
    rng = np.random.RandomState(3)
    w, h = 56, 40
    rois = np.concatenate([rng.uniform(0, w / 2, (9, 1)),
                           rng.uniform(0, h / 2, (9, 1)),
                           rng.uniform(w / 2, w - 1, (9, 1)),
                           rng.uniform(h / 2, h - 1, (9, 1))],
                          1).astype(np.float32)
    img = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
    s2 = resize(Sample(image=img, size=(w, h), rois=rois), 64, 128)
    tw, th = s2.size
    args = (np.array([[h, w]], np.float32), np.array([[th, tw]], np.float32))
    got = scale_boxes_batch(T(rois)[None], *(T(a) for a in args))[0].numpy()
    np.testing.assert_allclose(got, s2.rois, rtol=1e-5)
    np.testing.assert_array_equal(got, np.asarray(jdr.scale_boxes_batch(
        jnp.asarray(rois)[None], *(jnp.asarray(a) for a in args)))[0])


class _ToyModel(torch.nn.Module):
    """tests/test_eval_pipeline.py's stand-in for the detector, with the
    scores reading each image's mean over its valid region (so they move
    with the resampled pixels)."""

    def eval_forward(self, batch):
        imgs = batch.images.to(torch.float32)
        h = batch.image_sizes[:, 0].long()
        w = batch.image_sizes[:, 1].long()
        pooled = torch.stack([imgs[i, :h[i], :w[i]].mean(dim=(0, 1))
                              for i in range(imgs.shape[0])])      # [B, 3]
        base = torch.tanh(batch.boxes.sum(-1) * 1e-3)            # [B, P]
        logits = (base[..., None] + pooled[:, None, :1] * 0.01
                  + torch.arange(7)[None, None, :] * pooled[:, None, 1:2]
                  * 0.001)
        return torch.softmax(logits, -1), batch.boxes.repeat(1, 1, 7)


def _samples(n=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = 40 + 8 * i, 56 + 8 * i
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
        rois = np.concatenate([rng.uniform(0, w // 2, (12, 1)),
                               rng.uniform(0, h // 2, (12, 1)),
                               rng.uniform(w // 2, w - 1, (12, 1)),
                               rng.uniform(h // 2, h - 1, (12, 1))], 1)
        out.append(Sample(image=img, size=(w, h),
                          rois=rois.astype(np.float32), image_id=i))
    return out


@pytest.mark.parametrize("heur", ["AVG", "UNION"])
def test_device_resize_predict_matches_host_path(monkeypatch, heur):
    captured = {}
    orig = inf_mod.Inferencer._finalize

    def capture(self, scores, boxes, mask):
        captured["out"] = (scores.numpy().copy(), boxes.numpy().copy())
        return orig(self, scores, boxes, mask)

    monkeypatch.setattr(inf_mod.Inferencer, "_finalize", capture)
    outs = {}
    for mode in ("False", "True"):
        cfg = get_default_cfg()
        cfg.merge_from_list([
            "TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
            "TEST.BBOX_AUG.HEUR", heur, "TEST.BBOX_AUG.SCALES", "(32, 64)",
            "TEST.BBOX_AUG.SCALE_H_FLIP", "True",
            "TEST.BBOX_AUG.MAX_SIZE", "96", "INPUT.MIN_SIZE_TEST", "48",
            "INPUT.MAX_SIZE_TEST", "96", "MODEL.ROI_BOX_HEAD.NUM_CLASSES",
            "7", "TPU.PROPOSAL_BUCKETS", "(16,)",
            "TPU.IMAGE_PAD_MULTIPLE", "32", "MODEL.ROI_HEADS.SCORE_THRESH",
            "0.0", "TPU.EVAL_DEVICE_RESIZE", mode])
        inferencer = inf_mod.Inferencer(_ToyModel(), cfg, "cpu")
        inferencer.predict_samples(_samples())
        outs[mode] = captured["out"]
        assert inferencer.n_forwards == 6
    np.testing.assert_allclose(outs["True"][1], outs["False"][1], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(outs["True"][0], outs["False"][0], rtol=0.05,
                               atol=5e-3)
    assert not np.array_equal(outs["True"][0], outs["False"][0])


OPTS = ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.HEUR", "AVG",
        "TEST.BBOX_AUG.H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(128,)",
        "TEST.BBOX_AUG.MAX_SIZE", "160", "TEST.BBOX_AUG.SCALE_H_FLIP", "True",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
        "TPU.COMPUTE_DTYPE", "float32", "TPU.PROPOSAL_BUCKETS", "(64,)",
        "TPU.IMAGE_PAD_MULTIPLE", "32", "DATALOADER.NUM_WORKERS", "1",
        "TPU.EVAL_DEVICE_RESIZE", "True"]


def _cfg(get_default, out_dir):
    cfg = get_default()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(out_dir)])
    cfg.freeze()
    return cfg


def test_device_resize_inference_matches_jax(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_voc(data, n_test=4, seed=0, img_hw=(120, 144), n_props=64)
    jcfg = _cfg(jax_cfg, tmp_path / "jax")
    jmodel, params = _jax_params(jcfg)
    (name, jloader), = jax_loaders(jcfg, data)
    jout = str(tmp_path / "jax" / name)
    os.makedirs(jout)
    jres = jax_inference(jmodel, {"params": params}, jcfg, jloader,
                         jloader.dataset, jout)

    cfg = _cfg(get_default_cfg, tmp_path / "torch")
    model = detector_from_cfg(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    (name, loader), = make_eval_loaders(cfg, data)
    out = str(tmp_path / "torch" / name)
    os.makedirs(out)
    timing, waits = {}, []
    orig = inf_mod.Inferencer.prep_base

    def counted(self, samples):
        waits.append(len(samples))
        return orig(self, samples)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inf_mod.Inferencer, "prep_base", counted)
        res = inf_mod.inference(model, cfg, loader, loader.dataset, out,
                                device="cpu", timing_out=timing)
    assert waits == [2, 2]                     # one base upload per batch
    assert timing["n_images"] == 4 and timing["n_forwards"] == 2 * 4
    assert timing["prep_wait_s"] > 0
    jpreds, preds = _predictions(jout), _predictions(out)
    for d, jd in zip(preds, jpreds):
        assert len(d["scores"]) == len(jd["scores"]) > 0
        o = np.lexsort((-d["scores"], d["labels"]))
        jo = np.lexsort((-jd["scores"], jd["labels"]))
        np.testing.assert_array_equal(d["labels"][o], jd["labels"][jo])
        np.testing.assert_allclose(d["scores"][o], jd["scores"][jo], rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(d["boxes"][o], jd["boxes"][jo], rtol=0,
                                   atol=BOX_ATOL_PX)
    assert abs(res["map"] - jres["map"]) <= 1e-6
