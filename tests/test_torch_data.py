"""The port's config, data path and TTA helpers against the JAX package's,
on the CPU.

Tolerances: the config trees are equal; transformed images, collated
batches and proposals are bit-identical (the same numpy and PIL code
runs on both sides); the device flip twin is bit-identical to collating
the host-flipped transform (images) and to 1e-4 px (boxes, as the JAX
package's own test bounds it); the TTA box helpers agree to 1e-5 px.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import torch

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data.collate import BatchCollator as JCollator
from odwscl_tpu.data.transforms import EvalTransform as JEvalTransform
from odwscl_tpu.data.transforms import Sample as JSample
from odwscl_tpu.data.voc import PascalVOCDataset as JVOC
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data.collate import BatchCollator
from odwscl_tpu_torch.data.synthetic import write_synthetic_voc
from odwscl_tpu_torch.data.transforms import EvalTransform, Sample
from odwscl_tpu_torch.data.voc import PascalVOCDataset
from odwscl_tpu_torch.engine import inference as tinf

# the module, not the function that odwscl_tpu.engine exports by that name
jinf = importlib.import_module("odwscl_tpu.engine.inference")

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "voc", "voc07_contra_db_b8_lr0.01_mcg.yaml")


def _plain(node):
    return {k: _plain(v) if isinstance(v, dict) else v
            for k, v in node.items()}


def test_default_config_equals_jax():
    assert _plain(get_default_cfg()) == _plain(jax_cfg())
    cfg, jcfg = get_default_cfg(), jax_cfg()
    cfg.merge_from_file(CONFIG)
    jcfg.merge_from_file(CONFIG)
    assert _plain(cfg) == _plain(jcfg)


def _samples(n=2, seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = 40 + 8 * i, 56 + 8 * i
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        rois = np.concatenate([rng.uniform(0, w // 2, (12, 1)),
                               rng.uniform(0, h // 2, (12, 1)),
                               rng.uniform(w // 2, w - 1, (12, 1)),
                               rng.uniform(h // 2, h - 1, (12, 1))],
                              1).astype(np.float32)
        out.append((Sample(image=Image.fromarray(img), size=(w, h),
                           rois=rois, image_id=i),
                    JSample(image=Image.fromarray(img), size=(w, h),
                            rois=rois, image_id=i)))
    return out


def test_eval_transform_and_collate_match_jax():
    pairs = _samples()
    for flip in (False, True):
        tr = EvalTransform(48, 96, flip=flip)
        jtr = JEvalTransform(48, 96, flip=flip)
        batch = BatchCollator(7, 32, 32, (16,))([tr(s) for s, _ in pairs])
        jbatch = JCollator(7, 32, 32, (16,))([jtr(j) for _, j in pairs])
        for field in ("images", "image_sizes", "boxes", "box_mask",
                      "labels"):
            np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                          np.asarray(getattr(jbatch, field)))


def test_device_flip_and_box_helpers_match_jax():
    pairs = _samples()
    tr = EvalTransform(48, 96)
    trf = EvalTransform(48, 96, flip=True)
    coll = BatchCollator(7, 32, 32, (16,))
    batch = coll([tr(s) for s, _ in pairs])
    host_flipped = coll([trf(s) for s, _ in pairs])
    dev_flipped = tinf._flip_batch(batch)
    np.testing.assert_array_equal(dev_flipped.images.numpy(),
                                  host_flipped.images.numpy())
    np.testing.assert_allclose(dev_flipped.boxes.numpy(),
                               host_flipped.boxes.numpy(), atol=1e-4)
    np.testing.assert_array_equal(dev_flipped.box_mask.numpy(),
                                  host_flipped.box_mask.numpy())

    rng = np.random.RandomState(1)
    boxes = rng.uniform(0, 90, (2, 16, 28)).astype(np.float32)
    widths = np.array([56.0, 64.0], np.float32)
    rw = np.array([1.5, 0.5], np.float32)
    rh = np.array([0.75, 2.0], np.float32)
    np.testing.assert_allclose(
        tinf._unflip_boxes(torch.from_numpy(boxes),
                           torch.from_numpy(widths)).numpy(),
        np.asarray(jinf._unflip_boxes_device(jnp.asarray(boxes),
                                             jnp.asarray(widths))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tinf._rescale_boxes(torch.from_numpy(boxes), torch.from_numpy(rw),
                            torch.from_numpy(rh)).numpy(),
        np.asarray(jinf._rescale_boxes_device(jnp.asarray(boxes),
                                              jnp.asarray(rw),
                                              jnp.asarray(rh))),
        rtol=0, atol=1e-5)


def test_tta_transforms_and_groups_match_jax():
    cfg, jcfg = get_default_cfg(), jax_cfg()
    cfg.merge_from_file(CONFIG)
    jcfg.merge_from_file(CONFIG)
    trs = tinf.TTAConfig(cfg).transforms()
    jtrs = jinf.TTAConfig(jcfg).transforms()
    assert len(trs) == len(jtrs) == 14
    key = [(t.min_size, t.max_size, t.flip) for t in trs]
    assert key == [(t.min_size, t.max_size, t.flip) for t in jtrs]
    groups = tinf._tta_groups(trs)
    jgroups = jinf._tta_groups(jtrs)
    assert ([(g.min_size, f) for g, f in groups]
            == [(g.min_size, f) for g, f in jgroups])
    assert len(groups) == 7 and all(f for _, f in groups)


def test_voc_dataset_matches_jax(tmp_path):
    write_synthetic_voc(str(tmp_path), n_test=3, seed=2, n_props=40)
    root = str(tmp_path / "voc" / "VOC2007")
    pfile = str(tmp_path / "proposal" / "SS-voc07_test.pkl")
    ds = PascalVOCDataset(root, "test", True, pfile)
    jds = JVOC(root, "test", True, pfile)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        s, js = ds[i], jds[i]
        assert s.size == js.size
        np.testing.assert_array_equal(np.asarray(s.image),
                                      np.asarray(js.image))
        np.testing.assert_array_equal(s.rois, js.rois)
        np.testing.assert_array_equal(s.gt_boxes, js.gt_boxes)
        np.testing.assert_array_equal(s.gt_labels, js.gt_labels)
        assert ds.get_img_info(i) == jds.get_img_info(i)
