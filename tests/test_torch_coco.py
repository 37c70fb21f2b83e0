"""The port's COCO data path against the JAX package's, on the CPU.

- RLE (odwscl_tpu_torch/structures/rle.py): encode, decode and the
  compressed counts strings equal the JAX codec's on empty, full, 1x1,
  zero-size and odd-sized masks and on random masks with long runs;
  random count lists round-trip through both string codecs alike.
- The synthetic writer: ``write_synthetic_coco`` at
  ``tools/make_synthetic_coco.py``'s defaults writes byte-identical files
  (json, jpgs, proposal pickles).
- ``COCODataset`` (train: images without a non-crowd annotation dropped;
  eval: kept), ``WebDataset`` and ``ConcatDataset``: every sample's image,
  GT boxes and labels, rois, clicks and scribbles (the empty-scribble
  sentinel among them), ids and infos equal.
- ``make_train_loader`` for three epochs, one and two datasets, with and
  without aspect grouping, with ``SOLVER.CLASS_BATCH`` and with vertical
  flips: every Batch
  field equal, the collated clicks and scribbles included; the sampler's
  batches and ``class_batch_pairs`` equal for three epochs.
- ``CLASS_BATCH`` over several datasets or web data: the JAX package
  raises an AttributeError (``class_batch_pairs`` calls
  ``get_groundtruth``, which ``ConcatDataset`` and ``WebDataset`` lack), the
  port a ValueError naming the case.
- The collator's partial-label caps: 40 clicks keep the first 32.
- Two training datasets with one proposal file: the port raises a
  ValueError; the JAX package trains on the first dataset alone.
All comparisons are exact.
"""

import filecmp
import importlib.util
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from odwscl_tpu.config import get_default_cfg as jax_cfg
from odwscl_tpu.data import build as jbuild
from odwscl_tpu.data import collate as jcollate
from odwscl_tpu.data import samplers as jsamplers
from odwscl_tpu.data.transforms import Sample as JSample
from odwscl_tpu.structures import rle as jrle
from odwscl_tpu_torch.config import get_default_cfg
from odwscl_tpu_torch.data import build as tbuild
from odwscl_tpu_torch.data import collate as tcollate
from odwscl_tpu_torch.data import samplers as tsamplers
from odwscl_tpu_torch.data.synthetic import write_synthetic_coco
from odwscl_tpu_torch.data.transforms import Sample
from odwscl_tpu_torch.structures import rle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "coco",
                      "coco14_contra_db_b8_lr0.01_mcg.yaml")
TRAIN_PROPS = "proposal/MCG/coco/MCG-coco14_train.pkl"
VMM_PROPS = "proposal/MCG/coco/MCG-coco14_valminusminival.pkl"
N_TRAIN, N_VAL, N_VMM = 7, 4, 3


def _add_crowds_and_empties(root, split, first_new_id):
    """A crowd annotation on the split's first image, an image without
    annotations and one with only a crowd annotation (both with the first
    image's pixels and proposals)."""
    prop_path = os.path.join(root, f"proposal/MCG/coco/MCG-coco14_{split}"
                                   ".pkl")
    with open(prop_path, "rb") as f:
        props = pickle.load(f)
    props["boxes"] += [props["boxes"][0]] * 2
    props["indexes"] += [first_new_id, first_new_id + 1]
    with open(prop_path, "wb") as f:
        pickle.dump(props, f)
    path = os.path.join(root, f"coco/annotations/instances_{split}2014.json")
    img_dir = os.path.join(root, f"coco/{split}2014")
    with open(path) as f:
        data = json.load(f)
    src, anns = data["images"][0], data["annotations"]
    next_ann = max(a["id"] for a in anns) + 1
    crowd = dict(anns[0], id=next_ann, iscrowd=1, bbox=[2.0, 3.0, 40.0, 30.0])
    anns.append(crowd)
    for k in range(2):
        img_id = first_new_id + k
        name = f"{img_id:012d}.jpg"
        shutil.copy(os.path.join(img_dir, src["file_name"]),
                    os.path.join(img_dir, name))
        data["images"].append(dict(src, id=img_id, file_name=name))
        if k:
            anns.append(dict(crowd, id=next_ann + 1, image_id=img_id))
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco14"))
    write_synthetic_coco(root, N_TRAIN, N_VAL, seed=3, img_hw=(100, 130),
                         n_props=40, layout="coco14",
                         n_valminusminival=N_VMM, partial=True, web=True)
    _add_crowds_and_empties(root, "train", 500)
    _add_crowds_and_empties(root, "val", 600)
    return root


# -- RLE ---------------------------------------------------------------------

def _masks():
    rng = np.random.RandomState(0)
    long_runs = np.zeros((37, 29), np.uint8)
    long_runs[5:30, 3:20] = 1
    long_runs[0, 0] = 1
    return {"empty": np.zeros((7, 5), np.uint8),
            "full": np.ones((7, 5), np.uint8),
            "one": np.ones((1, 1), np.uint8),
            "zero_size": np.zeros((0, 3), np.uint8),
            "odd_random": (rng.rand(13, 11) > 0.5).astype(np.uint8),
            "sparse": (rng.rand(31, 17) > 0.97).astype(np.uint8),
            "long_runs": long_runs,
            "bool_big": rng.rand(120, 97) > 0.2}


@pytest.mark.parametrize("name", list(_masks()))
def test_rle_matches_jax(name):
    m = _masks()[name]
    got, want = rle.rle_encode(m), jrle.rle_encode(m)
    assert got == want
    np.testing.assert_array_equal(rle.rle_decode(got), jrle.rle_decode(want))
    np.testing.assert_array_equal(rle.rle_decode(got), m != 0)
    counts = rle._counts_from_string(got["counts"])
    assert counts == jrle._counts_from_string(want["counts"])
    # the uncompressed form decodes alike
    plain = {"size": got["size"], "counts": counts}
    np.testing.assert_array_equal(rle.rle_decode(plain),
                                  jrle.rle_decode(plain))
    assert rle.is_rle(got) and not rle.is_rle([[0, 1, 2, 3]])
    if m.size:
        np.testing.assert_array_equal(
            rle.rasterize_segmentation(got, *m.shape),
            jrle.rasterize_segmentation(want, *m.shape))


def test_rle_count_strings_match_jax():
    rng = np.random.RandomState(1)
    for _ in range(50):
        counts = rng.randint(0, 5000, rng.randint(1, 30)).tolist()
        s = rle._counts_to_string(counts)
        assert s == jrle._counts_to_string(counts)
        assert rle._counts_from_string(s) == counts
        assert rle._counts_from_string(s.encode()) == \
            jrle._counts_from_string(s.encode())


def test_rle_polygon_raises():
    """Polygon segmentations rasterize as the JAX package's; an RLE of
    another size than the image still raises."""
    poly = [[0, 0, 4, 0, 4, 4]]
    np.testing.assert_array_equal(rle.rasterize_segmentation(poly, 8, 8),
                                  jrle.rasterize_segmentation(poly, 8, 8))
    with pytest.raises(ValueError, match="RLE size"):
        rle.rasterize_segmentation(rle.rle_encode(np.ones((4, 4))), 8, 8)


# -- the synthetic writer ----------------------------------------------------

def test_synthetic_writer_matches_jax_tool(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_coco", os.path.join(REPO, "tools",
                                            "make_synthetic_coco.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    tool.main(out=jax_out)
    write_synthetic_coco(port_out)
    files = sorted(os.path.relpath(os.path.join(d, f), jax_out)
                   for d, _, fs in os.walk(jax_out) for f in fs)
    got = sorted(os.path.relpath(os.path.join(d, f), port_out)
                 for d, _, fs in os.walk(port_out) for f in fs)
    assert files == got and len(files) == 16
    for rel in files:
        assert filecmp.cmp(os.path.join(jax_out, rel),
                           os.path.join(port_out, rel), shallow=False), rel


# -- datasets ----------------------------------------------------------------

def _assert_samples_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.image),
                                  np.asarray(want.image))
    assert got.size == want.size and got.image_id == want.image_id
    for name in ("gt_boxes", "gt_labels", "gt_difficult", "rois", "clicks",
                 "click_labels", "scribbles", "scribble_labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _datasets(name, pfile, root, is_train):
    return (tbuild.build_dataset(name, pfile, root, is_train=is_train),
            jbuild.build_dataset(name, pfile, is_train, root))


@pytest.mark.parametrize("split,is_train", [
    ("coco_2014_train", True), ("coco_2014_val", False),
    ("coco_2014_valminusminival", True)])
def test_coco_dataset_matches_jax(coco, split, is_train):
    pfile = {"coco_2014_train": TRAIN_PROPS,
             "coco_2014_val": "proposal/MCG/coco/MCG-coco14_val.pkl",
             "coco_2014_valminusminival": VMM_PROPS}[split]
    got, want = _datasets(split, pfile, coco, is_train)
    assert got.ids == want.ids and got.id_to_img_map == want.id_to_img_map
    extra = {"coco_2014_train": 2, "coco_2014_val": 2}.get(split, 0)
    n = {"coco_2014_train": N_TRAIN, "coco_2014_val": N_VAL}.get(split, N_VMM)
    # training drops the image without annotations and the crowd-only one
    assert len(got) == n + (0 if is_train else extra)
    assert (got.json_category_id_to_contiguous_id
            == want.json_category_id_to_contiguous_id)
    assert len(got.json_category_id_to_contiguous_id) == 80
    assert got.json_category_id_to_contiguous_id[90] == 80
    sentinels = 0
    for i in range(len(got)):
        assert got.get_img_info(i) == want.get_img_info(i)
        assert got.get_origin_id(i) == want.get_origin_id(i)
        for a, b in zip(got.get_groundtruth(i), want.get_groundtruth(i)):
            np.testing.assert_array_equal(a, b)
        s = got[i]
        _assert_samples_equal(s, want[i])
        if s.scribbles is not None:
            sentinels += int((s.scribbles == [1, 2, 3, 4]).all(-1).sum())
    for c in (1, 12, 80):
        assert (got.map_class_id_to_class_name(c)
                == want.map_class_id_to_class_name(c))
    if split == "coco_2014_train":
        assert sentinels > 0            # the empty-scribble sentinel ran


def test_web_dataset_matches_jax(coco):
    got, want = _datasets("flickr_coco", "proposal/flickr_coco.pkl", coco,
                          True)
    assert len(got) == len(want) == N_TRAIN
    assert got.id_to_img_map == want.id_to_img_map
    for i in range(len(got)):
        assert got.get_img_info(i) == want.get_img_info(i)
        _assert_samples_equal(got[i], want[i])
        assert len(got[i].gt_labels) and not len(got[i].gt_boxes)


def test_concat_dataset_matches_jax(coco):
    parts = [_datasets(n, p, coco, True) for n, p in (
        ("coco_2014_train", TRAIN_PROPS),
        ("coco_2014_valminusminival", VMM_PROPS))]
    got = tbuild.ConcatDataset([p[0] for p in parts])
    want = jbuild.ConcatDataset([p[1] for p in parts])
    assert len(got) == len(want) == N_TRAIN + N_VMM
    for i in range(len(got)):
        assert got.get_img_info(i) == want.get_img_info(i)
        _assert_samples_equal(got[i], want[i])


# -- loaders and samplers ----------------------------------------------------

LOADER_OPTS = ["INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN",
               "120", "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS",
               "1", "TPU.PROPOSAL_BUCKETS", "(64,)"]
CASES = {
    "one": [],
    "one_no_grouping": ["DATALOADER.ASPECT_RATIO_GROUPING", "False"],
    "two": ["DATASETS.TRAIN",
            "('coco_2014_train', 'coco_2014_valminusminival')",
            "PROPOSAL_FILES.TRAIN", f"('{TRAIN_PROPS}', '{VMM_PROPS}')"],
    "two_no_grouping": ["DATASETS.TRAIN",
                        "('coco_2014_train', 'coco_2014_valminusminival')",
                        "PROPOSAL_FILES.TRAIN",
                        f"('{TRAIN_PROPS}', '{VMM_PROPS}')",
                        "DATALOADER.ASPECT_RATIO_GROUPING", "False"],
    "class_batch": ["SOLVER.CLASS_BATCH", "True"],
    "vflip": ["INPUT.VERTICAL_FLIP_PROB_TRAIN", "0.5"],
}
BATCH_FIELDS = ("images", "image_sizes", "boxes", "box_mask", "labels",
                "clicks", "click_labels", "click_mask", "scribbles",
                "scribble_labels", "scribble_mask")


def _cfg(get_default, opts):
    cfg = get_default()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg


def _epoch_iters(loader):
    """Iterations in three epochs of the loader's sampler."""
    s = loader.sampler
    return sum(len(s._epoch_batches(e)) for e in range(3))


@pytest.mark.parametrize("case", list(CASES))
def test_train_loader_matches_jax_three_epochs(coco, case):
    opts = LOADER_OPTS + CASES[case]
    probe = tbuild.make_train_loader(_cfg(get_default_cfg, opts), 0, coco)
    opts = opts + ["SOLVER.MAX_ITER", str(_epoch_iters(probe))]
    loader = tbuild.make_train_loader(_cfg(get_default_cfg, opts), 0, coco)
    jloader = jbuild.make_train_loader(_cfg(jax_cfg, opts), data_root=coco)
    assert len(loader) == len(jloader) >= 9
    assert ([b.tolist() for b in loader.sampler]
            == [b.tolist() for b in jloader.sampler])
    n_clicks = 0
    for got, want in zip(loader, jloader):
        for name in BATCH_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        n_clicks += int(got.click_mask.sum())
    assert n_clicks > 0


@pytest.mark.parametrize("batch_size", [2, 3, 4])
def test_class_batch_pairs_match_jax(coco, batch_size):
    got, want = _datasets("coco_2014_train", TRAIN_PROPS, coco, True)
    for epoch in range(3):
        a = tsamplers.class_batch_pairs(got, batch_size, epoch)
        b = jsamplers.class_batch_pairs(want, batch_size, epoch)
        assert [x.tolist() for x in a] == [x.tolist() for x in b]
        assert all(len(x) == batch_size for x in a)
    sampler = tsamplers.IterationBatchSampler(
        len(got), batch_size, 12, start_iter=2,
        epoch_batches_fn=lambda e: tsamplers.class_batch_pairs(
            got, batch_size, e))
    jsampler = jsamplers.IterationBatchSampler(
        len(want), batch_size, 12, start_iter=2,
        epoch_batches_fn=lambda e: jsamplers.class_batch_pairs(
            want, batch_size, e))
    assert ([b.tolist() for b in sampler]
            == [b.tolist() for b in jsampler])


@pytest.mark.parametrize("train", [
    ("coco_2014_train", "coco_2014_valminusminival"), ("flickr_coco",)])
def test_class_batch_without_groundtruth_raises(coco, train):
    props = {"coco_2014_train": TRAIN_PROPS,
             "coco_2014_valminusminival": VMM_PROPS,
             "flickr_coco": "proposal/flickr_coco.pkl"}
    opts = LOADER_OPTS + ["SOLVER.CLASS_BATCH", "True", "SOLVER.MAX_ITER",
                          "2", "DATASETS.TRAIN", str(train),
                          "PROPOSAL_FILES.TRAIN",
                          str(tuple(props[n] for n in train))]
    with pytest.raises(AttributeError, match="get_groundtruth"):
        list(jbuild.make_train_loader(_cfg(jax_cfg, opts), data_root=coco))
    with pytest.raises(ValueError, match="CLASS_BATCH"):
        tbuild.make_train_loader(_cfg(get_default_cfg, opts), 0, coco)


def test_collate_partial_caps_match_jax():
    rng = np.random.RandomState(5)

    def samples(cls):
        out = []
        for k in (40, 0, 3):
            img = rng.randn(50 + k, 60, 3).astype(np.float32)
            out.append(cls(image=img, size=(60, 50 + k),
                           gt_labels=np.array([2, 5]),
                           rois=rng.uniform(0, 40, (10, 4)).astype(np.float32),
                           clicks=rng.uniform(0, 50, (k, 2)).astype(np.float32),
                           click_labels=rng.randint(1, 81, k),
                           scribbles=(rng.uniform(0, 50, (k, 4))
                                      .astype(np.float32) if k else None),
                           scribble_labels=(rng.randint(1, 81, k)
                                            if k else None)))
        return out

    state = rng.get_state()
    got = tcollate.BatchCollator(81, proposal_buckets=(16,))(samples(Sample))
    rng.set_state(state)
    want = jcollate.BatchCollator(81, proposal_buckets=(16,))(
        samples(JSample))
    assert got.clicks.shape == (3, 32, 2)
    assert got.click_mask.sum().item() == 35
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_proposal_file_count_must_match_datasets(coco):
    """Two training datasets and one proposal file: the port raises (the
    JAX package's ``zip`` would train on the first dataset alone)."""
    opts = LOADER_OPTS + ["SOLVER.MAX_ITER", "2", "DATASETS.TRAIN",
                          "('coco_2014_train', 'coco_2014_valminusminival')",
                          "PROPOSAL_FILES.TRAIN", f"('{TRAIN_PROPS}',)"]
    assert len(jbuild.make_train_loader(_cfg(jax_cfg, opts),
                                        data_root=coco).dataset) == N_TRAIN
    with pytest.raises(ValueError, match="PROPOSAL_FILES.TRAIN"):
        tbuild.make_train_loader(_cfg(get_default_cfg, opts), 0, coco)
