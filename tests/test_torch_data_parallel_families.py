"""Data-parallel training of the port: RetinaNet against one process (as
tests/test_torch_data_parallel_supervised.py holds Mask R-CNN), and the
pieces around the step: the sampler's shards, the refusal of a batch the
world size does not divide, the collator's global widths, the skip of
an unlabeled global batch and ``TPU.MESH_AXES``.

- ``IterationBatchSampler``'s per-process shards are disjoint and make up
  the global batch, and equal the JAX sampler's (as
  tests/test_multihost.py holds the JAX one); a batch size the process
  count does not divide raises (the JAX sampler asserts at construction
  and drops the remainder of a shorter batch).
- ``BatchCollator`` with ``agree``: one rank's share padded to the global
  widths equals its rows of the whole batch collated at once (canvas,
  proposals, clicks present on the other rank only).
- A global batch with no image label is skipped on every rank, and one
  whose labels are all on rank 1 is trained on both.
"""

import numpy as np
import pytest
import torch

from odwscl_tpu_torch.data.collate import BatchCollator
from odwscl_tpu_torch.data.samplers import IterationBatchSampler
from odwscl_tpu_torch.data.transforms import Sample
from test_torch_data_parallel_supervised import check_supervised
from torch_dp_workers import run_ranks


def test_retinanet_data_parallel_equals_one_process(tmp_path):
    check_supervised("configs/coco/coco_retinanet_smoke.yaml", tmp_path)


def test_sampler_shards_cover_the_global_batch():
    from odwscl_tpu.data.samplers import IterationBatchSampler as JSampler

    n, bs, iters = 37, 8, 12
    full = [list(b) for b in IterationBatchSampler(n, bs, iters)]
    shards = [[list(b) for b in IterationBatchSampler(
        n, bs, iters, process_count=2, process_index=r)] for r in range(2)]
    want = [[list(b) for b in JSampler(n, bs, iters, process_count=2,
                                       process_index=r)] for r in range(2)]
    assert shards == want
    assert len(shards[0]) == len(shards[1]) == iters
    for b0, b1, fb in zip(*shards, full):
        assert len(b0) == len(b1) == bs // 2
        assert not set(b0) & set(b1)
        assert b0 + b1 == fb
    four = [[list(b) for b in IterationBatchSampler(
        n, bs, iters, process_count=4, process_index=r)] for r in range(4)]
    assert [sum(parts, []) for parts in zip(*four)] == full


def test_a_batch_the_world_does_not_divide_raises(tmp_path):
    from odwscl_tpu_torch.config import get_default_cfg
    from odwscl_tpu_torch.data.build import make_train_loader
    from odwscl_tpu_torch.data.synthetic import write_synthetic_voc

    with pytest.raises(ValueError, match="multiple of the world size"):
        IterationBatchSampler(10, 3, 5, process_count=2, process_index=0)
    write_synthetic_voc(str(tmp_path), n_test=1, n_trainval=3, n_props=8)
    cfg = get_default_cfg()
    cfg.merge_from_file("configs/voc/voc07_synth_smoke.yaml")
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "3"])
    with pytest.raises(ValueError, match="does not split over 2"):
        make_train_loader(cfg, 0, str(tmp_path), process_count=2,
                          process_index=1)


def _sample(rng, h, w, n_rois, clicks=False):
    rois = rng.uniform(0, min(h, w) - 9, (n_rois, 2))
    rois = np.concatenate([rois, rois + 8], 1).astype(np.float32)
    extra = {}
    if clicks:
        extra = dict(clicks=rng.uniform(0, 30, (3, 2)).astype(np.float32),
                     click_labels=np.array([1, 2, 3]))
    return Sample(image=rng.randn(h, w, 3).astype(np.float32), size=(w, h),
                  gt_labels=np.array([1 + n_rois % 4]), rois=rois, **extra)


def test_collator_pads_a_share_to_the_global_widths():
    rng = np.random.RandomState(0)
    shares = [[_sample(rng, 40, 70, 5), _sample(rng, 50, 60, 9)],
              [_sample(rng, 90, 60, 20, clicks=True),
               _sample(rng, 30, 30, 3)]]
    coll = BatchCollator(num_classes=6, size_divisibility=16,
                         image_pad_multiple=32, proposal_buckets=(8, 16, 32))
    whole = coll(shares[0] + shares[1])
    widths = [coll.widths(s) for s in shares]
    agreed = {k: max(w[k] for w in widths) for k in widths[0]}
    assert widths[0] != agreed
    for r, share in enumerate(shares):
        part = coll(share, lambda wd: agreed)
        rows = slice(2 * r, 2 * r + 2)
        for name in ("images", "image_sizes", "boxes", "box_mask", "labels",
                     "clicks", "click_labels", "click_mask"):
            got, want = getattr(part, name), getattr(whole, name)
            assert got.shape[1:] == want.shape[1:], name
            assert torch.equal(got, want[rows]), name
    assert whole.images.shape[1:3] == (96, 96)
    assert whole.boxes.shape[1] == 32


def test_unlabeled_global_batch_is_skipped_on_every_rank(tmp_path):
    rng = np.random.RandomState(0)

    def batch(labels):
        b, p = 2, 6
        xy = rng.uniform(0, 20, (b, p, 2))
        return {"images": rng.randn(b, 48, 64, 3).astype(np.float32) * 50,
                "image_sizes": np.array([[48, 64]] * b, np.float32),
                "boxes": np.concatenate([xy, xy + 16], -1).astype(np.float32),
                "box_mask": np.ones((b, p), bool),
                "labels": np.asarray(labels, np.float32)}

    lab = np.zeros((2, 21), np.float32)
    lab[0, 3] = lab[1, 5] = 1
    on_rank1 = lab.copy()
    on_rank1[0] = 0
    batches = [batch(lab), batch(np.zeros((2, 21))), batch(on_rank1)]
    opts = ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "TPU.COMPUTE_DTYPE",
            "float32", "TPU.BANK_CAPACITY", "64"]
    ranks = run_ranks(2, tmp_path, "train_batches",
                      "configs/voc/voc07_synth_smoke.yaml", opts, batches)
    for steps in ranks:
        assert [s["iter"] for s in steps] == [1, 2]
        assert all(np.isfinite(s["loss"]) for s in steps)
    assert [s["loss"] for s in ranks[0]] == [s["loss"] for s in ranks[1]]


def test_mesh_axes_as_the_jax_package_reads_them():
    """``TPU.MESH_AXES``: the first axis takes every process, the others
    are sized 1 (odwscl_tpu/parallel/mesh.py:22-31, there over devices)."""
    import jax

    from odwscl_tpu.parallel import make_mesh as jax_make_mesh
    from odwscl_tpu_torch.parallel import make_mesh

    for axes in (("data",), ("data", "tensor")):
        mesh = make_mesh(axes)
        want = jax_make_mesh(axes, jax.devices()[:1])
        assert mesh.axis_names == tuple(want.axis_names)
        assert mesh.shape == tuple(want.devices.shape) == \
            (1,) + (1,) * (len(axes) - 1)
