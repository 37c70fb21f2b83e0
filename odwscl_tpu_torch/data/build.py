"""Loader assembly: VOC, COCO and web datasets.

Counterpart of ``odwscl_tpu/data/build.py``: dataset + sampler + transform
+ collator. The train loader yields CPU ``Batch``es (a process's share of
each global batch when several train), over
one dataset or several concatenated, with aspect grouping or
``SOLVER.CLASS_BATCH`` pairs; the eval loader yields ``(batch, samples,
indices)``, sharded by process when several run. A thread pool prepares
the next batch while the current one runs.
"""

from __future__ import annotations

import concurrent.futures as futures
import functools
import os
from typing import Optional

import numpy as np
import torch.distributed as dist

from ..config.catalog import DatasetCatalog
from ..utils.dist import process_count_and_index
from .collate import BatchCollator, collator_from_cfg
from .coco_dataset import COCODataset
from .flickr import WebDataset
from .samplers import (InferenceSampler, IterationBatchSampler,
                       aspect_ratio_groups, class_batch_pairs,
                       require_groundtruth)
from .transforms import EvalTransform, TrainTransform, build_train_transform
from .voc import PascalVOCDataset


def build_dataset(name: str, proposal_file: Optional[str],
                  data_root: str = "datasets", is_train: bool = False,
                  load_masks: bool = False, load_keypoints: bool = False):
    """The catalog's dataset ``name``: VOC (difficult objects kept for
    evaluation only), COCO (images without a non-crowd annotation dropped
    in training only; with the instance masks and keypoints that
    ``load_masks`` and ``load_keypoints`` ask for) or web
    data. A relative proposal path resolves under ``data_root`` when it is
    not found as given."""
    if (proposal_file and not os.path.isabs(proposal_file)
            and not os.path.exists(proposal_file)):
        candidate = os.path.join(data_root, proposal_file)
        if os.path.exists(candidate):
            proposal_file = candidate
    info = DatasetCatalog.get(name, data_root)
    factory, args = info["factory"], info["args"]
    if factory == "PascalVOCDataset":
        return PascalVOCDataset(proposal_file=proposal_file,
                                use_difficult=not is_train, **args)
    if factory == "COCODataset":
        return COCODataset(proposal_file=proposal_file,
                           remove_images_without_annotations=is_train,
                           load_masks=load_masks,
                           load_keypoints=load_keypoints, **args)
    if factory == "WebDataset":
        return WebDataset(proposal_file=proposal_file, **args)
    raise ValueError(f"unknown dataset factory {factory}")


class ConcatDataset:
    """Several datasets as one, indexed in order (the samples keep their
    own datasets' ``image_id``)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d], idx - int(self.offsets[d])

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def get_img_info(self, idx):
        ds, i = self._locate(idx)
        return ds.get_img_info(i)


class TrainLoader:
    """Training batches for iterations ``start_iter + 1 .. max_iter``. The
    sample at (iteration, index) is transformed with
    ``RandomState((seed + iteration * 100003 + index) % 2**31)``, the
    iteration counted from 0 at the start of training, so a resumed run
    sees the arrays of an uninterrupted one, and each process of a
    data-parallel run the images of one process."""

    def __init__(self, dataset, transform: TrainTransform,
                 collator: BatchCollator, batch_size: int, max_iter: int,
                 start_iter: int = 0, seed: int = 1234,
                 aspect_grouping: bool = True, num_workers: int = 4,
                 class_batch: bool = False, process_count: int = 1,
                 process_index: int = 0, agree=None):
        """``class_batch`` (``SOLVER.CLASS_BATCH``) batches image pairs
        that share a class (``class_batch_pairs``) instead of grouping by
        aspect. Process ``process_index`` of ``process_count`` loads its
        share of each global batch of ``batch_size`` images, padded to the
        widths that ``agree`` returns (``BatchCollator.__call__``)."""
        self.dataset = dataset
        self.transform = transform
        self.collator = collator
        ebf = None
        if class_batch:
            require_groundtruth(dataset)
            ebf = functools.partial(class_batch_pairs, dataset, batch_size)
        self.sampler = IterationBatchSampler(
            len(dataset), batch_size, max_iter, start_iter=start_iter,
            groups=(aspect_ratio_groups(dataset)
                    if aspect_grouping and not class_batch else None),
            epoch_batches_fn=ebf, process_count=process_count,
            process_index=process_index)
        self.agree = agree
        self.start_iter = start_iter
        self.seed = seed
        self.num_workers = max(num_workers, 1)

    def __len__(self):
        return len(self.sampler)

    def _load_one(self, idx: int, it: int):
        rng = np.random.RandomState(
            (self.seed + it * 100003 + int(idx)) % (2 ** 31))
        return self.transform(self.dataset[int(idx)], rng)

    def __iter__(self):
        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = None
            for k, batch_idx in enumerate(self.sampler):
                it = self.start_iter + k
                fs = [pool.submit(self._load_one, i, it) for i in batch_idx]
                if pending is not None:
                    yield self.collator([f.result() for f in pending],
                                        self.agree)
                pending = fs
            if pending is not None:
                yield self.collator([f.result() for f in pending],
                                    self.agree)


def make_train_loader(cfg, start_iter: int = 0,
                      data_root: str = "datasets",
                      process_count: Optional[int] = None,
                      process_index: Optional[int] = None,
                      agree=None) -> TrainLoader:
    """The train loader of ``cfg.DATASETS.TRAIN``, each dataset with its
    ``PROPOSAL_FILES.TRAIN`` entry; several datasets are concatenated. A
    count of proposal files other than the datasets' raises (the JAX
    package's ``zip`` drops the datasets past the last file).

    ``process_count`` and ``process_index`` default to
    ``torch.distributed``'s world size and rank when it is initialized
    (else one process); ``agree`` then defaults to
    ``parallel.mesh.DataParallel().agree_widths``, so that every rank pads
    its share to the global batch's widths."""
    pc, pi = process_count_and_index(process_count, process_index)
    if agree is None and dist.is_available() and dist.is_initialized():
        from ..parallel.mesh import DataParallel
        agree = DataParallel().agree_widths
    names = cfg.DATASETS.TRAIN
    pfiles = cfg.PROPOSAL_FILES.TRAIN or (None,) * len(names)
    if len(pfiles) != len(names):
        raise ValueError(f"DATASETS.TRAIN {names} needs one "
                         f"PROPOSAL_FILES.TRAIN entry each: {pfiles}")
    datasets = [build_dataset(n, p, data_root, is_train=True,
                              load_masks=cfg.MODEL.MASK_ON,
                              load_keypoints=cfg.MODEL.KEYPOINT_ON)
                for n, p in zip(names, pfiles)]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    return TrainLoader(dataset, build_train_transform(cfg),
                       collator_from_cfg(cfg),
                       batch_size=cfg.SOLVER.IMS_PER_BATCH,
                       max_iter=cfg.SOLVER.MAX_ITER, start_iter=start_iter,
                       seed=cfg.SEED,
                       aspect_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING,
                       num_workers=cfg.DATALOADER.NUM_WORKERS,
                       class_batch=cfg.SOLVER.CLASS_BATCH, process_count=pc,
                       process_index=pi, agree=agree)


class EvalLoader:
    """Sequential eval batches. Yields ``(Batch | None, samples, indices)``;
    with TTA (``transform=None``) the batch is None and the Inferencer
    transforms the raw samples per scale."""

    def __init__(self, dataset, transform: Optional[EvalTransform],
                 collator: BatchCollator, batch_size: int,
                 num_workers: int = 4, process_count: int = 1,
                 process_index: int = 0):
        self.dataset = dataset
        self.transform = transform
        self.collator = collator
        self.sampler = InferenceSampler(len(dataset), batch_size,
                                        process_count, process_index)
        self.num_workers = max(num_workers, 1)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        def load(i):
            s = self.dataset[int(i)]
            return self.transform(s) if self.transform is not None else s

        def collate(samples):
            return None if self.transform is None else self.collator(samples)

        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending, pending_idx = None, None
            for batch_idx in self.sampler:
                fs = [pool.submit(load, i) for i in batch_idx]
                if pending is not None:
                    samples = [f.result() for f in pending]
                    yield collate(samples), samples, pending_idx
                pending, pending_idx = fs, batch_idx
            if pending is not None:
                samples = [f.result() for f in pending]
                yield collate(samples), samples, pending_idx


def make_eval_loaders(cfg, data_root: str = "datasets",
                      process_count: Optional[int] = None,
                      process_index: Optional[int] = None):
    """[(dataset name, EvalLoader)] for ``cfg.DATASETS.TEST``, each sharded
    ``process_index::process_count`` (by default ``torch.distributed``'s
    rank and world size when it is initialized, else unsharded)."""
    pc, pi = process_count_and_index(process_count, process_index)
    names = cfg.DATASETS.TEST
    pfiles = cfg.PROPOSAL_FILES.TEST or (None,) * len(names)
    loaders = []
    for n, p in zip(names, pfiles):
        ds = build_dataset(n, p, data_root,
                           load_masks=cfg.MODEL.MASK_ON,
                           load_keypoints=cfg.MODEL.KEYPOINT_ON)
        transform = (None if cfg.TEST.BBOX_AUG.ENABLED else EvalTransform(
            cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST,
            tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD),
            cfg.INPUT.TO_BGR255))
        loaders.append((n, EvalLoader(ds, transform, collator_from_cfg(cfg),
                                      cfg.TEST.IMS_PER_BATCH,
                                      cfg.DATALOADER.NUM_WORKERS, pc, pi)))
    return loaders
