"""Loader assembly, VOC.

Counterpart of ``odwscl_tpu/data/build.py``: dataset + sampler + transform
+ collator. The train loader yields CPU ``Batch``es (one process); the
eval loader yields ``(batch, samples, indices)``, sharded by process when
several run. A thread pool prepares the next batch while the current one
runs.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
from typing import Optional

import numpy as np

from ..config.catalog import DatasetCatalog
from ..utils.dist import process_count_and_index
from .collate import BatchCollator, collator_from_cfg
from .samplers import (InferenceSampler, IterationBatchSampler,
                       aspect_ratio_groups)
from .transforms import EvalTransform, TrainTransform, build_train_transform
from .voc import PascalVOCDataset


def build_dataset(name: str, proposal_file: Optional[str],
                  data_root: str = "datasets",
                  is_train: bool = False) -> PascalVOCDataset:
    """A VOC dataset (difficult objects kept for evaluation only); a
    relative proposal path resolves under ``data_root`` when it is not
    found as given."""
    if (proposal_file and not os.path.isabs(proposal_file)
            and not os.path.exists(proposal_file)):
        candidate = os.path.join(data_root, proposal_file)
        if os.path.exists(candidate):
            proposal_file = candidate
    info = DatasetCatalog.get(name, data_root)
    if info["factory"] != "PascalVOCDataset":
        raise NotImplementedError(f"dataset {name!r} ({info['factory']}) is "
                                  "not ported yet: VOC only")
    return PascalVOCDataset(proposal_file=proposal_file,
                            use_difficult=not is_train, **info["args"])


class TrainLoader:
    """Training batches for iterations ``start_iter + 1 .. max_iter``. The
    sample at (iteration, index) is transformed with
    ``RandomState((seed + iteration * 100003 + index) % 2**31)``, the
    iteration counted from 0 at the start of training, so a resumed run
    sees the arrays of an uninterrupted one."""

    def __init__(self, dataset, transform: TrainTransform,
                 collator: BatchCollator, batch_size: int, max_iter: int,
                 start_iter: int = 0, seed: int = 1234,
                 aspect_grouping: bool = True, num_workers: int = 4):
        self.dataset = dataset
        self.transform = transform
        self.collator = collator
        self.sampler = IterationBatchSampler(
            len(dataset), batch_size, max_iter, start_iter=start_iter,
            groups=aspect_ratio_groups(dataset) if aspect_grouping else None)
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
                    yield self.collator([f.result() for f in pending])
                pending = fs
            if pending is not None:
                yield self.collator([f.result() for f in pending])


def make_train_loader(cfg, start_iter: int = 0,
                      data_root: str = "datasets") -> TrainLoader:
    """The train loader of ``cfg.DATASETS.TRAIN`` (one VOC dataset)."""
    if cfg.SOLVER.CLASS_BATCH:
        raise NotImplementedError("SOLVER.CLASS_BATCH is not ported yet")
    names = cfg.DATASETS.TRAIN
    if len(names) != 1:
        raise NotImplementedError("training on several datasets is not "
                                  f"ported yet: {names}")
    pfiles = cfg.PROPOSAL_FILES.TRAIN or (None,)
    dataset = build_dataset(names[0], pfiles[0], data_root, is_train=True)
    return TrainLoader(dataset, build_train_transform(cfg),
                       collator_from_cfg(cfg),
                       batch_size=cfg.SOLVER.IMS_PER_BATCH,
                       max_iter=cfg.SOLVER.MAX_ITER, start_iter=start_iter,
                       seed=cfg.SEED,
                       aspect_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING,
                       num_workers=cfg.DATALOADER.NUM_WORKERS)


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
        ds = build_dataset(n, p, data_root)
        transform = (None if cfg.TEST.BBOX_AUG.ENABLED else EvalTransform(
            cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST,
            tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD),
            cfg.INPUT.TO_BGR255))
        loaders.append((n, EvalLoader(ds, transform, collator_from_cfg(cfg),
                                      cfg.TEST.IMS_PER_BATCH,
                                      cfg.DATALOADER.NUM_WORKERS, pc, pi)))
    return loaders
