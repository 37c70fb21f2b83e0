"""Eval loader assembly, VOC, single process.

Counterpart of the eval half of ``odwscl_tpu/data/build.py``: dataset +
sampler + transform + collator into an iterator of ``(batch, samples,
indices)``. A thread pool decodes the next batch's images while the
current one is evaluated.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
from typing import Optional

from ..config.catalog import DatasetCatalog
from .collate import BatchCollator, collator_from_cfg
from .samplers import InferenceSampler
from .transforms import EvalTransform
from .voc import PascalVOCDataset


def build_dataset(name: str, proposal_file: Optional[str],
                  data_root: str = "datasets") -> PascalVOCDataset:
    """A VOC test dataset; a relative proposal path resolves under
    ``data_root`` when it is not found as given."""
    if (proposal_file and not os.path.isabs(proposal_file)
            and not os.path.exists(proposal_file)):
        candidate = os.path.join(data_root, proposal_file)
        if os.path.exists(candidate):
            proposal_file = candidate
    info = DatasetCatalog.get(name, data_root)
    if info["factory"] != "PascalVOCDataset":
        raise NotImplementedError(f"dataset {name!r} ({info['factory']}) is "
                                  "not ported yet: VOC only")
    return PascalVOCDataset(proposal_file=proposal_file, use_difficult=True,
                            **info["args"])


class EvalLoader:
    """Sequential eval batches. Yields ``(Batch | None, samples, indices)``;
    with TTA (``transform=None``) the batch is None and the Inferencer
    transforms the raw samples per scale."""

    def __init__(self, dataset, transform: Optional[EvalTransform],
                 collator: BatchCollator, batch_size: int,
                 num_workers: int = 4):
        self.dataset = dataset
        self.transform = transform
        self.collator = collator
        self.sampler = InferenceSampler(len(dataset), batch_size)
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


def make_eval_loaders(cfg, data_root: str = "datasets"):
    """[(dataset name, EvalLoader)] for ``cfg.DATASETS.TEST``."""
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
                                      cfg.DATALOADER.NUM_WORKERS)))
    return loaders
