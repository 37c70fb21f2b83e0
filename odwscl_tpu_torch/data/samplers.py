"""Samplers: epoch-seeded shuffling with aspect-ratio grouping, recycled
up to a number of iterations and resumable, and sequential eval batches.

Counterpart of ``odwscl_tpu/data/samplers.py`` for one process.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


def aspect_ratio_groups(dataset) -> np.ndarray:
    """0 = landscape (w >= h), 1 = portrait, per image."""
    flags = np.zeros(len(dataset), np.int64)
    for i in range(len(dataset)):
        info = dataset.get_img_info(i)
        flags[i] = 1 if info["height"] > info["width"] else 0
    return flags


class IterationBatchSampler:
    """Batches of dataset indices up to ``num_iterations``. Each epoch
    shuffles with ``RandomState(epoch)`` and pads the order to whole
    batches; with ``groups`` every batch stays in one aspect group and the
    epoch's batches are shuffled. Iterations before ``start_iter`` are
    skipped (resume)."""

    def __init__(self, dataset_len: int, batch_size: int,
                 num_iterations: int, start_iter: int = 0,
                 groups: Optional[np.ndarray] = None):
        self.n = dataset_len
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.start_iter = start_iter
        self.groups = groups

    def _epoch_batches(self, epoch: int) -> List[np.ndarray]:
        rng = np.random.RandomState(epoch)
        order = rng.permutation(self.n)
        total = int(np.ceil(self.n / self.batch_size)) * self.batch_size
        order = np.concatenate([order, order[: total - self.n]])
        if self.groups is not None:
            batches = []
            for g in np.unique(self.groups):
                sel = order[self.groups[order] == g]
                for k in range(0, len(sel) - self.batch_size + 1,
                               self.batch_size):
                    batches.append(sel[k:k + self.batch_size])
            rng.shuffle(batches)
            return batches
        return [order[k:k + self.batch_size]
                for k in range(0, total, self.batch_size)]

    def __iter__(self) -> Iterator[np.ndarray]:
        it, epoch = 0, 0
        while it < self.num_iterations:
            for batch in self._epoch_batches(epoch):
                if it >= self.num_iterations:
                    return
                it += 1
                if it <= self.start_iter:
                    continue
                yield batch
            epoch += 1

    def __len__(self):
        return self.num_iterations - self.start_iter


class InferenceSampler:
    """Sequential batches over the dataset, optionally sharded by process."""

    def __init__(self, dataset_len: int, batch_size: int,
                 process_count: int = 1, process_index: int = 0):
        self.indices = np.arange(dataset_len)[process_index::process_count]
        self.batch_size = batch_size

    def __iter__(self):
        for k in range(0, len(self.indices), self.batch_size):
            yield self.indices[k:k + self.batch_size]

    def __len__(self):
        return int(np.ceil(len(self.indices) / self.batch_size))
