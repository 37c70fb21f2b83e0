"""Samplers: epoch-seeded shuffling with aspect-ratio grouping or class
pairs (``SOLVER.CLASS_BATCH``), recycled up to a number of iterations and
resumable, and sequential eval batches.

Counterpart of ``odwscl_tpu/data/samplers.py``. With several processes
each yields its contiguous share of every global batch (rank order is the
global batch's order); a batch size that the process count does not
divide raises (the JAX sampler silently drops the remainder).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

from ..utils.dist import rank_slice


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
    epoch's batches are shuffled. ``epoch_batches_fn(epoch)``, when given,
    makes each epoch's batches instead (``class_batch_pairs``). Iterations
    before ``start_iter`` are skipped (resume). Process ``process_index``
    of ``process_count`` gets its share of each batch
    (``utils/dist.py:rank_slice``)."""

    def __init__(self, dataset_len: int, batch_size: int,
                 num_iterations: int, start_iter: int = 0,
                 groups: Optional[np.ndarray] = None,
                 epoch_batches_fn: Optional[
                     Callable[[int], List[np.ndarray]]] = None,
                 process_count: int = 1, process_index: int = 0):
        self.share = rank_slice(batch_size, process_count, process_index)
        self.n = dataset_len
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.start_iter = start_iter
        self.groups = groups
        self.epoch_batches_fn = epoch_batches_fn

    def _epoch_batches(self, epoch: int) -> List[np.ndarray]:
        if self.epoch_batches_fn is not None:
            return [np.asarray(b) for b in self.epoch_batches_fn(epoch)]
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
                yield batch[self.share]
            epoch += 1

    def __len__(self):
        return self.num_iterations - self.start_iter


def require_groundtruth(dataset) -> None:
    """Raise a ValueError when ``SOLVER.CLASS_BATCH`` cannot read the
    dataset's GT classes."""
    if not hasattr(dataset, "get_groundtruth"):
        raise ValueError(
            f"SOLVER.CLASS_BATCH needs each image's GT classes, which "
            f"{type(dataset).__name__} does not give (a web dataset or "
            f"several training datasets): train them without CLASS_BATCH")


def class_batch_pairs(dataset, batch_size: int, epoch: int
                      ) -> List[np.ndarray]:
    """One epoch of ``SOLVER.CLASS_BATCH`` batches: in a
    ``RandomState(epoch)`` order, each image not yet used is followed by
    the first unused image that shares one of its GT classes (the classes
    of its GT set in the set's order, as in the JAX package; candidates in
    index order), so that the batches carry
    contrastive positives; the last batch is filled up by repeating its
    own images. Reads ``dataset.get_groundtruth``: a dataset without GT
    boxes (web data, several datasets concatenated) raises a ValueError
    (the JAX package fails on them with an AttributeError)."""
    require_groundtruth(dataset)
    rng = np.random.RandomState(epoch)
    by_class = {}
    labels_per_img = []
    for i in range(len(dataset)):
        _, labels, _ = dataset.get_groundtruth(i)
        cls = set(np.unique(labels).tolist())
        labels_per_img.append(cls)
        for c in cls:
            by_class.setdefault(c, []).append(i)

    order = rng.permutation(len(dataset))
    used = np.zeros(len(dataset), bool)
    batches, cur = [], []
    for i in order:
        if used[i]:
            continue
        used[i] = True
        cur.append(i)
        partner = -1
        for c in labels_per_img[i]:
            partner = next((j for j in by_class.get(c, []) if not used[j]),
                           -1)
            if partner >= 0:
                break
        if partner >= 0:
            used[partner] = True
            cur.append(partner)
        if len(cur) >= batch_size:
            batches.append(np.asarray(cur[:batch_size]))
            cur = cur[batch_size:]
    if cur:
        pad = batch_size - len(cur)
        cur = cur + cur[:pad] if pad <= len(cur) else cur * batch_size
        batches.append(np.asarray(cur[:batch_size]))
    return batches


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
