"""Eval sampling (counterpart of ``odwscl_tpu/data/samplers.py``)."""

from __future__ import annotations

import numpy as np


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
