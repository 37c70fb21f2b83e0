"""Seeding, the config snapshot, the label map and a wall-clock timer.

Counterpart of ``odwscl_tpu/utils/miscellaneous.py``. ``seed_all_rng``
seeds numpy's and Python's global generators, as the JAX one does; the
port's draws take explicit ``torch.Generator``s and ``RandomState``s, so
the global ones only reach code that asks for no generator.
"""

from __future__ import annotations

import json
import logging
import os
import random
from datetime import datetime

import numpy as np

logger = logging.getLogger("odwscl_tpu_torch")


def seed_all_rng(seed=None) -> int:
    """Seed the global generators with ``seed`` (a fresh one when it is
    None or negative); returns the seed."""
    if seed is None or seed < 0:
        seed = (os.getpid() + int(datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
        logger.info("Using a generated random seed %d", seed)
    np.random.seed(seed % (2 ** 31))
    random.seed(seed)
    return seed


def mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def save_config(cfg, path: str):
    """Write the merged config."""
    with open(path, "w") as f:
        f.write(cfg.dump())


def save_labels(dataset_list, output_dir: str):
    """``output_dir/labels.json``: the datasets' ``categories`` ({id:
    name}), when any dataset has them."""
    if not isinstance(dataset_list, (list, tuple)):
        dataset_list = [dataset_list]
    ids_to_labels = {}
    for ds in dataset_list:
        if hasattr(ds, "categories"):
            ids_to_labels.update({int(k): v
                                  for k, v in ds.categories.items()})
    if ids_to_labels:
        with open(os.path.join(output_dir, "labels.json"), "w") as f:
            json.dump(ids_to_labels, f, indent=2)


class Timer:
    """tic/toc wall-clock timer with the mean over its calls."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def tic(self):
        import time
        self.start_time = time.time()

    def toc(self, average: bool = True):
        import time
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls > 0 else 0.0
