"""The run's logger and windowed metric tracking.

Counterpart of ``odwscl_tpu/utils/logging_utils.py``: ``setup_logger``
(stderr and ``<save_dir>/log.txt`` on rank 0, nothing on the others),
``SmoothedValue`` (median and mean of the last 20 values, the global
mean), ``MetricLogger`` and ``JsonlLogger``, which appends one record a
iteration to ``<log_dir>/scalars.jsonl`` (``train_net
--use-tensorboard``): ``iteration``, then the values passed, ``time`` the
step's seconds.

Unlike the JAX ``setup_logger``, the stream is stderr (the JAX one prints
to stdout), so that a caller's stdout stays its own; records still
propagate to the root logger (so callers in the same process, tests
among them, capture them), and a second call replaces the handlers the
first added, so that a process that trains twice writes each run's
``log.txt`` into its own directory.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Optional


def setup_logger(name: str, save_dir: Optional[str] = None,
                 distributed_rank: int = 0, filename: str = "log.txt"):
    """``name``'s logger at DEBUG; on rank 0 it prints to stderr and, with
    ``save_dir``, writes ``save_dir/filename``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in [h for h in logger.handlers if getattr(h, "_odwscl", False)]:
        logger.removeHandler(h)
        h.close()
    if distributed_rank != 0:
        return logger
    formatter = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    handlers = [logging.StreamHandler(stream=sys.stderr)]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(save_dir,
                                                         filename)))
    for h in handlers:
        h.setLevel(logging.DEBUG)
        h.setFormatter(formatter)
        h._odwscl = True
        logger.addHandler(h)
    return logger


class SmoothedValue:
    """Window median and mean, and the global mean."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    """A ``SmoothedValue`` per name; prints as ``name: median
    (global mean)``."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr != "meters" and attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())


class JsonlLogger(MetricLogger):
    """A ``MetricLogger`` that also appends each update to
    ``<log_dir>/scalars.jsonl`` as ``{"iteration", "time", ...}``."""

    def __init__(self, log_dir: str, start_iter: int = 0,
                 delimiter: str = "  "):
        super().__init__(delimiter)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self.iteration = start_iter

    def update(self, **kwargs):
        super().update(**kwargs)
        self.iteration += 1
        rec = {"iteration": self.iteration, "time": time.time()}
        rec.update({k: float(v) for k, v in kwargs.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
