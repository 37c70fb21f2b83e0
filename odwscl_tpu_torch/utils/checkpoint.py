"""Training checkpoints: model, optimizer, step and the RNG state.

Counterpart of ``odwscl_tpu/utils/checkpoint.py`` with ``torch.save``:
``OUTPUT_DIR/model_<iter:07d>.pt`` plus a ``last_checkpoint`` file naming
the newest, and ``model_final.pt`` at the end of training, which
``last_checkpoint`` then names (the JAX package points it at the final
iteration's checkpoint, which holds the same state). A checkpoint is
a dict ``{"model", "optimizer", "step", "rng"}``; ``--weights`` of
``tools/test_net.py`` takes one as it takes a bare state_dict, and
without ``--weights`` it evaluates ``last_checkpoint``'s. With
``save=False`` (every rank but 0 of a data-parallel run) nothing is
written; every rank loads. Importing the JAX package's orbax checkpoints
is not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger("odwscl_tpu_torch.checkpoint")


class Checkpointer:
    def __init__(self, output_dir: str, save: bool = True):
        self.dir = os.path.abspath(output_dir)
        self.save_enabled = save
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, it: int) -> str:
        return os.path.join(self.dir, f"model_{it:07d}.pt")

    def save(self, it: int, model, optimizer, generator=None,
             final: bool = False) -> Optional[str]:
        """Write the checkpoint of iteration ``it`` (``final``: as
        ``model_final.pt``) and point ``last_checkpoint`` at it; returns
        its path (None when saving is off)."""
        if not self.save_enabled:
            return None
        ckpt = {"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": it,
                "rng": None if generator is None else generator.get_state()}
        path = os.path.join(self.dir, "model_final.pt") if final \
            else self._path(it)
        torch.save(ckpt, path)
        with open(os.path.join(self.dir, "last_checkpoint"), "w") as f:
            f.write(path)
        logger.info("Saved checkpoint to %s", path)
        return path

    def has_checkpoint(self) -> bool:
        return self.last_checkpoint_path() is not None

    def last_checkpoint_path(self) -> Optional[str]:
        p = os.path.join(self.dir, "last_checkpoint")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            path = f.read().strip()
        return path if os.path.exists(path) else None

    def load(self, model, optimizer=None, generator=None,
             path: Optional[str] = None) -> int:
        """Restore into ``model`` (and ``optimizer``, ``generator``);
        returns the checkpoint's step."""
        path = path or self.last_checkpoint_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt["model"])
        if optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        if generator is not None and ckpt["rng"] is not None:
            generator.set_state(ckpt["rng"])
        logger.info("Restored checkpoint from %s (step %d)", path,
                    ckpt["step"])
        return int(ckpt["step"])


def load_model_weights(path: str) -> dict:
    """The model state_dict of a training checkpoint or of a bare
    state_dict file."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["model"] if "model" in obj and "step" in obj else obj
