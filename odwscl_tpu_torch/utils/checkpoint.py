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
written; every rank loads.

The JAX package's Orbax checkpoints load too: ``load`` and
``load_model_weights`` take a checkpoint directory
(``OUTPUT_DIR/model_<iter:07d>`` of the JAX ``Checkpointer.save``), or find
it through ``last_checkpoint``, which the JAX package writes as the
directory's absolute path (a ``last_checkpoint`` naming a path that does
not exist, as after the output directory moved to another machine, falls
back to the same name inside this ``OUTPUT_DIR``). The directory is read
without orbax (``utils/orbax_import.py``: the native zstd decoder, the
OCDBT reader, the zarr arrays); its ``params`` become the model's
state_dict (``utils/from_jax.py:state_dict_from_jax``), its ``opt_state``
the optimizer's momentum buffers and counts
(``optimizer_state_from_jax``) and its ``step`` the start iteration. Its
``rng`` is not carried over: the port's generator keeps its seed.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
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
        if os.path.exists(path):
            return path
        moved = os.path.join(self.dir, os.path.basename(path.rstrip("/")))
        return moved if path and os.path.exists(moved) else None

    def load(self, model, optimizer=None, generator=None,
             path: Optional[str] = None) -> int:
        """Restore into ``model`` (and ``optimizer``, ``generator``) from a
        port checkpoint or a JAX Orbax directory; returns the checkpoint's
        step."""
        path = path or self.last_checkpoint_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        if os.path.isdir(path):
            return self._load_orbax(model, optimizer, path)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt["model"])
        if optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        if generator is not None and ckpt["rng"] is not None:
            generator.set_state(ckpt["rng"])
        logger.info("Restored checkpoint from %s (step %d)", path,
                    ckpt["step"])
        return int(ckpt["step"])

    @staticmethod
    def _load_orbax(model, optimizer, path: str) -> int:
        from .from_jax import optimizer_state_from_jax, state_dict_from_jax
        from .orbax_import import load_orbax

        t0 = time.perf_counter()
        tree = load_orbax(path)
        for field in ("params", "opt_state", "step"):
            if field not in tree:
                raise ValueError(f"{path}: no {field!r} in the checkpoint's "
                                 "tree: not a TrainState of the JAX package")
        model.load_state_dict(state_dict_from_jax(tree["params"]))
        if optimizer is not None:
            optimizer_state_from_jax(tree["opt_state"], model, optimizer)
        step = int(np.asarray(tree["step"]))
        logger.info("Imported the JAX package's Orbax checkpoint %s (step "
                    "%d) in %.2f s; its rng is not carried over", path, step,
                    time.perf_counter() - t0)
        return step


def load_model_weights(path: str) -> dict:
    """The model state_dict of a training checkpoint, of a bare state_dict
    file, or of a JAX Orbax checkpoint directory (its ``params``; a tree of
    params alone is taken as it is)."""
    if os.path.isdir(path):
        from .from_jax import state_dict_from_jax
        from .orbax_import import load_orbax

        tree = load_orbax(path)
        return state_dict_from_jax(tree.get("params", tree))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["model"] if "model" in obj and "step" in obj else obj
