"""Weight bridge between the JAX package's flax parameters and the port.

The flax tree of ``odwscl_tpu.models.WSODDetector`` is
``{backbone: {conv{i}: {kernel, bias}}, neck: {fc6, fc7},
sim_net: {mlp0, mlp1}, pred: {<head>: {linear: {kernel, bias}}}}``. It is
taken as nested dicts of numpy arrays (with or without the outer
``params`` level) or as an ``.npz`` whose keys are the ``/``-joined paths.

- conv kernels go from HWIO to OIHW;
- Dense kernels go from (in, out) to (out, in);
- fc6 needs no permutation: the port flattens the pooled NHWC tensor in
  the same (h, w, c) order as the JAX neck;
- the MIST heads drop the ``linear`` level: ``pred/cls_score/linear/kernel``
  becomes ``pred.cls_score.weight``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_MODULES = ("backbone", "neck", "sim_net", "pred")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts, or a path to an ``.npz`` of ``/``-joined
    keys) -> the port's ``state_dict`` (f32 tensors)."""
    if isinstance(params, (str, bytes)) or hasattr(params, "__fspath__"):
        with np.load(params) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = flatten_tree(params)
    out = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[0] not in _MODULES or parts[-1] not in ("kernel", "bias"):
            raise KeyError(f"no port parameter for flax leaf {key!r}")
        if parts[0] == "pred":
            if len(parts) != 4 or parts[2] != "linear":
                raise KeyError(f"unexpected MIST head leaf {key!r}")
            parts = [parts[0], parts[1], parts[3]]
        v = np.asarray(v, np.float32)
        if parts[-1] == "kernel":
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif v.ndim == 2:
                v = v.T                          # (in, out) -> (out, in)
            else:
                raise ValueError(f"kernel {key!r} has shape {v.shape}")
            parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.array(v, order="C"))
    return out


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` -> the flax params tree
    (without the outer ``params`` level), numpy f32."""
    flat = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if parts[-1] == "weight":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
            parts[-1] = "kernel"
        if parts[0] == "pred":
            parts = [parts[0], parts[1], "linear", parts[2]]
        flat["/".join(parts)] = np.ascontiguousarray(v)
    return unflatten_tree(flat)


def save_npz(path: str, params) -> None:
    """Write a flax params tree as an ``.npz`` of ``/``-joined keys."""
    np.savez(path, **flatten_tree(params))
