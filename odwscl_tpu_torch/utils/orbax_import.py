"""Read an Orbax checkpoint directory of the JAX package without orbax.

Counterpart of ``odwscl_tpu/utils/checkpoint.py:Checkpointer.load``:
``orbax.checkpoint.StandardCheckpointer`` writes, for the TrainState
``{params, opt_state, step, rng}`` that ``Checkpointer.save`` gets,

- ``_METADATA`` (JSON): the tree, one entry per leaf path (e.g. ``('params',
  'neck', 'fc6', 'kernel')``) with its ``value_type`` (``np.ndarray``,
  ``jax.Array`` or ``scalar`` for an array; ``None``, ``Dict``, ``List``
  for the empty placeholders of optax's masked states and ``EmptyState``),
  and whether the store is OCDBT and zarr v2 (``use_ocdbt``, ``use_zarr3``);
- an OCDBT store (``utils/ocdbt.py``) holding each array as zarr v2 under
  the leaf path joined by ``.``: ``<name>/.zarray`` (JSON: shape, chunks,
  dtype, ``"compressor": {"id": "zstd", ...}``, ``"order": "C"``) and one
  zstd frame per chunk, ``<name>/0.0`` and so on (a scalar's ``<name>/0``).

``load_orbax(path)`` returns the tree as nested dicts (lists where the
keys were sequence indices), each array a numpy array of the stored dtype
and shape, assembled in C order from as many chunks as it has. A
``bfloat16`` array (no numpy dtype) is read as its uint16 bits and returned
as a ``torch.bfloat16`` view of them, not rounded through f32. What the
reader does not handle raises ``ValueError`` naming the key: a compressor
other than zstd, ``filters``, Fortran order, zarr v3 (``zarr.json``), a
missing chunk, a leaf that is not an array (a string, say), a store that
is not OCDBT. The native zstd decoder decodes everything unless another
``decompress`` (the tests' ``zstd.decompress_plain``) is given.
"""

from __future__ import annotations

import ast
import itertools
import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from .ocdbt import OcdbtStore

ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY_TYPES = {"None": None, "Dict": {}, "List": []}
KEY_SEQUENCE = 1          # key_type of a tuple or list index
_DTYPES = {"bfloat16": np.dtype("<u2")}


class OrbaxFormatError(ValueError):
    pass


def load_orbax(path: str, decompress: Optional[Callable] = None) -> dict:
    """The checkpoint directory ``path`` as a tree of arrays (see the
    module docstring)."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise OrbaxFormatError(f"{path}: no _METADATA file (not an Orbax "
                               "checkpoint directory)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not isinstance(meta, dict) or "tree_metadata" not in meta:
        raise OrbaxFormatError(f"{meta_path}: no 'tree_metadata' (the "
                               "checkpoint's tree is missing)")
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_path}: use_zarr3 is set; only zarr "
                               "v2 arrays are read")
    if meta.get("use_ocdbt") is False:
        raise OrbaxFormatError(f"{meta_path}: use_ocdbt is false; only "
                               "OCDBT checkpoints are read")
    tree_meta = meta["tree_metadata"]
    if not tree_meta:
        raise OrbaxFormatError(f"{meta_path}: the tree has no leaves")
    store = OcdbtStore(path, decompress)
    tree: dict = {}
    seq_levels = set()
    for entry_key, entry in tree_meta.items():
        keys, types = _leaf_path(entry_key, entry)
        name = ".".join(keys)
        vtype = entry.get("value_metadata", {}).get("value_type")
        if vtype in ARRAY_TYPES:
            value = read_array(store, name)
            if vtype == "scalar":
                value = value.item() if isinstance(value, np.ndarray) \
                    else value
        elif vtype in EMPTY_TYPES:
            value = EMPTY_TYPES[vtype]
            value = value.copy() if value is not None else None
        else:
            raise OrbaxFormatError(f"{name}: leaf type {vtype!r} is not "
                                   "an array; not read")
        node = tree
        for depth, k in enumerate(keys[:-1]):
            node = node.setdefault(k, {})
            if types[depth + 1] == KEY_SEQUENCE:
                seq_levels.add(tuple(keys[:depth + 1]))
        if types[0] == KEY_SEQUENCE:
            seq_levels.add(())
        node[keys[-1]] = value
    return _sequences_to_lists(tree, (), seq_levels)


def _leaf_path(entry_key: str, entry: dict):
    km = entry.get("key_metadata")
    if km:
        return [str(k["key"]) for k in km], [k.get("key_type") for k in km]
    keys = [str(k) for k in ast.literal_eval(entry_key)]
    return keys, [None] * len(keys)


def _sequences_to_lists(node, path, seq_levels):
    if not isinstance(node, dict):
        return node
    out = {k: _sequences_to_lists(v, path + (k,), seq_levels)
           for k, v in node.items()}
    if path in seq_levels and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def read_array(store: OcdbtStore, name: str):
    """The zarr v2 array ``name`` of ``store``: numpy, or a torch.bfloat16
    tensor for a ``bfloat16`` array."""
    if f"{name}/zarr.json" in store:
        raise OrbaxFormatError(f"{name}: zarr v3 (zarr.json); only zarr v2 "
                               "arrays are read")
    try:
        zarray = json.loads(store.get(f"{name}/.zarray"))
    except KeyError:
        raise OrbaxFormatError(f"{name}: no {name}/.zarray in the "
                               "checkpoint") from None
    if zarray.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format "
                               f"{zarray.get('zarr_format')!r}")
    comp = zarray.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r}; "
                               "only zstd is read")
    if zarray.get("filters"):
        raise OrbaxFormatError(f"{name}: filters {zarray['filters']!r} are "
                               "not read")
    if zarray.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {zarray.get('order')!r}; "
                               "only C order is read")
    dtype_str = zarray["dtype"]
    if not isinstance(dtype_str, str):
        raise OrbaxFormatError(f"{name}: structured dtype {dtype_str!r}")
    bf16 = dtype_str == "bfloat16"
    try:
        dtype = _DTYPES[dtype_str] if bf16 else np.dtype(dtype_str)
    except TypeError:
        raise OrbaxFormatError(f"{name}: dtype {dtype_str!r} is not read") \
            from None
    if dtype.kind not in "biuf":
        raise OrbaxFormatError(f"{name}: dtype {dtype_str!r} is not read")
    shape = tuple(int(s) for s in zarray["shape"])
    chunks = tuple(int(c) for c in zarray["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    sep = zarray.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        try:
            raw = store.get(key)
        except KeyError:
            raise OrbaxFormatError(f"{name}: chunk {key} is missing") \
                from None
        data = store.decompress(raw) if comp is not None else raw
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{key}: {len(data)} bytes, a chunk of "
                                   f"{chunks} {dtype_str} is {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:
            out = block if block.flags.writeable else block.copy()
            break
        if out is None:
            out = np.empty(shape, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            block[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if out is None:                       # a zero-size array: no chunks
        out = np.empty(shape, dtype)
    if not out.dtype.isnative:
        out = out.astype(out.dtype.newbyteorder("="))
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(out)).view(
            torch.bfloat16)
    return out
