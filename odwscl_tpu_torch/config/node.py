"""A minimal yacs-style config node.

The reference framework configures everything through a yacs ``CfgNode``
singleton (see reference wetectron/config/defaults.py:22).  We reimplement the
small surface actually used: attribute access, ``merge_from_file`` (YAML),
``merge_from_list`` (CLI ``opts`` key/value pairs), ``freeze``/``defrost`` and
``clone`` — without depending on yacs.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List

import yaml


class CfgNode(dict):
    """Nested dict with attribute access, type-checked merging and freezing."""

    _FROZEN = "__frozen__"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key, value):
        if self.is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freezing ------------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    # -- merging -------------------------------------------------------------
    def merge_from_other(self, other: dict) -> None:
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Unknown config key: {k}")
            if isinstance(v, dict):
                if not isinstance(self[k], CfgNode):
                    raise TypeError(f"Cannot merge dict into non-dict key {k}")
                self[k].merge_from_other(v)
            else:
                self[k] = _coerce(v, self[k], k)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other(data)

    def merge_from_list(self, opts: List[Any]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError("opts must be key/value pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            node[leaf] = _coerce(value, node[leaf], key)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), sort_keys=False)


def _to_plain(node: Any) -> Any:
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Match the replacement value's type to the default's (yacs semantics)."""
    if old is None or value is None:
        return value
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, bool) and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    if type(old) is not type(value) and not isinstance(value, type(old)):
        # permissive for str-typed defaults replaced by parsed literals
        if isinstance(old, str):
            return str(value)
        raise TypeError(f"Type mismatch for {key}: {type(old)} vs {type(value)}")
    return value
