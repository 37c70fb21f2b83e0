"""A read-only OCDBT key-value store: the store under every Orbax checkpoint.

Counterpart of what ``tensorstore``'s ``ocdbt`` driver does for
``odwscl_tpu/utils/checkpoint.py`` (``orbax.checkpoint.
StandardCheckpointer``); the port reads it without tensorstore. The layout:

- ``manifest.ocdbt`` at the root: the config (uuid, manifest kind, inline
  value and node size limits, version-tree arity, compression) and, for a
  ``single`` manifest, the version tree's latest leaf inline: each version's
  generation, B-tree root (height, data file, offset, length) and
  statistics. A ``numbered`` manifest keeps only the config there; the
  versions are in ``manifest.<generation as 16 hex digits>``, the newest
  of which is read. Only the latest version is read (older generations and
  the version tree's interior nodes are not).
- B-tree nodes: a height, a table of data files (paths relative to the
  store's root, prefix-compressed: a checkpoint's root store points into
  ``ocdbt.process_<i>/d/...``), and the entries, columnar. Interior entries
  hold each child's first key, the length of the prefix common to the
  child's keys (the child stores its keys without it) and the child's
  (file, offset, length); leaf entries hold each value inline or as a
  (file, offset, length) reference into a data file.
- Every manifest and node file: a 4-byte big-endian magic (0x0cdb3a2a for a
  manifest, 0x0cdb20de for a node), the 8-byte little-endian length of the
  whole file, a varint format version (0), a varint compression method (0
  none, 1 zstd), the body, and a little-endian CRC-32C of everything before
  it. Each is checked; a mismatch, an unknown method or a truncated field
  raises ``ValueError``.

``OcdbtStore(root).keys()`` lists the keys (bytes, sorted) and ``get(key)``
returns a value's bytes. Bodies are decoded with the native zstd decoder
(``utils/zstd.py``) unless another ``decompress`` is given.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_SINGLE, MANIFEST_NUMBERED = 0, 1
_NUMBERED = re.compile(r"^manifest\.[0-9a-f]{16}$")


class OcdbtError(ValueError):
    pass


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Varints, bytes and fixed-width integers from a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg}")

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.raw(1)[0]

    def le(self, n: int) -> int:
        return int.from_bytes(self.raw(n), "little")

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the body")


def decode_file(raw: bytes, magic: int, what: str,
                decompress: Callable[[bytes], bytes]) -> bytes:
    """Check one manifest or node file's header and CRC-32C; its body."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(raw)} bytes, too short")
    got_magic = int.from_bytes(raw[:4], "big")
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic 0x{got_magic:08x}, expected "
                         f"0x{magic:08x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise OcdbtError(f"{what}: header length {length}, file {len(raw)}")
    want = int.from_bytes(raw[-4:], "little")
    got = crc32c(raw[:-4])
    if got != want:
        raise OcdbtError(f"{what}: CRC-32C 0x{got:08x}, stored 0x{want:08x}")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    method = r.varint()
    body = raw[r.pos:-4]
    if method == 0:
        return body
    if method == 1:
        try:
            return bytes(decompress(body))
        except ValueError as e:
            raise OcdbtError(f"{what}: {e}") from e
    raise OcdbtError(f"{what}: unknown compression method {method}")


def _data_file_table(r: _Reader) -> List[str]:
    """A prefix-compressed list of data file paths (base path + relative
    path, both relative to the store's root)."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file prefix longer than the previous path")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(path):
            r.fail("data file base path longer than the path")
        paths.append(path)
        prev = path
    out = []
    for p in paths:
        s = p.decode("utf-8", errors="strict")
        parts = s.split("/")
        if s.startswith("/") or ".." in parts:
            r.fail(f"data file path {s!r} leaves the store")
        out.append(s)
    return out


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    return prefix, suffix


def _join_keys(r: _Reader, prefix: List[int], suffix: List[int]
               ) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            r.fail("key prefix longer than the previous key")
        key = prev[:p] + r.raw(s)
        if keys and key <= keys[-1]:
            r.fail("keys out of order")
        keys.append(key)
        prev = key
    return keys


class OcdbtStore:
    """The latest version of the OCDBT store at ``root`` (a directory)."""

    def __init__(self, root: str,
                 decompress: Optional[Callable[[bytes], bytes]] = None):
        self.root = os.path.abspath(root)
        self.decompress = decompress or zstd.decompress
        self.config: Dict[str, int] = {}
        # key -> (inline bytes) or (data file path, offset, length)
        self._index: Dict[bytes, object] = {}
        root_ref = self._read_manifest()
        # the latest version's B-tree height (None: an empty store)
        self.height: Optional[int] = None
        if root_ref is not None:
            self.height, path, offset, length = root_ref
            self._walk(self.height, path, offset, length, b"")

    # -- files ---------------------------------------------------------
    def _path(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def _read(self, rel: str, offset: int = 0,
              length: Optional[int] = None) -> bytes:
        path = self._path(rel)
        try:
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if length is None:
                    length = size - offset
                if offset < 0 or length < 0 or offset + length > size:
                    raise OcdbtError(f"{rel}: [{offset}, {offset + length}) "
                                     f"past the end of its {size} bytes")
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError as e:
            raise OcdbtError(f"missing OCDBT file {path}") from e

    # -- manifest --------------------------------------------------------
    def _config(self, r: _Reader) -> int:
        self.config = {"uuid": r.raw(16).hex()}
        kind = r.varint()
        self.config.update(max_inline_value_bytes=r.varint(),
                           max_decoded_node_bytes=r.varint(),
                           version_tree_arity_log2=r.u8())
        method = r.varint()
        if method == 1:
            self.config["zstd_level"] = r.le(4)
        elif method != 0:
            r.fail(f"unknown compression method {method} in the config")
        self.config["compression"] = method
        return kind

    def _read_manifest(self):
        """(root height, data file, offset, length) of the latest version,
        or None for an empty store."""
        body = decode_file(self._read("manifest.ocdbt"), MANIFEST_MAGIC,
                           "manifest.ocdbt", self.decompress)
        r = _Reader(body, "manifest.ocdbt")
        kind = self._config(r)
        if kind == MANIFEST_NUMBERED:
            r.end()
            names = sorted(n for n in os.listdir(self.root)
                           if _NUMBERED.match(n))
            if not names:
                raise OcdbtError(f"{self.root}: a numbered manifest without "
                                 "manifest.<generation> files")
            body = decode_file(self._read(names[-1]), MANIFEST_MAGIC,
                               names[-1], self.decompress)
            r = _Reader(body, names[-1])
            self._config(r)
        elif kind != MANIFEST_SINGLE:
            r.fail(f"unknown manifest kind {kind}")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            return None
        generation = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                  # num keys, tree and value bytes
        r.raw(8 * n)                      # commit times
        # the version tree's interior nodes (older generations) follow
        latest = max(range(n), key=generation.__getitem__)
        if file_id[latest] >= len(files):
            r.fail(f"data file {file_id[latest]} of {len(files)}")
        if length[latest] == 0:
            return None
        return (height[latest], files[file_id[latest]], offset[latest],
                length[latest])

    # -- B-tree ----------------------------------------------------------
    def _walk(self, height: int, rel: str, offset: int, length: int,
              prefix: bytes) -> None:
        what = f"{rel}@{offset}"
        body = decode_file(self._read(rel, offset, length), NODE_MAGIC, what,
                           self.decompress)
        r = _Reader(body, what)
        got = r.u8()
        if got != height:
            r.fail(f"node height {got}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("node without entries")
        kp, ks = _keys(r, n)
        if height == 0:
            keys = _join_keys(r, kp, ks)
            vlen = r.varints(n)
            kind = r.varints(n)
            if any(k not in (0, 1) for k in kind):
                r.fail(f"value kinds {sorted(set(kind))}")
            n_ref = sum(kind)
            ref_file, ref_off = r.varints(n_ref), r.varints(n_ref)
            j = 0
            for key, ln, k in zip(keys, vlen, kind):
                full = prefix + key
                if k == 0:
                    self._index[full] = r.raw(ln)
                    continue
                if ref_file[j] >= len(files):
                    r.fail(f"data file {ref_file[j]} of {len(files)}")
                self._index[full] = (files[ref_file[j]], ref_off[j], ln)
                j += 1
            r.end()
            return
        scp = r.varints(n)
        keys = _join_keys(r, kp, ks)
        child_file, child_off = r.varints(n), r.varints(n)
        child_len = r.varints(n)
        r.varints(3 * n)                  # num keys, tree and value bytes
        r.end()
        for key, c, f, o, ln in zip(keys, scp, child_file, child_off,
                                    child_len):
            if c > len(key):
                r.fail("subtree prefix longer than the key")
            if f >= len(files):
                r.fail(f"data file {f} of {len(files)}")
            self._walk(height - 1, files[f], o, ln, prefix + key[:c])

    # -- access ------------------------------------------------------------
    def keys(self) -> List[bytes]:
        return sorted(self._index)

    def __contains__(self, key) -> bool:
        return _key_bytes(key) in self._index

    def get(self, key) -> bytes:
        """The value of ``key`` (str or bytes); ``KeyError`` if absent."""
        v = self._index[_key_bytes(key)]
        if isinstance(v, bytes):
            return v
        rel, offset, length = v
        return self._read(rel, offset, length)


def _key_bytes(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
