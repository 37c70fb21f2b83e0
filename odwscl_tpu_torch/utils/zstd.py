"""Zstandard (RFC 8878) decoding for the Orbax checkpoint import.

The JAX package's checkpoints store every OCDBT manifest and B-tree node
and every zarr chunk as a zstd frame (``utils/ocdbt.py``,
``utils/orbax_import.py``). The port links no zstd library: the card's
machine has none, so the decoder is written here from RFC 8878.

- ``decompress`` is the native decoder, ``csrc/zstd_decode.cpp``, built at
  first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
  ``build/odwscl_tpu_torch/`` (named by a hash of the source) as
  ``utils/host_ops.py`` builds its library; a failed build raises. Every
  read of the input and every match copy is bounds-checked, so no input
  crashes the process: a bad or truncated frame raises a ``ValueError``.
- ``decompress_plain`` is the same decoder in pure Python, slow, the
  native one's plain version in the tests. The CLIs never use it.

Both decode one or more frames back to back: skippable frames, raw, RLE
and compressed blocks, raw / RLE / Huffman literals (1 or 4 streams,
direct or FSE-coded weights, treeless blocks reusing the previous table),
sequences in predefined, RLE, FSE and repeat table modes with the three
repeat offsets, and the XXH64 content checksum, checked when present. A
frame that names a dictionary raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

from . import host_ops
from .cuda_build import CSRC_DIR

SOURCE = CSRC_DIR / "zstd_decode.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The native decoder, built and bound on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(host_ops.build(SOURCE)))
            lib.zstd_decode.restype = ctypes.c_void_p
            lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
            lib.zstd_result_size.restype = ctypes.c_size_t
            lib.zstd_result_size.argtypes = [ctypes.c_void_p]
            lib.zstd_result_copy.restype = None
            lib.zstd_result_copy.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p]
            lib.zstd_result_free.restype = None
            lib.zstd_result_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def decompress(data) -> bytearray:
    """Decode every frame of ``data`` (bytes-like) with the native decoder;
    raises ``ValueError`` on a bad, truncated or unsupported frame."""
    lib = load()
    src = bytes(data)
    err = ctypes.create_string_buffer(256)
    handle = lib.zstd_decode(src, len(src), err, len(err))
    if not handle:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        out = bytearray(lib.zstd_result_size(handle))
        if out:
            lib.zstd_result_copy(
                handle, (ctypes.c_char * len(out)).from_buffer(out))
    finally:
        lib.zstd_result_free(handle)
    return out


# ---------------------------------------------------------------------------
# The plain version: RFC 8878 in pure Python.

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024

# (baseline, extra bits) of the literal-length and match-length codes
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# the predefined distributions (accuracy logs 6, 5, 6)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, -1, -1, -1, -1, -1], 5)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
# (largest symbol, largest accuracy log) of each sequence table
LL_LIMITS, OF_LIMITS, ML_LIMITS = (35, 9), (31, 8), (52, 9)

M64 = (1 << 64) - 1
P1, P2 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F
P3, P4, P5 = 0x165667B19E3779F9, 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


class ZstdError(ValueError):
    pass


def _check(cond, what: str) -> None:
    if not cond:
        raise ZstdError(what)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _xxh_round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * P2) & M64, 31) * P1) & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M64, (seed + P2) & M64, seed,
             (seed - P1) & M64]
        while i + 32 <= n:
            for k in range(4):
                v[k] = _xxh_round(v[k], int.from_bytes(
                    data[i + 8 * k:i + 8 * k + 8], "little"))
            i += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & M64
        for k in range(4):
            h = (((h ^ _xxh_round(0, v[k])) * P1) + P4) & M64
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        h ^= _xxh_round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * P1 + P4) & M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & M64
        h = (_rotl(h, 23) * P2 + P3) & M64
        i += 4
    while i < n:
        h ^= (data[i] * P5) & M64
        h = (_rotl(h, 11) * P1) & M64
        i += 1
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    return h ^ (h >> 32)


class _ForwardBits:
    """Little-endian bits read from the start (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        end = self.pos + n
        _check(end <= 8 * len(self.data), "FSE table description truncated")
        lo, hi = self.pos >> 3, (end + 7) >> 3
        v = int.from_bytes(self.data[lo:hi], "little") >> (self.pos & 7)
        self.pos = end
        return v & ((1 << n) - 1)

    def nbytes(self) -> int:
        return (self.pos + 7) >> 3


class _BackwardBits:
    """A backward bitstream: read from the highest bit, below the final
    byte's end marker, down to bit 0. Bits below 0 read as zeros (a peek
    may reach there; ``overflowed`` says whether a read consumed them)."""

    def __init__(self, data: bytes):
        _check(len(data) > 0, "empty bitstream")
        last = data[-1]
        _check(last != 0, "bitstream without an end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + last.bit_length() - 1

    def peek(self, n: int) -> int:
        if n == 0:
            return 0
        start = self.pos - n
        if self.pos <= 0:
            return 0
        lo, hi = max(start, 0) >> 3, (self.pos - 1) >> 3
        v = int.from_bytes(self.data[lo:hi + 1], "little")
        if start >= 0:
            v >>= start & 7
        else:
            v <<= -start
        return v & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos -= n
        return v

    @property
    def overflowed(self) -> bool:
        return self.pos < 0


def _read_fse_table(data: bytes, max_symbol: int, max_log: int):
    """An FSE table description -> (table, bytes read); the table is a
    list of (symbol, nb_bits, base) by state, with its accuracy log."""
    bits = _ForwardBits(data)
    log = bits.read(4) + 5
    _check(log <= max_log, f"FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    probs: List[int] = []
    prev_zero = False
    while remaining > 1 and len(probs) <= max_symbol:
        if prev_zero:
            while True:
                r = bits.read(2)
                probs.extend([0] * r)
                if r != 3:
                    break
            _check(len(probs) <= max_symbol, "FSE symbol out of range")
        mx = (2 * threshold - 1) - remaining
        # nb - 1 low bits first; the nb-th only when they reach ``mx``
        start = bits.pos
        v = bits.read(nb - 1)
        if v >= mx:
            bits.pos = start
            v = bits.read(nb)
            if v >= threshold:
                v -= mx
        count = v - 1
        remaining -= abs(count)
        probs.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    _check(remaining == 1 and len(probs) <= max_symbol + 1,
           "corrupt FSE table description")
    return _build_fse(probs, log), bits.nbytes()


def _build_fse(probs: List[int], log: int):
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    _check(pos == 0, "corrupt FSE distribution")
    table = []
    for u in range(size):
        s = symbols[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        table.append((s, nb, (n << nb) - size))
    return table, log


def _rle_table(symbol: int):
    return [(symbol, 0, 0)], 0


class _Huffman:
    """A Huffman decoding table: (symbol, nb_bits) by ``max_bits``-bit
    prefix."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        _check(total > 0, "Huffman weights all zero")
        max_bits = total.bit_length()
        _check(max_bits <= 11, "Huffman code longer than 11 bits")
        rest = (1 << max_bits) - total
        _check(rest & (rest - 1) == 0, "Huffman weights do not sum to a "
                                        "power of two")
        weights = weights + [rest.bit_length()]
        self.max_bits = max_bits
        self.table: List[Tuple[int, int]] = [None] * (1 << max_bits)
        pos = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    n = 1 << (w - 1)
                    entry = (s, max_bits + 1 - w)
                    self.table[pos:pos + n] = [entry] * n
                    pos += n
        _check(pos == 1 << max_bits, "corrupt Huffman weights")

    def decode(self, stream: bytes, n: int) -> bytes:
        bits = _BackwardBits(stream)
        out = bytearray(n)
        table, mb = self.table, self.max_bits
        for i in range(n):
            s, nb = table[bits.peek(mb)]
            out[i] = s
            bits.pos -= nb
            _check(bits.pos >= 0, "Huffman stream overread")
        _check(bits.pos == 0, "Huffman stream not consumed")
        return bytes(out)


def _read_huffman(data: bytes, seen: set) -> Tuple[_Huffman, int]:
    """A Huffman tree description -> (table, bytes read)."""
    _check(len(data) >= 1, "Huffman tree description truncated")
    hb = data[0]
    seen.add("huffman weights direct" if hb >= 128 else "huffman weights fse")
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        _check(len(data) >= 1 + nbytes, "Huffman weights truncated")
        weights = []
        for i in range(n):
            byte = data[1 + i // 2]
            weights.append(byte >> 4 if i % 2 == 0 else byte & 15)
        return _Huffman(weights), 1 + nbytes
    _check(hb > 0 and len(data) >= 1 + hb, "Huffman weights truncated")
    region = data[1:1 + hb]
    (table, log), used = _read_fse_table(region, 255, 6)
    bits = _BackwardBits(region[used:])
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    states = [s1, s2]
    k = 0
    while True:
        _check(len(weights) <= 253, "too many Huffman weights")
        sym, nb, base = table[states[k]]
        weights.append(sym)
        states[k] = base + bits.read(nb)
        if bits.overflowed:
            weights.append(table[states[1 - k]][0])
            break
        k = 1 - k
    _check(all(w <= 11 for w in weights), "Huffman weight above 11")
    return _Huffman(weights), 1 + hb


class _FrameState:
    def __init__(self, seen: Optional[set]):
        self.seen = seen if seen is not None else set()
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    """The literals section -> (literals, bytes read)."""
    _check(len(block) >= 1, "literals header truncated")
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, hl = b0 >> 3, 1
        elif fmt == 1:
            _check(len(block) >= 2, "literals header truncated")
            size, hl = (b0 >> 4) + (block[1] << 4), 2
        else:
            _check(len(block) >= 3, "literals header truncated")
            size, hl = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        _check(size <= BLOCK_MAX, "literals larger than a block")
        st.seen.add("literals raw" if kind == 0 else "literals rle")
        if kind == 0:
            _check(len(block) >= hl + size, "raw literals truncated")
            return bytes(block[hl:hl + size]), hl + size
        _check(len(block) >= hl + 1, "RLE literals truncated")
        return bytes([block[hl]]) * size, hl + 1
    hl = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    _check(len(block) >= hl, "literals header truncated")
    h = int.from_bytes(block[:hl], "little")
    bits = {3: 10, 4: 14, 5: 18}[hl]
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    _check(size <= BLOCK_MAX, "literals larger than a block")
    _check(len(block) >= hl + csize, "compressed literals truncated")
    data = block[hl:hl + csize]
    st.seen.add("literals 1 stream" if fmt == 0 else "literals 4 streams")
    if kind == 2:
        st.huffman, used = _read_huffman(data, st.seen)
        data = data[used:]
    else:
        st.seen.add("literals treeless")
        _check(st.huffman is not None, "treeless literals without a "
                                       "previous Huffman table")
    if fmt == 0:
        return st.huffman.decode(data, size), hl + csize
    _check(len(data) >= 6, "jump table truncated")
    sizes = [int.from_bytes(data[2 * i:2 * i + 2], "little")
             for i in range(3)]
    sizes.append(len(data) - 6 - sum(sizes))
    _check(sizes[3] >= 0, "corrupt jump table")
    per = (size + 3) // 4
    _check(per * 3 <= size, "four literal streams of too few bytes")
    out, pos = [], 6
    for i, n in enumerate(sizes):
        out.append(st.huffman.decode(data[pos:pos + n],
                                     per if i < 3 else size - 3 * per))
        pos += n
    return b"".join(out), hl + csize


def _sequence_table(block: bytes, pos: int, mode: int, name: str,
                    st: _FrameState):
    default = {"ll": LL_DEFAULT, "of": OF_DEFAULT, "ml": ML_DEFAULT}[name]
    max_symbol, max_log = {"ll": LL_LIMITS, "of": OF_LIMITS,
                           "ml": ML_LIMITS}[name]
    st.seen.add(f"sequences {name} " + ("predefined", "rle", "fse",
                                         "repeat")[mode])
    if mode == 0:
        table = _build_fse(*default)
    elif mode == 1:
        _check(pos < len(block), "RLE sequence table truncated")
        _check(block[pos] <= max_symbol, "RLE symbol out of range")
        table = _rle_table(block[pos])
        pos += 1
    elif mode == 2:
        table, used = _read_fse_table(block[pos:], max_symbol, max_log)
        pos += used
    else:
        _check(st.tables[name] is not None, f"repeat {name} table without "
                                            "a previous one")
        table = st.tables[name]
    st.tables[name] = table
    return table, pos


def _sequences(block: bytes, st: _FrameState):
    """The sequences section -> [(literal length, offset, match length)]."""
    _check(len(block) >= 1, "sequences header truncated")
    b0 = block[0]
    if b0 < 128:
        n, pos = b0, 1
    elif b0 < 255:
        _check(len(block) >= 2, "sequences header truncated")
        n, pos = ((b0 - 128) << 8) + block[1], 2
    else:
        _check(len(block) >= 3, "sequences header truncated")
        n, pos = block[1] + (block[2] << 8) + 0x7F00, 3
    if n == 0:
        _check(pos == len(block), "bytes after an empty sequences section")
        return []
    _check(pos < len(block), "sequences header truncated")
    modes = block[pos]
    pos += 1
    _check(modes & 3 == 0, "reserved bits set in the sequence modes")
    tables = {}
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        tables[name], pos = _sequence_table(block, pos, (modes >> shift) & 3,
                                            name, st)
    bits = _BackwardBits(block[pos:])
    state = {k: bits.read(tables[k][1]) for k in ("ll", "of", "ml")}
    seqs = []
    reps = st.reps
    for i in range(n):
        of_code = tables["of"][0][state["of"]][0]
        ll_code = tables["ll"][0][state["ll"]][0]
        ml_code = tables["ml"][0][state["ml"]][0]
        _check(of_code <= 31, "offset code out of range")
        of_value = (1 << of_code) + bits.read(of_code)
        ml_base, ml_bits = ML_CODES[ml_code]
        ml = ml_base + bits.read(ml_bits)
        ll_base, ll_bits = LL_CODES[ll_code]
        ll = ll_base + bits.read(ll_bits)
        if of_value > 3:
            offset = of_value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = of_value - 1 if ll else of_value
            st.seen.add(f"repeat offset {idx + 1}" if ll
                        else f"repeat offset {idx} with no literals")
            if idx == 0:
                offset = reps[0]
            elif idx == 1:
                offset = reps[1]
                reps[:] = [offset, reps[0], reps[2]]
            else:
                offset = reps[2] if idx == 2 else reps[0] - 1
                reps[:] = [offset, reps[0], reps[1]]
        _check(offset > 0, "zero offset")
        seqs.append((ll, offset, ml))
        if i + 1 < n:
            for k in ("ll", "ml", "of"):
                _, nb, base = tables[k][0][state[k]]
                state[k] = base + bits.read(nb)
        _check(not bits.overflowed, "sequence bitstream overread")
    _check(bits.pos == 0, "sequence bitstream not consumed")
    return seqs


def _compressed_block(block: bytes, out: bytearray, frame_start: int,
                      st: _FrameState) -> None:
    lits, used = _literals(block, st)
    seqs = _sequences(block[used:], st)
    lp = 0
    for ll, offset, ml in seqs:
        _check(lp + ll <= len(lits), "literal lengths past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        _check(offset <= len(out) - frame_start, "match offset before the "
                                                 "frame's start")
        src = len(out) - offset
        if offset >= ml:
            out += out[src:src + ml]
        else:
            for k in range(ml):
                out.append(out[src + k])
    out += lits[lp:]


def decompress_plain(data, seen: Optional[set] = None) -> bytes:
    """``decompress`` in pure Python (slow: the native decoder's plain
    version). ``seen`` (a set) receives the name of each format feature
    that the input used (block, literal and sequence-table kinds, repeat
    offsets, checksums, skippable frames): the tests read it to show what
    their corpus covers."""
    seen = set() if seen is None else seen
    data = bytes(data)
    out = bytearray()
    pos = 0
    _check(len(data) > 0, "empty input")
    while pos < len(data):
        _check(len(data) - pos >= 4, "truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            _check(len(data) - pos >= 8, "truncated skippable frame")
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            _check(len(data) - pos - 8 >= size, "truncated skippable frame")
            pos += 8 + size
            seen.add("skippable frame")
            continue
        _check(magic == FRAME_MAGIC, f"bad frame magic 0x{magic:08x}")
        pos = _frame(data, pos + 4, out, seen)
        seen.add("frame")
    return bytes(out)


def _frame(data: bytes, pos: int, out: bytearray, seen: set) -> int:
    _check(pos < len(data), "truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    _check(fhd & 8 == 0, "reserved bit set in the frame header")
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    window = None
    if not single:
        _check(pos < len(data), "truncated frame header")
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    _check(len(data) - pos >= did_size + fcs_size, "truncated frame header")
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    _check(did == 0, f"frame needs dictionary {did}")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        pos += fcs_size
    if window is None:
        window = fcs
    block_max = min(window, BLOCK_MAX)
    start = len(out)
    st = _FrameState(seen)
    if fcs is not None:
        seen.add("content size")
    seen.add("single segment" if single else "window descriptor")
    while True:
        _check(len(data) - pos >= 3, "truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        _check(kind != 3, "reserved block type")
        seen.add(("raw", "rle", "compressed")[kind] + " block")
        if kind == 1:
            _check(size <= block_max, "RLE block larger than the window")
            _check(pos < len(data), "truncated RLE block")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            _check(size <= block_max, "block larger than the window")
            _check(len(data) - pos >= size, "truncated block")
            block = data[pos:pos + size]
            pos += size
            if kind == 0:
                out += block
            else:
                n0 = len(out)
                _compressed_block(block, out, start, st)
                _check(len(out) - n0 <= block_max,
                       "block larger than the window")
        if last:
            break
    if fcs is not None:
        _check(len(out) - start == fcs, f"frame content size {fcs} but "
                                        f"{len(out) - start} bytes decoded")
    if checksum:
        _check(len(data) - pos >= 4, "truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        got = xxh64(bytes(out[start:])) & 0xFFFFFFFF
        _check(got == want, "content checksum mismatch")
        seen.add("checksum")
    return pos
