"""The port's zstd decoders against ``zstandard`` (RFC 8878), on the CPU.

``odwscl_tpu_torch/utils/zstd.py``: ``decompress`` (the native decoder,
``csrc/zstd_decode.cpp``) and ``decompress_plain`` (pure Python) must give
exactly ``zstandard``'s bytes. The corpus: levels -5, 1, 3 and 19, each
with and without the content checksum and the content size, over empty
input, an RLE-only input (300 KB of one byte: RLE blocks), random bytes
(raw blocks), f32 weight tensors (Huffman literals, few matches) and a
387 KB text with repeated structure (several blocks, matches, repeat
offsets, repeat tables, treeless literals); two frames back to back and a
skippable frame; and frames built here by hand for what the encoder does
not emit on these inputs: RLE literals, Huffman literals with direct
weights in one and four streams followed by a treeless block, and
sequences with RLE tables. The plain decoder records the format features
it met; together they must cover every one. A frame that names a
dictionary raises. Hypothesis flips and truncates bytes of checksummed
frames: each decoder either raises ``ValueError`` or returns exactly the
original bytes, both decoders agree on which, and the test process never
crashes. No tolerance applies (bytes).
"""

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from odwscl_tpu_torch.utils import zstd

LEVELS = (-5, 1, 3, 19)
FEATURES = {
    "frame", "skippable frame", "checksum", "content size", "single segment",
    "window descriptor", "raw block", "rle block", "compressed block",
    "literals raw", "literals rle", "literals 1 stream",
    "literals 4 streams", "literals treeless", "huffman weights direct",
    "huffman weights fse", "repeat offset 1", "repeat offset 2",
    "repeat offset 3", "repeat offset 1 with no literals",
    "repeat offset 2 with no literals", "repeat offset 3 with no literals",
    *(f"sequences {t} {m}" for t in ("ll", "of", "ml")
      for m in ("predefined", "rle", "fse", "repeat"))}


def _inputs():
    rng = np.random.RandomState(0)
    lines = b"".join(b"param_%05d: %.6f weight_%d\n"
                     % (i % 977, rng.randn(), rng.randint(40))
                     for i in range(12000))
    return {"empty": b"", "rle": b"\x07" * 300_000,
            "random": rng.bytes(3000),
            "weights": (rng.randn(64, 32) * 0.05).astype(np.float32).tobytes(),
            "structured": lines}


INPUTS = _inputs()


def _check_both(frame, want):
    seen = set()
    assert zstd.decompress_plain(frame, seen) == want
    assert bytes(zstd.decompress(frame)) == want
    return seen


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", LEVELS)
def test_decoders_match_zstandard(level, checksum, content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in INPUTS.items():
        frame = c.compress(data)
        assert zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=len(data) + 1) == data, name
        seen = _check_both(frame, data)
        assert ("checksum" in seen) == checksum, name
    if level == 3:
        assert "structured" in INPUTS and len(INPUTS["structured"]) > 131072


def test_frames_back_to_back_and_skippable():
    a, b = INPUTS["weights"], INPUTS["structured"][:50_000]
    frames = (zstandard.ZstdCompressor(level=3).compress(a)
              + zstandard.ZstdCompressor(level=1, write_checksum=True)
              .compress(b))
    data = _skippable() + frames + _skippable()
    seen = _check_both(data, a + b)
    assert "skippable frame" in seen


def test_a_frame_with_a_dictionary_raises():
    d = zstandard.train_dictionary(1024, [INPUTS["structured"][i:i + 400]
                                          for i in range(0, 200_000, 400)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(b"param_00001")
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress_plain(frame)
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


# -- frames built by hand ---------------------------------------------------

def _backward(fields):
    """A backward bitstream: (value, bits) in the order the decoder reads
    them (the first at the top), then the end marker."""
    v, n = 1, 0
    for value, bits in fields:
        assert 0 <= value < (1 << bits) or bits == 0
        v = (v << bits) | value
        n += bits
    return v.to_bytes((n + 1 + 7) // 8, "little")


def _frame(blocks):
    """A frame of compressed blocks: no content size, a 1 KB window."""
    out = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 0x00])
    for i, block in enumerate(blocks):
        last = i == len(blocks) - 1
        out += (int(last) | 2 << 1 | len(block) << 3).to_bytes(3, "little")
        out += block
    return out


def _huffman_literals(text: bytes, streams: int, treeless: bool):
    """A compressed (or treeless) literals section of ``text`` over 'a'-'d'
    with direct weights a 2, b 1, c 1 (d, the last symbol, implied 3):
    codes b 000, c 001, a 01, d 1."""
    codes = {ord("b"): (0, 3), ord("c"): (1, 3), ord("a"): (1, 2),
             ord("d"): (1, 1)}
    tree = b""
    if not treeless:
        weights = [0] * 100
        weights[ord("a")], weights[ord("b")], weights[ord("c")] = 2, 1, 1
        tree = bytes([127 + 100]) + bytes(
            weights[i] << 4 | weights[i + 1] for i in range(0, 100, 2))
    if streams == 1:
        body = tree + _backward(codes[c] for c in text)
    else:
        per = (len(text) + 3) // 4
        parts = [_backward(codes[c] for c in text[i * per:(i + 1) * per])
                 for i in range(4)]
        body = tree + b"".join(len(p).to_bytes(2, "little")
                               for p in parts[:3]) + b"".join(parts)
    kind, fmt = (3 if treeless else 2), (0 if streams == 1 else 1)
    h = kind | fmt << 2 | len(text) << 4 | len(body) << 14
    return h.to_bytes(3, "little") + body


def _hand_built_frames():
    """{name: (frame, content)}: RLE literals; Huffman literals with direct
    weights in one and four streams, then a treeless block; sequences with
    RLE tables."""
    # RLE literals (kind 1, 1-byte header), no sequences
    rle = _frame([bytes([1 | 25 << 3, ord("z"), 0])])
    text1, text2, text3 = b"abcdabcaddda", b"dcbaddaaabcd" * 3, b"cabbad"
    huff = _frame([_huffman_literals(text1, 1, False) + b"\x00",
                   _huffman_literals(text2, 4, False) + b"\x00",
                   _huffman_literals(text3, 1, True) + b"\x00"])
    # 40 raw literals (2-byte header), then 3 sequences of RLE tables:
    # literal-length code 13 (13 literals), offset code 4 (value 16 + 4
    # extra bits, here 0: offset 13), match-length code 5 (8 bytes)
    lits = b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcd"
    raw = bytes([1 << 2 | (len(lits) & 15) << 4, len(lits) >> 4]) + lits
    seqs = bytes([3, 1 << 6 | 1 << 4 | 1 << 2, 13, 4, 5]) + _backward(
        [(0, 4), (0, 4), (0, 4)])
    want = bytearray()
    for k in range(3):
        want += lits[13 * k:13 * (k + 1)]
        for _ in range(8):
            want.append(want[-13])
    want += lits[39:]
    return {"rle literals": (rle, b"z" * 25),
            "huffman": (huff, text1 + text2 + text3),
            "rle tables": (_frame([raw + seqs]), bytes(want))}


@pytest.mark.parametrize("name", ["rle literals", "huffman", "rle tables"])
def test_hand_built_frames(name):
    frame, data = _hand_built_frames()[name]
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=1 << 16) == data
    _check_both(frame, data)


def test_the_corpus_covers_every_feature():
    """The frames of the tests above, decoded exactly, meet every format
    feature the plain decoder knows."""
    seen = set()
    for level in (1, 3, 19):
        c = zstandard.ZstdCompressor(level=level, write_checksum=True)
        for name in ("rle", "random", "structured"):
            zstd.decompress_plain(c.compress(INPUTS[name]), seen)
    zstd.decompress_plain(zstandard.ZstdCompressor(
        level=3, write_content_size=False).compress(INPUTS["weights"]), seen)
    zstd.decompress_plain(_skippable() + zstandard.ZstdCompressor().compress(
        b"x"), seen)
    for frame, _ in _hand_built_frames().values():
        zstd.decompress_plain(frame, seen)
    assert FEATURES <= seen, sorted(FEATURES - seen)


def _skippable():
    return ((0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
            + b"12345")


# -- corrupt input ----------------------------------------------------------

BASES = [zstandard.ZstdCompressor(level=lv, write_checksum=True).compress(d)
         for lv, d in ((1, INPUTS["weights"][:1024]),
                       (3, INPUTS["structured"][:3000]),
                       (19, INPUTS["structured"][5000:7000]))]
WANTS = [INPUTS["weights"][:1024], INPUTS["structured"][:3000],
         INPUTS["structured"][5000:7000]]


def _outcome(fn, data):
    try:
        return bytes(fn(data))
    except ValueError:
        return None


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, len(BASES) - 1), st.integers(0, 1 << 30),
       st.integers(1, 255), st.booleans())
def test_corrupt_frames_raise_or_decode_exactly(which, where, flip, truncate):
    frame = bytearray(BASES[which])
    if truncate:
        frame = frame[:where % len(frame)]
    else:
        frame[where % len(frame)] ^= flip
    native = _outcome(zstd.decompress, bytes(frame))
    plain = _outcome(zstd.decompress_plain, bytes(frame))
    assert (native is None) == (plain is None)
    if native is not None:
        assert native == plain == WANTS[which]
