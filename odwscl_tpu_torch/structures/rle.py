"""COCO run-length-encoded (RLE) mask codec in numpy.

Counterpart of ``odwscl_tpu/structures/rle.py`` (no pycocotools). The two
COCO wire formats:

- uncompressed: ``{"counts": [int, ...], "size": [h, w]}``, alternating
  run lengths over the mask flattened in column-major (Fortran) order,
  starting with the run of zeros (possibly of length 0);
- compressed: ``{"counts": str | bytes, "size": [h, w]}``, pycocotools'
  base-32 varint string: from the third count on each count is coded as
  its difference to the count two places back, then written as 5-bit
  chunks, low chunk first, each chunk OR'd with a continuation bit (0x20)
  while more follow and offset by 48 into printable ASCII; bit 0x10 of the
  last chunk is the sign.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def _counts_from_string(s: Union[str, bytes]) -> List[int]:
    """pycocotools' rleFrString: base-32 varints, order-2 delta coding."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i, n = 0, len(s)
    while i < n:
        x = k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_string(counts: Sequence[int]) -> str:
    """pycocotools' rleToString, the inverse of ``_counts_from_string``."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # arithmetic shift: the emitted chunk's sign bit says whether
            # the remaining bits are pure sign fill
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return out.decode("ascii")


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed or not) -> uint8 [H, W] mask."""
    h, w = int(rle["size"][0]), int(rle["size"][1])
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_from_string(counts)
    counts = np.asarray(counts, np.int64)
    if counts.sum() != h * w:
        raise ValueError(f"RLE counts sum {int(counts.sum())} != h*w {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1                      # runs alternate 0, 1, 0, 1, ...
    flat = np.repeat(vals, counts)
    return flat.reshape((w, h)).T.copy()   # column-major -> [H, W]


def rle_encode(mask: np.ndarray) -> Dict:
    """uint8/bool [H, W] mask -> compressed COCO RLE dict."""
    m = (np.asarray(mask) != 0).astype(np.uint8)
    h, w = m.shape
    flat = m.T.reshape(-1)              # column-major
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate(([0], change, [flat.size]))
    runs = np.diff(starts).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    if not flat.size:
        runs = []
    return {"size": [h, w], "counts": _counts_to_string(runs)}


def is_rle(seg) -> bool:
    """True for a COCO RLE segmentation dict (not a polygon list)."""
    return isinstance(seg, dict) and "counts" in seg and "size" in seg


def rasterize_segmentation(seg, height: int, width: int) -> np.ndarray:
    """A COCO ``segmentation`` (an RLE dict, or a list of polygons) ->
    uint8 [H, W]; polygons fill with ``structures/masks.py``'s
    ``rasterize_polygons``."""
    if not is_rle(seg):
        from .masks import rasterize_polygons
        return rasterize_polygons([np.asarray(p) for p in (seg or [])],
                                  height, width)
    m = rle_decode(seg)
    if m.shape != (height, width):
        raise ValueError(f"RLE size {m.shape} != image size "
                         f"{(height, width)}")
    return m
