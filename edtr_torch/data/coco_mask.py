"""Pure-numpy COCO mask API: polygon rasterization + RLE codecs.

Counterpart of ``edtr_tpu/data/coco_mask.py``, host code copied.

pycocotools is not installed in this environment, but the reference's
COCO target prep (``datasets/utils_coco.py:19-33`` convert_coco_poly_to_mask,
``:129-179`` convert_to_coco_api's mask encode) and real COCO annotation
files depend on three primitives:

- polygon -> binary mask (``coco_mask.frPyObjects`` + ``decode``),
- uncompressed RLE ({"counts": [...], "size": [h, w]}, column-major), and
- compressed RLE (the base-48 LEB128-style byte string pycocotools emits).

This module implements all three host-side in numpy. The polygon
rasterizer follows the COCO mask API's published algorithm (maskApi.c
``rleFrPoly``): vertices are scaled 5x to an integer grid, the boundary is
densely traced, downsampled column-crossing points define even-odd runs in
column-major order. That makes axis-aligned integer rectangles exact and
matches pycocotools' boundary-inclusion behavior (tested against a
point-in-polygon + boundary oracle in tests/test_coco_mask.py).
"""

from typing import Dict, List, Sequence, Union

import numpy as np

__all__ = [
    "poly_to_rle",
    "rle_decode",
    "rle_encode_mask",
    "rle_compress",
    "rle_decompress",
    "rle_merge",
    "rle_area",
    "rle_to_bbox",
    "segmentation_to_mask",
    "convert_coco_poly_to_mask",
]


def poly_to_rle(xy: Sequence[float], h: int, w: int) -> Dict:
    """Rasterize one polygon (flat [x0, y0, x1, y1, ...]) to uncompressed RLE.

    COCO mask-API semantics: 5x-upsampled integer boundary trace, then
    even-odd column crossings. Column-major counts, leading background run.
    """
    xy = np.asarray(xy, dtype=np.float64)
    k = len(xy) // 2
    scale = 5.0
    x = np.round(scale * xy[0::2]).astype(np.int64)
    y = np.round(scale * xy[1::2]).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    # densely trace each edge on the upsampled grid
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.floor(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.floor(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # downsample: keep points where the trace crosses a column boundary
    m = len(u)
    xb: List[int] = []
    yb: List[int] = []
    for j in range(1, m):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        xb.append(int(xd))
        yb.append(int(np.ceil(yd)))

    # even-odd runs from sorted column-major crossing positions
    a = np.array([xi * h + yi for xi, yi in zip(xb, yb)], dtype=np.int64)
    a = np.sort(np.concatenate([a, [h * w]]))
    diffs = np.diff(np.concatenate([[0], a]))
    counts: List[int] = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            counts.append(int(diffs[j]))
            j += 1
        else:  # zero-length run: merge with the previous same-parity run
            j += 1
            if j < len(diffs):
                counts[-1] += int(diffs[j])
                j += 1
    return {"size": [int(h), int(w)], "counts": counts}


def rle_decode(rle: Dict) -> np.ndarray:
    """Uncompressed RLE -> (H, W) uint8 mask (column-major runs)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_decompress(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def rle_encode_mask(mask: np.ndarray) -> Dict:
    """(H, W) {0,1} mask -> uncompressed RLE (column-major, leading 0-run)."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [h * w]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:  # counts always start with a 0-run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": [int(c) for c in counts]}


def rle_compress(counts: Sequence[int]) -> bytes:
    """Counts -> pycocotools compressed byte string.

    Delta-codes every count against the one two places back, then emits
    signed little-endian base-32 groups offset by 48 with a 0x20
    continuation bit (maskApi.c ``rleToString``).
    """
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def rle_decompress(s: Union[bytes, str]) -> List[int]:
    """pycocotools compressed byte string -> counts list."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k = 0, 0
        more = True
        while more:
            ch = s[i] - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            i += 1
            if not more and (ch & 0x10):
                x |= -1 << (5 * (k + 1))  # sign-extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_merge(rles: List[Dict]) -> Dict:
    """Union of masks (``coco_mask.merge`` with intersect=False)."""
    if not rles:
        return {"size": [0, 0], "counts": [0]}
    mask = rle_decode(rles[0])
    for r in rles[1:]:
        mask |= rle_decode(r)
    return rle_encode_mask(mask)


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_decompress(counts)
    return int(sum(counts[1::2]))


def rle_to_bbox(rle: Dict) -> List[float]:
    """RLE -> [x, y, w, h] (``coco_mask.toBbox``); zeros for empty masks."""
    mask = rle_decode(rle)
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    return [
        float(xs.min()),
        float(ys.min()),
        float(xs.max() - xs.min() + 1),
        float(ys.max() - ys.min() + 1),
    ]


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """One COCO ``segmentation`` field (polygon list or RLE dict) -> mask."""
    if isinstance(segm, dict):  # RLE (crowd annotations)
        return rle_decode(segm)
    rles = [poly_to_rle(p, h, w) for p in segm]
    return rle_decode(rle_merge(rles)) if rles else np.zeros((h, w), np.uint8)


def convert_coco_poly_to_mask(segmentations, height: int, width: int) -> np.ndarray:
    """(N, H, W) uint8 masks; parity ``datasets/utils_coco.py:19-33``."""
    if not segmentations:
        return np.zeros((0, height, width), dtype=np.uint8)
    return np.stack(
        [segmentation_to_mask(s, height, width) for s in segmentations]
    ).astype(np.uint8)
