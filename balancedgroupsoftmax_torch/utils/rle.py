"""COCO's mask codec in numpy, a copy of JAX `utils/rle.py`: binary masks to
run lengths and LVIS's compressed strings (`mask_to_counts` :26,
`encode_counts` :51, `encode_mask` :91), back (`counts_to_mask` :39,
`decode_counts` :70, `decode_rle` :96) and polygons to masks
(`rle_counts_from_polygon` :111, `polygons_to_mask` :169,
`segmentation_to_mask` :179). The evaluator's mask IoU is
`eval/lvis_eval.py mask_iou_bitmaps`.

Run lengths are column-major (Fortran order), starting with a run of zeros;
compressed counts are COCO's base-48 strings (rleToString: from the third
run on, each the difference from the run two before, in 5-bit groups with a
continuation bit); a polygon is rasterised as pycocotools' rleFrPoly does
(the boundary walked at 5x upsampling, a fill toggle where it crosses a
column), and a polygon list is the union of its polygons.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """Binary (H, W) mask -> column-major run lengths, starting with the run
    of zeros."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:  # the counts start with a run of zeros
        runs = [0] + runs
    return [int(r) for r in runs]


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def encode_counts(counts: Sequence[int]) -> str:
    """Run lengths -> COCO's compressed string (rleToString)."""
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))  # sign-extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    """(H, W) binary mask -> {"size": [H, W], "counts": compressed string}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts(mask_to_counts(mask))}


def decode_rle(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts(counts)
    return counts_to_mask(counts, h, w)


def rle_counts_from_polygon(xy: Sequence[float], h: int, w: int) -> List[int]:
    """One polygon (flat [x0, y0, x1, y1, ...]) -> column-major RLE counts.

    COCO 'crossing boundary' semantics: the boundary is walked at 5x
    upsampling, each column crossing contributes a fill toggle at the
    (col, ceil(row)) it crosses, and toggles with even multiplicity cancel.
    Equivalent of pycocotools rleFrPoly (what the reference's lvis-api
    calls through mask.frPyObjects, lvis-api/lvis/lvis.py:236-240).
    """
    scale = 5.0
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    # C-style (int)(scale * v + .5): truncation toward zero
    x = np.trunc(scale * pts[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * pts[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])
    us, vs = [], []
    for j in range(len(x) - 1):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            d = np.arange(dx + 1, dtype=np.int64)
            t = dx - d if flip else d
            s = (ye - ys) / dx if dx else 0.0
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            d = np.arange(dy + 1, dtype=np.int64)
            t = dy - d if flip else d
            s = (xe - xs) / dy if dy else 0.0
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    # downsample: a point where the walk crosses into a new upsampled column
    # toggles the fill state of one (row, col) cell, provided the crossing
    # sits on an exact downsampled column boundary inside the canvas
    cross = np.nonzero(u[1:] != u[:-1])[0] + 1
    uj, ujm1 = u[cross], u[cross - 1]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(v[cross], v[cross - 1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0.0, float(h)))
    pos = xd[keep].astype(np.int64) * h + yd[keep].astype(np.int64)
    pos_u, cnt = np.unique(pos, return_counts=True)
    pos_u = pos_u[cnt % 2 == 1]  # even-multiplicity toggles cancel
    bounds = np.concatenate([[0], pos_u, [h * w]])
    counts = [int(c) for c in np.diff(bounds)]
    if len(counts) > 1 and counts[-1] == 0:  # toggle exactly at h*w
        counts.pop()
    return counts


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon lists -> (H, W) uint8 mask (union of the
    per-polygon RLEs, the lvis-api ann_to_mask merge semantics)."""
    mask = np.zeros((h, w), np.uint8)
    for p in polys:
        if len(p) >= 6:
            mask |= counts_to_mask(rle_counts_from_polygon(p, h, w), h, w)
    return mask


def segmentation_to_mask(seg: Union[Dict, List], h: int, w: int) -> np.ndarray:
    """COCO `segmentation` field (polygons or RLE) -> binary mask."""
    if isinstance(seg, dict):
        return decode_rle(seg)
    return polygons_to_mask(seg, h, w)
