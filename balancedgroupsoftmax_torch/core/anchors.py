"""Anchor generation over static feature-map shapes, in numpy.

A copy of JAX `core/anchors.py` (`base_anchors` :22,
`grid_anchors` :58, `multilevel_anchors` :77): base anchors centred at
0.5 * (base_size - 1) with rounded corners, laid out location-major with the
A base anchors of a location contiguous. The detector builds them once per
padded image shape.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def base_anchors(
    base_size: int,
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
    scale_major: bool = True,
) -> np.ndarray:
    """(A, 4) base anchors for one level, A = len(ratios) * len(scales)."""
    w = float(base_size)
    h = float(base_size)
    x_ctr = 0.5 * (w - 1)
    y_ctr = 0.5 * (h - 1)

    scales_a = np.asarray(scales, dtype=np.float32)
    ratios_a = np.asarray(ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios_a)
    w_ratios = 1.0 / h_ratios
    if scale_major:
        ws = (w * w_ratios[:, None] * scales_a[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales_a[None, :]).reshape(-1)
    else:
        ws = (w * scales_a[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (h * scales_a[:, None] * h_ratios[None, :]).reshape(-1)

    anchors = np.stack(
        [
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        ],
        axis=-1,
    )
    return np.round(anchors).astype(np.float32)


@functools.lru_cache(maxsize=None)
def grid_anchors(
    featmap_size: Tuple[int, int],
    stride: int,
    base_size: int,
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
) -> np.ndarray:
    """(H*W*A, 4) anchors for one level; location-major, A contiguous."""
    base = base_anchors(base_size, scales, ratios)
    feat_h, feat_w = featmap_size
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    xx = np.tile(shift_x, feat_h)
    yy = np.repeat(shift_y, feat_w)
    shifts = np.stack([xx, yy, xx, yy], axis=-1)  # (H*W, 4)
    all_anchors = base[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


def multilevel_anchors(
    featmap_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    scales: Sequence[float],
    ratios: Sequence[float],
    base_sizes: Sequence[int] | None = None,
) -> list[np.ndarray]:
    """Anchors for every FPN level. base_sizes default to the strides
    (anchor_head.py behavior: anchor_base_sizes = anchor_strides)."""
    if base_sizes is None:
        base_sizes = list(strides)
    return [
        grid_anchors(
            tuple(fs), int(s), int(bs), tuple(float(x) for x in scales), tuple(float(x) for x in ratios)
        )
        for fs, s, bs in zip(featmap_sizes, strides, base_sizes)
    ]
