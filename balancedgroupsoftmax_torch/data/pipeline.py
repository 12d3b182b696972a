"""Test-time image preprocessing, in numpy.

A copy of the inference branch of JAX `data/pipeline.py`
(`rescale_size` :57, `preprocess_image` :63 with train=False): keep-ratio
resize to (1333, 800), ImageNet normalisation in RGB, and zero padding into
the landscape (800, 1344) or portrait (1344, 800) bucket.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)
SCALE = (1333, 800)  # (long, short)
# (landscape, portrait) pad buckets: SCALE's sides rounded up to 32
LANDSCAPE_BUCKET = (800, 1344)
PORTRAIT_BUCKET = (1344, 800)


def rescale_size(w: int, h: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.imrescale sizing: factor = min(long/max, short/min)."""
    long_side, short_side = max(scale), min(scale)
    f = min(long_side / max(w, h), short_side / min(w, h))
    return int(w * f + 0.5), int(h * f + 0.5), f


def preprocess_image(img: np.ndarray) -> Dict[str, np.ndarray]:
    """(H, W, 3) uint8 RGB -> the padded network input and its geometry."""
    import cv2

    h0, w0 = img.shape[:2]
    new_w, new_h, _ = rescale_size(w0, h0, SCALE)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    norm = (resized.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    bucket = LANDSCAPE_BUCKET if new_w >= new_h else PORTRAIT_BUCKET
    padded = np.zeros((*bucket, 3), np.float32)
    padded[:new_h, :new_w] = norm
    return dict(
        image=padded,
        img_shape=np.array([new_h, new_w], np.float32),
        scale_factor=np.float32(new_w / w0),
        bucket=bucket,
    )
