"""Image preprocessing and batching, in numpy.

A copy of JAX `data/pipeline.py` (`PipelineConfig` :36, `rescale_size` :57,
`preprocess_image` :63, `collate` :374) without multi-scale training:
keep-ratio resize to (1333, 800), in training a random horizontal flip (gt
boxes scaled and flipped with the image), ImageNet normalisation in RGB, zero
padding into the landscape (800, 1344) or portrait (1344, 800) bucket, and gt
boxes padded to `max_gt_boxes` slots with a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)
SCALE = (1333, 800)  # (long, short)
# (landscape, portrait) pad buckets: SCALE's sides rounded up to 32
LANDSCAPE_BUCKET = (800, 1344)
PORTRAIT_BUCKET = (1344, 800)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    flip_prob: float = 0.5
    max_gt_boxes: int = 100


def rescale_size(w: int, h: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.imrescale sizing: factor = min(long/max, short/min)."""
    long_side, short_side = max(scale), min(scale)
    f = min(long_side / max(w, h), short_side / min(w, h))
    return int(w * f + 0.5), int(h * f + 0.5), f


def preprocess_image(
    img: np.ndarray,  # (H, W, 3) uint8 RGB
    gt_bboxes: Optional[np.ndarray] = None,  # (N, 4) xyxy at the original scale
    gt_labels: Optional[np.ndarray] = None,  # (N,) 1-based
    cfg: PipelineConfig = PipelineConfig(),
    train: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """One image -> the padded network input, its geometry and padded gts.
    In training, `rng` draws the flip."""
    import cv2

    if gt_bboxes is None:
        gt_bboxes = np.zeros((0, 4), np.float32)
        gt_labels = np.zeros(0, np.int32)
    h0, w0 = img.shape[:2]
    new_w, new_h, _ = rescale_size(w0, h0, SCALE)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    w_scale = new_w / w0
    h_scale = new_h / h0
    scale_factor = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
    boxes = gt_bboxes * scale_factor if len(gt_bboxes) else gt_bboxes

    flipped = False
    if train and rng is not None and rng.rand() < cfg.flip_prob:
        resized = resized[:, ::-1]
        flipped = True
        if len(boxes):
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = new_w - boxes[:, 2] - 1
            boxes[:, 2] = new_w - x1 - 1

    norm = (resized.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    bucket = LANDSCAPE_BUCKET if new_w >= new_h else PORTRAIT_BUCKET
    padded = np.zeros((*bucket, 3), np.float32)
    padded[:new_h, :new_w] = norm

    g = cfg.max_gt_boxes
    out_boxes = np.zeros((g, 4), np.float32)
    out_labels = np.zeros((g,), np.int32)
    out_mask = np.zeros((g,), bool)
    n = min(len(boxes), g)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = gt_labels[:n]
    out_mask[:n] = True
    return dict(
        image=padded,
        gt_boxes=out_boxes,
        gt_labels=out_labels,
        gt_mask=out_mask,
        img_shape=np.array([new_h, new_w], np.float32),
        scale_factor=np.float32(w_scale),
        flipped=flipped,
        bucket=bucket,
    )


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples of one bucket into a batch."""
    return dict(
        images=np.stack([s["image"] for s in samples]),
        gt_boxes=np.stack([s["gt_boxes"] for s in samples]),
        gt_labels=np.stack([s["gt_labels"] for s in samples]),
        gt_mask=np.stack([s["gt_mask"] for s in samples]),
        img_shapes=np.stack([s["img_shape"] for s in samples]),
        scale_factors=np.stack([s["scale_factor"] for s in samples]),
    )
