"""Detections -> LVIS result records and their JSON (JAX `eval/results.py`
:17-46; the reference's mmdet/core/evaluation/lvis_utils.py `det2json` and
its xyxy -> xywh with the +1 convention), and their masks pasted into the
image and RLE-encoded, with Mask-Scoring R-CNN's mask scores (JAX
tools/test_lvis.py:590-607). Labels are 0-based
foreground indices; category_id = cat_ids[label]."""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from ..ops.mask import paste_mask
from ..utils.rle import encode_mask


def xyxy2xywh(b: np.ndarray) -> List[float]:
    return [float(b[0]), float(b[1]), float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)]


def detections_to_records(
    image_id: int,
    boxes: np.ndarray,  # (M, 4) xyxy at the original image scale
    scores: np.ndarray,  # (M,)
    labels: np.ndarray,  # (M,) int, 0-based foreground label
    valid: np.ndarray,  # (M,) bool
    cat_ids: Sequence[int],  # label -> category id
) -> List[dict]:
    return [
        dict(
            image_id=int(image_id),
            bbox=xyxy2xywh(boxes[i]),
            score=float(scores[i]),
            category_id=int(cat_ids[int(labels[i])]),
        )
        for i in range(len(boxes))
        if valid[i]
    ]


def add_segmentations(
    records: List[dict],  # detections_to_records' records of one image
    masks: np.ndarray,  # (M, 28, 28) f32 probabilities of the image's detections
    boxes: np.ndarray,  # (M, 4) xyxy at the original image scale
    valid: np.ndarray,  # (M,) bool
    img_h: int,
    img_w: int,
    mask_scores: Optional[np.ndarray] = None,  # (M,) Mask-Scoring R-CNN's
) -> None:
    """Give each record the "segmentation" of its detection: the mask pasted
    at the original size (`paste_mask`) and RLE-encoded, and with
    `mask_scores` its "segm_score", which the segm evaluator ranks by. The
    records are those of the valid slots, in order."""
    for rec, i in zip(records, np.flatnonzero(valid)):
        rec["segmentation"] = encode_mask(paste_mask(masks[i], boxes[i], img_h, img_w))
        if mask_scores is not None:
            rec["segm_score"] = float(mask_scores[i])


def write_results_json(records: List[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(records, f)
