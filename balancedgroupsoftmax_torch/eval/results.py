"""Detections -> LVIS result records and their JSON (JAX `eval/results.py`
:17-46; the reference's mmdet/core/evaluation/lvis_utils.py `det2json` and
its xyxy -> xywh with the +1 convention). Labels are 0-based foreground
indices; category_id = cat_ids[label]."""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


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


def write_results_json(records: List[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(records, f)
