"""LVIS v0.5 annotation loading, in plain JSON and numpy (no lvis-api).

A copy of JAX `data/lvis.py` (`LvisDataset` :27-119). Conventions of the
reference's mmdet/datasets/lvis.py:
- contiguous 1-based labels by ascending category id (the identity for LVIS
  v0.5, whose ids are already 1..1230);
- bbox xywh -> xyxy with the -1 convention: [x, y, x + w - 1, y + h - 1];
- annotations with area <= 0 or w, h < 1 dropped;
- training images without annotations or with min(w, h) < `min_size`
  dropped;
- `filename` is the tail of `file_name` split on '_' (LVIS file names look
  like COCO_val2014_00000xxxx.jpg).

It also gives each image's `neg_category_ids` and
`not_exhaustive_category_ids`, which the federated evaluator reads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np


class LvisDataset:
    def __init__(self, ann_file: str, img_prefix: str = "", test_mode: bool = False, min_size: int = 32):
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        with open(ann_file) as f:
            data = json.load(f)

        self.categories = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in self.categories]
        self.cat2label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        self.label2cat = {v: k for k, v in self.cat2label.items()}
        self.class_names = tuple(c["name"] for c in self.categories)

        self._anns_by_img: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            self._anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.img_infos: List[Dict[str, Any]] = []
        for info in data["images"]:
            info = dict(info)
            info["filename"] = info["file_name"].split("_")[-1]
            self.img_infos.append(info)
        if not test_mode:
            self.img_infos = [
                i for i in self.img_infos
                if i["id"] in self._anns_by_img and min(i["width"], i["height"]) >= min_size
            ]
        self.img_ids = [i["id"] for i in self.img_infos]

    def __len__(self) -> int:
        return len(self.img_infos)

    def get_ann_info(self, idx: int) -> Dict[str, Any]:
        info = self.img_infos[idx]
        gt_bboxes, gt_labels, gt_ignore, gt_masks = [], [], [], []
        for ann in self._anns_by_img.get(info["id"], []):
            if ann.get("ignore", False):
                continue
            x1, y1, w, h = ann["bbox"]
            if ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            bbox = [x1, y1, x1 + w - 1, y1 + h - 1]
            if ann.get("iscrowd", 0):
                gt_ignore.append(bbox)
            else:
                gt_bboxes.append(bbox)
                gt_labels.append(self.cat2label[ann["category_id"]])
                gt_masks.append(ann.get("segmentation"))
        return dict(
            bboxes=np.asarray(gt_bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(gt_labels, np.int32),
            bboxes_ignore=np.asarray(gt_ignore, np.float32).reshape(-1, 4),
            masks=gt_masks,
        )

    def instance_counts(self) -> np.ndarray:
        """(num_classes + 1,) instance counts by label from the categories'
        `instance_count` (the GS partition's source)."""
        counts = np.zeros(len(self.cat_ids) + 1, np.int64)
        for i, c in enumerate(self.categories):
            counts[i + 1] = c.get("instance_count", 0)
        return counts

    def federated_fields(self, idx: int):
        info = self.img_infos[idx]
        return info.get("neg_category_ids", []), info.get("not_exhaustive_category_ids", [])

    def image_path(self, idx: int) -> str:
        """The stripped COCO file name under `img_prefix` where it exists
        (the reference's val2017/000000xxx.jpg layout), else `file_name`."""
        info = self.img_infos[idx]
        p = os.path.join(self.img_prefix, info["filename"])
        if os.path.exists(p):
            return p
        return os.path.join(self.img_prefix, info["file_name"])
