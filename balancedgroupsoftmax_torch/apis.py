"""User API: build (and load) a detector and run single-image inference
(JAX `apis.py` `init_detector` :79,
`inference_detector` :116).

The detector runs on the card: with no `device`, `init_detector` takes
"cuda" and raises where there is none. Tests pass device="cpu".
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import zoo
from .data.pipeline import preprocess_image
from .gs.partition import load_partition, synthetic_partition
from .models.detector import FasterRCNN, build_detector

BUILDERS = {
    "faster_rcnn_r50": zoo.faster_rcnn_r50_fpn_lvis,
    "gs_faster_rcnn_r50": zoo.gs_faster_rcnn_r50_fpn_lvis,
}


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """The given device, or "cuda"; refuses a CUDA device the host lacks."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the detector runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions of its kernels instead"
        )
    return device


class Detector:
    """A loaded model on its device. Each image is padded into the landscape
    or the portrait bucket by its aspect (data/pipeline.py), and the model's
    anchors follow that shape."""

    def __init__(self, model: FasterRCNN, device: torch.device, cat_ids=None):
        self.model = model
        self.device = device
        self.cat_ids = cat_ids or list(range(1, model.cfg.bbox_head.num_classes))

    def __call__(self, image: np.ndarray) -> List[dict]:
        """image: (H, W, 3) uint8 RGB -> list of detection dicts."""
        s = preprocess_image(image)
        dets = self.model.predict(
            torch.from_numpy(s["image"][None]).to(self.device),
            torch.from_numpy(s["img_shape"][None]).to(self.device),
            torch.tensor([s["scale_factor"]], device=self.device),
        )
        boxes, scores, labels, valid = (t[0].cpu().numpy() for t in dets)
        return [
            dict(
                bbox=boxes[i].tolist(),
                score=float(scores[i]),
                label=int(labels[i]),
                category_id=int(self.cat_ids[int(labels[i])]),
            )
            for i in range(len(boxes))
            if valid[i]
        ]


def init_detector(
    model_name: str = "gs_faster_rcnn_r50",
    checkpoint: Optional[str] = None,
    partition_path: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[str | torch.device] = None,
    seed: int = 0,
) -> Detector:
    """Build a detector with seeded weights, or those of `checkpoint` (a
    `torch.save`d state_dict, e.g. from `convert.params_from_flax`)."""
    device = resolve_device(device)
    det_cfg = BUILDERS[model_name]()
    partition = None
    if det_cfg.bbox_head.use_gs:
        partition = (
            load_partition(partition_path)
            if partition_path
            else synthetic_partition(det_cfg.bbox_head.num_classes)
        )
    model = build_detector(det_cfg, partition=partition, dtype=dtype).init_weights(seed)
    if checkpoint:
        model.load_state_dict(torch.load(checkpoint, map_location="cpu", weights_only=True))
    return Detector(model.to(device).eval(), device)


def inference_detector(detector: Detector, image: np.ndarray) -> List[dict]:
    """Single-image inference (apis/inference.py inference_detector parity)."""
    return detector(image)
