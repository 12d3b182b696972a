"""User API: build (and load) a detector, run single-image inference, draw
its detections, and tau-normalise its classifier (JAX `apis.py`
`init_detector` :79, `inference_detector` :116, `show_result` :121; JAX
tools/test_lvis.py `tau_norm` :99-115).

The detector runs on the card: with no `device`, `init_detector` takes
"cuda" and raises where there is none. Tests pass device="cpu".
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import zoo
from .data.pipeline import preprocess_image
from .gs.partition import load_partition, synthetic_partition
from .models.detector import FasterRCNN, build_model
from .utils.checkpoint import restore_checkpoint

# the model names of the CLIs -> (zoo constructor, its TrainConfig in zoo.TRAIN_CONFIGS)
MODELS = {
    "faster_rcnn_r50": (zoo.faster_rcnn_r50_fpn_lvis, "faster_rcnn_r50_fpn_lvis"),
    "gs_faster_rcnn_r50": (zoo.gs_faster_rcnn_r50_fpn_lvis, "gs_faster_rcnn_r50_fpn_lvis"),
    "faster_rcnn_x101": (zoo.faster_rcnn_x101_64x4d_fpn_lvis, "faster_rcnn_x101_64x4d_fpn_lvis"),
    "mask_rcnn_r50": (zoo.mask_rcnn_r50_fpn_lvis, "mask_rcnn_r50_fpn_lvis"),
    "gs_mask_rcnn_r50": (functools.partial(zoo.mask_rcnn_r50_fpn_lvis, use_gs=True), "gs_mask_rcnn_r50_fpn_lvis"),
    "cascade_rcnn_r50": (zoo.cascade_rcnn_r50_fpn_lvis, "cascade_rcnn_r50_fpn_lvis"),
    "gs_cascade_rcnn_r50": (
        functools.partial(zoo.cascade_rcnn_r50_fpn_lvis, use_gs=True),
        "gs_cascade_rcnn_r50_fpn_lvis",
    ),
    "cascade_rcnn_x101": (zoo.cascade_rcnn_x101_64x4d_fpn_lvis, "cascade_rcnn_x101_64x4d_fpn_lvis"),
    "gs_cascade_rcnn_x101": (
        functools.partial(zoo.cascade_rcnn_x101_64x4d_fpn_lvis, use_gs=True),
        "gs_cascade_rcnn_x101_64x4d_fpn_lvis",
    ),
    "htc_x101": (zoo.htc_x101_64x4d_fpn_lvis, "htc_x101_64x4d_fpn_lvis"),
    "gs_htc_x101": (functools.partial(zoo.htc_x101_64x4d_fpn_lvis, use_gs=True), "gs_htc_x101_64x4d_fpn_lvis"),
    "gs_htc_dcn_x101": (
        functools.partial(zoo.htc_x101_64x4d_fpn_lvis, use_gs=True, dcn=True),
        "gs_htc_x101_64x4d_fpn_lvis",
    ),
    # the detector variants; Fast R-CNN takes its proposals as input and is
    # API-only (`zoo.fast_rcnn_r50_fpn`, `models/variants.py`), as in JAX
    "grid_rcnn_r50": (zoo.grid_rcnn_r50_fpn, "grid_rcnn_r50_fpn"),
    "mask_scoring_rcnn_r50": (zoo.mask_scoring_rcnn_r50_fpn, "mask_scoring_rcnn_r50_fpn"),
    "double_head_rcnn_r50": (zoo.double_head_rcnn_r50_fpn, "double_head_rcnn_r50_fpn"),
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
    """Build a detector with seeded weights, or those of `checkpoint` (one
    the train CLI wrote, or a `torch.save`d state_dict such as
    `convert.params_from_flax` gives)."""
    device = resolve_device(device)
    det_cfg = MODELS[model_name][0]()
    partition = None
    if det_cfg.bbox_head.use_gs:
        partition = (
            load_partition(partition_path)
            if partition_path
            else synthetic_partition(det_cfg.bbox_head.num_classes)
        )
    model = build_model(det_cfg, partition=partition, dtype=dtype).init_weights(seed)
    if checkpoint:
        model.load_state_dict(restore_checkpoint(checkpoint)["model"])
    return Detector(model.to(device).eval(), device)


def inference_detector(detector: Detector, image: np.ndarray) -> List[dict]:
    """Single-image inference (apis/inference.py inference_detector parity)."""
    return detector(image)


def show_result(
    image: np.ndarray,
    detections: List[dict],
    class_names: Optional[Tuple[str, ...]] = None,
    score_thr: float = 0.3,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """A copy of the (H, W, 3) RGB `image` with each detection of
    `inference_detector` scoring at least `score_thr` drawn (base.py
    show_result): its box in green, and its class name (or category id) and
    score above it; written to `out_file` as BGR when given."""
    import cv2

    img = image.copy()
    for det in detections:
        if det["score"] < score_thr:
            continue
        x1, y1, x2, y2 = [int(round(v)) for v in det["bbox"]]
        cv2.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        name = class_names[det["label"]] if class_names is not None else str(det["category_id"])
        cv2.putText(img, f"{name} {det['score']:.2f}", (x1, max(y1 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 255, 0), 1)
    if out_file:
        cv2.imwrite(out_file, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return img


@torch.no_grad()
def tau_norm(fc: torch.nn.Linear, tau: float, skip_bg: bool = False) -> None:
    """Scale each row of the classifier `fc.weight` (a model's
    `bbox_head.fc_cls`) by 1 / ||row||^tau, in place, the bias
    untouched (the reference's reweight_cls); with `skip_bg` row 0
    (background) stays as it is."""
    w = fc.weight  # (logits, in)
    scale = 1.0 / w.norm(dim=1, keepdim=True).clamp_min(1e-12) ** tau
    if skip_bg:
        scale[0] = 1.0
    w.mul_(scale)
