"""The detector configurations of the inference slice
(JAX `zoo.py` :27 and :38), as `DetectorConfig`s."""

from __future__ import annotations

from .config import BBoxHeadConfig, DetectorConfig, GSConfig


def faster_rcnn_r50_fpn_lvis(num_classes: int = 1231) -> DetectorConfig:
    """configs/baselines/faster_rcnn_r50_fpn_1x_lvis.py equivalent."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes))


def gs_faster_rcnn_r50_fpn_lvis(num_classes: int = 1231, num_bins: int = 5) -> DetectorConfig:
    """configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py equivalent."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=True, gs=GSConfig(num_bins=num_bins))
    )
