"""The detector configurations of the ported slices (JAX `zoo.py` :27, :38
and :109): each constructor returns its `DetectorConfig`, and
`TRAIN_CONFIGS` holds the `TrainConfig` that the JAX constructor returns
beside it."""

from __future__ import annotations

from .config import BBoxHeadConfig, CascadeConfig, DetectorConfig, GSConfig, TrainConfig


def faster_rcnn_r50_fpn_lvis(num_classes: int = 1231) -> DetectorConfig:
    """configs/baselines/faster_rcnn_r50_fpn_1x_lvis.py equivalent."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes))


def gs_faster_rcnn_r50_fpn_lvis(num_classes: int = 1231, num_bins: int = 5) -> DetectorConfig:
    """configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py equivalent."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=True, gs=GSConfig(num_bins=num_bins))
    )


def cascade_rcnn_r50_fpn_lvis(num_classes: int = 1231, use_gs: bool = False) -> DetectorConfig:
    """configs/cascade_rcnn_r50_fpn_1x.py on the LVIS class set; with
    `use_gs` the grouped-softmax head in every stage (the R50 version of
    configs/bags/gs_cascade_rcnn_x101_64x4d_fpn_1x_lvis.py)."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=use_gs),
        cascade=CascadeConfig(),
    )


# the BAGS recipe trains phase 2 with only fc_cls (bg8.py:193,198); the GS
# cascade trains every stage's fc_cls (selectp=3)
TRAIN_CONFIGS = {
    "faster_rcnn_r50_fpn_lvis": TrainConfig(),
    "gs_faster_rcnn_r50_fpn_lvis": TrainConfig(selectp=1),
    "cascade_rcnn_r50_fpn_lvis": TrainConfig(),
    "gs_cascade_rcnn_r50_fpn_lvis": TrainConfig(selectp=3),
}
