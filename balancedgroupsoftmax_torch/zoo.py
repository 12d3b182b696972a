"""The detector configurations of the ported slices (JAX `zoo.py` :27, :38,
:65, :83, :92, :109, :127, :162-190 and the variants :191-250): each constructor returns its
`DetectorConfig`, and `TRAIN_CONFIGS` holds the `TrainConfig` that the JAX
constructor returns beside it."""

from __future__ import annotations

from .config import (
    BackboneConfig,
    BBoxHeadConfig,
    CascadeConfig,
    DetectorConfig,
    GSConfig,
    HTCConfig,
    MaskHeadConfig,
    TrainConfig,
    VariantConfig,
)


def faster_rcnn_r50_fpn_lvis(num_classes: int = 1231) -> DetectorConfig:
    """configs/baselines/faster_rcnn_r50_fpn_1x_lvis.py equivalent."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes))


def gs_faster_rcnn_r50_fpn_lvis(num_classes: int = 1231, num_bins: int = 5) -> DetectorConfig:
    """configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py equivalent."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=True, gs=GSConfig(num_bins=num_bins))
    )


def mask_rcnn_r50_fpn_lvis(num_classes: int = 1231, use_gs: bool = False, num_bins: int = 5) -> DetectorConfig:
    """configs/baselines/mask_rcnn_r50_fpn_1x_lvis.py; with `use_gs`,
    configs/bags/gs_mask_rcnn_r50_fpn_1x_lvis_with0_bg8.py: Faster R-CNN with
    an FCN mask head (28 x 28 class-selected masks)."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=use_gs, gs=GSConfig(num_bins=num_bins)),
        mask_head=MaskHeadConfig(num_classes=num_classes),
    )


def cascade_rcnn_r50_fpn_lvis(num_classes: int = 1231, use_gs: bool = False) -> DetectorConfig:
    """configs/cascade_rcnn_r50_fpn_1x.py on the LVIS class set; with
    `use_gs` the grouped-softmax head in every stage (the R50 version of
    configs/bags/gs_cascade_rcnn_x101_64x4d_fpn_1x_lvis.py)."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=use_gs),
        cascade=CascadeConfig(),
    )


def cascade_rcnn_x101_64x4d_fpn_lvis(num_classes: int = 1231, use_gs: bool = False) -> DetectorConfig:
    """configs/bags/gs_cascade_rcnn_x101_64x4d_fpn_1x_lvis.py (`use_gs`) and
    its softmax baseline: the cascade on the ResNeXt-101 64x4d backbone."""
    return DetectorConfig(
        backbone=BackboneConfig(depth=101, groups=64, base_width=4),
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=use_gs),
        cascade=CascadeConfig(),
    )


def faster_rcnn_x101_64x4d_fpn_lvis(num_classes: int = 1231) -> DetectorConfig:
    """X101-64x4d backbone variant (configs/bags/gs_faster_rcnn_x101...)."""
    return DetectorConfig(
        backbone=BackboneConfig(depth=101, groups=64, base_width=4),
        bbox_head=BBoxHeadConfig(num_classes=num_classes),
    )


def htc_x101_64x4d_fpn_lvis(
    num_classes: int = 1231, use_gs: bool = False, dcn: bool = False, dcn_shift_window: int = 4
) -> DetectorConfig:
    """configs/bags/gs_htc_x101_64x4d_fpn_20e_16gpu_lvis.py equivalent; `dcn`
    adds deformable conv v1 in c3-c5 with 64 groups (the BAGS paper's
    top-line gs_htc_dconv_c3-c5_mstrain_400_1400_x101_64x4d_fpn_20e, :22),
    its offsets clamped to +-`dcn_shift_window` cells (0: the exact bilinear
    gather everywhere)."""
    return DetectorConfig(
        backbone=BackboneConfig(
            depth=101,
            groups=64,
            base_width=4,
            dcn_stages=(False, True, True, True) if dcn else (False,) * 4,
            dcn_shift_window=dcn_shift_window if dcn else 0,
        ),
        bbox_head=BBoxHeadConfig(num_classes=num_classes, use_gs=use_gs),
        mask_head=MaskHeadConfig(num_classes=num_classes),
        cascade=CascadeConfig(),
        htc=HTCConfig(),
    )


def faster_rcnn_r50_fpn_rfs_lvis(num_classes: int = 1231) -> DetectorConfig:
    """transferred/faster_rcnn_r50_fpn_1x_lvis_rfs.py: the same model, with
    repeat-factor sampling in the data pipeline (train CLI --use-rfs)."""
    return faster_rcnn_r50_fpn_lvis(num_classes)


def faster_rcnn_r50_fpn_focal_lvis(num_classes: int = 1231) -> DetectorConfig:
    """transferred/faster_rcnn_r50_fpn_1x_lvis_focalloss*.py: the sigmoid focal
    classification loss."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes, loss_cls_type="focal"))


def faster_rcnn_r50_fpn_reweight_lvis(num_classes: int = 1231) -> DetectorConfig:
    """transferred/faster_rcnn_r50_fpn_1x_lvis_reweight*.py: CE weighted by
    class (ReweightBBoxHead); the weights enter the model as
    `FasterRCNN(class_weights=gs.partition.class_weights_from_counts(...))`."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes, loss_cls_type="reweight"))


# The detector variants (`models/variants.py`): mmdet detectors that no LVIS
# config uses; 81 classes as in their COCO configs, `num_classes` overridable
# (the CLIs set the dataset's).


def fast_rcnn_r50_fpn(num_classes: int = 81) -> DetectorConfig:
    """mmdet fast_rcnn_r50_fpn: no RPN, the proposals are an input."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes), variant=VariantConfig(kind="fast"))


def grid_rcnn_r50_fpn(num_classes: int = 81) -> DetectorConfig:
    """mmdet grid_rcnn_gn_head_r50_fpn: boxes located by grid-point heatmaps."""
    return DetectorConfig(bbox_head=BBoxHeadConfig(num_classes=num_classes), variant=VariantConfig(kind="grid"))


def mask_scoring_rcnn_r50_fpn(num_classes: int = 81) -> DetectorConfig:
    """mmdet ms_rcnn_r50_fpn: Mask R-CNN whose mask scores are rescored by a
    MaskIoU head."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes),
        mask_head=MaskHeadConfig(num_classes=num_classes),
        variant=VariantConfig(kind="mask_scoring"),
    )


def double_head_rcnn_r50_fpn(num_classes: int = 81, reg_roi_scale_factor: float = 1.3) -> DetectorConfig:
    """mmdet dh_faster_rcnn_r50_fpn: a conv branch regresses from rois
    inflated by `reg_roi_scale_factor`, an fc branch classifies."""
    return DetectorConfig(
        bbox_head=BBoxHeadConfig(num_classes=num_classes),
        variant=VariantConfig(kind="double_head", reg_roi_scale_factor=reg_roi_scale_factor),
    )


# the BAGS recipe trains phase 2 with only fc_cls (bg8.py:193,198), GS Mask
# R-CNN's too; the GS cascade and the GS HTC train every stage's fc_cls
# (selectp=3); HTC runs 20 epochs (the _20e configs); the focal and
# re-weight entries are the "*_cls" rows, which train fc_cls alone (JAX's
# cls_only=True; their full-training rows take TrainConfig())
TRAIN_CONFIGS = {
    "faster_rcnn_r50_fpn_lvis": TrainConfig(),
    "gs_faster_rcnn_r50_fpn_lvis": TrainConfig(selectp=1),
    "mask_rcnn_r50_fpn_lvis": TrainConfig(),
    "gs_mask_rcnn_r50_fpn_lvis": TrainConfig(selectp=1),
    "cascade_rcnn_r50_fpn_lvis": TrainConfig(),
    "gs_cascade_rcnn_r50_fpn_lvis": TrainConfig(selectp=3),
    "cascade_rcnn_x101_64x4d_fpn_lvis": TrainConfig(),
    "gs_cascade_rcnn_x101_64x4d_fpn_lvis": TrainConfig(selectp=3),
    "faster_rcnn_r50_fpn_rfs_lvis": TrainConfig(),
    "faster_rcnn_r50_fpn_focal_lvis": TrainConfig(selectp=1),
    "faster_rcnn_r50_fpn_reweight_lvis": TrainConfig(selectp=1),
    "faster_rcnn_x101_64x4d_fpn_lvis": TrainConfig(),
    "htc_x101_64x4d_fpn_lvis": TrainConfig(total_epochs=20),
    "gs_htc_x101_64x4d_fpn_lvis": TrainConfig(selectp=3, total_epochs=20),
    "fast_rcnn_r50_fpn": TrainConfig(),
    "grid_rcnn_r50_fpn": TrainConfig(),
    "mask_scoring_rcnn_r50_fpn": TrainConfig(),
    "double_head_rcnn_r50_fpn": TrainConfig(),
}
