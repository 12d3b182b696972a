"""Configuration dataclasses of the ported slices.

Copies of the fields that the ported detectors (Faster, Mask and Cascade
R-CNN, HTC and the variants of `VariantConfig`) read from JAX `config.py`,
with the same names and defaults (the canonical BAGS config
`configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py`).
The input-size field is not copied: the port's anchors follow each batch's
shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.5
    gt_max_assign_all: bool = True


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num: int = 512
    pos_fraction: float = 0.25
    add_gt_as_proposals: bool = True


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    scales: Tuple[float, ...] = (8.0,)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)

    @property
    def num_base_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclasses.dataclass(frozen=True)
class RPNTrainConfig:
    assigner: AssignerConfig = AssignerConfig(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3)
    sampler: SamplerConfig = SamplerConfig(num=256, pos_fraction=0.5, add_gt_as_proposals=False)
    allowed_border: int = 0
    pos_weight: float = -1.0


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """RPN proposal generation (train: bg8.py:78-84, test: :101-107)."""

    nms_pre: int = 2000
    nms_post: int = 2000
    max_num: int = 2000
    nms_thr: float = 0.7
    # proposals narrower or lower than this (+1 widths, after the clip) are dropped before NMS
    min_bbox_size: float = 0.0


@dataclasses.dataclass(frozen=True)
class RCNNTrainConfig:
    assigner: AssignerConfig = AssignerConfig()
    sampler: SamplerConfig = SamplerConfig()
    pos_weight: float = -1.0


@dataclasses.dataclass(frozen=True)
class RCNNTestConfig:
    score_thr: float = 0.0
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    nms_type: str = "nms"  # or "soft_nms"
    # candidate boxes entering per-class NMS per class
    nms_candidates_per_class: int = 300


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Grouped-softmax head (bg8.py:39-51)."""

    num_bins: int = 5
    others_sample_ratio: float = 8.0


@dataclasses.dataclass(frozen=True)
class BBoxHeadConfig:
    num_shared_fcs: int = 2
    in_channels: int = 256
    roi_feat_size: int = 7
    fc_out_channels: int = 1024
    num_classes: int = 1231  # 1230 fg + 1 bg
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    reg_class_agnostic: bool = False
    use_gs: bool = False
    gs: GSConfig = GSConfig()
    # the classification loss: "softmax" (CE), "focal" (transferred/*focalloss*
    # configs: sigmoid focal loss over all logits against one-hot targets) or
    # "reweight" (ReweightBBoxHead: CE weighted by the target class's weight,
    # `FasterRCNN(class_weights=...)`; with the GS head, GS-reweight).
    loss_cls_type: str = "softmax"
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25


@dataclasses.dataclass(frozen=True)
class RoIExtractorConfig:
    out_size: int = 7
    sample_num: int = 2
    featmap_strides: Tuple[int, ...] = (4, 8, 16, 32)
    finest_scale: int = 56


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    depth: int = 50
    frozen_stages: int = 1
    # ResNeXt: grouped 3x3 convolutions, width rule of resnext.py
    groups: int = 1
    base_width: int = 4
    # stages whose 3x3 is a deformable convolution (HTC-DCN: c3-c5)
    dcn_stages: Tuple[bool, ...] = (False, False, False, False)
    # DCN v2 (modulated); the shipped top-line config is v1
    dcn_modulated: bool = False
    # deform-conv groups; None follows `groups` (both 64 in the shipped X101)
    dcn_groups: Optional[int] = None
    # >0: offsets clamped to +-dcn_shift_window cells; 0: the exact bilinear gather
    dcn_shift_window: int = 0


@dataclasses.dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5


@dataclasses.dataclass(frozen=True)
class MaskHeadConfig:
    num_convs: int = 4
    in_channels: int = 256
    conv_out_channels: int = 256
    num_classes: int = 1231
    mask_size: int = 28
    class_agnostic: bool = False


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade R-CNN staging: per-stage target stds tighten and assigner IoU
    thresholds rise; every stage's head regresses class-agnostically."""

    num_stages: int = 3
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)
    stage_pos_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_target_stds: Tuple[Tuple[float, ...], ...] = (
        (0.1, 0.1, 0.2, 0.2),
        (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067),
    )


@dataclasses.dataclass(frozen=True)
class HTCConfig:
    """Hybrid Task Cascade extras (htc.py:13-33)."""

    semantic_num_classes: int = 183
    semantic_loss_weight: float = 0.2
    semantic_ignore_label: int = 255
    fusion_level: int = 1  # stride-8 FPN level
    semantic_fusion: Tuple[str, ...] = ("bbox", "mask")
    interleaved: bool = True
    mask_info_flow: bool = True


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """A detector variant (mmdet detectors/{fast_rcnn,grid_rcnn,
    mask_scoring_rcnn,double_head_rcnn}.py), wired in `models/variants.py`."""

    kind: str  # "fast" | "grid" | "mask_scoring" | "double_head"
    # Double-Head: the regression branch pools rois inflated by this factor
    reg_roi_scale_factor: float = 1.3
    # Grid R-CNN: the point heatmaps' size, and the positives' jitter
    grid_heatmap_size: int = 56
    grid_jitter: float = 0.15


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = BackboneConfig()
    fpn: FPNConfig = FPNConfig()
    anchors: AnchorConfig = AnchorConfig()
    roi_extractor: RoIExtractorConfig = RoIExtractorConfig()
    bbox_head: BBoxHeadConfig = BBoxHeadConfig()
    mask_head: Optional[MaskHeadConfig] = None
    cascade: Optional[CascadeConfig] = None
    htc: Optional[HTCConfig] = None
    variant: Optional[VariantConfig] = None
    rpn_train: RPNTrainConfig = RPNTrainConfig()
    rpn_proposal_train: ProposalConfig = ProposalConfig(nms_pre=2000, nms_post=2000, max_num=2000)
    rpn_proposal_test: ProposalConfig = ProposalConfig(
        nms_pre=1000, nms_post=1000, max_num=1000
    )
    rcnn_train: RCNNTrainConfig = RCNNTrainConfig()
    rcnn_test: RCNNTestConfig = RCNNTestConfig()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization recipe (bg8.py:170-198)."""

    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_step_epochs: Tuple[int, ...] = (8, 11)
    total_epochs: int = 12
    # 0: everything but the frozen backbone stages; 1: only fc_cls (BAGS
    # phase 2); 2: the whole bbox head; 3: every cascade stage's fc_cls
    # (tools/train.py:143-158)
    selectp: int = 0
