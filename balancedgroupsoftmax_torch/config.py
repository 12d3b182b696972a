"""Configuration dataclasses of the ported slices.

Copies of the fields that Faster R-CNN and Cascade R-CNN R50-FPN inference
and training read from JAX `config.py`, with the same names and defaults
(the canonical BAGS config `configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py`).
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
    nms_type: str = "nms"  # "soft_nms" is not ported yet
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


@dataclasses.dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5


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
class DetectorConfig:
    backbone: BackboneConfig = BackboneConfig()
    fpn: FPNConfig = FPNConfig()
    anchors: AnchorConfig = AnchorConfig()
    roi_extractor: RoIExtractorConfig = RoIExtractorConfig()
    bbox_head: BBoxHeadConfig = BBoxHeadConfig()
    cascade: Optional[CascadeConfig] = None
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
    # 0: everything but the frozen backbone stages; 1: only fc_cls (BAGS
    # phase 2); 2: the whole bbox head; 3: every cascade stage's fc_cls
    # (tools/train.py:143-158)
    selectp: int = 0
