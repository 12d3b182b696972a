"""Configuration dataclasses of the inference slice.

Copies of the fields that Faster R-CNN R50-FPN inference reads from JAX
`config.py`, with the same names and defaults (the canonical BAGS config
`configs/bags/gs_faster_rcnn_r50_fpn_1x_lvis_with0_bg8.py`). Training fields,
class-agnostic regression and the input-size field (the port's anchors follow
each batch's shape) come with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    scales: Tuple[float, ...] = (8.0,)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)

    @property
    def num_base_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """RPN proposal generation (bg8.py:101-107 at test time)."""

    nms_pre: int = 2000
    nms_post: int = 2000
    max_num: int = 2000
    nms_thr: float = 0.7


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


@dataclasses.dataclass(frozen=True)
class BBoxHeadConfig:
    num_shared_fcs: int = 2
    in_channels: int = 256
    roi_feat_size: int = 7
    fc_out_channels: int = 1024
    num_classes: int = 1231  # 1230 fg + 1 bg
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
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


@dataclasses.dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = BackboneConfig()
    fpn: FPNConfig = FPNConfig()
    anchors: AnchorConfig = AnchorConfig()
    roi_extractor: RoIExtractorConfig = RoIExtractorConfig()
    bbox_head: BBoxHeadConfig = BBoxHeadConfig()
    rpn_proposal_test: ProposalConfig = ProposalConfig(
        nms_pre=1000, nms_post=1000, max_num=1000
    )
    rcnn_test: RCNNTestConfig = RCNNTestConfig()
