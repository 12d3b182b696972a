"""Faster R-CNN with the BAGS grouped-softmax head, inference
(JAX `models/detector.py`: `FasterRCNN` :45,
`predict` :355, `build_detector` :537).

ResNet -> FPN -> RPN proposals (K1) -> multi-level RoIAlign (K2) -> shared-FC
head -> GS score merge -> per-class NMS (K3). Images enter and detections
leave in the JAX layout; inside, feature maps are NCHW tensors in
channels-last memory, so the RoIAlign kernel reads them as NHWC without a
copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import DetectorConfig
from ..core.anchors import multilevel_anchors
from ..gs.head import gs_merge_scores
from ..gs.partition import GSPartition
from ..kernels import batched_multiclass_nms, batched_multilevel_roi_align
from ..ops.boxes import delta2bbox
from .bbox_head import SharedFCBBoxHead
from .fpn import FPN
from .layers import Conv2d, Linear
from .resnet import ResNet
from .rpn import RPNHead, rpn_proposals_batched


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, M, 4)
    scores: torch.Tensor  # (B, M)
    labels: torch.Tensor  # (B, M) int32, 0-based foreground class
    valid: torch.Tensor  # (B, M) bool


class FasterRCNN(nn.Module):
    def __init__(
        self,
        cfg: DetectorConfig,
        partition: Optional[GSPartition] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.cfg = cfg
        self.partition = partition
        self.dtype = dtype
        self.backbone = ResNet(cfg.backbone.depth)
        self.neck = FPN(cfg.fpn.in_channels, cfg.fpn.out_channels, cfg.fpn.num_outs)
        self.rpn_head = RPNHead(cfg.fpn.out_channels, cfg.anchors.num_base_anchors)
        self.bbox_head = SharedFCBBoxHead(cfg.bbox_head)
        self._anchor_cache: dict = {}

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "FasterRCNN":
        """Seeded random weights, drawn on the CPU so every device gets the
        same ones: the JAX initialisers' distributions (lecun-normal convs,
        normal(0.01) RPN and fc_cls, xavier-uniform shared FCs, normal(0.001)
        fc_reg, zero biases) and identity BatchNorm statistics."""
        gen = torch.Generator().manual_seed(seed)
        special = {
            self.rpn_head.rpn_conv: 0.01,
            self.rpn_head.rpn_cls: 0.01,
            self.rpn_head.rpn_reg: 0.01,
            self.bbox_head.fc_cls: 0.01,
            self.bbox_head.fc_reg: 0.001,
        }
        for m in self.modules():
            if not isinstance(m, (Conv2d, Linear)):
                continue
            w = torch.empty(m.weight.shape)
            if m in special:
                w.normal_(0.0, special[m], generator=gen)
            elif isinstance(m, Linear):
                a = math.sqrt(6.0 / (m.in_features + m.out_features))
                w.uniform_(-a, a, generator=gen)
            else:
                fan_in = m.weight[0].numel()
                w.normal_(0.0, math.sqrt(1.0 / fan_in), generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        return self

    def extract_feats(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) -> FPN levels (B, C, H / s, W / s), channels-last."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        feats = self.neck(self.backbone(x))
        # a no-op where the convolutions already returned channels-last
        return tuple(f.contiguous(memory_format=torch.channels_last) for f in feats)

    def _anchors(self, images: torch.Tensor) -> list[torch.Tensor]:
        # the grid follows the actual padded batch shape (landscape or portrait)
        h, w = images.shape[1], images.shape[2]
        key = (h, w, images.device)
        if key not in self._anchor_cache:
            c = self.cfg.anchors
            sizes = [(-(-h // s), -(-w // s)) for s in c.strides]
            per_level = multilevel_anchors(sizes, c.strides, c.scales, c.ratios)
            self._anchor_cache[key] = [torch.from_numpy(a).to(images.device) for a in per_level]
        return self._anchor_cache[key]

    def _bbox_forward(self, feats, rois: torch.Tensor):
        c = self.cfg.roi_extractor
        pooled = batched_multilevel_roi_align(
            [f.permute(0, 2, 3, 1) for f in feats[: len(c.featmap_strides)]],
            rois,
            c.featmap_strides,
            c.out_size,
            c.sample_num,
            c.finest_scale,
        )
        return self.bbox_head(pooled)

    @torch.inference_mode()
    def predict(
        self,
        images: torch.Tensor,  # (B, H, W, 3)
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) in network scale
        scale_factors: torch.Tensor,  # (B,) network / original scale
        rescale: bool = True,
    ) -> Detections:
        """simple_test parity (two_stage.py:267-290)."""
        return self._predict_feats(self.extract_feats(images), images, img_shapes, scale_factors, rescale)

    def _predict_feats(self, feats, images, img_shapes, scale_factors, rescale=True) -> Detections:
        c = self.cfg
        img_shapes = img_shapes.float()
        proposals = rpn_proposals_batched(
            self.rpn_head(feats), self._anchors(images), img_shapes, c.rpn_proposal_test
        )
        cls_logits, bbox_deltas = self._bbox_forward(feats, proposals.boxes)
        b, r = proposals.valid.shape
        if c.bbox_head.use_gs:
            scores = gs_merge_scores(cls_logits.reshape(b * r, -1), self.partition).reshape(b, r, -1)
        else:
            scores = torch.softmax(cls_logits.float(), dim=-1)
        boxes = delta2bbox(
            proposals.boxes,
            bbox_deltas.float(),
            c.bbox_head.target_means,
            c.bbox_head.target_stds,
            max_shape=(img_shapes[:, 0, None, None], img_shapes[:, 1, None, None]),
        )
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, None]
        det = batched_multiclass_nms(
            boxes,
            scores,
            proposals.valid,
            c.rcnn_test.score_thr,
            c.rcnn_test.nms_iou_thr,
            c.rcnn_test.max_per_img,
            candidates_per_class=c.rcnn_test.nms_candidates_per_class,
            nms_type=c.rcnn_test.nms_type,
        )
        return Detections(*det)


def build_detector(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> FasterRCNN:
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS head requires a GSPartition")
    return FasterRCNN(cfg, partition=partition, dtype=dtype)
