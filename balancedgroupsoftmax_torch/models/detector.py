"""Faster R-CNN with the BAGS grouped-softmax head, inference and training
losses (JAX `models/detector.py`: `FasterRCNN` :45, `loss` :138, `_loss_core`
:169, `predict` :355, `propose` :415, `rescore` :432, `build_detector` :537,
`build_model` :543).

Inference: ResNet -> FPN -> RPN proposals (K1) -> multi-level RoIAlign (K2)
-> shared-FC head -> GS score merge -> per-class NMS (K3). Training: the RPN
loss over sampled anchors, detached proposals (K4 at the training RPN's
2000 boxes a level), sampled RoI targets, RoIAlign (K2, and K2b for its
gradient) and the GS (or softmax) and regression losses. Images enter and
results leave in the JAX layout; inside, feature maps are NCHW tensors in
channels-last memory, so the RoIAlign kernels read them as NHWC without a
copy.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import DetectorConfig
from ..core.anchors import multilevel_anchors
from ..core.targets import roi_targets
from ..gs.head import gs_loss, gs_merge_scores
from ..gs.partition import GSPartition
from ..kernels import batched_multiclass_nms, batched_multilevel_roi_align
from ..ops.boxes import delta2bbox
from ..ops.deform_conv import DeformConv
from .bbox_head import SharedFCBBoxHead, bbox_head_loss, bbox_reg_loss
from .fpn import FPN
from .layers import Conv2d, ConvTranspose2d, Linear
from .resnet import ResNet
from .rpn import RPNHead, rpn_loss, rpn_proposals_batched


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
        bb = cfg.backbone
        self.backbone = ResNet(
            bb.depth, bb.groups, bb.base_width, bb.dcn_stages, bb.dcn_modulated,
            bb.dcn_groups or 0, bb.dcn_shift_window,
        )
        self.neck = FPN(cfg.fpn.in_channels, cfg.fpn.out_channels, cfg.fpn.num_outs)
        self.rpn_head = RPNHead(cfg.fpn.out_channels, cfg.anchors.num_base_anchors)
        self._init_roi_heads()
        self._anchor_cache: dict = {}

    def _init_roi_heads(self) -> None:
        self.bbox_head = SharedFCBBoxHead(self.cfg.bbox_head)

    def _init_special(self) -> dict:
        """Layers whose JAX initialiser is not the default: layer -> ("normal",
        std), ("he", None) for he-normal (variance 2 / fan_in), or ("zeros",
        None)."""
        special = {m: ("normal", 0.01) for m in (self.rpn_head.rpn_conv, self.rpn_head.rpn_cls, self.rpn_head.rpn_reg)}
        for head in (m for m in self.modules() if isinstance(m, SharedFCBBoxHead)):
            special.update({head.fc_cls: ("normal", 0.01), head.fc_reg: ("normal", 0.001)})
        for dcn in (m for m in self.modules() if isinstance(m, DeformConv)):
            special.update({dcn: ("he", None), dcn.conv_offset: ("zeros", None)})
        return special

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "FasterRCNN":
        """Seeded random weights, drawn on the CPU so every device gets the
        same ones: the JAX initialisers' distributions (lecun-normal convs,
        normal(0.01) RPN and fc_cls, xavier-uniform shared FCs, normal(0.001)
        fc_reg, he-normal deformable convs, zero DCN offset convs, zero
        biases) and identity BatchNorm statistics."""
        gen = torch.Generator().manual_seed(seed)
        special = self._init_special()
        for m in self.modules():
            if not isinstance(m, (Conv2d, ConvTranspose2d, Linear, DeformConv)):
                continue
            w = torch.zeros(m.weight.shape)
            kind, std = special.get(m, ("xavier" if isinstance(m, Linear) else "lecun", None))
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel() if isinstance(m, ConvTranspose2d) else m.weight[0].numel()
            if kind == "normal":
                w.normal_(0.0, std, generator=gen)
            elif kind == "xavier":
                a = math.sqrt(6.0 / (m.in_features + m.out_features))
                w.uniform_(-a, a, generator=gen)
            elif kind in ("lecun", "he"):
                w.normal_(0.0, math.sqrt((1.0 if kind == "lecun" else 2.0) / fan_in), generator=gen)
            m.weight.copy_(w)
            if getattr(m, "bias", None) is not None:
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

    def _pool(self, feats, rois: torch.Tensor, out_size: Optional[int] = None) -> torch.Tensor:
        """RoIAlign (K2) of rois (B, R, 4) -> (B, R, S, S, C)."""
        c = self.cfg.roi_extractor
        return batched_multilevel_roi_align(
            [f.permute(0, 2, 3, 1) for f in feats[: len(c.featmap_strides)]],
            rois,
            c.featmap_strides,
            out_size or c.out_size,
            c.sample_num,
            c.finest_scale,
        )

    def _bbox_forward(self, feats, rois: torch.Tensor):
        return self.bbox_head(self._pool(feats, rois))

    def _rpn_train(self, images, gt_boxes, gt_mask, img_shapes, generator):
        """The RPN's losses and the detached training proposals:
        (feats, losses, proposals)."""
        c = self.cfg
        feats = self.extract_feats(images)
        rpn_outs = self.rpn_head(feats)
        anchors = self._anchors(images)
        anchors_flat = torch.cat(anchors)
        anchor_valid = torch.ones(anchors_flat.shape[0], dtype=torch.bool, device=images.device)
        losses: Dict[str, torch.Tensor] = {}
        losses["loss_rpn_cls"], losses["loss_rpn_bbox"] = rpn_loss(
            rpn_outs, anchors_flat, anchor_valid, gt_boxes, gt_mask,
            (images.shape[1], images.shape[2]), c.rpn_train, generator,
        )
        # proposals carry no gradient (two_stage.py treats them as detached)
        with torch.no_grad():
            proposals = rpn_proposals_batched(
                [(cls.detach(), reg.detach()) for cls, reg in rpn_outs],
                anchors, img_shapes.float(), c.rpn_proposal_train,
            )
        return feats, losses, proposals

    def loss(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalised, padded bucket
        gt_boxes: torch.Tensor,  # (B, G, 4)
        gt_labels: torch.Tensor,  # (B, G) int, 1-based
        gt_mask: torch.Tensor,  # (B, G) bool
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) before padding
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training losses (two_stage.py forward_train parity): the RPN's,
        then the GS head's per-bin losses (or softmax CE and accuracy) and the
        box regression. Sampling draws from `generator`."""
        c = self.cfg
        feats, losses, proposals = self._rpn_train(images, gt_boxes, gt_mask, img_shapes, generator)
        with torch.no_grad():
            t = roi_targets(
                proposals.boxes, proposals.valid, gt_boxes, gt_labels, gt_mask, c.rcnn_train,
                generator, c.bbox_head.target_means, c.bbox_head.target_stds,
            )
        cls_logits, bbox_deltas = self._bbox_forward(feats, t.rois)

        flat = lambda x: x.reshape(-1, *x.shape[2:])
        if c.bbox_head.use_gs:
            losses.update(
                gs_loss(
                    flat(cls_logits), flat(t.labels), flat(t.roi_valid), self.partition,
                    c.bbox_head.gs.others_sample_ratio, generator,
                )
            )
            losses["loss_bbox"] = bbox_reg_loss(
                flat(bbox_deltas), flat(t.labels), flat(t.bbox_targets), flat(t.bbox_weights)
            )
        else:
            losses["loss_cls"], losses["loss_bbox"], losses["acc"] = bbox_head_loss(
                flat(cls_logits), flat(bbox_deltas), flat(t.labels), flat(t.label_weights),
                flat(t.bbox_targets), flat(t.bbox_weights),
            )
        return losses

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
        img_shapes = img_shapes.float()
        proposals = self._proposals(feats, images, img_shapes)
        boxes, scores = self._score_rois(feats, proposals.boxes, img_shapes)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, None]
        return self._multiclass_nms(boxes, scores, proposals.valid)

    def _proposals(self, feats, images, img_shapes):
        """The test-time RPN's proposals (K1), in the input's frame."""
        return rpn_proposals_batched(
            self.rpn_head(feats), self._anchors(images), img_shapes, self.cfg.rpn_proposal_test
        )

    def _score_rois(self, feats, rois, img_shapes):
        """The bbox head on rois (B, P, 4) (K2): (boxes (B, P, C * 4) decoded
        and clipped to `img_shapes`, scores (B, P, C) from the GS merge or a
        softmax)."""
        c = self.cfg
        cls_logits, bbox_deltas = self._bbox_forward(feats, rois)
        b, r = rois.shape[:2]
        if c.bbox_head.use_gs:
            scores = gs_merge_scores(cls_logits.reshape(b * r, -1), self.partition).reshape(b, r, -1)
        else:
            scores = torch.softmax(cls_logits.float(), dim=-1)
        boxes = delta2bbox(
            rois,
            bbox_deltas.float(),
            c.bbox_head.target_means,
            c.bbox_head.target_stds,
            max_shape=(img_shapes[:, 0, None, None], img_shapes[:, 1, None, None]),
        )
        return boxes, scores

    @torch.inference_mode()
    def propose(self, images: torch.Tensor, img_shapes: torch.Tensor):
        """The RPN's proposals for one test view, in the view's frame (JAX
        `detector.py:415`): `Proposals` (boxes (B, P, 4), scores, valid)."""
        return self._proposals(self.extract_feats(images), images, img_shapes.float())

    @torch.inference_mode()
    def rescore(self, images: torch.Tensor, rois: torch.Tensor, img_shapes: torch.Tensor):
        """A fixed proposal set scored on this view's features (JAX
        `detector.py:432`): (boxes (B, P, C * 4) in the view's frame, not
        rescaled, scores (B, P, C))."""
        return self._score_rois(self.extract_feats(images), rois, img_shapes.float())

    def _multiclass_nms(self, boxes, scores, valid) -> Detections:
        t = self.cfg.rcnn_test
        return Detections(
            *batched_multiclass_nms(
                boxes, scores, valid, t.score_thr, t.nms_iou_thr, t.max_per_img,
                candidates_per_class=t.nms_candidates_per_class, nms_type=t.nms_type,
            )
        )


def build_detector(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> FasterRCNN:
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS head requires a GSPartition")
    return FasterRCNN(cfg, partition=partition, dtype=dtype)


def build_model(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> FasterRCNN:
    """The detector family `cfg` names (JAX `detector.py:543`): HTC when
    `cfg.htc` is set, else Cascade R-CNN when `cfg.cascade` is, else Faster
    R-CNN. All have `predict` alike, and Faster and Cascade R-CNN `loss`
    (HTC's is not ported yet). The detector variants are not ported."""
    if getattr(cfg, "variant", None) is not None:
        raise NotImplementedError("variant detectors are not ported yet")
    if cfg.htc is not None:
        from .htc import build_htc

        return build_htc(cfg, partition=partition, dtype=dtype)
    if cfg.cascade is not None:
        from .cascade import build_cascade

        return build_cascade(cfg, partition=partition, dtype=dtype)
    return build_detector(cfg, partition=partition, dtype=dtype)
