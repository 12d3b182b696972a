"""Faster R-CNN with the BAGS grouped-softmax head, and Mask R-CNN (the same
with an FCN mask head), inference and training losses (JAX
`models/detector.py`: `FasterRCNN` :45 (its `class_weights` :49), `loss`
:138, `_loss_core` :169 (the loss types :250-287),
`_mask_branch` :291, `predict` :355, `propose` :415, `rescore` :432,
`predict_masks` :468, `predict_with_masks` :483, `_masks_feats` :513,
`build_detector` :537, `build_model` :543).

Inference: ResNet -> FPN -> RPN proposals (K1) -> multi-level RoIAlign (K2)
-> shared-FC head -> GS score merge -> per-class NMS (K3); with a mask head,
the detections pooled again at 14 x 14 (K2) -> the class-selected mask
logits -> sigmoid. Training: the RPN loss over sampled anchors, detached
proposals (K4 at the training RPN's 2000 boxes a level), sampled RoI
targets, RoIAlign (K2, and K2b for its gradient) and the GS (or softmax)
and regression losses; with a mask head, the positive slots pooled at
14 x 14 (K2 and K2b) against targets resampled from the gt crops. Images
enter and results leave in the JAX layout; inside, feature maps are NCHW
tensors in channels-last memory, so the RoIAlign kernels read them as NHWC
without a copy.
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
from ..ops.mask import mask_targets
from .bbox_head import SharedFCBBoxHead, bbox_head_loss, bbox_reg_loss
from .fpn import FPN
from .layers import Conv2d, ConvTranspose2d, Linear
from .mask_head import FCNMaskHead, mask_head_loss
from .resnet import ResNet
from .rpn import RPNHead, rpn_loss, rpn_proposals_batched


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, M, 4)
    scores: torch.Tensor  # (B, M)
    labels: torch.Tensor  # (B, M) int32, 0-based foreground class
    valid: torch.Tensor  # (B, M) bool


class FasterRCNN(nn.Module):
    # Fast R-CNN (`models/variants.py`) has no RPN: its proposals are an input
    HAS_RPN = True

    def __init__(
        self,
        cfg: DetectorConfig,
        partition: Optional[GSPartition] = None,
        dtype: torch.dtype = torch.float32,
        class_weights=None,  # (C,) per-class CE weights for loss_cls_type "reweight"
    ):
        super().__init__()
        self.cfg = cfg
        self.partition = partition
        self.dtype = dtype
        # not a parameter and not saved: the weights enter the model, as in JAX
        cw = None if class_weights is None else torch.as_tensor(class_weights, dtype=torch.float32)
        self.register_buffer("class_weights", cw, persistent=False)
        bb = cfg.backbone
        self.backbone = ResNet(
            bb.depth, bb.groups, bb.base_width, bb.dcn_stages, bb.dcn_modulated,
            bb.dcn_groups or 0, bb.dcn_shift_window,
        )
        self.neck = FPN(cfg.fpn.in_channels, cfg.fpn.out_channels, cfg.fpn.num_outs)
        self.rpn_head = RPNHead(cfg.fpn.out_channels, cfg.anchors.num_base_anchors) if self.HAS_RPN else None
        self.mask_head: Optional[FCNMaskHead] = None
        self._init_roi_heads()
        self._anchor_cache: dict = {}

    def _init_roi_heads(self) -> None:
        """The RoI heads; the families and the variants build theirs here
        (JAX's `_make_bbox_head` and `_setup_extra`)."""
        self.bbox_head = SharedFCBBoxHead(self.cfg.bbox_head)
        if self.cfg.mask_head is not None:
            self.mask_head = FCNMaskHead(self.cfg.mask_head)

    def _init_special(self) -> dict:
        """Layers whose JAX initialiser is not the default, as each module
        with an `init_special()` names its own: layer -> ("normal", std),
        ("he", None) for he-normal (variance 2 / fan_in), ("lecun", None) for
        a Linear (flax's default Dense), or ("zeros", None)."""
        special = {}
        for m in self.modules():
            if hasattr(m, "init_special"):
                special.update(m.init_special())
        return special

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "FasterRCNN":
        """Seeded random weights, drawn on the CPU so every device gets the
        same ones: the JAX initialisers' distributions (lecun-normal convs,
        normal(0.01) RPN and fc_cls, xavier-uniform shared FCs, normal(0.001)
        fc_reg, he-normal deformable convs and mask-head convs, normal(0.001)
        mask logits, zero DCN offset convs, zero biases) and identity
        BatchNorm statistics."""
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
        gt_mask_crops: Optional[torch.Tensor] = None,  # (B, G, CROP, CROP) box-normalised gt masks
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training losses (two_stage.py forward_train parity): the RPN's,
        then the GS head's per-bin losses (or the `loss_cls_type` loss and
        accuracy) and the box regression, and "loss_mask" where the model has a mask head and
        `gt_mask_crops` are given. Sampling draws from `generator`."""
        losses, feats, t = self._loss_core(images, gt_boxes, gt_labels, gt_mask, img_shapes, generator=generator)
        if self.mask_head is not None and gt_mask_crops is not None:
            losses["loss_mask"] = self._mask_loss(feats, t, gt_boxes, gt_mask_crops)
        return losses

    def _loss_core(self, images, gt_boxes, gt_labels, gt_mask, img_shapes, proposals=None, generator=None):
        """The RPN's and the bbox head's losses: (losses, FPN levels, RoI
        targets), which the variants' branches go on from (JAX
        `detector.py:169`). Given `proposals` (boxes (B, P, 4), valid (B,
        P)), no RPN runs (Fast R-CNN)."""
        c = self.cfg
        if proposals is None:
            feats, losses, proposals = self._rpn_train(images, gt_boxes, gt_mask, img_shapes, generator)
        else:
            feats, losses = self.extract_feats(images), {}
        with torch.no_grad():
            t = roi_targets(
                proposals.boxes, proposals.valid, gt_boxes, gt_labels, gt_mask, c.rcnn_train,
                generator, c.bbox_head.target_means, c.bbox_head.target_stds,
            )
        cls_logits, bbox_deltas = self._bbox_forward(feats, t.rois)

        flat = lambda x: x.reshape(-1, *x.shape[2:])
        h = c.bbox_head
        if h.use_gs:
            # GS-reweight takes the class weights only under "reweight" (detector.py:250-262)
            losses.update(
                gs_loss(
                    flat(cls_logits), flat(t.labels), flat(t.roi_valid), self.partition,
                    h.gs.others_sample_ratio, generator,
                    class_weights=self.class_weights if h.loss_cls_type == "reweight" else None,
                )
            )
            losses["loss_bbox"] = bbox_reg_loss(
                flat(bbox_deltas), flat(t.labels), flat(t.bbox_targets), flat(t.bbox_weights)
            )
        else:
            losses["loss_cls"], losses["loss_bbox"], losses["acc"] = bbox_head_loss(
                flat(cls_logits), flat(bbox_deltas), flat(t.labels), flat(t.label_weights),
                flat(t.bbox_targets), flat(t.bbox_weights), loss_cls_type=h.loss_cls_type,
                class_weights=self.class_weights, focal_gamma=h.focal_gamma, focal_alpha=h.focal_alpha,
            )
        return losses, feats, t

    def _mask_loss(self, feats, t, gt_boxes, gt_mask_crops, pool=None, head=None) -> torch.Tensor:
        """"loss_mask" of `_mask_branch`."""
        return self._mask_branch(feats, t, gt_boxes, gt_mask_crops, pool, head)["loss_mask"]

    def _mask_branch(self, feats, t, gt_boxes, gt_mask_crops, pool=None, head=None) -> dict:
        """The mask branch (two_stage.py:238-262) on the RoI targets `t`: the
        sampler puts the positives first, so only the first `mask_cap` =
        sampler.num x pos_fraction slots are pooled, at mask_size / 2 (K2,
        and K2b for its gradient), through the class-selected head, against
        the gt crops resampled into each positive's box. HTC passes its
        stage's `pool(feats, rois)` and `head(x, labels) -> logits`. Returns
        "loss_mask" and what JAX's `_mask_branch` returns for the variants
        (Mask-Scoring R-CNN): `m_rois` (B, cap, 4), `m_pooled` (B * cap, C,
        S, S), `mask_logits` (B * cap, 2S, 2S), `m_targets` (B, cap, 2S, 2S),
        `m_labels` and `m_pos` (B, cap), `mask_cap`."""
        c = self.cfg
        pool = pool or (lambda f, r: self._pool(f, r, c.mask_head.mask_size // 2))
        head = head or (lambda x, labels: self.mask_head(x, labels=labels)[0])
        mask_cap = max(int(c.rcnn_train.sampler.num * c.rcnn_train.sampler.pos_fraction), 1)
        m_rois, m_labels = t.rois[:, :mask_cap].contiguous(), t.labels[:, :mask_cap]
        m_pos = (m_labels > 0) & t.roi_valid[:, :mask_cap]
        x = pool(feats, m_rois).flatten(0, 1).permute(0, 3, 1, 2)
        num_fg = c.mask_head.num_classes - 1
        logits = head(x, None if c.mask_head.class_agnostic else (m_labels.flatten() - 1).clamp(0, num_fg - 1))
        with torch.no_grad():
            m_targets = mask_targets(
                m_rois, gt_boxes, t.pos_gt_inds[:, :mask_cap], gt_mask_crops, m_pos, c.mask_head.mask_size
            )
        loss = mask_head_loss(
            logits, m_targets.flatten(0, 1), m_labels.flatten(), m_pos.flatten(),
            class_agnostic=c.mask_head.class_agnostic, preselected=not c.mask_head.class_agnostic,
        )
        return dict(loss_mask=loss, m_rois=m_rois, m_pooled=x, mask_logits=logits, m_targets=m_targets,
                    m_labels=m_labels, m_pos=m_pos, mask_cap=mask_cap)

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

    def _predict_feats(self, feats, images, img_shapes, scale_factors, rescale=True, proposals=None) -> Detections:
        """The detections from the FPN levels: the test RPN's proposals (K1),
        or the given `proposals` (boxes, valid) of Fast R-CNN."""
        img_shapes = img_shapes.float()
        if proposals is None:
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

    @torch.inference_mode()
    def predict_masks(
        self,
        images: torch.Tensor,  # (B, H, W, 3)
        det_boxes: torch.Tensor,  # (B, M, 4) at the original image scale
        det_labels: torch.Tensor,  # (B, M) int, 0-based foreground class
        scale_factors: torch.Tensor,  # (B,) network / original scale
    ) -> torch.Tensor:
        """(B, M, 28, 28) mask probabilities of each detection's class, in the
        model dtype (simple_test_mask, test_mixins.py:178): the boxes scaled
        back to the network's scale and pooled (K2)."""
        return self._masks_feats(self.extract_feats(images), det_boxes, det_labels, scale_factors)

    @torch.inference_mode()
    def predict_with_masks(
        self,
        images: torch.Tensor,  # (B, H, W, 3)
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) in network scale
        scale_factors: torch.Tensor,  # (B,) network / original scale
        rescale: bool = True,
    ) -> tuple[Detections, torch.Tensor]:
        """The detections and their masks (B, M, 28, 28) from one backbone
        pass (two_stage.py simple_test :267-290)."""
        feats = self.extract_feats(images)
        dets = self._predict_feats(feats, images, img_shapes, scale_factors, rescale)
        # the rois pool at network scale: with rescale=False the boxes are there already
        sf = scale_factors if rescale else torch.ones_like(scale_factors)
        return dets, self._masks_feats(feats, dets.boxes, dets.labels, sf)

    def _masks_feats(self, feats, det_boxes, det_labels, scale_factors, pool=None, logits=None) -> torch.Tensor:
        """The detections' boxes scaled back to the network's scale (times
        the scale factors), pooled at mask_size / 2 (K2) and through the
        class-selected head: (B, M, 28, 28) probabilities, the sigmoid in
        f32, the result in the model dtype. HTC passes its fused
        `pool(feats, rois)` and `logits(x, labels)`, its stages' mean."""
        c = self.cfg
        if self.mask_head is None and logits is None:
            raise ValueError("this model has no mask head")
        pool = pool or (lambda f, r: self._pool(f, r, c.mask_head.mask_size // 2))
        logits = logits or (lambda x, labels: self.mask_head(x, labels=labels)[0].float())
        pooled = pool(feats, det_boxes * scale_factors.float()[:, None, None])  # (B, M, S, S, C)
        b, m = pooled.shape[:2]
        # class-selected logits: no (B * M, 1230, 28, 28) tensor; the head
        # clamps the labels of invalid slots into range
        labels = None if c.mask_head.class_agnostic else det_labels.flatten()
        out = logits(pooled.flatten(0, 1).permute(0, 3, 1, 2), labels)
        if c.mask_head.class_agnostic:
            out = out[:, 0]
        return torch.sigmoid(out).to(self.dtype).reshape(b, m, *out.shape[-2:])

    def _multiclass_nms(self, boxes, scores, valid) -> Detections:
        t = self.cfg.rcnn_test
        return Detections(
            *batched_multiclass_nms(
                boxes, scores, valid, t.score_thr, t.nms_iou_thr, t.max_per_img,
                candidates_per_class=t.nms_candidates_per_class, nms_type=t.nms_type,
            )
        )


def build_detector(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32,
    class_weights=None,
) -> FasterRCNN:
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS head requires a GSPartition")
    return FasterRCNN(cfg, partition=partition, dtype=dtype, class_weights=class_weights)


def build_model(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32,
    class_weights=None,
) -> FasterRCNN:
    """The detector family `cfg` names (JAX `detector.py:543`): HTC when
    `cfg.htc` is set, else Cascade R-CNN when `cfg.cascade` is, else Faster
    R-CNN, which is Mask R-CNN when `cfg.mask_head` is set. All have
    `predict` and `loss` (HTC's and Mask R-CNN's also take the gt mask
    crops, and have `predict_with_masks`). With `cfg.variant`, the variant
    of `models/variants.py` (Fast, Grid, Mask-Scoring or Double-Head R-CNN).
    `class_weights` feed the "reweight" loss of Faster and Mask R-CNN; the
    cascade and HTC, as in JAX, ignore `loss_cls_type`."""
    if cfg.htc is not None:
        from .htc import build_htc

        return build_htc(cfg, partition=partition, dtype=dtype, class_weights=class_weights)
    if cfg.cascade is not None:
        from .cascade import build_cascade

        return build_cascade(cfg, partition=partition, dtype=dtype, class_weights=class_weights)
    if cfg.variant is not None:
        from .variants import build_variant

        return build_variant(cfg, partition=partition, dtype=dtype, class_weights=class_weights)
    return build_detector(cfg, partition=partition, dtype=dtype, class_weights=class_weights)
