"""Hybrid Task Cascade, inference and training: the cascade with a semantic branch and
mask heads with information flow (JAX `models/htc.py`: `HTC` :43, `setup`
:48, `_pool_semantic` :136, `_run_stages` :169, `predict` :405,
`_predict_feats` :417, `predict_with_masks` :461, `_masks_feats` :488,
`build_htc` :522, `loss` :240).

It is the port's `CascadeRCNN` (backbone, FPN, RPN with K1, three
class-agnostic stages over K2, the multiclass NMS with K6 then K5) plus:
- a `FusedSemanticHead` over the FPN levels, whose stride-8 feature is
  pooled (K2 over a one-level pyramid) for every RoI and added to its FPN
  RoI feature, for the bbox stages and for the masks (`semantic_fusion`);
- one `FCNMaskHead` a stage. At test time all three run on the detections'
  boxes (14 x 14 RoIs), each stage's head taking the previous one's conv
  feature through its `conv_res` (`mask_info_flow`); the class-selected
  logits of the three are averaged and passed through a sigmoid.
With the HTC-DCN backbone (X101-64x4d, deformable c3-c5) the backbone runs
K7 in 30 of its blocks, and in training K7b for their gradient.

Training (`HTC.loss`, JAX :240-403) is the cascade's loss with the semantic
branch's loss, the semantic RoI features and a mask branch a stage
(interleaved targets, information flow, class-selected logits, targets
resampled from the gt crops of `ops/mask.py`).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from ..config import DetectorConfig
from ..gs.partition import GSPartition
from ..kernels import batched_multilevel_roi_align
from .cascade import CascadeRCNN
from .detector import Detections
from .mask_head import FCNMaskHead
from .semantic_head import FusedSemanticHead, semantic_seg_loss


class HTC(CascadeRCNN):
    def _init_roi_heads(self) -> None:
        super()._init_roi_heads()
        c = self.cfg
        self.semantic_head = FusedSemanticHead(
            num_ins=c.fpn.num_outs,
            fusion_level=c.htc.fusion_level,
            in_channels=c.fpn.out_channels,
            conv_out_channels=c.fpn.out_channels,
            num_classes=c.htc.semantic_num_classes,
        )
        self.mask_heads = nn.ModuleList(
            FCNMaskHead(c.mask_head, with_conv_res=c.htc.mask_info_flow and i > 0)
            for i in range(c.cascade.num_stages)
        )

    def loss(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalised, padded bucket
        gt_boxes: torch.Tensor,  # (B, G, 4)
        gt_labels: torch.Tensor,  # (B, G) int, 1-based
        gt_mask: torch.Tensor,  # (B, G) bool
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) before padding
        gt_mask_crops: torch.Tensor,  # (B, G, CROP, CROP) box-normalised gt masks
        gt_semantic_seg: Optional[torch.Tensor] = None,  # (B, H / 8, W / 8) int stuff map
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The RPN's losses, "loss_semantic_seg" when a stuff map is given,
        then per stage i the cascade's "s{i}.loss_cls*" and "s{i}.loss_bbox"
        on the FPN and semantic RoI features, and "s{i}.loss_mask": the
        stage's rois refined by its own deltas (no gradient) are assigned and
        sampled again (interleaved), the first `mask_cap` = sampler.num x
        pos_fraction rows of them are pooled at mask_size / 2, run through
        the heads of stages 0..i-1 for the information flow and then stage
        i's head, class-selected, against the resampled gt crops
        (htc.py forward_train; `FasterRCNN._mask_loss`). Each stage's losses
        are times its weight. Sampling draws from `generator`."""
        c = self.cfg
        feats, losses, proposals = self._rpn_train(images, gt_boxes, gt_mask, img_shapes, generator)
        trunk = self.semantic_head(feats)
        sem_feat = self._semantic(feats, trunk)
        if gt_semantic_seg is not None:
            losses["loss_semantic_seg"] = semantic_seg_loss(
                self.semantic_head.conv_logits(trunk), gt_semantic_seg,
                c.htc.semantic_ignore_label, c.htc.semantic_loss_weight,
            )
        bbox_pool = self._fused_pool(sem_feat, "bbox")
        mask_pool = self._fused_pool(sem_feat, "mask", c.mask_head.mask_size // 2)
        rois, roi_valid = proposals.boxes, proposals.valid
        targets = lambda i, r, v: self._stage_targets(i, r, v, gt_boxes, gt_labels, gt_mask, generator)
        for i, head in enumerate(self.bbox_heads):
            t = targets(i, rois, roi_valid)
            cls_logits, deltas = head(bbox_pool(feats, t.rois))
            losses.update(self._stage_losses(i, cls_logits, deltas, t, generator))
            refined = self._refine(i, t, deltas, img_shapes)
            mt = targets(i, refined, t.roi_valid) if c.htc.interleaved else t
            losses[f"s{i}.loss_mask"] = c.cascade.stage_loss_weights[i] * self._mask_loss(
                feats, mt, gt_boxes, gt_mask_crops, mask_pool, functools.partial(self._stage_mask_logits, i)
            )
            if i < len(self.bbox_heads) - 1:
                rois, roi_valid = refined, t.roi_valid
        return losses

    def _stage_mask_logits(self, i: int, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """Stage i's mask logits in training, the heads of stages 0..i-1
        feeding it their features (the mask information flow)."""
        last = None
        if self.cfg.htc.mask_info_flow:
            for j in range(i):
                _, last = self.mask_heads[j](x, res_feat=last)
        return self.mask_heads[i](x, res_feat=last, labels=labels)[0]

    def _semantic(self, feats, trunk: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The semantic feature (B, C, H / 8, W / 8), channels-last, so that K2
        reads it as NHWC in every pooling without a copy; from the head's
        `trunk` when the caller has it."""
        if trunk is None:
            trunk = self.semantic_head(feats)
        return self.semantic_head.feature(trunk).contiguous(memory_format=torch.channels_last)

    def _pool_semantic(self, sem_feat: torch.Tensor, rois: torch.Tensor, out_size: int) -> torch.Tensor:
        """RoIAlign (K2) of the stride-8 semantic feature: a one-level
        pyramid, to which every roi is routed."""
        c = self.cfg
        return batched_multilevel_roi_align(
            [sem_feat.permute(0, 2, 3, 1)],
            rois,
            (c.anchors.strides[c.htc.fusion_level],),
            out_size,
            c.roi_extractor.sample_num,
            c.roi_extractor.finest_scale,
        )

    def _fused_pool(self, sem_feat: torch.Tensor, branch: str, out_size: Optional[int] = None):
        """pool(feats, rois): the FPN RoI features, plus the semantic ones
        when `cfg.htc.semantic_fusion` names `branch` ("bbox" or "mask")."""
        size = out_size or self.cfg.roi_extractor.out_size

        def pool(feats, rois):
            pooled = self._pool(feats, rois, size)
            if branch in self.cfg.htc.semantic_fusion:
                pooled = pooled + self._pool_semantic(sem_feat, rois, size).to(pooled.dtype)
            return pooled

        return pool

    def _predict_feats(self, feats, images, img_shapes, scale_factors, rescale=True, sem_feat=None) -> Detections:
        if sem_feat is None:
            sem_feat = self._semantic(feats)
        return super()._predict_feats(
            feats, images, img_shapes, scale_factors, rescale, self._fused_pool(sem_feat, "bbox")
        )

    @torch.inference_mode()
    def predict_with_masks(
        self,
        images: torch.Tensor,  # (B, H, W, 3)
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) in network scale
        scale_factors: torch.Tensor,  # (B,) network / original scale
        rescale: bool = True,
    ) -> tuple[Detections, torch.Tensor]:
        """Detections and their masks (B, M, 28, 28) in the model dtype from
        one backbone and semantic pass (htc.py simple_test :157-199)."""
        feats = self.extract_feats(images)
        sem_feat = self._semantic(feats)
        dets = self._predict_feats(feats, images, img_shapes, scale_factors, rescale, sem_feat)
        # the rois pool at network scale: with rescale=False the boxes are there already
        sf = scale_factors if rescale else torch.ones_like(scale_factors)
        return dets, self._masks_feats(feats, dets.boxes, dets.labels, sf, sem_feat)

    def _masks_feats(self, feats, det_boxes, det_labels, scale_factors, sem_feat=None) -> torch.Tensor:
        if sem_feat is None:
            sem_feat = self._semantic(feats)
        pool = self._fused_pool(sem_feat, "mask", self.cfg.mask_head.mask_size // 2)
        return super()._masks_feats(feats, det_boxes, det_labels, scale_factors, pool, self._mean_mask_logits)

    def _mean_mask_logits(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """The mean of every stage's mask logits in f32, each stage fed the
        previous one's feature when the information flow is on."""
        last = agg = None
        for i, head in enumerate(self.mask_heads):
            logits, feat = head(x, res_feat=last if i > 0 else None, labels=labels)
            if self.cfg.htc.mask_info_flow:
                last = feat
            agg = logits if agg is None else agg + logits
        # divided by a tensor, so the card rounds as the CPU does
        return agg.float() / torch.tensor(float(len(self.mask_heads)), device=agg.device)


def build_htc(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> HTC:
    if cfg.htc is None or cfg.cascade is None or cfg.mask_head is None:
        raise ValueError("HTC needs cfg.htc, cfg.cascade and cfg.mask_head")
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS heads require a GSPartition")
    return HTC(cfg, partition=partition, dtype=dtype)
