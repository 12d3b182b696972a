"""Cascade R-CNN with class-agnostic stage heads, GS or softmax, inference
and training losses (JAX `models/cascade.py`: `CascadeRCNN` :35, `loss`
:121, `_run_stages` :237, `predict` :270, `build_cascade` :352).

It is Faster R-CNN's backbone, neck, RPN and RoIAlign with `num_stages`
heads in place of the one. Each stage pools the current rois (K2), scores
them and regresses one class-agnostic set of deltas, which refines the rois
for the next stage with that stage's target stds. At test time the stages'
class logits are averaged before the GS merge (or softmax), the boxes are
decoded from the last stage's deltas, and the multiclass NMS takes its
class-agnostic branch (K6, then K5). In training every stage assigns its
rois at its own IoU threshold and encodes with its own stds, and its losses
are weighted by `stage_loss_weights`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..config import DetectorConfig
from ..core.targets import roi_targets
from ..gs.head import gs_loss, gs_merge_scores
from ..gs.partition import GSPartition
from ..ops.boxes import delta2bbox
from ..ops.losses import softmax_cross_entropy
from .bbox_head import SharedFCBBoxHead, bbox_reg_loss
from .detector import Detections, FasterRCNN


class CascadeRCNN(FasterRCNN):
    def _init_roi_heads(self) -> None:
        head_cfg = dataclasses.replace(self.cfg.bbox_head, reg_class_agnostic=True)
        self.bbox_heads = nn.ModuleList(SharedFCBBoxHead(head_cfg) for _ in range(self.cfg.cascade.num_stages))

    def _decode(self, rois, deltas, stds, img_shapes) -> torch.Tensor:
        """Class-agnostic deltas (B, R, 4) applied to rois (B, R, 4), clipped
        to each image's (h, w)."""
        return delta2bbox(
            rois, deltas.float(), self.cfg.bbox_head.target_means, stds,
            max_shape=(img_shapes[:, 0, None, None], img_shapes[:, 1, None, None]),
        )

    def _run_stages(self, feats, rois, img_shapes, pool=None):
        """Pool (with `pool(feats, rois)`, RoIAlign by default) and score with
        each stage, refining the rois between stages. Returns the last
        stage's rois, the class scores of the stage-averaged logits (B, R, C)
        and the last stage's deltas."""
        c = self.cfg
        pool = pool or self._pool
        logits = []
        for i, head in enumerate(self.bbox_heads):
            cls_logits, deltas = head(pool(feats, rois))
            logits.append(cls_logits.float())
            if i < len(self.bbox_heads) - 1:
                rois = self._decode(rois, deltas, c.cascade.stage_target_stds[i], img_shapes)
        # divided by a tensor, so the card rounds as the CPU does
        avg = sum(logits) / torch.tensor(float(len(logits)), device=rois.device)
        b, r = rois.shape[:2]
        if c.bbox_head.use_gs:
            scores = gs_merge_scores(avg.reshape(b * r, -1), self.partition).reshape(b, r, -1)
        else:
            scores = torch.softmax(avg, dim=-1)
        return rois, scores, deltas

    def _predict_feats(self, feats, images, img_shapes, scale_factors, rescale=True, pool=None) -> Detections:
        c = self.cfg
        img_shapes = img_shapes.float()
        proposals = self._proposals(feats, images, img_shapes)
        rois, scores, deltas = self._run_stages(feats, proposals.boxes, img_shapes, pool)
        boxes = self._decode(rois, deltas, c.cascade.stage_target_stds[-1], img_shapes)
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, None]
        return self._multiclass_nms(boxes, scores, proposals.valid)

    def rescore(self, images, rois, img_shapes):
        raise NotImplementedError("the cascade's rescore (JAX cascade.py:323) is not ported yet (ROADMAP A5)")

    def _stage_targets(self, i, rois, roi_valid, gt_boxes, gt_labels, gt_mask, generator):
        """Stage i's sampled RoI targets: assigned at its IoU threshold,
        encoded with its stds; no gradient."""
        c = self.cfg
        iou = c.cascade.stage_pos_ious[i]
        stage_cfg = dataclasses.replace(
            c.rcnn_train,
            assigner=dataclasses.replace(c.rcnn_train.assigner, pos_iou_thr=iou, neg_iou_thr=iou, min_pos_iou=iou),
        )
        with torch.no_grad():
            return roi_targets(
                rois, roi_valid, gt_boxes, gt_labels, gt_mask, stage_cfg, generator,
                c.bbox_head.target_means, c.cascade.stage_target_stds[i],
            )

    def _stage_losses(self, i, cls_logits, deltas, t, generator) -> Dict[str, torch.Tensor]:
        """Stage i's GS per-bin losses "s{i}.loss_cls_bin*" (or softmax CE
        "s{i}.loss_cls") and class-agnostic "s{i}.loss_bbox", each times the
        stage's weight."""
        c = self.cfg
        w = c.cascade.stage_loss_weights[i]
        flat = lambda x: x.reshape(-1, *x.shape[2:])
        losses = {}
        if c.bbox_head.use_gs:
            stage = gs_loss(
                flat(cls_logits), flat(t.labels), flat(t.roi_valid), self.partition,
                c.bbox_head.gs.others_sample_ratio, generator,
            )
            losses.update({f"s{i}.{name}": v * w for name, v in stage.items()})
        else:
            label_weights = flat(t.label_weights)
            avg = (label_weights > 0).sum().clamp(min=1).float()
            losses[f"s{i}.loss_cls"] = w * softmax_cross_entropy(
                flat(cls_logits).float(), flat(t.labels), weight=label_weights, avg_factor=avg
            )
        losses[f"s{i}.loss_bbox"] = w * bbox_reg_loss(
            flat(deltas), flat(t.labels), flat(t.bbox_targets), flat(t.bbox_weights), reg_class_agnostic=True
        )
        return losses

    def _refine(self, i, t, deltas, img_shapes) -> torch.Tensor:
        """Stage i's sampled rois moved by its deltas: the next stage's
        proposals, which carry no gradient."""
        with torch.no_grad():
            return self._decode(t.rois, deltas.detach(), self.cfg.cascade.stage_target_stds[i], img_shapes.float())

    def loss(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalised, padded bucket
        gt_boxes: torch.Tensor,  # (B, G, 4)
        gt_labels: torch.Tensor,  # (B, G) int, 1-based
        gt_mask: torch.Tensor,  # (B, G) bool
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) before padding
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The RPN's losses, then each stage's (`_stage_losses`)
        (cascade_rcnn.py:207-298). Sampling draws from `generator`."""
        feats, losses, proposals = self._rpn_train(images, gt_boxes, gt_mask, img_shapes, generator)
        rois, roi_valid = proposals.boxes, proposals.valid
        for i, head in enumerate(self.bbox_heads):
            t = self._stage_targets(i, rois, roi_valid, gt_boxes, gt_labels, gt_mask, generator)
            cls_logits, deltas = head(self._pool(feats, t.rois))
            losses.update(self._stage_losses(i, cls_logits, deltas, t, generator))
            if i < len(self.bbox_heads) - 1:
                rois, roi_valid = self._refine(i, t, deltas, img_shapes), t.roi_valid
        return losses

def build_cascade(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> CascadeRCNN:
    if cfg.cascade is None:
        raise ValueError("a cascade needs cfg.cascade")
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS heads require a GSPartition")
    return CascadeRCNN(cfg, partition=partition, dtype=dtype)
