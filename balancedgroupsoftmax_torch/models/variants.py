"""The detector variants on the shared two-stage machinery (JAX
`models/variants.py`: `_scale_rois` :43, `FastRCNN` :52, `GridRCNN` :125,
`MaskScoringRCNN` :245, `DoubleHeadRCNN` :358, `build_variant` :398).

- Fast R-CNN (fast_rcnn.py): no RPN; `loss` and `predict` take proposals
  (B, P, 4) in the network frame and their validity (B, P).
- Grid R-CNN (grid_rcnn.py): the bbox head classifies, the grid head
  (`models/grid_head.py`) locates. Training jitters the positives (uniform
  draws from the step's generator) and pools them at heatmap / 4 (K2, K2b);
  serving pools the detections, padded slots included, and replaces their
  boxes by the decoded grid points.
- Mask-Scoring R-CNN (mask_scoring_rcnn.py): Mask R-CNN with a MaskIoU head
  on the mask branch's pooled features (S = 14) and predicted masks;
  `predict_with_masks` returns the mask scores, detection score x predicted
  mask IoU, beside the detections and masks.
- Double-Head R-CNN (double_head_rcnn.py): its bbox head's conv branch reads
  rois inflated by `reg_roi_scale_factor`, its fc branch the plain rois: two
  K2 launches at S = 7.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .detector import Detections, FasterRCNN
from .extra_heads import DoubleConvFCBBoxHead, MaskIoUHead, mask_iou_target
from .grid_head import GridHead, grid_targets, grid_to_boxes
from .mask_head import FCNMaskHead
from .rpn import Proposals


def _scale_rois(rois: torch.Tensor, factor: float) -> torch.Tensor:
    """Rois inflated about their centres by `factor` (roi_scale_factor)."""
    cx = (rois[..., 0] + rois[..., 2]) * 0.5
    cy = (rois[..., 1] + rois[..., 3]) * 0.5
    hw = (rois[..., 2] - rois[..., 0]) * 0.5 * factor
    hh = (rois[..., 3] - rois[..., 1]) * 0.5 * factor
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def _given(proposals: Optional[torch.Tensor], proposal_valid: Optional[torch.Tensor], what: str) -> Proposals:
    if proposals is None:
        raise ValueError(f"FastRCNN.{what} requires precomputed proposals")
    if proposal_valid is None:
        proposal_valid = torch.ones(proposals.shape[:2], dtype=torch.bool, device=proposals.device)
    return Proposals(boxes=proposals.float().contiguous(), scores=None, valid=proposal_valid)


class FastRCNN(FasterRCNN):
    HAS_RPN = False

    def _proposals(self, feats, images, img_shapes):
        raise ValueError("Fast R-CNN has no RPN: pass its proposals to loss or predict")

    def loss(
        self,
        images: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_mask: torch.Tensor,
        img_shapes: torch.Tensor,
        gt_mask_crops: Optional[torch.Tensor] = None,
        proposals: Optional[torch.Tensor] = None,  # (B, P, 4), required
        proposal_valid: Optional[torch.Tensor] = None,  # (B, P) bool; all valid by default
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The bbox head's losses (and "loss_mask") on the given proposals;
        no RPN loss."""
        losses, feats, t = self._loss_core(
            images, gt_boxes, gt_labels, gt_mask, img_shapes, _given(proposals, proposal_valid, "loss"), generator
        )
        if self.mask_head is not None and gt_mask_crops is not None:
            losses["loss_mask"] = self._mask_loss(feats, t, gt_boxes, gt_mask_crops)
        return losses

    @torch.inference_mode()
    def predict(
        self,
        images: torch.Tensor,
        img_shapes: torch.Tensor,
        scale_factors: torch.Tensor,
        proposals: Optional[torch.Tensor] = None,  # (B, P, 4) in the network frame, required
        proposal_valid: Optional[torch.Tensor] = None,
        rescale: bool = True,
    ) -> Detections:
        feats = self.extract_feats(images)
        return self._predict_feats(
            feats, images, img_shapes, scale_factors, rescale, _given(proposals, proposal_valid, "predict")
        )


def jitter_rois(rois: torch.Tensor, img_shapes: torch.Tensor, jitter: float, generator=None) -> torch.Tensor:
    """Grid R-CNN's _random_jitter (grid_rcnn.py:58-81) of rois (B, R, 4):
    the centre moved and the size scaled by uniform draws in +-`jitter` (of
    the size), then the corners clipped to (w - 1, h - 1) of `img_shapes`
    (B, 2). JAX's order of operations."""
    off = torch.rand(rois.shape, generator=generator, device=rois.device, dtype=rois.dtype) * (2 * jitter) - jitter
    cxcy = (rois[..., :2] + rois[..., 2:]) * 0.5
    wh = (rois[..., 2:] - rois[..., :2]).abs()
    new_c = cxcy + wh * off[..., :2]
    new_wh = wh * (1.0 + off[..., 2:])
    hi = (torch.stack([img_shapes[:, 1], img_shapes[:, 0]], -1).to(rois.dtype) - 1.0)[:, None, :]
    clip = lambda p: torch.minimum(torch.maximum(p, torch.zeros((), dtype=rois.dtype, device=rois.device)), hi)
    return torch.cat([clip(new_c - new_wh * 0.5), clip(new_c + new_wh * 0.5)], dim=-1)


class GridRCNN(FasterRCNN):
    def _init_roi_heads(self) -> None:
        super()._init_roi_heads()
        self.grid_head = GridHead(self.cfg.fpn.out_channels, heatmap_size=self.cfg.variant.grid_heatmap_size)

    def _grid_heatmaps(self, feats, rois: torch.Tensor) -> torch.Tensor:
        """rois (B, R, 4) pooled at heatmap / 4 (K2; the grid head's two
        transposed convs upsample 4x) -> (B * R, 9, hm, hm) logits."""
        pooled = self._pool(feats, rois, self.cfg.variant.grid_heatmap_size // 4)
        return self.grid_head(pooled.flatten(0, 1).permute(0, 3, 1, 2))

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes, gt_mask_crops=None, generator=None):
        """Faster R-CNN's losses and "loss_grid" (grid_rcnn.py:176-196): the
        positive prefix of the sampled slots jittered (_random_jitter,
        grid_rcnn.py:58-81: centre offsets in box units and scale changes
        uniform in +-grid_jitter, clipped to the image), its heatmaps against
        the assigned gts' grid points, BCE on logits clipped to +-30,
        averaged over hm x hm and over the valid (positive, in-roi) points."""
        c = self.cfg
        v = c.variant
        losses, feats, t = self._loss_core(images, gt_boxes, gt_labels, gt_mask, img_shapes, generator=generator)
        cap = max(int(c.rcnn_train.sampler.num * c.rcnn_train.sampler.pos_fraction), 1)
        with torch.no_grad():
            pos_valid = (t.labels[:, :cap] > 0) & t.roi_valid[:, :cap]
            jit_rois = jitter_rois(t.rois[:, :cap], img_shapes, v.grid_jitter, generator)
            gi = t.pos_gt_inds[:, :cap].long().clamp(min=0)
            pos_gt = torch.gather(gt_boxes.to(jit_rois.dtype), 1, gi[..., None].expand(-1, -1, 4))
            heat_t, point_valid = grid_targets(jit_rois.flatten(0, 1), pos_gt.flatten(0, 1), v.grid_heatmap_size)
        lg = self._grid_heatmaps(feats, jit_rois).float().clamp(-30, 30)
        bce = lg.clamp(min=0) - lg * heat_t + torch.log1p(torch.exp(-lg.abs()))
        w = (pos_valid.flatten()[:, None] & point_valid).float()
        losses["loss_grid"] = (bce.mean(dim=(2, 3)) * w).sum() / w.sum().clamp(min=1.0)
        return losses

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        """simple_test (grid_rcnn.py:200-229): the detections in the network
        frame, every slot pooled (K2) and its box decoded from the grid
        points, clipped to (w - 1, h - 1), then divided by the scale factor."""
        feats = self.extract_feats(images)
        dets = self._predict_feats(feats, images, img_shapes, scale_factors, rescale=False)
        b, m = dets.boxes.shape[:2]
        refined = grid_to_boxes(self._grid_heatmaps(feats, dets.boxes), dets.boxes.flatten(0, 1)).reshape(b, m, 4)
        hi = torch.stack([img_shapes[:, 1], img_shapes[:, 0]], -1).float() - 1.0
        refined = torch.minimum(torch.maximum(refined, torch.zeros((), device=hi.device)), torch.cat([hi, hi], -1)[:, None])
        if rescale:
            refined = refined / scale_factors.float()[:, None, None]
        return Detections(refined, dets.scores, dets.labels, dets.valid)


class MaskScoringRCNN(FasterRCNN):
    def _init_roi_heads(self) -> None:
        if self.cfg.mask_head is None:
            raise ValueError("MaskScoringRCNN needs a mask head")
        super()._init_roi_heads()
        self.mask_iou_head = MaskIoUHead(
            self.cfg.mask_head.num_classes, self.cfg.mask_head.in_channels, self.cfg.mask_head.mask_size // 2
        )

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes, gt_mask_crops=None, generator=None):
        """Mask R-CNN's losses and "loss_mask_iou" (mask_scoring_rcnn.py:152-166):
        half the squared error of the predicted IoU of each positive's class
        against its target, averaged over the positives. The target (no
        gradient) is the IoU of the thresholded prediction with the
        resampled gt, corrected for the gt's area outside the proposal: the
        targets' mean times the proposal's area over the gt crop's mean times
        the gt box's area. The gradient reaches the mask head through the
        predicted probabilities and the backbone through the pooled
        features."""
        losses, feats, t = self._loss_core(images, gt_boxes, gt_labels, gt_mask, img_shapes, generator=generator)
        if gt_mask_crops is None:
            return losses
        aux = self._mask_branch(feats, t, gt_boxes, gt_mask_crops)
        losses["loss_mask"] = aux["loss_mask"]
        cap = aux["mask_cap"]
        pred_prob = torch.sigmoid(aux["mask_logits"].float())  # (B * cap, 2S, 2S)
        iou_logits = self.mask_iou_head(aux["m_pooled"], pred_prob)
        labels0 = (aux["m_labels"].flatten().long() - 1).clamp(0, iou_logits.shape[-1] - 1)
        iou_pred = iou_logits.float().gather(1, labels0[:, None])[:, 0]
        with torch.no_grad():
            m_rois = aux["m_rois"].flatten(0, 1)
            prop_area = ((m_rois[:, 2] - m_rois[:, 0]) * (m_rois[:, 3] - m_rois[:, 1])).clamp(min=1.0)
            gi = t.pos_gt_inds[:, :cap].long().clamp(min=0)
            pos_gt = torch.gather(gt_boxes.float(), 1, gi[..., None].expand(-1, -1, 4)).flatten(0, 1)
            gt_area = ((pos_gt[:, 2] - pos_gt[:, 0]) * (pos_gt[:, 3] - pos_gt[:, 1])).clamp(min=1.0)
            b = gi.shape[0]
            crops = gt_mask_crops.float()[torch.arange(b, device=gi.device)[:, None], gi].flatten(0, 1)
            m_targets = aux["m_targets"].flatten(0, 1)
            in_prop = m_targets.mean(dim=(-2, -1)) * prop_area
            full = (crops.mean(dim=(-2, -1)) * gt_area).clamp(min=1.0)
            iou_t = mask_iou_target(pred_prob, m_targets, (in_prop / full).clamp(0.0, 1.0))
        w = aux["m_pos"].flatten().float()
        losses["loss_mask_iou"] = (0.5 * (iou_pred - iou_t) ** 2 * w).sum() / w.sum().clamp(min=1.0)
        return losses

    @torch.inference_mode()
    def predict_with_masks(self, images, img_shapes, scale_factors, rescale: bool = True):
        """(detections, masks (B, M, 28, 28) in the model dtype, mask scores
        (B, M) f32) from one backbone pass: a mask score is the detection's
        score times the predicted IoU of its class (maskiou_head.py
        get_mask_scores), the labels clipped into the head's range."""
        c = self.cfg
        feats = self.extract_feats(images)
        dets = self._predict_feats(feats, images, img_shapes, scale_factors, rescale)
        sf = scale_factors.float() if rescale else torch.ones_like(scale_factors, dtype=torch.float32)
        pooled = self._pool(feats, dets.boxes * sf[:, None, None], c.mask_head.mask_size // 2)
        b, m = pooled.shape[:2]
        x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
        labels = dets.labels.flatten()
        probs = torch.sigmoid(self.mask_head(x, labels=labels)[0].float())  # (B * M, 2S, 2S)
        iou_logits = self.mask_iou_head(x, probs)
        idx = labels.long().clamp(0, iou_logits.shape[-1] - 1)
        iou_pred = iou_logits.float().gather(1, idx[:, None])[:, 0].reshape(b, m)
        return dets, probs.to(self.dtype).reshape(b, m, *probs.shape[-2:]), dets.scores * iou_pred


class DoubleHeadRCNN(FasterRCNN):
    def _init_roi_heads(self) -> None:
        c = self.cfg.bbox_head
        self.bbox_head = DoubleConvFCBBoxHead(
            c.num_classes, c.in_channels, c.roi_feat_size, fc_out_channels=c.fc_out_channels,
            reg_class_agnostic=c.reg_class_agnostic,
        )
        if self.cfg.mask_head is not None:
            self.mask_head = FCNMaskHead(self.cfg.mask_head)

    def _bbox_forward(self, feats, rois: torch.Tensor):
        """The fc branch on the rois pooled as they are, the conv branch on
        the rois inflated by `reg_roi_scale_factor` (K2 twice at S = 7)."""
        inflated = _scale_rois(rois, self.cfg.variant.reg_roi_scale_factor)
        return self.bbox_head(self._pool(feats, rois), self._pool(feats, inflated))


VARIANTS = {
    "fast": FastRCNN,
    "grid": GridRCNN,
    "mask_scoring": MaskScoringRCNN,
    "double_head": DoubleHeadRCNN,
}


def build_variant(cfg, partition=None, dtype: torch.dtype = torch.float32, class_weights=None) -> FasterRCNN:
    kind = cfg.variant.kind
    if kind not in VARIANTS:
        raise ValueError(f"unknown detector variant {kind!r}")
    return VARIANTS[kind](cfg, partition=partition, dtype=dtype, class_weights=class_weights)
