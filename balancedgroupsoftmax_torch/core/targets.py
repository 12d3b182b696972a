"""Anchor and RoI targets with static shapes, batched over images (JAX
`core/targets.py` `anchor_targets_single` :34, `roi_targets_single` :118).

Assignment runs over all anchors with the inside-the-image test folded into
the proposal mask, so no unmap is needed. Sampling priorities come from the
caller's generator unless passed in as (B, n) tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RCNNTrainConfig, RPNTrainConfig
from ..ops.boxes import bbox2delta
from .assigner import assign_max_iou
from .sampler import add_gt_as_proposals, sample_pos_neg


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (B, N) int32, 1 on sampled positives
    label_weights: torch.Tensor  # (B, N) f32, non-zero on sampled anchors
    bbox_targets: torch.Tensor  # (B, N, 4) f32
    bbox_weights: torch.Tensor  # (B, N, 4) f32, 1 on positives
    num_pos: torch.Tensor  # (B,) at least 1 (anchor_target.py:68)
    num_neg: torch.Tensor  # (B,) at least 1


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, S) -> (B, S, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def anchor_targets(
    anchors: torch.Tensor,  # (N, 4) all levels concatenated
    valid_mask: torch.Tensor,  # (N,) bool grid validity
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_mask: torch.Tensor,  # (B, G) bool
    img_shape: Tuple[int, int],  # (H, W) the anchors must lie inside
    cfg: RPNTrainConfig,
    generator: Optional[torch.Generator] = None,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(1.0, 1.0, 1.0, 1.0),
    pos_priority: Optional[torch.Tensor] = None,  # (B, N)
    neg_priority: Optional[torch.Tensor] = None,
) -> AnchorTargets:
    img_h, img_w = img_shape
    border = cfg.allowed_border
    inside = valid_mask
    if border >= 0:
        inside = (
            valid_mask
            & (anchors[:, 0] >= -border)
            & (anchors[:, 1] >= -border)
            & (anchors[:, 2] < img_w + border)
            & (anchors[:, 3] < img_h + border)
        )
    b, n = gt_boxes.shape[0], anchors.shape[0]
    a = cfg.assigner
    assign = assign_max_iou(
        anchors, inside, gt_boxes, torch.ones_like(gt_mask, dtype=torch.int32), gt_mask,
        a.pos_iou_thr, a.neg_iou_thr, a.min_pos_iou, a.gt_max_assign_all,
    )
    samp = sample_pos_neg(
        assign, cfg.sampler.num, cfg.sampler.pos_fraction, generator, pos_priority, neg_priority
    )

    pos_slots = samp.is_pos & samp.valid
    neg_slots = samp.valid & ~samp.is_pos
    pos_weight = 1.0 if cfg.pos_weight <= 0 else cfg.pos_weight
    dev = anchors.device
    labels = torch.zeros(b, n, dtype=torch.int32, device=dev).scatter_add_(1, samp.inds, pos_slots.to(torch.int32))
    slot_w = torch.where(pos_slots, pos_weight, torch.where(neg_slots, 1.0, 0.0))
    label_weights = torch.zeros(b, n, device=dev).scatter_add_(1, samp.inds, slot_w)

    gt_idx = (torch.gather(assign.gt_inds, 1, samp.inds) - 1).clamp(0, gt_boxes.shape[1] - 1).long()
    deltas = bbox2delta(anchors[samp.inds], _gather_rows(gt_boxes, gt_idx), target_means, target_stds)
    inds4 = samp.inds[..., None].expand(-1, -1, 4)
    pos4 = pos_slots[..., None]
    bbox_targets = torch.zeros(b, n, 4, device=dev).scatter_add_(1, inds4, torch.where(pos4, deltas, 0.0))
    bbox_weights = torch.zeros(b, n, 4, device=dev).scatter_add_(
        1, inds4, pos4.expand(-1, -1, 4).to(torch.float32)
    )
    return AnchorTargets(
        labels=labels,
        label_weights=label_weights,
        bbox_targets=bbox_targets,
        bbox_weights=bbox_weights,
        num_pos=samp.num_pos.clamp(min=1),
        num_neg=samp.num_neg.clamp(min=1),
    )


class RoITargets(NamedTuple):
    rois: torch.Tensor  # (B, S, 4) sampled boxes
    roi_valid: torch.Tensor  # (B, S) bool
    labels: torch.Tensor  # (B, S) int32, gt class (1-based) on positives, 0 else
    label_weights: torch.Tensor  # (B, S) f32
    bbox_targets: torch.Tensor  # (B, S, 4)
    bbox_weights: torch.Tensor  # (B, S, 4)
    pos_gt_inds: torch.Tensor  # (B, S) 0-based assigned gt on positive slots
    num_pos: torch.Tensor  # (B,)
    num_neg: torch.Tensor  # (B,)


def roi_targets(
    proposals: torch.Tensor,  # (B, P, 4)
    prop_mask: torch.Tensor,  # (B, P) bool
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_labels: torch.Tensor,  # (B, G) int, 1-based
    gt_mask: torch.Tensor,  # (B, G) bool
    cfg: RCNNTrainConfig,
    generator: Optional[torch.Generator] = None,
    target_means=(0.0, 0.0, 0.0, 0.0),
    target_stds=(0.1, 0.1, 0.2, 0.2),
    pos_priority: Optional[torch.Tensor] = None,  # (B, G + P) with gt added, else (B, P)
    neg_priority: Optional[torch.Tensor] = None,
) -> RoITargets:
    """Assign, sample and encode the RCNN stage's targets; S =
    cfg.sampler.num slots per image, positives first."""
    a = cfg.assigner
    assign = assign_max_iou(
        proposals, prop_mask, gt_boxes, gt_labels, gt_mask,
        a.pos_iou_thr, a.neg_iou_thr, a.min_pos_iou, a.gt_max_assign_all,
    )
    boxes = proposals.float()
    if cfg.sampler.add_gt_as_proposals:
        boxes, _, assign = add_gt_as_proposals(boxes, prop_mask, assign, gt_boxes, gt_labels, gt_mask)
    samp = sample_pos_neg(
        assign, cfg.sampler.num, cfg.sampler.pos_fraction, generator, pos_priority, neg_priority
    )

    rois = _gather_rows(boxes, samp.inds)
    pos_slots = samp.is_pos & samp.valid
    labels = torch.where(pos_slots, torch.gather(assign.labels, 1, samp.inds), 0).to(torch.int32)
    pos_weight = 1.0 if cfg.pos_weight <= 0 else cfg.pos_weight
    label_weights = torch.where(pos_slots, pos_weight, torch.where(samp.valid, 1.0, 0.0))
    gt_idx = (torch.gather(assign.gt_inds, 1, samp.inds) - 1).clamp(0, gt_boxes.shape[1] - 1).long()
    deltas = bbox2delta(rois, _gather_rows(gt_boxes, gt_idx), target_means, target_stds)
    pos4 = pos_slots[..., None]
    return RoITargets(
        rois=rois,
        roi_valid=samp.valid,
        labels=labels,
        label_weights=label_weights.float(),
        bbox_targets=torch.where(pos4, deltas, 0.0),
        bbox_weights=pos4.expand(-1, -1, 4).to(torch.float32),
        pos_gt_inds=gt_idx.to(torch.int32),
        num_pos=samp.num_pos,
        num_neg=samp.num_neg,
    )
