"""Guided Anchoring RPN (JAX `models/guided_anchor.py`: `GAConfig` :41,
`GuidedAnchorRPN` :51, `_generated_anchors` :86, `ga_loc_targets` :99,
`GARPN` :125, `loss` :162, `propose` :232).

At each level of an R50-FPN on C2-C5 (strides 4-64) the head predicts an
objectness location logit and an anchor shape (dw, dh on a square of
`octave_base` x stride); a deformable convolution whose offsets a 1x1 conv
reads from the detached shape adapts the features (K7 forward, K7b
backward, at D = 0), and an RPN class and box pair runs on them over the
generated anchors. Targets: the location's centre region of each gt on its
level positive and a wider ring ignored; the shape fitted to the best-IoU gt
at the location positives (loss 1 - IoU); RPN max-IoU assignment (0.7 /
0.3 / 0.3) on the generated anchors. `propose` gates the class scores by the
location (`loc_filter_thr`), takes the top `nms_pre`, decodes them on their
anchors and runs K1 (`batched_nms_topk`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ProposalConfig
from ..core.assigner import assign_max_iou
from ..kernels import batched_nms_topk
from ..ops.boxes import bbox2delta, bbox_overlaps, delta2bbox
from ..ops.losses import binary_cross_entropy_with_logits, sigmoid_focal_loss, smooth_l1
from ..ops.topk import top_k
from .fcos import _points
from .layers import Conv2d
from .reppoints import deform_conv
from .rpn import Proposals
from .single_stage import FOCAL_BIAS, SingleStageDetector, flat, take


@dataclasses.dataclass(frozen=True)
class GAConfig:
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    octave_base: float = 8.0  # the square anchor's base: octave_base x stride
    sigma_center: float = 0.2
    sigma_ignore: float = 0.5
    feat_channels: int = 256
    loc_filter_thr: float = 0.01
    image_size: Tuple[int, int] = (800, 1344)


class GuidedAnchorRPN(nn.Module):
    def __init__(self, cfg: GAConfig):
        super().__init__()
        ch = cfg.feat_channels
        self.conv_loc = Conv2d(ch, 1, 1)
        self.conv_shape = Conv2d(ch, 2, 1)
        self.feature_adaption_offset = Conv2d(2, 2 * 9, 1)
        # (C_out, C_in, 3, 3); flax holds it (3, 3, C_in, C_out)
        self.feature_adaption_kernel = nn.Parameter(torch.zeros(ch, ch, 3, 3))
        self.ga_rpn_cls = Conv2d(ch, 1, 1)
        self.ga_rpn_reg = Conv2d(ch, 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (location logits (B, 1, H, W), shape (B, 2, H, W), RPN
        logits (B, 1, H, W), deltas (B, 4, H, W))."""
        outs = []
        for x in feats:
            shape = self.conv_shape(x)
            off = self.feature_adaption_offset(shape.detach()).float()
            adapted = F.relu(deform_conv(x, off, self.feature_adaption_kernel))
            outs.append((self.conv_loc(x), shape, self.ga_rpn_cls(adapted), self.ga_rpn_reg(adapted)))
        return outs


def _generated_anchors(shape_pred, points, stride, octave_base):
    """(..., N, 2) shape deltas, their centres (..., N, 2) and strides (...,
    N) -> (..., N, 4) anchors of w = octave_base x stride x exp(dw), dw
    clipped to [-4, 4]."""
    base = octave_base * stride
    w = base * torch.exp(shape_pred[..., 0].clamp(-4.0, 4.0))
    h = base * torch.exp(shape_pred[..., 1].clamp(-4.0, 4.0))
    return torch.stack(
        [points[..., 0] - (w - 1) / 2, points[..., 1] - (h - 1) / 2, points[..., 0] + (w - 1) / 2, points[..., 1] + (h - 1) / 2],
        dim=-1,
    )


def ga_loc_targets(points, strides_per_pt, lvl_of_pt, gt_boxes, gt_mask, cfg: GAConfig):
    """(..., N) location labels, 1 positive, 0 negative, -1 ignored, of the
    gts (..., G, 4): positive inside the `sigma_center`-scaled gt on its own
    level, ignored in the `sigma_ignore` region there."""
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    gw = gt_boxes[..., 2] - gt_boxes[..., 0] + 1
    gh = gt_boxes[..., 3] - gt_boxes[..., 1] + 1
    scale = torch.sqrt(gw * gh)

    def region(s):
        inx = (points[:, 0, None] - cx[..., None, :]).abs() < (s * gw / 2)[..., None, :]
        iny = (points[:, 1, None] - cy[..., None, :]).abs() < (s * gh / 2)[..., None, :]
        return inx & iny & gt_mask[..., None, :]

    gt_lvl = torch.floor(torch.log2(scale / (cfg.octave_base * cfg.strides[0]) + 1e-6)).clamp(0, len(cfg.strides) - 1)
    same_lvl = lvl_of_pt[:, None] == gt_lvl.int()[..., None, :]
    pos = (region(cfg.sigma_center) & same_lvl).any(dim=-1)
    ign = (region(cfg.sigma_ignore) & same_lvl).any(dim=-1) & ~pos
    return torch.where(pos, 1, torch.where(ign, -1, 0)).int()


class GARPN(SingleStageDetector):
    """The standalone GA-RPN: proposals (ga_rpn_head.py)."""

    HEAD = "rpn_head"
    INIT = {
        "rpn_head.feature_adaption_offset.weight": ("constant", 0.0),
        "rpn_head.*.weight": ("normal", 0.01),
        "rpn_head.feature_adaption_kernel": ("normal", 0.01),
        "rpn_head.conv_loc.bias": ("constant", FOCAL_BIAS),
    }
    fpn_inputs = (0, 1, 2, 3)

    def __init__(self, cfg: GAConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, GuidedAnchorRPN(cfg), dtype)

    def _meta(self, images: torch.Tensor):
        """(centres (N, 2), strides (N,), level ids (N,)) of all levels."""
        c = self.cfg
        sizes = self._level_sizes(images)

        def make():
            pts = [_points(lh, lw, s) for (lh, lw), s in zip(sizes, c.strides)]
            strides = [np.full(len(p), s, np.float32) for p, s in zip(pts, c.strides)]
            lvls = [np.full(len(p), li, np.int32) for li, p in enumerate(pts)]
            return tuple(torch.from_numpy(np.concatenate(a)).to(images.device) for a in (pts, strides, lvls))

        return self._cached(("meta", *sizes, images.device), make)

    def _flat_outs(self, outs):
        """The levels' outputs as (location (B, N), shape (B, N, 2), RPN
        logits (B, N), deltas (B, N, 4)), f32."""
        cat = lambda i, last: torch.cat([flat(o[i].float(), last) for o in outs], dim=1)
        return cat(0, 1)[..., 0], cat(1, 2), cat(2, 1)[..., 0], cat(3, 4)

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes) -> Dict[str, torch.Tensor]:
        c = self.cfg
        points, strides, lvls = self._meta(images)
        loc_logits, shape_pred, cls_logits, reg_pred = self._flat_outs(self(images))
        gt_boxes = gt_boxes.float()
        anchors = _generated_anchors(shape_pred, points, strides, c.octave_base)
        with torch.no_grad():
            loc_t = ga_loc_targets(points, strides, lvls, gt_boxes, gt_mask, c)
            # the shape target: the gt of best IoU with the generated anchor
            ious = bbox_overlaps(anchors, gt_boxes)
            ious = torch.where(gt_mask[:, None, :], ious, torch.full_like(ious, -1.0))
            shape_tgt = take(gt_boxes, ious.argmax(dim=-1))
            # the RPN's class and box targets on the generated anchors
            fixed = anchors.detach()
            assign = assign_max_iou(
                fixed, torch.ones(fixed.shape[:2], dtype=torch.bool, device=fixed.device),
                gt_boxes, torch.ones_like(gt_mask, dtype=torch.int32), gt_mask,
                pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
            )
            pos = assign.gt_inds > 0
            neg = assign.gt_inds == 0
            deltas_t = bbox2delta(fixed, take(gt_boxes, (assign.gt_inds - 1).clamp(0, gt_boxes.shape[1] - 1).long()))

        loc_pos = (loc_t == 1).float()
        num_loc_pos = loc_pos.sum().clamp(min=1.0)
        loss_loc = sigmoid_focal_loss(loc_logits, loc_pos, weight=(loc_t >= 0).float(), avg_factor=num_loc_pos)
        ious = bbox_overlaps(anchors, shape_tgt, is_aligned=True)
        loss_shape = ((1.0 - ious) * loc_pos).sum() / num_loc_pos
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = binary_cross_entropy_with_logits(
            cls_logits, pos.float(), weight=(pos | neg).float(), avg_factor=num_pos + neg.sum()
        )
        loss_reg = smooth_l1(reg_pred, deltas_t, beta=1.0 / 9.0, weight=pos[..., None].float(), avg_factor=num_pos)
        return {"loss_loc": loss_loc, "loss_shape": loss_shape, "loss_cls": loss_cls, "loss_bbox": loss_reg}

    @torch.inference_mode()
    def propose(self, images, img_shapes, cfg: ProposalConfig) -> Proposals:
        """The proposals of the guided anchors (the GA-RPN test path): K1."""
        c = self.cfg
        points, strides, _ = self._meta(images)
        loc_logits, shape_pred, cls_logits, reg = self._flat_outs(self(images))
        scores = torch.sigmoid(cls_logits) * (torch.sigmoid(loc_logits) > c.loc_filter_thr)
        top, idx = top_k(scores, min(cfg.nms_pre, scores.shape[1]))
        anchors = _generated_anchors(take(shape_pred, idx), points[idx], strides[idx], c.octave_base)
        shapes = img_shapes.float()
        boxes = delta2bbox(anchors, take(reg, idx), max_shape=(shapes[:, 0, None, None], shapes[:, 1, None, None]))
        valid = torch.ones(top.shape, dtype=torch.bool, device=top.device)
        return Proposals(*batched_nms_topk(boxes, top, valid, cfg.nms_thr, cfg.max_num))
