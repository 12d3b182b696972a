"""Shared-FC bbox head and its losses (JAX `models/bbox_head.py`
`SharedFCBBoxHead` :26, its `return_feature` hook :31-66, `bbox_reg_loss`
:69, `bbox_head_loss` :91 with its `loss_cls_type` branch :100-137): two shared FCs, then fc_cls and fc_reg. The GS
variant widens fc_cls to num_classes + num_bins logits. Regression is
class-specific (4 deltas per class), or one set of 4 deltas with
`reg_class_agnostic` (the cascade's stage heads).

RoI features enter channels-last, (..., S, S, C), and flatten in H-W-C order
as in the JAX head, so `shared_fc0` is the flax kernel transposed."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BBoxHeadConfig
from ..ops.losses import (
    accuracy,
    sigmoid_focal_loss,
    smooth_l1,
    softmax_cross_entropy,
    weighted_softmax_cross_entropy_per_class,
)
from .layers import Linear


class SharedFCBBoxHead(nn.Module):
    def __init__(self, cfg: BBoxHeadConfig):
        super().__init__()
        in_dim = cfg.in_channels * cfg.roi_feat_size**2
        self.shared_fcs = nn.ModuleList()
        for _ in range(cfg.num_shared_fcs):
            self.shared_fcs.append(Linear(in_dim, cfg.fc_out_channels))
            in_dim = cfg.fc_out_channels
        num_logits = cfg.num_classes + (cfg.gs.num_bins if cfg.use_gs else 0)
        self.fc_cls = Linear(in_dim, num_logits)
        self.fc_reg = Linear(in_dim, 4 if cfg.reg_class_agnostic else 4 * cfg.num_classes)

    def init_special(self) -> dict:
        """normal(0.01) fc_cls, normal(0.001) fc_reg; the shared FCs keep
        `FasterRCNN.init_weights`' xavier-uniform."""
        return {self.fc_cls: ("normal", 0.01), self.fc_reg: ("normal", 0.001)}

    def forward(self, roi_feats: torch.Tensor, return_feature: bool = False):
        """(..., S, S, C) -> (cls_logits (..., L), bbox_deltas (..., 4K or 4));
        with `return_feature` also the last shared FC's ReLU output, the
        feature DCM classifies (`models/dcm.py`)."""
        x = roi_feats.flatten(-3)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        if return_feature:
            return self.fc_cls(x), self.fc_reg(x), x
        return self.fc_cls(x), self.fc_reg(x)


def bbox_reg_loss(
    bbox_deltas: torch.Tensor,  # (N, 4C), or (N, 4) class-agnostic
    labels: torch.Tensor,  # (N,) int
    bbox_targets: torch.Tensor,  # (N, 4)
    bbox_weights: torch.Tensor,  # (N, 4)
    beta: float = 1.0,
    reg_class_agnostic: bool = False,
) -> torch.Tensor:
    """Smooth-L1 on each roi's target-class deltas (or its only deltas,
    class-agnostic), averaged over all rois (bbox_head.py:113-131)."""
    n = bbox_deltas.shape[0]
    if reg_class_agnostic:
        pos_deltas = bbox_deltas.float()
    else:
        d = bbox_deltas.float().reshape(n, -1, 4)
        idx = labels.long().clamp(0, d.shape[1] - 1)[:, None, None].expand(-1, 1, 4)
        pos_deltas = torch.gather(d, 1, idx)[:, 0]
    return smooth_l1(pos_deltas, bbox_targets, beta=beta, weight=bbox_weights, avg_factor=n)


def bbox_head_loss(
    cls_logits: torch.Tensor,  # (N, C)
    bbox_deltas: torch.Tensor,  # (N, 4C)
    labels: torch.Tensor,  # (N,) int
    label_weights: torch.Tensor,  # (N,)
    bbox_targets: torch.Tensor,  # (N, 4)
    bbox_weights: torch.Tensor,  # (N, 4)
    beta: float = 1.0,
    loss_cls_type: str = "softmax",
    class_weights: Optional[torch.Tensor] = None,  # (C,) for "reweight"
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
):
    """(loss_cls, loss_bbox, acc): the classification loss of
    `loss_cls_type` on f32 logits averaged over the weighted rois -- softmax
    CE, the sigmoid focal loss against one-hot targets ("focal"), or CE
    weighted by `class_weights` of each roi's label ("reweight") --, the
    regression loss above, and top-1 accuracy (bbox_head.py:91-142)."""
    avg_cls = (label_weights > 0).sum().clamp(min=1).float()
    logits32 = cls_logits.float()
    if loss_cls_type == "focal":
        onehot = F.one_hot(labels.long(), logits32.shape[-1]).float()
        loss_cls = sigmoid_focal_loss(
            logits32, onehot, weight=label_weights[:, None], gamma=focal_gamma, alpha=focal_alpha, avg_factor=avg_cls
        )
    elif loss_cls_type == "reweight":
        if class_weights is None:
            raise ValueError('loss_cls_type "reweight" needs class_weights')
        loss_cls = weighted_softmax_cross_entropy_per_class(
            logits32, labels, class_weights, weight=label_weights, avg_factor=avg_cls
        )
    else:
        loss_cls = softmax_cross_entropy(logits32, labels, weight=label_weights, avg_factor=avg_cls)
    loss_bbox = bbox_reg_loss(bbox_deltas, labels, bbox_targets, bbox_weights, beta)
    acc = accuracy(cls_logits, labels, mask=(label_weights > 0).float())
    return loss_cls, loss_bbox, acc
