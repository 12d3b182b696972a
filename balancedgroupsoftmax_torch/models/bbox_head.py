"""Shared-FC bbox head and its losses (JAX `models/bbox_head.py`
`SharedFCBBoxHead` :26, `bbox_reg_loss` :69, `bbox_head_loss` :91): two
shared FCs, then fc_cls and fc_reg. The GS variant widens fc_cls to
num_classes + num_bins logits. Regression is class-specific.

RoI features enter channels-last, (..., S, S, C), and flatten in H-W-C order
as in the JAX head, so `shared_fc0` is the flax kernel transposed."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BBoxHeadConfig
from ..ops.losses import accuracy, smooth_l1, softmax_cross_entropy
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
        self.fc_reg = Linear(in_dim, 4 * cfg.num_classes)  # class-specific regression

    def forward(self, roi_feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., S, S, C) -> (cls_logits (..., L), bbox_deltas (..., 4K))."""
        x = roi_feats.flatten(-3)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


def bbox_reg_loss(
    bbox_deltas: torch.Tensor,  # (N, 4C)
    labels: torch.Tensor,  # (N,) int
    bbox_targets: torch.Tensor,  # (N, 4)
    bbox_weights: torch.Tensor,  # (N, 4)
    beta: float = 1.0,
) -> torch.Tensor:
    """Smooth-L1 on each roi's target-class deltas, averaged over all rois
    (bbox_head.py:113-131)."""
    n = bbox_deltas.shape[0]
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
):
    """(loss_cls, loss_bbox, acc): softmax CE averaged over the weighted rois,
    the regression loss above, and top-1 accuracy (bbox_head.py:98-131)."""
    avg_cls = (label_weights > 0).sum().clamp(min=1).float()
    loss_cls = softmax_cross_entropy(cls_logits.float(), labels, weight=label_weights, avg_factor=avg_cls)
    loss_bbox = bbox_reg_loss(bbox_deltas, labels, bbox_targets, bbox_weights, beta)
    acc = accuracy(cls_logits, labels, mask=(label_weights > 0).float())
    return loss_cls, loss_bbox, acc
