"""Shared-FC bbox head (JAX `models/bbox_head.py`
`SharedFCBBoxHead` :26): two shared FCs, then fc_cls and fc_reg. The GS
variant widens fc_cls to num_classes + num_bins logits.

RoI features enter channels-last, (..., S, S, C), and flatten in H-W-C order
as in the JAX head, so `shared_fc0` is the flax kernel transposed."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BBoxHeadConfig
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
