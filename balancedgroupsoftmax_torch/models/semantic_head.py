"""Fused semantic head, the HTC stuff branch (JAX `models/semantic_head.py`
`FusedSemanticHead` :55, `semantic_seg_loss` :98).

Per-level 1x1 laterals with relu, each resized to the fusion level
(stride 8) by bilinear interpolation with align_corners=True
(`resize_bilinear_align_corners` :18) and summed, four 3x3 convs with relu,
then a 1x1 embedding with relu: the feature that HTC's RoIs pool beside the
FPN's. Training with a stuff map also scores the trunk's 1x1 segmentation
logits (`conv_logits`, `semantic_seg_loss`). JAX's head returns both, and XLA
drops the logits where nothing reads them; eager PyTorch would not, so the
head returns its trunk and each caller applies only the 1x1 it reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FusedSemanticHead(nn.Module):
    def __init__(
        self,
        num_ins: int = 5,
        fusion_level: int = 1,
        num_convs: int = 4,
        in_channels: int = 256,
        conv_out_channels: int = 256,
        num_classes: int = 183,
    ):
        super().__init__()
        self.fusion_level = fusion_level
        self.lateral = nn.ModuleList(Conv2d(in_channels, conv_out_channels, 1) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            Conv2d(in_channels if i == 0 else conv_out_channels, conv_out_channels, 3, padding=1)
            for i in range(num_convs)
        )
        self.conv_logits = Conv2d(conv_out_channels, num_classes, 1)
        self.conv_embedding = Conv2d(conv_out_channels, conv_out_channels, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """feats: FPN levels (B, C, H_l, W_l) -> the trunk (B, C', H_f, W_f)
        at the fusion level; `conv_logits` of it gives the segmentation
        logits, `feature` of it the feature."""
        x = F.relu(self.lateral[self.fusion_level](feats[self.fusion_level]))
        size = x.shape[-2:]
        for i, f in enumerate(feats):
            if i != self.fusion_level:
                y = F.relu(self.lateral[i](f))
                if y.shape[-2:] != size:
                    y = F.interpolate(y, size=size, mode="bilinear", align_corners=True)
                x = x + y
        for conv in self.convs:
            x = F.relu(conv(x))
        return x

    def feature(self, trunk: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv_embedding(trunk))


def semantic_seg_loss(
    seg_logits: torch.Tensor,  # (B, classes, H, W)
    labels: torch.Tensor,  # (B, H, W) int, `ignore_label` skipped
    ignore_label: int = 255,
    loss_weight: float = 0.2,
) -> torch.Tensor:
    """Pixel cross-entropy over the labelled pixels, in f32, times
    `loss_weight` (fused_semantic_head.py:100-106)."""
    logp = torch.log_softmax(seg_logits.float(), dim=1)
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    return loss_weight * torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
