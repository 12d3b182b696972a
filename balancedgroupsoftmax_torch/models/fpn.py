"""Feature Pyramid Network (JAX `models/fpn.py`):
lateral 1x1 convs, top-down nearest x2 upsampling, 3x3 output convs and
stride-2 max-pool extra levels; no norm, no activation."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), each pixel repeated 2 x 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral = nn.ModuleList(Conv2d(c, out_channels, 1) for c in in_channels)
        self.fpn = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels
        )

    def forward(self, inputs: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(laterals[i])
        outs = [conv(x) for conv, x in zip(self.fpn, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)
