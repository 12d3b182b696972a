"""ResNet / ResNeXt backbone (JAX `models/resnet.py`).

Torchvision-style bottlenecks (stride on the 3x3, style='pytorch') with
BatchNorm frozen at its running statistics, as every reference config runs it
(norm_eval=True). With groups > 1 the 3x3 is grouped and the block's width
follows ResNeXt's rule (`Bottleneck` :68-75); the stages of `dcn_stages` make
it a deformable convolution (ops/deform_conv.py, kernel K7), grouped by
`dcn_groups` or else by `groups`. Tensors are NCHW; the detector keeps them in
channels-last memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import DeformConv
from .layers import Conv2d

ARCH_SETTINGS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """BN with frozen statistics (resnet.py:33): the scale and shift are
    formed in f32 and applied in the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(
        self,
        in_ch: int,
        planes: int,
        stride: int = 1,
        groups: int = 1,
        base_width: int = 4,
        use_dcn: bool = False,
        dcn_modulated: bool = False,
        dcn_groups: int = 0,
        dcn_shift_window: int = 0,
    ):
        super().__init__()
        out_ch = planes * self.expansion
        width = planes if groups == 1 else int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        if use_dcn:
            self.conv2 = DeformConv(
                width, width, 3, stride, 1, dcn_modulated, dcn_groups or groups, dcn_shift_window
            )
        else:
            self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride=stride, bias=False), FrozenBatchNorm(out_ch)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(
        self,
        depth: int = 50,
        groups: int = 1,
        base_width: int = 4,
        dcn_stages: tuple = (False, False, False, False),
        dcn_modulated: bool = False,
        dcn_groups: int = 0,
        dcn_shift_window: int = 0,
    ):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch = 64
        for stage, num_blocks in enumerate(ARCH_SETTINGS[depth]):
            planes = 64 * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(
                    Bottleneck(
                        in_ch, planes, stride, groups, base_width, dcn_stages[stage],
                        dcn_modulated, dcn_groups, dcn_shift_window,
                    )
                )
                in_ch = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 3, H, W) -> the four stage outputs, strides 4 to 32."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            outs.append(x)
        return outs
