"""The heads of the Double-Head and Mask-Scoring R-CNN variants (JAX
`models/extra_heads.py`: `DoubleConvFCBBoxHead` :51, `MaskIoUHead` :109,
`mask_iou_target` :140).

The layers keep the flax names, so `convert.py` maps them one to one.
Convolutions run NCHW; where a flax head flattens NHWC features into a dense
layer, the port permutes to NHWC first, so the dense kernels convert as they
are. Every dense layer is flax's default lecun-normal, but the Double-Head's
`fc_cls` (normal 0.01) and `fc_reg` (normal 0.001): `init_special` tells
`FasterRCNN.init_weights` so.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear


class DoubleConvFCBBoxHead(nn.Module):
    """double_bbox_head.py: a conv branch (a 1x1 conv, then bottlenecks, a
    global average pool) regresses, an fc branch (two FCs on the flattened
    features) classifies."""

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        roi_feat_size: int = 7,
        num_convs: int = 4,
        num_fcs: int = 2,
        conv_out_channels: int = 1024,
        fc_out_channels: int = 1024,
        reg_class_agnostic: bool = False,
    ):
        super().__init__()
        self.num_convs, self.num_fcs = num_convs, num_fcs
        mid = conv_out_channels // 4
        self.res_in = Conv2d(in_channels, conv_out_channels, 1)
        for i in range(num_convs):
            self.add_module(f"res{i}_conv1", Conv2d(conv_out_channels, mid, 1))
            self.add_module(f"res{i}_conv2", Conv2d(mid, mid, 3, padding=1))
            self.add_module(f"res{i}_conv3", Conv2d(mid, conv_out_channels, 1))
        self.fc_reg = Linear(conv_out_channels, 4 if reg_class_agnostic else 4 * num_classes)
        in_dim = in_channels * roi_feat_size**2
        for i in range(num_fcs):
            self.add_module(f"fc{i}", Linear(in_dim if i == 0 else fc_out_channels, fc_out_channels))
        self.fc_cls = Linear(fc_out_channels, num_classes)

    def init_special(self) -> dict:
        fcs = {getattr(self, f"fc{i}"): ("lecun", None) for i in range(self.num_fcs)}
        return {**fcs, self.fc_cls: ("normal", 0.01), self.fc_reg: ("normal", 0.001)}

    def forward(self, roi_feats: torch.Tensor, reg_feats: Optional[torch.Tensor] = None):
        """roi_feats (..., S, S, C) channels-last -> (cls_logits (..., K),
        bbox_deltas (..., 4K or 4)); `reg_feats` (the Double-Head's pooling
        of inflated rois) feeds the conv branch when given."""
        reg_feats = roi_feats if reg_feats is None else reg_feats
        lead = roi_feats.shape[:-3]
        x = self.res_in(reg_feats.reshape(-1, *reg_feats.shape[-3:]).permute(0, 3, 1, 2))
        for i in range(self.num_convs):
            y = F.relu(getattr(self, f"res{i}_conv1")(x))
            y = F.relu(getattr(self, f"res{i}_conv2")(y))
            x = F.relu(x + getattr(self, f"res{i}_conv3")(y))
        bbox_deltas = self.fc_reg(x.mean(dim=(2, 3))).reshape(*lead, -1)
        z = roi_feats.flatten(-3)
        for i in range(self.num_fcs):
            z = F.relu(getattr(self, f"fc{i}")(z))
        return self.fc_cls(z), bbox_deltas


class MaskIoUHead(nn.Module):
    """maskiou_head.py: the IoU of each RoI's predicted mask with its gt,
    one output a foreground class, from the mask features and the predicted
    mask max-pooled to their size."""

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        roi_feat_size: int = 14,
        num_convs: int = 4,
        num_fcs: int = 2,
        conv_out_channels: int = 256,
        fc_out_channels: int = 1024,
    ):
        super().__init__()
        self.num_convs, self.num_fcs = num_convs, num_fcs
        for i in range(num_convs):
            stride = 2 if i == num_convs - 1 else 1
            c_in = in_channels + 1 if i == 0 else conv_out_channels
            self.add_module(f"conv{i}", Conv2d(c_in, conv_out_channels, 3, stride=stride, padding=1))
        in_dim = conv_out_channels * (roi_feat_size // 2) ** 2
        for i in range(num_fcs):
            self.add_module(f"fc{i}", Linear(in_dim if i == 0 else fc_out_channels, fc_out_channels))
        self.fc_mask_iou = Linear(fc_out_channels, num_classes - 1)

    def init_special(self) -> dict:
        fcs = [getattr(self, f"fc{i}") for i in range(self.num_fcs)] + [self.fc_mask_iou]
        return {fc: ("lecun", None) for fc in fcs}

    def forward(self, mask_feats: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
        """mask_feats (N, C, S, S), mask_pred (N, 2S, 2S) f32 probabilities of
        the RoI's class -> (N, num_classes - 1) mask IoU logits."""
        mp = F.max_pool2d(mask_pred[:, None], 2, 2).to(mask_feats.dtype)
        x = torch.cat([mask_feats, mp], dim=1)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        # flattened H-W-C, as the flax head's `fc0` reads it
        x = x.permute(0, 2, 3, 1).flatten(1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.fc_mask_iou(x)


def mask_iou_target(
    mask_pred: torch.Tensor,  # (N, M, M) predicted probabilities
    mask_targets: torch.Tensor,  # (N, M, M) gt masks inside the proposals
    full_areas: torch.Tensor,  # (N,) the share of each gt's area inside its proposal
) -> torch.Tensor:
    """The MaskIoU target (maskiou_head.py get_target): the IoU of the
    prediction thresholded at 0.5 with the gt, the gt's area corrected for
    its part outside the proposal."""
    pred = (mask_pred > 0.5).float()
    inter = (pred * mask_targets).sum(dim=(-2, -1))
    gt_full = mask_targets.sum(dim=(-2, -1)) / full_areas.clamp(1e-6, 1.0)
    union = pred.sum(dim=(-2, -1)) + gt_full - inter
    return inter / union.clamp(min=1.0)
