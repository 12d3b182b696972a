"""FCN mask head of HTC and its loss (JAX `models/mask_head.py`
`_ClassSelect1x1` :18, `FCNMaskHead` :60, `mask_head_loss` :119).

`num_convs` 3x3 convs with relu, a 2x2 stride-2 transposed conv with relu,
then the per-class 1x1 logits. With the mask information flow, `conv_res`
(1x1) maps the previous stage's conv feature onto the RoI feature and adds it
(htc_mask_head.py). Given labels (0-based foreground classes, clipped into
range as in JAX), each RoI's logits are only its class's map: the selected
row of the 1x1 kernel dotted with the feature, so no (N, classes, 2S, 2S)
tensor is formed, and in training only the selected rows get a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MaskHeadConfig
from .layers import Conv2d, ConvTranspose2d


class FCNMaskHead(nn.Module):
    def __init__(self, cfg: MaskHeadConfig, with_conv_res: bool = False):
        super().__init__()
        c = cfg
        self.class_agnostic = c.class_agnostic
        self.conv_res = Conv2d(c.conv_out_channels, c.in_channels, 1) if with_conv_res else None
        self.convs = nn.ModuleList(
            Conv2d(c.in_channels if i == 0 else c.conv_out_channels, c.conv_out_channels, 3, padding=1)
            for i in range(c.num_convs)
        )
        self.upsample = ConvTranspose2d(c.conv_out_channels, c.conv_out_channels, 2, stride=2)
        self.conv_logits = Conv2d(c.conv_out_channels, 1 if c.class_agnostic else c.num_classes - 1, 1)

    def forward(
        self,
        x: torch.Tensor,  # (N, C, S, S) RoI features
        res_feat: Optional[torch.Tensor] = None,  # (N, C', S, S) previous stage's feature
        labels: Optional[torch.Tensor] = None,  # (N,) 0-based foreground class
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (N, num_out, 2S, 2S), or (N, 2S, 2S) for the labels'
        classes; the conv feature (N, C', S, S) that feeds the next stage)."""
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = F.relu(conv(x))
        feat = x
        x = F.relu(self.upsample(x))
        if labels is None or self.class_agnostic:
            return self.conv_logits(x), feat
        idx = labels.long().clamp(0, self.conv_logits.out_channels - 1)
        wsel = self.conv_logits.weight[idx, :, 0, 0].to(x.dtype)  # (N, C)
        bsel = self.conv_logits.bias[idx].float()
        logits = torch.einsum("nchw,nc->nhw", x, wsel).float() + bsel[:, None, None]
        return logits.to(x.dtype), feat


def mask_head_loss(
    mask_logits: torch.Tensor,  # (N, M, M) class-selected, or (N, num_out, M, M)
    mask_targets: torch.Tensor,  # (N, M, M) binary
    labels: torch.Tensor,  # (N,) 1-based gt class, 0 background
    pos_mask: torch.Tensor,  # (N,) bool
    class_agnostic: bool = False,
    preselected: bool = False,
) -> torch.Tensor:
    """Binary cross-entropy of the target class's mask, each RoI's mean over
    its pixels, averaged over the positives (fcn_mask_head.py:109-123).
    `preselected` marks logits the head already gathered to the target class
    (its `labels` path)."""
    if preselected:
        sel = mask_logits
    elif class_agnostic:
        sel = mask_logits[:, 0]
    else:
        idx = (labels.long() - 1).clamp(0, mask_logits.shape[1] - 1)
        sel = mask_logits[torch.arange(mask_logits.shape[0], device=idx.device), idx]
    x = sel.float()
    bce = x.clamp(min=0) - x * mask_targets + torch.log1p(torch.exp(-x.abs()))
    per = bce.mean(dim=(1, 2))
    return (per * pos_mask).sum() / pos_mask.sum().clamp(min=1)
