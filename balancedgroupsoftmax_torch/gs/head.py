"""The grouped-softmax loss and score merging
(JAX `gs/head.py` `gs_loss` :36, `gs_merge_scores` :123)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.losses import softmax_cross_entropy
from .partition import GSPartition


def gs_loss(
    cls_logits: torch.Tensor,  # (N, L), L = num_classes + num_bins
    labels: torch.Tensor,  # (N,) global labels, 0 = background
    roi_valid: torch.Tensor,  # (N,) bool
    partition: GSPartition,
    others_sample_ratio: float = 8.0,
    generator: Optional[torch.Generator] = None,
    others_priority: Optional[torch.Tensor] = None,  # (num_bins, N)
    class_weights: Optional[torch.Tensor] = None,  # (C,), GS-reweight
) -> Dict[str, torch.Tensor]:
    """Per-bin cross-entropy losses {"loss_cls_bin{i}": scalar}.

    Bin 0 ({bg, fg}) weighs every valid roi. Bin i > 0 weighs its own
    foreground rois and `others_sample_ratio` times as many of the others
    (rois whose within-bin label is 0), the others with the highest
    priorities -- uniform draws from `generator` unless `others_priority`
    (row i for bin i) is given; all of them when the budget covers them. A
    bin with no foreground in the batch has loss 0 (gs_bbox_head_with0.py:63-89).
    `class_weights` (GS-reweight, gs/head.py:93-94) scales each foreground
    roi's weight, inside its own bin, by its class's weight."""
    logits = cls_logits.float()
    dev = logits.device
    label2binlabel = torch.as_tensor(partition.label2binlabel, dtype=torch.long, device=dev)
    bins = logits.split(list(partition.bin_sizes), dim=-1)
    validf = roi_valid.float()
    n = labels.shape[0]
    labels = labels.long()
    losses = {}
    for i in range(partition.num_bins):
        bin_labels = label2binlabel[i][labels]
        if i == 0:
            weight = validf
        else:
            fg = (bin_labels > 0) & roi_valid
            others = roi_valid & ~fg
            fg_num = fg.sum()
            budget = (fg_num.float() * others_sample_ratio).to(torch.int64)
            prio = (
                torch.rand(n, generator=generator, device=dev) if others_priority is None else others_priority[i]
            )
            order = torch.argsort(-torch.where(others, prio.float(), -torch.inf), stable=True)
            ranks = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=dev))
            sampled = others & (ranks < budget)
            weight = torch.where(budget >= others.sum(), fg | others, fg | sampled).float()
            weight = torch.where(fg_num > 0, weight, 0.0)
            if class_weights is not None:
                weight = torch.where(fg, weight * class_weights[labels], weight)
        avg = weight.sum().clamp(min=1.0)
        losses[f"loss_cls_bin{i}"] = softmax_cross_entropy(bins[i], bin_labels, weight=weight, avg_factor=avg)
    return losses


def gs_merge_scores(cls_logits: torch.Tensor, partition: GSPartition) -> torch.Tensor:
    """(N, L) logits -> (N, num_classes) calibrated scores, f32.

    A softmax within each bin; every foreground class takes the probability
    at its own logit (`label2logit`) times bin 0's foreground probability;
    class 0 keeps bin 0's background probability."""
    logits = cls_logits.float()
    probs = torch.cat(
        [torch.softmax(b, dim=-1) for b in logits.split(list(partition.bin_sizes), dim=-1)],
        dim=-1,
    )
    label2logit = torch.as_tensor(partition.label2logit, dtype=torch.long, device=logits.device)
    gathered = probs[:, label2logit]  # (N, C): column 0 is bin 0's background
    return torch.cat([gathered[:, :1], gathered[:, 1:] * probs[:, 1:2]], dim=-1)
