"""Grouped-softmax score merging at inference
(JAX `gs/head.py` `gs_merge_scores` :123)."""

from __future__ import annotations

import torch

from .partition import GSPartition


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
