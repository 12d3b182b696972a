"""Weighted detection losses (JAX `ops/losses.py`).

`loss = sum(elementwise * weight) / avg_factor`, as the reference's
reduction helpers compute it, so padded slots of fixed-capacity arrays
contribute exactly zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weight_reduce(loss: torch.Tensor, weight=None, avg_factor=None) -> torch.Tensor:
    """(losses.py:18)"""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor


def softmax_cross_entropy(logits, labels, weight=None, avg_factor=None) -> torch.Tensor:
    """CE over the last dim; labels int (...) (losses.py:26)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return weight_reduce(nll, weight, avg_factor)


def binary_cross_entropy_with_logits(logits, targets, weight=None, avg_factor=None) -> torch.Tensor:
    """Sigmoid BCE in the stable form of losses.py:35."""
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return weight_reduce(loss, weight, avg_factor)


def smooth_l1(pred, target, beta: float = 1.0, weight=None, avg_factor=None) -> torch.Tensor:
    """Huber loss (losses.py:41); `weight` broadcasts elementwise."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weight_reduce(loss, weight, avg_factor)


def sigmoid_focal_loss(logits, targets, weight=None, gamma: float = 2.0, alpha: float = 0.25, avg_factor=None):
    """Focal loss in the stable form of losses.py:48 (mmdet focal_loss.py:10-21):
    `targets` one-hot floats of the logits' shape."""
    p = torch.sigmoid(logits)
    pt = torch.where(targets > 0, 1 - p, p)
    focal_weight = (alpha * targets + (1 - alpha) * (1 - targets)) * pt**gamma
    bce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return weight_reduce(bce * focal_weight, weight, avg_factor)


def weighted_softmax_cross_entropy_per_class(logits, labels, class_weights, weight=None, avg_factor=None):
    """CE with each sample's weight times its target class's weight
    (losses.py:65; ReweightBBoxHead, reweight_bbox_head.py:27-55)."""
    cw = class_weights[labels.long()]
    w = cw if weight is None else weight * cw
    return softmax_cross_entropy(logits, labels, weight=w, avg_factor=avg_factor)


def accuracy(logits, labels, mask=None) -> torch.Tensor:
    """Top-1 accuracy over the entries where `mask` is set (losses.py:177)."""
    correct = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        return (correct * mask).sum() / mask.sum().clamp(min=1.0)
    return correct.mean()
