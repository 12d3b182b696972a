"""Max-IoU assignment over fixed-capacity padded boxes (JAX
`core/assigner.py` `assign_max_iou` :34), batched over leading dims.

`gt_inds`: -1 ignore, 0 negative, >0 the 1-based index of the assigned gt.
Padded gts and padded proposals take overlap -1, below every threshold;
padded proposals are always ignored.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor  # (..., N) int32: -1 ignore / 0 neg / 1-based gt index
    max_overlaps: torch.Tensor  # (..., N) f32
    labels: torch.Tensor  # (..., N) int32 class of the assigned gt, 0 if none


def assign_max_iou(
    proposals: torch.Tensor,  # (..., N, 4)
    prop_mask: torch.Tensor,  # (..., N) bool
    gt_boxes: torch.Tensor,  # (..., G, 4)
    gt_labels: torch.Tensor,  # (..., G) int, 1-based
    gt_mask: torch.Tensor,  # (..., G) bool
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float = 0.0,
    gt_max_assign_all: bool = True,
) -> AssignResult:
    """The reference's four steps: ignore, negatives below `neg_iou_thr`,
    positives at or above `pos_iou_thr`, then each gt claims the proposals
    that tie its best overlap (the last claiming gt wins). Ties in the
    argmax take the first index, as in JAX."""
    overlaps = bbox_overlaps(gt_boxes, proposals)  # (..., G, N)
    overlaps = torch.where(
        gt_mask[..., :, None] & prop_mask[..., None, :], overlaps, torch.full_like(overlaps, -1.0)
    )
    max_overlaps = overlaps.amax(dim=-2)  # (..., N)
    argmax_overlaps = overlaps.argmax(dim=-2)  # the first of equal maxima
    gt_max_overlaps = overlaps.amax(dim=-1)  # (..., G)

    gt_inds = torch.full_like(max_overlaps, -1, dtype=torch.int32)
    gt_inds = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr), 0, gt_inds)
    gt_inds = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps.to(torch.int32) + 1, gt_inds)

    best = gt_max_overlaps[..., :, None]
    claim = (
        (overlaps == best)
        & (best >= min_pos_iou)
        & gt_mask[..., :, None]
        & prop_mask[..., None, :]
        & (best > -1.0)
    )
    if not gt_max_assign_all:
        onehot = torch.zeros_like(claim).scatter_(-1, overlaps.argmax(dim=-1, keepdim=True), True)
        claim = claim & onehot
    g = claim.shape[-2]
    g_idx = torch.arange(1, g + 1, dtype=torch.int32, device=claim.device)[:, None]
    claimed_by = torch.where(claim, g_idx, 0).amax(dim=-2)  # (..., N), 0 = none
    gt_inds = torch.where(claimed_by > 0, claimed_by, gt_inds)
    gt_inds = torch.where(prop_mask, gt_inds, -1)

    safe = (gt_inds - 1).clamp(0, g - 1).long()
    labels = torch.where(gt_inds > 0, torch.gather(gt_labels.to(torch.int32), -1, safe), 0)
    return AssignResult(gt_inds=gt_inds, max_overlaps=max_overlaps, labels=labels.to(torch.int32))
