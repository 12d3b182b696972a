"""Random positive / negative sampling with static output shapes (JAX
`core/sampler.py`: `_rank_among` :38, `sample_pos_neg` :48,
`add_gt_as_proposals` :176), batched over leading dims.

Up to `num * pos_fraction` positives, then negatives up to `num`, positives
first, each side in the order of its random priorities. The priorities are
uniform draws from the caller's `torch.Generator` unless passed in; the JAX
package draws them from `jax.random`, so a test hands both the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.topk import top_k
from .assigner import AssignResult


class SamplingResult(NamedTuple):
    inds: torch.Tensor  # (..., num) int64 indices into the candidates
    is_pos: torch.Tensor  # (..., num) bool: the slot holds a positive
    valid: torch.Tensor  # (..., num) bool: the slot holds any sample
    num_pos: torch.Tensor  # (...,) int64
    num_neg: torch.Tensor  # (...,) int64


def _rank_among(mask: torch.Tensor, priority: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each masked element by descending priority along the
    last dim, equal priorities by index (a stable sort, as `jnp.argsort`);
    unmasked elements get a rank past the end."""
    n = mask.shape[-1]
    p = torch.where(mask, priority.float(), torch.full_like(priority, -torch.inf, dtype=torch.float32))
    order = torch.argsort(-p, dim=-1, stable=True)
    arange = torch.arange(n, device=mask.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(-1, order, arange)
    return torch.where(mask, ranks, n)


def sample_pos_neg(
    assign: AssignResult,
    num: int,
    pos_fraction: float,
    generator: Optional[torch.Generator] = None,
    pos_priority: Optional[torch.Tensor] = None,
    neg_priority: Optional[torch.Tensor] = None,
) -> SamplingResult:
    """Sample `num` candidates: up to num * pos_fraction positives, the rest
    negatives. Priorities default to uniform draws from `generator`."""
    gt_inds = assign.gt_inds
    n = gt_inds.shape[-1]
    num_expected_pos = int(num * pos_fraction)
    is_pos_cand = gt_inds > 0
    is_neg_cand = gt_inds == 0
    if pos_priority is None:
        pos_priority = torch.rand(gt_inds.shape, generator=generator, device=gt_inds.device)
    if neg_priority is None:
        neg_priority = torch.rand(gt_inds.shape, generator=generator, device=gt_inds.device)
    pos_rank = _rank_among(is_pos_cand, pos_priority)
    neg_rank = _rank_among(is_neg_cand, neg_priority)

    pos_elig = is_pos_cand & (pos_rank < num_expected_pos)
    n_pos = pos_elig.sum(dim=-1)
    neg_elig = is_neg_cand & (neg_rank < (num - n_pos)[..., None])
    n_neg = neg_elig.sum(dim=-1)

    # positives first (2 - rank / n), then negatives (1 - rank / n)
    prio = torch.where(
        pos_elig,
        2.0 - pos_rank.float() / n,
        torch.where(neg_elig, 1.0 - neg_rank.float() / n, torch.full_like(pos_rank, -torch.inf, dtype=torch.float32)),
    )
    k = min(num, n)
    top_prio, inds = top_k(prio, k)
    if k < num:  # fewer candidates than slots: pad with invalid slots
        top_prio = F.pad(top_prio, (0, num - k), value=-torch.inf)
        inds = F.pad(inds, (0, num - k))
    slot = torch.arange(num, device=gt_inds.device)
    return SamplingResult(
        inds=inds,
        is_pos=slot < n_pos[..., None],
        valid=(slot < (n_pos + n_neg)[..., None]) & torch.isfinite(top_prio),
        num_pos=n_pos,
        num_neg=n_neg,
    )


def add_gt_as_proposals(
    proposals: torch.Tensor,  # (..., P, 4)
    prop_mask: torch.Tensor,  # (..., P) bool
    assign: AssignResult,
    gt_boxes: torch.Tensor,  # (..., G, 4)
    gt_labels: torch.Tensor,  # (..., G) int
    gt_mask: torch.Tensor,  # (..., G) bool
):
    """Prepend the gt boxes as self-assigned proposals (gt index i + 1,
    overlap 1). Returns (boxes (..., G + P, 4), mask (..., G + P), the
    AssignResult over G + P)."""
    g = gt_boxes.shape[-2]
    boxes = torch.cat([gt_boxes.to(proposals.dtype), proposals], dim=-2)
    mask = torch.cat([gt_mask, prop_mask], dim=-1)
    gt_self = torch.where(gt_mask, torch.arange(1, g + 1, dtype=torch.int32, device=gt_mask.device), -1)
    new_assign = AssignResult(
        gt_inds=torch.cat([gt_self, assign.gt_inds], dim=-1),
        max_overlaps=torch.cat([gt_mask.float(), assign.max_overlaps], dim=-1),
        labels=torch.cat([torch.where(gt_mask, gt_labels.to(torch.int32), 0), assign.labels], dim=-1),
    )
    return boxes, mask, new_assign
