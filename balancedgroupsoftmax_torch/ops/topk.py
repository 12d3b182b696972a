"""Top-k with `jax.lax.top_k`'s order."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim, in
    descending order, ties broken by the lower index as `jax.lax.top_k` does.

    `torch.topk` leaves the order of ties unspecified, so this takes the
    first k of a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
