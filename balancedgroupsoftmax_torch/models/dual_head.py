"""The dual-head tail-class score override, the test path of tau-norm-select
(JAX `models/dual_head.py`; the reference's `update_scores_with_reweight`,
test_mixins.py:70-136): a second classifier, the first one tau-normalised,
rescores the same proposals, and a RoI's whole score row is taken from it
where the second classifier's class is a tail class."""

from __future__ import annotations

import numpy as np
import torch


def tail_class_mask_from_counts(instance_counts: np.ndarray, threshold: int = 100) -> np.ndarray:
    """(C,) bool: the classes with fewer than `threshold` training instances
    (the reference's mask.pt rule); background (0) never."""
    m = np.asarray(instance_counts) < threshold
    m[0] = False
    return m


def update_scores_with_reweight(
    scores_main: torch.Tensor,  # (..., N, C) the main classifier's scores
    scores_back: torch.Tensor,  # (..., N, C) the second classifier's
    tail_mask: torch.Tensor,  # (C,) bool, the classes taken from the second
) -> torch.Tensor:
    """Each RoI's score row from the second classifier where the main one's
    class is not background and the second one's class is a tail class;
    elsewhere the main row. Leading dimensions (images) are kept."""
    # torch.argmax returns the first of tied maxima, as jnp.argmax does: ties
    # decide which rows are replaced
    cls_main = torch.argmax(scores_main, dim=-1)
    cls_back = torch.argmax(scores_back, dim=-1)
    cls_sel = torch.where(cls_main == 0, cls_main, cls_back)
    replace = tail_mask.to(torch.bool)[cls_sel]
    return torch.where(replace[..., None], scores_back, scores_main)
