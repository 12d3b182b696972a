"""DCM: nearest-class-mean classification of RoI features (JAX
`models/dcm.py`; the reference's DCM.py and DCM_bbox_head.py). A dump phase
averages the feature of every positive RoI by class (`CenterAccumulator`);
at test time RoIs are scored by the cosine similarity of their feature to
each class centre (`dcm_scores`). The feature is the bbox head's last shared
FC output, `SharedFCBBoxHead(..., return_feature=True)`. No CLI runs it, as
in the JAX package. The centres' `.npz` (key `centers`) loads in both."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class CenterAccumulator:
    """A streaming per-class feature mean (the dump phase), in float64."""

    def __init__(self, num_classes: int, feat_dim: int):
        self.sums = np.zeros((num_classes, feat_dim), np.float64)
        self.counts = np.zeros(num_classes, np.int64)

    def update(self, features: np.ndarray, labels: np.ndarray, valid: np.ndarray) -> None:
        """features (N, D); labels (N,) 1-based (0, background, is skipped)."""
        for f, l, v in zip(features, labels, valid):
            if v and l > 0:
                self.sums[l] += f
                self.counts[l] += 1

    def centers(self) -> np.ndarray:
        """(C, D) f32 class means; a class never seen stays zero."""
        out = np.zeros_like(self.sums, np.float32)
        seen = self.counts > 0
        out[seen] = (self.sums[seen] / self.counts[seen, None]).astype(np.float32)
        return out


def dcm_scores(
    features: torch.Tensor,  # (N, D) RoI features
    centers: torch.Tensor,  # (C, D) class centres, row 0 (background) zero
    bg_score: Optional[torch.Tensor] = None,  # (N,) the head's background probability
) -> torch.Tensor:
    """(N, C) f32 cosine similarities of the normalised features and centres
    (norms floored at 1e-12, so a zero centre scores 0); column 0 is
    `bg_score` where one is given."""
    f = features.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    c = centers.float()
    c = c / c.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sims = f @ c.T
    if bg_score is not None:
        sims[:, 0] = bg_score
    return sims


def save_centers(path: str, centers: np.ndarray) -> None:
    np.savez(path, centers=centers)


def load_centers(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z["centers"]
