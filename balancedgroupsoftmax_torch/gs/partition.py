"""Group partition of the BAGS head, in numpy.

A copy of JAX `gs/partition.py` (`GSPartition` :34, `make_partition` :58,
`partition_from_lvis` :108, `save_partition` :126, `load_partition` :136,
`synthetic_partition` :161, `class_weights_from_counts` :146); the files of
both packages are the same `.npz`.
Layout (B bins, C classes incl. background label 0, L = C + B logits):
- label2binlabel (B, C): global label -> within-bin label (0 = others/bg);
  row 0 is the {bg, fg} bin.
- pred_slice (B, 2): [start, length] of each bin's slice of the L logits.
- label2logit (C,): global label -> its own logit position (label 0 -> the
  bin-0 background slot).
- label2bin (C,): global label -> owning bin (0 for background).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)  # ndarray fields: compare by identity
class GSPartition:
    label2binlabel: np.ndarray  # (B, C) int32
    pred_slice: np.ndarray  # (B, 2) int32
    label2logit: np.ndarray  # (C,) int32
    label2bin: np.ndarray  # (C,) int32

    @property
    def num_bins(self) -> int:
        return int(self.label2binlabel.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.label2binlabel.shape[1])

    @property
    def num_logits(self) -> int:
        return int(self.pred_slice[-1, 0] + self.pred_slice[-1, 1])

    @property
    def bin_sizes(self) -> tuple:
        """Slice lengths per bin (static python ints for jit closure)."""
        return tuple(int(x) for x in self.pred_slice[:, 1])


def make_partition(
    instance_counts: np.ndarray,  # (C,) counts per label; index 0 (bg) ignored
    thresholds: Sequence[int] = (10, 100, 1000),
) -> GSPartition:
    """Build the partition from per-class instance counts.

    `instance_counts[l]` is the LVIS `instance_count` for contiguous label l
    (1-based; LVIS v0.5 category ids are already contiguous 1..1230,
    lvis_analyse.py:24-36 indexes label2binlabel directly with cat id).
    """
    c = int(instance_counts.shape[0])
    edges = [0, *thresholds, np.inf]
    num_fg_bins = len(edges) - 1
    num_bins = num_fg_bins + 1

    label2binlabel = np.zeros((num_bins, c), dtype=np.int32)
    label2bin = np.zeros(c, dtype=np.int32)
    # bin 0: {bg, fg} 2-way
    label2binlabel[0, 1:] = 1
    counters = [1] * num_bins
    counters[0] = 2
    for label in range(1, c):
        n = instance_counts[label]
        for b in range(num_fg_bins):
            if edges[b] <= n < edges[b + 1]:
                label2binlabel[b + 1, label] = counters[b + 1]
                counters[b + 1] += 1
                label2bin[label] = b + 1
                break

    pred_slice = np.zeros((num_bins, 2), dtype=np.int32)
    start = 0
    for b in range(num_bins):
        pred_slice[b, 0] = start
        pred_slice[b, 1] = counters[b]
        start += counters[b]

    label2logit = np.zeros(c, dtype=np.int32)
    label2logit[0] = 0  # bin-0 background slot
    for label in range(1, c):
        b = label2bin[label]
        label2logit[label] = pred_slice[b, 0] + label2binlabel[b, label]
    return GSPartition(
        label2binlabel=label2binlabel,
        pred_slice=pred_slice,
        label2logit=label2logit,
        label2bin=label2bin,
    )


def partition_from_lvis(ann_file: str, num_classes: int = 1231, thresholds=(10, 100, 1000)) -> GSPartition:
    """The partition of an LVIS annotation JSON, from each category's
    `instance_count` (lvis_analyse.py:23-25), category ids mapped to 1-based
    labels by ascending id."""
    import json

    with open(ann_file) as f:
        cats = sorted(json.load(f)["categories"], key=lambda x: x["id"])
    counts = np.zeros(num_classes, dtype=np.int64)
    for i, cat in enumerate(cats):
        counts[i + 1] = cat.get("instance_count", 0)
    return make_partition(counts, thresholds)


def save_partition(path: str, p: GSPartition) -> None:
    np.savez(
        path,
        label2binlabel=p.label2binlabel,
        pred_slice=p.pred_slice,
        label2logit=p.label2logit,
        label2bin=p.label2bin,
    )


def load_partition(path: str) -> GSPartition:
    with np.load(path) as z:
        return GSPartition(
            label2binlabel=z["label2binlabel"].astype(np.int32),
            pred_slice=z["pred_slice"].astype(np.int32),
            label2logit=z["label2logit"].astype(np.int32),
            label2bin=z["label2bin"].astype(np.int32),
        )


def synthetic_partition(
    num_classes: int = 1231, seed: int = 0, thresholds=(10, 100, 1000)
) -> GSPartition:
    """A long-tail-shaped partition for tests/benchmarks without LVIS data."""
    rng = np.random.RandomState(seed)
    # Zipf-ish instance counts spanning all four bins
    counts = np.floor(10000.0 / (1 + np.arange(num_classes)) ** 1.1).astype(np.int64)
    counts[0] = 0
    rng.shuffle(counts[1:])
    return make_partition(counts, thresholds)


def class_weights_from_counts(instance_counts: np.ndarray, clip: tuple = (0.1, 5.0)) -> np.ndarray:
    """Per-class CE weights of the re-weight baselines (partition.py:146;
    tools/lvis_analyse.py get_cate_weight :338-367): 1 / count, normalised
    by the foreground classes' mean, background 1, clipped to [0.1, 5]; in
    f64, returned as f32."""
    counts = np.asarray(instance_counts, np.float64).copy()
    counts[0] = 1.0
    w = 1.0 / np.maximum(counts, 1.0)
    w = w / w[1:].mean()
    w[0] = 1.0
    return np.clip(w, clip[0], clip[1]).astype(np.float32)
