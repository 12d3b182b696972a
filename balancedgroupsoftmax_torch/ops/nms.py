"""Exact greedy NMS keep masks: kernels K1, K3 and K4 and their plain versions.

`nms_keep_batched` (K1) replaces JAX `pallas/nms.py`
`nms_keep_batched` (:304); `nms_keep_gathered` (K3) replaces its
`nms_keep_gathered` (:371); `nms_keep_tiled` (K4) replaces its
`nms_keep_tiled` (:213). Each launches its CUDA kernel of `csrc/nms.cu` on a
CUDA tensor and runs the plain PyTorch version below on a CPU tensor.

Semantics (JAX `ops/nms.py` `nms_keep` :33 on presorted
rows): box i suppresses box j when i < j, both are valid and
iou(i, j) > thr under the +1 convention; a box is kept when it is valid and no
kept box suppresses it. Invalid slots neither keep nor suppress.
"""

from __future__ import annotations

import torch

from .. import cuda
from .boxes import bbox_overlaps


def nms_keep_reference(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Plain version of K1: the keep fixpoint of ops/nms.py `nms_keep`.

    boxes (G, K, 4) f32 rows in score order, valid (G, K) bool -> (G, K) bool.
    Each round keeps the valid boxes that no kept box suppresses; starting
    from all valid boxes it settles on the greedy result."""
    boxes = boxes.float()
    k = boxes.shape[1]
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    # adj[g, i, j]: box i may suppress box j
    adj = (bbox_overlaps(boxes, boxes) > iou_thr) & upper & valid[:, :, None] & valid[:, None, :]
    keep = valid
    while True:
        suppressed = (keep[:, :, None] & adj).any(dim=1)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def _launch_keep(kernel: cuda.Kernel, boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    g, k = valid.shape
    cuda.check(boxes, torch.float32, (g, k, 4), "boxes")
    cuda.check(valid, torch.bool, (g, k), "valid")
    keep = torch.empty(g, k, dtype=torch.bool, device=boxes.device)
    mask = torch.empty(g, k, -(-k // 64), dtype=torch.int64, device=boxes.device)  # scratch
    if g and k:
        kernel(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(), g, k, float(iou_thr))
    return keep


def nms_keep_batched(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K1: greedy keep mask per row. boxes (G, K, 4) f32, valid (G, K) bool;
    the walk holds a row's mask in shared memory, so K <= ~1350."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thr)
    return _launch_keep(cuda.NMS_KEEP, boxes, valid, iou_thr)


def nms_keep_tiled(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K4: the K1 keep mask for any K (the training RPN's K = 2000); the walk
    streams each row's mask from device memory."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thr)
    return _launch_keep(cuda.NMS_KEEP_TILED, boxes, valid, iou_thr)


def nms_keep_gathered_reference(
    planes: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, iou_thr: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: gather, then the K1 keep.

    planes (G, 4, N) f32, idx (G, K) int, valid (G, K) bool ->
    (keep (G, K) bool, cand (G, 4, K) f32), cand[g, :, k] = planes[g, :, idx[g, k]];
    an index outside [0, N) gathers 0, as the TPU's one-hot gather does."""
    n = planes.shape[-1]
    inside = (idx >= 0) & (idx < n)
    safe = torch.where(inside, idx, torch.zeros_like(idx)).long()
    cand = torch.gather(planes.float(), 2, safe[:, None, :].expand(-1, 4, -1))
    cand = torch.where(inside[:, None, :], cand, torch.zeros_like(cand))
    keep = nms_keep_reference(cand.transpose(1, 2), valid, iou_thr)
    return keep, cand


def nms_keep_gathered(
    planes: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, iou_thr: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: fused candidate gather + greedy keep, (keep, cand) as above."""
    if planes.device.type == "cpu":
        return nms_keep_gathered_reference(planes, idx, valid, iou_thr)
    g, k = valid.shape
    n = planes.shape[-1]
    cuda.check(planes, torch.float32, (g, 4, n), "planes")
    cuda.check(idx, torch.int32, (g, k), "idx")
    cuda.check(valid, torch.bool, (g, k), "valid")
    keep = torch.empty(g, k, dtype=torch.bool, device=planes.device)
    cand = torch.empty(g, 4, k, dtype=torch.float32, device=planes.device)
    if g and k:
        cuda.NMS_KEEP_GATHERED(
            planes.data_ptr(), idx.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            cand.data_ptr(), g, k, n, float(iou_thr),
        )
    return keep, cand

