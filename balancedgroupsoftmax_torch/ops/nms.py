"""Exact greedy NMS keep masks: kernels K1, K3, K4 and K5 and their plain versions.

`nms_keep_batched` (K1) replaces JAX `pallas/nms.py`
`nms_keep_batched` (:304); `nms_keep_gathered` (K3) replaces its
`nms_keep_gathered` (:371); `nms_keep_tiled` (K4) replaces its
`nms_keep_tiled` (:213); `nms_keep_batched_coords` (K5) replaces its
`nms_keep_batched_coords` (:316). Each launches its CUDA kernel of `csrc/nms.cu` on a
CUDA tensor and runs the plain PyTorch version below on a CPU tensor.

On top of K1, `nms_keep` and `nms` are JAX `ops/nms.py` `nms_keep` (:33) on
unsorted rows and `nms` (:77), the merges of test-time augmentation;
`soft_nms` (:103) is plain PyTorch on every device, as JAX runs it as XLA
(there is no TPU kernel to port).

Semantics (JAX `ops/nms.py` `nms_keep` :33 on presorted
rows): box i suppresses box j when i < j, both are valid and
iou(i, j) > thr under the +1 convention; a box is kept when it is valid and no
kept box suppresses it. Invalid slots neither keep nor suppress.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import cuda
from .boxes import bbox_overlaps
from .topk import top_k


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


def _launch_keep(
    kernel: cuda.Kernel, boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float, layout: str = "rows"
) -> torch.Tensor:
    g, k = valid.shape
    cuda.check(boxes, torch.float32, (g, k, 4) if layout == "rows" else (g, 4, k), "boxes")
    cuda.check(valid, torch.bool, (g, k), "valid")
    keep = torch.empty(g, k, dtype=torch.bool, device=boxes.device)
    mask = torch.empty(g, k, -(-k // 64), dtype=torch.int64, device=boxes.device)  # scratch
    if g and k:
        kernel(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(), g, k, float(iou_thr))
    return keep


def nms_keep_batched(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K1: greedy keep mask per row (the test-time RPN's K = 1000). boxes (G,
    K, 4) f32, valid (G, K) bool; K <= 46272 (the mask pass's grid): the mask
    pass builds the upper 64 x 64 tiles of each row's mask over the card, then
    a block a row walks it 64 boxes a chunk from device memory, as K4 does."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thr)
    return _launch_keep(cuda.NMS_KEEP, boxes, valid, iou_thr)


def nms_keep_tiled(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K4: the K1 keep mask for long rows (the training RPN's K = 2000; K <=
    46272), on K1's kernels."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, iou_thr)
    return _launch_keep(cuda.NMS_KEEP_TILED, boxes, valid, iou_thr)


def nms_keep_batched_coords(coords: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """K5: the K1 keep mask of coordinate planes, coords (G, 4, K) f32 (rows
    x1, y1, x2, y2; columns in score order), valid (G, K) bool; K <= 1344
    (a row's mask in one block's shared memory). Its plain version is K1's
    on the transposed boxes."""
    if coords.device.type == "cpu":
        return nms_keep_reference(coords.transpose(1, 2), valid, iou_thr)
    return _launch_keep(cuda.NMS_KEEP_COORDS, coords, valid, iou_thr, layout="planes")


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
    """K3: candidate gather + greedy keep, (keep, cand) as above; K <= 1344
    (K5's walk holds a row's mask in one block's shared memory). The mask
    pass gathers each box through idx and writes cand, then K5's walk runs."""
    if planes.device.type == "cpu":
        return nms_keep_gathered_reference(planes, idx, valid, iou_thr)
    g, k = valid.shape
    n = planes.shape[-1]
    cuda.check(planes, torch.float32, (g, 4, n), "planes")
    cuda.check(idx, torch.int32, (g, k), "idx")
    cuda.check(valid, torch.bool, (g, k), "valid")
    keep = torch.empty(g, k, dtype=torch.bool, device=planes.device)
    cand = torch.empty(g, 4, k, dtype=torch.float32, device=planes.device)
    mask = torch.empty(g, k, -(-k // 64), dtype=torch.int64, device=planes.device)  # scratch
    if g and k:
        cuda.NMS_KEEP_GATHERED(
            planes.data_ptr(), idx.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            cand.data_ptr(), mask.data_ptr(), g, k, n, float(iou_thr),
        )
    return keep, cand



def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Greedy keep mask of unsorted rows (ops/nms.py `nms_keep` :33): boxes
    (G, N, 4) f32, scores and valid (G, N) -> (G, N) bool in input order.
    Each row is sorted by descending score, ties by index (the stable
    `argsort(-s)` of :51, invalid slots last), K1 takes the sorted rows
    (N <= 46272), and the mask is scattered back."""
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-s, dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    keep_sorted = nms_keep_batched(sorted_boxes, torch.gather(valid, 1, order), iou_thr)
    return torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thr: float, max_out: int):
    """The top `max_out` kept boxes of each row by score (ops/nms.py `nms`
    :77): boxes (G, N, 4), scores and valid (G, N) -> (boxes (G, max_out, 4),
    scores (G, max_out), valid (G, max_out)), slots past the kept boxes
    invalid with score 0."""
    keep = nms_keep(boxes, scores, valid, iou_thr)
    kept = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    n = scores.shape[-1]
    k = min(max_out, n)
    top, idx = top_k(kept, k)
    if k < max_out:
        top = F.pad(top, (0, max_out - k), value=-torch.inf)
        idx = F.pad(idx, (0, max_out - k))
    out_valid = torch.isfinite(top)
    out_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return out_boxes, torch.where(out_valid, top, torch.zeros_like(top)), out_valid


def soft_nms(
    boxes: torch.Tensor,  # (G, N, 4)
    scores: torch.Tensor,  # (G, N)
    valid: torch.Tensor,  # (G, N) bool
    iou_thr: float = 0.3,
    method: str = "linear",  # "linear", "gaussian" or "naive" (hard NMS)
    sigma: float = 0.5,
    min_score: float = 1e-3,
    max_out: int = 300,
):
    """Soft-NMS of each row (ops/nms.py `soft_nms` :103, soft_nms_cpu.pyx):
    `max_out` times, take the live box of the highest score (the first of
    equal ones), while that score is above `min_score`, and decay the live
    scores by its IoU with them: 1 - IoU above `iou_thr` ("linear"),
    exp(-IoU^2 / sigma) ("gaussian"), or 0 above `iou_thr` ("naive").
    Returns (boxes (G, max_out, 4), scores (G, max_out), valid (G, max_out))
    in selection order; the slots after the last taken one hold the row's
    first box with score 0, invalid. Plain PyTorch: a few dozen small
    kernels an iteration on the card."""
    g = boxes.shape[0]
    boxes = boxes.float()
    live = torch.where(valid, scores.float(), torch.full_like(scores, -torch.inf, dtype=torch.float32))
    out_idx = torch.zeros(g, max_out, dtype=torch.long, device=boxes.device)
    out_score = torch.zeros(g, max_out, device=boxes.device)
    out_n = torch.zeros(g, 1, dtype=torch.long, device=boxes.device)
    zero = torch.zeros((), device=boxes.device)
    for _ in range(max_out):
        i = live.argmax(dim=-1, keepdim=True)  # (G, 1): the first maximum
        s_i = torch.gather(live, 1, i)
        take = s_i > min_score
        iou = bbox_overlaps(torch.gather(boxes, 1, i[..., None].expand(-1, 1, 4)), boxes)[:, 0]  # (G, N)
        if method == "linear":
            decay = torch.where(iou > iou_thr, 1.0 - iou, 1.0)
        elif method == "gaussian":
            decay = torch.exp(-(iou * iou) / sigma)
        else:
            decay = torch.where(iou > iou_thr, 0.0, 1.0)
        new_live = torch.where(live > -torch.inf, live * decay, live).scatter_(1, i, -torch.inf)
        out_idx.scatter_(1, out_n, torch.where(take, i, 0))
        out_score.scatter_(1, out_n, torch.where(take, s_i, zero))
        out_n += take
        live = torch.where(take, new_live, live)
    out_valid = torch.arange(max_out, device=boxes.device) < out_n
    return torch.gather(boxes, 1, out_idx[..., None].expand(-1, -1, 4)), out_score, out_valid
