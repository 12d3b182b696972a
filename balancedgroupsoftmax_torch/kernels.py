"""The detector's kernel-backed steps (JAX `kernels.py`).

Each function here runs the hand-written CUDA kernel on CUDA tensors and its
plain PyTorch version on CPU tensors; the choice is made inside the kernel
wrappers in ops/ from the tensors' device, with no other switch.

- `batched_multilevel_roi_align` -> K2, and K2b for its gradient
  (ops/roi_align.py)
- `batched_nms_topk` -> K1 (ops/nms.py `nms_keep_batched`) for K <= 1280, K4
  (`nms_keep_tiled`) above
- `batched_multiclass_nms`, class-specific hard NMS -> K3
  (ops/nms.py `nms_keep_gathered`); class-agnostic hard NMS -> K6
  (ops/gather.py `gather_lanes`), then K5 (ops/nms.py `nms_keep_batched_coords`);
  soft-NMS -> ops/nms.py `soft_nms`, plain PyTorch on every device, as JAX
  runs that branch as XLA on every device (kernels.py:142)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.gather import gather_lanes
from .ops.nms import nms_keep_batched, nms_keep_batched_coords, nms_keep_gathered, nms_keep_tiled, soft_nms
from .ops.roi_align import multilevel_roi_align as batched_multilevel_roi_align  # JAX kernels.py:26
from .ops.topk import top_k


def batched_nms_topk(
    boxes: torch.Tensor,  # (G, K, 4), rows score-descending
    scores: torch.Tensor,  # (G, K)
    valid: torch.Tensor,  # (G, K) bool
    iou_thr: float,
    max_out: int,
):
    """Greedy NMS per row, then the top `max_out` kept (kernels.py:50).

    Rows of up to 1280 boxes (the test-time RPN's 1000) go to K1, longer ones
    (the training RPN's 2000) to K4: the split of kernels.py:63-74.

    Returns (boxes (G, max_out, 4), scores (G, max_out), valid (G, max_out));
    slots beyond the kept boxes are invalid with score 0."""
    k = valid.shape[1]
    keep = (nms_keep_batched if k <= 1280 else nms_keep_tiled)(boxes, valid, iou_thr)
    masked = torch.where(keep & valid, scores, torch.full_like(scores, -torch.inf))
    m = min(max_out, k)
    top, idx = top_k(masked, m)
    if m < max_out:
        top = F.pad(top, (0, max_out - m), value=-torch.inf)
        idx = F.pad(idx, (0, max_out - m))
    out_valid = torch.isfinite(top)
    out_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return out_boxes, torch.where(out_valid, top, torch.zeros_like(top)), out_valid


def batched_multiclass_nms(
    boxes: torch.Tensor,  # (B, N, C * 4) class-specific or (B, N, 4) class-agnostic boxes
    scores: torch.Tensor,  # (B, N, C), column 0 background
    valid: torch.Tensor,  # (B, N) bool
    score_thr: float,
    iou_thr: float,
    max_per_img: int,
    candidates_per_class: int = 300,
    nms_type: str = "nms",
    soft_min_score: float = 1e-3,
):
    """Per-class greedy NMS and the global top `max_per_img` (kernels.py:92).

    Each foreground class keeps its top `candidates_per_class` boxes above
    `score_thr`. When there are more classes than `max_per_img`, only that
    many classes per image, ranked by their best candidate, enter NMS; this
    is exact, because greedy NMS keeps each class's best box, which outranks
    every box of a dropped class.

    Returns (boxes (B, M, 4), scores (B, M), labels (B, M) int32 0-based
    foreground class, valid (B, M) bool), M = max_per_img, by score.

    Class-specific boxes go through K3, which gathers each class's
    candidates from its own coordinate planes. For class-agnostic boxes,
    K6 gathers every class's candidates from its image's (N, 4) box rows as
    they lie, and K5 then suppresses within (kernels.py:170-184).

    With nms_type "soft_nms" (kernels.py:214-228) each class's candidates,
    gathered from its own boxes (class-specific) or its image's rows
    (class-agnostic), go through linear soft-NMS at `iou_thr` and
    `soft_min_score`, `candidates_per_class` selections a class, and the
    decayed scores feed the global top-k. The class cap stays exact: a
    class's best candidate is taken first and never decays."""
    if nms_type not in ("nms", "soft_nms"):
        raise ValueError(f"nms_type={nms_type!r}")
    b, n, c = scores.shape
    num_fg = c - 1
    k = min(candidates_per_class, n)

    fg_scores = scores[..., 1:].transpose(1, 2)  # (B, num_fg, N)
    masked = torch.where(
        valid[:, None, :] & (fg_scores > score_thr),
        fg_scores,
        torch.full_like(fg_scores, -torch.inf),
    )
    classes = torch.arange(num_fg, device=scores.device).expand(b, -1)
    if num_fg > max_per_img:
        _, classes = top_k(masked.amax(dim=-1), max_per_img)  # (B, max_per_img)
        masked = torch.gather(masked, 1, classes[..., None].expand(-1, -1, n))
        num_fg = max_per_img

    top_scores, top_idx = top_k(masked, k)  # (B, num_fg, K)
    cand_valid = torch.isfinite(top_scores)
    cand_idx = top_idx.reshape(b * num_fg, k).to(torch.int32)
    flat_valid = cand_valid.reshape(b * num_fg, k)
    if nms_type == "soft_nms":
        # plain PyTorch on the card too: JAX runs this branch as XLA
        image = torch.arange(b, device=scores.device)[:, None, None]
        if boxes.shape[-1] == 4:
            cand_rows = boxes.float()[image, top_idx]  # (B, num_fg, K, 4)
        else:
            cand_rows = boxes.float().reshape(b, n, c, 4)[image, top_idx, (classes + 1)[..., None]]
        sb, ss, sv = soft_nms(
            cand_rows.reshape(b * num_fg, k, 4),
            torch.where(cand_valid, top_scores, 0.0).reshape(b * num_fg, k),
            flat_valid, iou_thr, "linear", min_score=soft_min_score, max_out=k,
        )
        cand = sb.reshape(b, num_fg, k, 4).transpose(2, 3)
        top_scores = ss.reshape(b, num_fg, k)
        keep = cand_valid = sv.reshape(b, num_fg, k)
    elif boxes.shape[-1] == 4:
        # each image's decoded (N, 4) rows, shared by its classes and read
        # where they lie: K6 takes the (B, 4, N) transposed view with no copy
        # (`.float()` is a no-op for the decoders' f32 boxes)
        cand = gather_lanes(boxes.float().transpose(1, 2), cand_idx, groups_per_plane=num_fg)
        keep = nms_keep_batched_coords(cand, flat_valid, iou_thr)
    else:
        # (B, C, 4, N) coordinate planes of the selected classes (bg is class 0)
        planes = boxes.reshape(b, n, c, 4).permute(0, 2, 3, 1)
        planes = torch.gather(planes, 1, (classes + 1)[..., None, None].expand(-1, -1, 4, n))
        keep, cand = nms_keep_gathered(
            planes.reshape(b * num_fg, 4, n).contiguous(), cand_idx, flat_valid, iou_thr
        )
    if nms_type == "nms":
        keep = keep.reshape(b, num_fg, k)
        cand = cand.reshape(b, num_fg, 4, k)

    cand_scores = torch.where(keep & cand_valid, top_scores, torch.full_like(top_scores, -torch.inf))
    out_scores, flat_idx = top_k(cand_scores.reshape(b, -1), max_per_img)
    det_valid = torch.isfinite(out_scores)
    cls_idx = flat_idx // k
    slot_idx = flat_idx % k
    image = torch.arange(b, device=scores.device)[:, None]
    det_boxes = cand[image, cls_idx, :, slot_idx]  # (B, M, 4)
    labels = torch.gather(classes, 1, cls_idx).to(torch.int32)
    return (
        det_boxes,
        torch.where(det_valid, out_scores, torch.zeros_like(out_scores)),
        labels,
        det_valid,
    )
