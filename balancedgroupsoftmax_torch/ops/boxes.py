"""Box codec and geometry (JAX `ops/boxes.py`).

The legacy "+1 pixel" convention of the reference is kept: a box is
x2 - x1 + 1 wide. Formulas are written in the JAX functions' order so f32
results round alike.
"""

from __future__ import annotations

import math

import torch


def delta2bbox(
    rois: torch.Tensor,  # (..., 4) xyxy base boxes
    deltas: torch.Tensor,  # (..., 4 * K) deltas, K per-class sets
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
    max_shape=None,  # (h, w): numbers or tensors broadcastable to (..., K)
    wh_ratio_clip: float = 16 / 1000,
) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on top of `rois` (ops/boxes.py:56).

    dw and dh are clamped at |log(wh_ratio_clip)|; with `max_shape` the
    decoded corners are clipped to [0, w - 1] and [0, h - 1]."""
    deltas = deltas.float()
    dx, dy, dw, dh = (deltas[..., i::4] * stds[i] + means[i] for i in range(4))
    max_ratio = float(abs(math.log(wh_ratio_clip)))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy

    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    if max_shape is not None:
        h, w = max_shape
        x1 = _clip(x1, w - 1)
        y1 = _clip(y1, h - 1)
        x2 = _clip(x2, w - 1)
        y2 = _clip(y2, h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def _clip(x: torch.Tensor, hi) -> torch.Tensor:
    """jnp.clip(x, 0, hi) for a number or a tensor `hi`."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(x.clamp(min=0.0), hi.to(x.dtype))
    return x.clamp(0.0, hi)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(x2 - x1 + 1) * (y2 - y1 + 1) over the last dim."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., M, N) of (..., M, 4) and (..., N, 4) boxes
    (ops/boxes.py:118, mode "iou"). A union below 1e-6 is floored there, so
    degenerate boxes give no NaN."""
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    denom = box_area(bboxes1)[..., :, None] + box_area(bboxes2)[..., None, :] - overlap
    return overlap / denom.clamp(min=1e-6)
