"""Box codec and geometry (JAX `ops/boxes.py`).

The legacy "+1 pixel" convention of the reference is kept: a box is
x2 - x1 + 1 wide. Formulas are written in the JAX functions' order so f32
results round alike.
"""

from __future__ import annotations

import math

import torch


def bbox2delta(
    proposals: torch.Tensor,  # (..., 4) xyxy
    gt: torch.Tensor,  # (..., 4) xyxy, same shape
    means=(0.0, 0.0, 0.0, 0.0),
    stds=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode `gt` relative to `proposals` as normalised (dx, dy, dw, dh)
    (ops/boxes.py:23). Every division is by a tensor, so the card rounds as
    the CPU does (PyTorch's CUDA division by a number multiplies by its
    reciprocal)."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0

    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0

    deltas = torch.stack(
        [(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)], dim=-1
    )
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds


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


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor, is_aligned: bool = False) -> torch.Tensor:
    """Pairwise IoU (..., M, N) of (..., M, 4) and (..., N, 4) boxes
    (ops/boxes.py:118, mode "iou"); with `is_aligned`, the IoU (..., M) of
    each box with its counterpart in a set of the same shape. A union below
    1e-6 is floored there, so degenerate boxes give no NaN."""
    if is_aligned:
        lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
        rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
        wh = (rb - lt + 1).clamp(min=0)
        overlap = wh[..., 0] * wh[..., 1]
        return overlap / (box_area(bboxes1) + box_area(bboxes2) - overlap).clamp(min=1e-6)
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    denom = box_area(bboxes1)[..., :, None] + box_area(bboxes2)[..., None, :] - overlap
    return overlap / denom.clamp(min=1e-6)


def _per_image(x, like: torch.Tensor):
    """A number, or a (B,) tensor of per-image values shaped to broadcast
    against `like`'s (B, ..., 4K) boxes."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.to(like.dtype).reshape(-1, *([1] * (like.dim() - 1)))
    return x


def bbox_flip(bboxes: torch.Tensor, img_shape) -> torch.Tensor:
    """Horizontal flip under the -1 convention (ops/boxes.py:157): (..., 4K)
    xyxy boxes in an image of `img_shape` (h, w), or in each image of a
    (B, 2) tensor of shapes for (B, ..., 4K) boxes."""
    w = _per_image(img_shape[..., 1] if isinstance(img_shape, torch.Tensor) else img_shape[1], bboxes)
    x1, x2 = bboxes[..., 0::4], bboxes[..., 2::4]
    flipped = torch.stack([w - x2 - 1, bboxes[..., 1::4], w - x1 - 1, bboxes[..., 3::4]], dim=-1)
    return flipped.reshape(bboxes.shape)


def bbox_mapping(bboxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """Boxes at the original scale -> a test view's (ops/boxes.py:175):
    scaled, then flipped in the view."""
    new = bboxes * _per_image(scale_factor, bboxes)
    return bbox_flip(new, img_shape) if flip else new


def bbox_mapping_back(bboxes: torch.Tensor, img_shape, scale_factor, flip: bool) -> torch.Tensor:
    """A test view's boxes -> the original scale (ops/boxes.py:183): flipped
    back in the view, then divided by the scale factor."""
    new = bbox_flip(bboxes, img_shape) if flip else bboxes
    return new / _per_image(scale_factor, new)
