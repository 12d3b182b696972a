"""Mask targets from fixed-size gt crops, and masks pasted into their images
(JAX `ops/mask.py`: `GT_MASK_CROP` :24, `rasterize_gt_masks` :26,
`mask_target_single` :57, `paste_mask` :122).

The input pipeline rasterises each gt mask on the host into a (CROP, CROP)
crop normalised to its own box (`rasterize_gt_masks`). In training
`mask_targets` resamples a positive RoI's gt crop bilinearly through the
RoI -> gt box transform at the centres of the target's M x M pixels and
thresholds it at 0.5: fixed shapes, one gather, no image-sized masks on the
card.

The arithmetic is that of JAX's function as XLA compiles it for the CPU
under `jit` (the JAX train step is jitted), so the targets are equal bit for
bit: the division by mask_size becomes a product with its f32 reciprocal,
and `x1 + u * w`, `q * crop - 0.5` and the bilinear blend's sums are fused
multiply-adds, rounded once (`_fma`). A rasterised rectangle's edge is
exactly 0.5 and a gt box as a roi samples exactly halfway between crop
pixels, so one rounding more or less moves targets across the threshold.
"""

from __future__ import annotations

import numpy as np
import torch

GT_MASK_CROP = 112  # the side of a gt mask's box-normalised crop


def rasterize_gt_masks(
    segmentations,  # COCO segmentation fields (polygon lists or RLE dicts; None for none)
    gt_boxes: np.ndarray,  # (N, 4) xyxy at the ORIGINAL image scale
    img_h: int,
    img_w: int,
    capacity: int,
    crop: int = GT_MASK_CROP,
) -> np.ndarray:
    """(capacity, crop, crop) f32: each mask's pixels inside its box (the
    floor of x1, y1 to the ceiling of x2, y2, inclusive), resized by cv2's
    bilinear resize."""
    import cv2

    from ..utils.rle import segmentation_to_mask

    out = np.zeros((capacity, crop, crop), np.float32)
    for i, seg in enumerate(segmentations[:capacity]):
        if seg is None:
            continue
        m = segmentation_to_mask(seg, img_h, img_w)
        x1, y1, x2, y2 = gt_boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)) + 1, int(np.ceil(y2)) + 1
        patch = m[max(y1i, 0) : y2i, max(x1i, 0) : x2i]
        if patch.size == 0:
            continue
        out[i] = cv2.resize(patch.astype(np.float32), (crop, crop), interpolation=cv2.INTER_LINEAR)
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors with one rounding: the product is exact in
    f64, and the sum rounds to f64 and then to f32."""
    return (a.double() * b.double() + c.double()).float()


def mask_targets(
    rois: torch.Tensor,  # (B, S, 4) sampled boxes, network scale
    gt_boxes: torch.Tensor,  # (B, G, 4) network scale
    gt_inds: torch.Tensor,  # (B, S) 0-based assigned gt of each roi
    gt_mask_crops: torch.Tensor,  # (B, G, CROP, CROP) box-normalised masks
    pos_mask: torch.Tensor,  # (B, S) bool
    mask_size: int = 28,
) -> torch.Tensor:
    """(B, S, mask_size, mask_size) f32 binary targets, 0 on rois that are
    not positive."""
    b, s = rois.shape[:2]
    crop = gt_mask_crops.shape[-1]
    dev = rois.device
    g = gt_inds.long().clamp(0, gt_boxes.shape[1] - 1)
    gb = torch.gather(gt_boxes.float(), 1, g[..., None].expand(-1, -1, 4))  # (B, S, 4)
    crops = gt_mask_crops.float()[torch.arange(b, device=dev)[:, None], g]  # (B, S, crop, crop)
    one = torch.ones((), device=dev)
    gw = torch.maximum(gb[..., 2] - gb[..., 0] + 1.0, one)
    gh = torch.maximum(gb[..., 3] - gb[..., 1] + 1.0, one)
    rw = torch.maximum(rois[..., 2] - rois[..., 0] + 1.0, one)
    rh = torch.maximum(rois[..., 3] - rois[..., 1] + 1.0, one)
    # the output pixels' centres in the image, then in crop pixels; the
    # divisions are by tensors, so the card rounds as the CPU does
    recip = torch.tensor(1.0 / mask_size, dtype=torch.float32, device=dev)
    u = (torch.arange(mask_size, dtype=torch.float32, device=dev) + 0.5) * recip
    px = _fma(u, rw[..., None], rois[..., 0, None])  # (B, S, M)
    py = _fma(u, rh[..., None], rois[..., 1, None])
    scale, half = torch.tensor(float(crop), device=dev), torch.tensor(-0.5, device=dev)
    cx = _fma((px - gb[..., 0, None]) / gw[..., None], scale, half)
    cy = _fma((py - gb[..., 1, None]) / gh[..., None], scale, half)

    y0 = torch.floor(cy).long().clamp(0, crop - 1)
    x0 = torch.floor(cx).long().clamp(0, crop - 1)
    y1 = (y0 + 1).clamp(0, crop - 1)
    x1 = (x0 + 1).clamp(0, crop - 1)
    wy = (cy - y0.float()).clamp(0.0, 1.0)[..., :, None]  # (B, S, M, 1)
    wx = (cx - x0.float()).clamp(0.0, 1.0)[..., None, :]  # (B, S, 1, M)
    flat = crops.reshape(b, s, crop * crop)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy[..., :, None] * crop + xx[..., None, :]).reshape(b, s, -1)).reshape(
            b, s, mask_size, mask_size
        )

    hy, hx = 1 - wy, 1 - wx
    vals = _fma(at(y0, x1) * hy, wx, at(y0, x0) * hy * hx)
    vals = _fma(at(y1, x0) * wy, hx, vals)
    vals = _fma(at(y1, x1) * wy, wx, vals)
    inside = (
        (cx[..., None, :] >= -1.0) & (cx[..., None, :] <= crop) & (cy[..., :, None] >= -1.0) & (cy[..., :, None] <= crop)
    )
    vals = torch.where(inside, vals, 0.0)
    targets = (vals >= 0.5).float()
    return torch.where(pos_mask[..., None, None], targets, 0.0)


def paste_mask(
    mask: np.ndarray,  # (M, M) sigmoid probabilities
    box: np.ndarray,  # (4,) xyxy at the original image scale
    img_h: int,
    img_w: int,
) -> np.ndarray:
    """(img_h, img_w) uint8: the mask resized to its box by cv2's bilinear
    resize and thresholded at > 0.5 (fcn_mask_head.py:125-170). The box is
    rounded half to even with the +1 convention and clipped to the image;
    the probabilities are resized in f32 (a bf16 model's are cast first)."""
    import cv2

    x1 = max(int(np.round(box[0])), 0)
    y1 = max(int(np.round(box[1])), 0)
    w = min(max(int(np.round(box[2] - box[0] + 1)), 1), img_w - x1)
    h = min(max(int(np.round(box[3] - box[1] + 1)), 1), img_h - y1)
    out = np.zeros((img_h, img_w), np.uint8)
    if w <= 0 or h <= 0:
        return out
    resized = cv2.resize(mask.astype(np.float32), (w, h))
    out[y1 : y1 + h, x1 : x1 + w] = (resized > 0.5).astype(np.uint8)
    return out
