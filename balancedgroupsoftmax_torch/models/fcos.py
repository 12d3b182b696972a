"""FCOS (JAX `models/fcos.py`: `FCOSConfig` :18, `FCOSHead` :34,
`_points` :77, `FCOS` :85, `loss` :120, `predict` :194).

Anchor-free: a four-conv class and box tower at each level of the R50-FPN
(C3-C5 and two max-pool extras), the ltrb distances exp(conv x the level's
learnable `scale{lvl}`), and a centerness branch on the class tower. Each
cell centre is assigned the smallest gt box that holds it and whose largest
distance lies in the level's regression range; the losses are the focal
loss, the IoU loss of the decoded boxes weighted by the centerness target,
and the centerness BCE. `predict` scores sigmoid(cls) x sigmoid(centerness),
takes each level's top `nms_pre` cells, decodes and clips them, and runs the
class-agnostic multiclass NMS (K6, then K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.boxes import bbox_overlaps
from ..ops.losses import binary_cross_entropy_with_logits, sigmoid_focal_loss
from .detector import Detections
from .layers import Conv2d
from .retinanet import conv_towers, tower
from .single_stage import FOCAL_BIAS, SingleStageDetector, clip_to_image, flat, focal_targets, level_top_k, take

INF = 1e8


def _points(h: int, w: int, stride: int):
    """(h * w, 2) f32 centres (x, y) of a level's cells, row-major."""
    ys = (np.arange(h) * stride + stride // 2).astype(np.float32)
    xs = (np.arange(w) * stride + stride // 2).astype(np.float32)
    return np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=-1)


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    num_classes: int = 1231  # with the background label 0; the head outputs num_classes - 1
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    regress_ranges: Tuple[Tuple[float, float], ...] = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))
    stacked_convs: int = 4
    feat_channels: int = 256
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    image_size: Tuple[int, int] = (800, 1344)


class FCOSHead(nn.Module):
    def __init__(self, cfg: FCOSConfig):
        super().__init__()
        self.cfg = cfg
        c, ch = cfg, cfg.feat_channels
        conv_towers(self, ("cls", "reg"), c.stacked_convs, ch)
        self.fcos_cls = Conv2d(ch, c.num_classes - 1, 3, padding=1)
        self.fcos_reg = Conv2d(ch, 4, 3, padding=1)
        self.fcos_centerness = Conv2d(ch, 1, 3, padding=1)
        for lvl in range(len(c.strides)):
            self.register_parameter(f"scale{lvl}", nn.Parameter(torch.ones(())))

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (class logits (B, num_fg, H, W), ltrb distances (B, 4, H,
        W) in f32, centerness logits (B, 1, H, W))."""
        n = self.cfg.stacked_convs
        outs = []
        for lvl, x in enumerate(feats):
            cf, rf = tower(self, "cls", x, n), tower(self, "reg", x, n)
            ltrb = torch.exp(self.fcos_reg(rf).float() * getattr(self, f"scale{lvl}"))
            outs.append((self.fcos_cls(cf), ltrb, self.fcos_centerness(cf)))
        return outs


def fcos_targets(points, ranges, gt_boxes, gt_labels, gt_mask):
    """(labels (B, P) 1-based or 0, pos (B, P), ltrb targets (B, P, 4),
    centerness targets (B, P)) of each point: the smallest-area gt that holds
    it within the point's regression range (`loss` :133-159); area ties take
    the first gt, as `argmin` does in both packages."""
    xs, ys = points[:, 0, None], points[:, 1, None]  # (P, 1)
    gb = gt_boxes[:, None]  # (B, 1, G, 4)
    ltrb = torch.stack([xs - gb[..., 0], ys - gb[..., 1], gb[..., 2] - xs, gb[..., 3] - ys], dim=-1)
    inside = ltrb.amin(dim=-1) > 0
    maxd = ltrb.amax(dim=-1)
    in_range = (maxd >= ranges[:, 0:1]) & (maxd <= ranges[:, 1:2])
    areas = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    areas = torch.where(gt_mask[:, None, :] & inside & in_range, areas[:, None, :], torch.full_like(maxd, INF))
    min_area, min_idx = areas.amin(dim=-1), areas.argmin(dim=-1)
    pos = min_area < INF
    labels = torch.where(pos, torch.gather(gt_labels, 1, min_idx), 0)
    tgt = torch.gather(ltrb, 2, min_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    lr, tb = tgt[..., [0, 2]], tgt[..., [1, 3]]
    ctr = torch.sqrt(
        (lr.amin(dim=-1) / lr.amax(dim=-1).clamp(min=1e-6)) * (tb.amin(dim=-1) / tb.amax(dim=-1).clamp(min=1e-6))
    )
    return labels, pos, tgt, torch.where(pos, ctr, 0.0)


def ltrb_boxes(points, d):
    """(x - l, y - t, x + r, y + b) of (..., 2) points and (..., 4) distances."""
    px, py = points[..., 0], points[..., 1]
    return torch.stack([px - d[..., 0], py - d[..., 1], px + d[..., 2], py + d[..., 3]], dim=-1)


class FCOS(SingleStageDetector):
    INIT = {"bbox_head.*.weight": ("normal", 0.01), "bbox_head.fcos_cls.bias": ("constant", FOCAL_BIAS)}

    def __init__(self, cfg: FCOSConfig, dtype: torch.dtype = torch.float32, depth: int = 50):
        super().__init__(cfg, FCOSHead(cfg), dtype, depth)

    def _level_points(self, images: torch.Tensor):
        """(points (P, 2), regression ranges (P, 2)) of all levels."""
        c = self.cfg
        sizes = self._level_sizes(images)

        def make():
            pts = [_points(lh, lw, s) for (lh, lw), s in zip(sizes, c.strides)]
            ranges = [np.tile(np.asarray(rr, np.float32), (len(p), 1)) for p, rr in zip(pts, c.regress_ranges)]
            return tuple(torch.from_numpy(np.concatenate(a)).to(images.device) for a in (pts, ranges))

        return self._cached(("points", *sizes, images.device), make)

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes) -> Dict[str, torch.Tensor]:
        num_fg = self.cfg.num_classes - 1
        outs = self(images)
        points, ranges = self._level_points(images)
        with torch.no_grad():
            labels, pos, tgt, ctr_t = fcos_targets(points, ranges, gt_boxes.float(), gt_labels, gt_mask)
        cls_logits = torch.cat([flat(o[0].float(), num_fg) for o in outs], dim=1)
        ltrb_pred = torch.cat([flat(o[1], 4) for o in outs], dim=1)
        ctr_logits = torch.cat([flat(o[2].float(), 1)[..., 0] for o in outs], dim=1)

        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = sigmoid_focal_loss(cls_logits, focal_targets(labels, pos, num_fg), avg_factor=num_pos)
        # the IoU loss on the decoded boxes at the positive points
        ious = bbox_overlaps(ltrb_boxes(points, ltrb_pred), ltrb_boxes(points, tgt), is_aligned=True)
        w = pos.float() * ctr_t
        loss_bbox = (-torch.log(ious.clamp(min=1e-6)) * w).sum() / w.sum().clamp(min=1e-6)
        loss_ctr = binary_cross_entropy_with_logits(ctr_logits, ctr_t, weight=pos.float(), avg_factor=num_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, "loss_centerness": loss_ctr}

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        points = self._level_points(images)[0]
        offset = 0
        boxes_all, scores_all = [], []
        for cls_map, ltrb, ctr_map in outs:
            n = cls_map.shape[2] * cls_map.shape[3]
            p = points[offset : offset + n]
            offset += n
            gate = torch.sigmoid(flat(ctr_map, 1)[..., 0].float())
            scores, idx = level_top_k(flat(cls_map, num_fg), min(c.nms_pre, n), gate)
            boxes_all.append(clip_to_image(ltrb_boxes(p[idx], take(flat(ltrb, 4), idx)), img_shapes.float()))
            scores_all.append(scores)
        return self._detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1), scale_factors, rescale)
