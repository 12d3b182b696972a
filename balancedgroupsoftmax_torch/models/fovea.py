"""FoveaBox (JAX `models/fovea.py`: `FoveaConfig` :30, `FoveaHead` :47,
`FoveaBox` :85, `_level_meta` :102, `loss` :120, `predict` :179).

A four-conv class and box tower at each level of the R50-FPN (C3-C5 and two
max-pool extras). A cell centre is positive for the smallest gt whose fovea
(the box shrunk by `sigma` about its centre) holds it, on the levels whose
scale range holds sqrt(gt area); the box targets are the log of its corner
distances over the level's base edge, clipped to [1/16, 16]; the focal loss
and smooth-L1 (beta 0.11). `predict` decodes exp(pred) x base edge around
each of a level's top `nms_pre` cells, clips to the image, and runs the
class-agnostic multiclass NMS (K6, then K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.losses import sigmoid_focal_loss, smooth_l1
from .detector import Detections
from .fcos import _points, ltrb_boxes
from .layers import Conv2d
from .retinanet import conv_towers, tower
from .single_stage import FOCAL_BIAS, SingleStageDetector, clip_to_image, flat, focal_targets, level_top_k, take


@dataclasses.dataclass(frozen=True)
class FoveaConfig:
    num_classes: int = 1231
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    base_edges: Tuple[int, ...] = (16, 32, 64, 128, 256)
    scale_ranges: Tuple[Tuple[float, float], ...] = ((1, 64), (32, 128), (64, 256), (128, 512), (256, 2048))
    sigma: float = 0.4
    stacked_convs: int = 4
    feat_channels: int = 256
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    image_size: Tuple[int, int] = (800, 1344)


class FoveaHead(nn.Module):
    def __init__(self, cfg: FoveaConfig):
        super().__init__()
        self.cfg = cfg
        c, ch = cfg, cfg.feat_channels
        conv_towers(self, ("cls", "reg"), c.stacked_convs, ch)
        self.fovea_cls = Conv2d(ch, c.num_classes - 1, 3, padding=1)
        self.fovea_reg = Conv2d(ch, 4, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (class logits (B, num_fg, H, W), log distances (B, 4, H, W))."""
        n = self.cfg.stacked_convs
        return [(self.fovea_cls(tower(self, "cls", x, n)), self.fovea_reg(tower(self, "reg", x, n))) for x in feats]


def fovea_targets(points, bases, ranges, gt_boxes, gt_labels, gt_mask, sigma: float):
    """(labels (B, P) 1-based or 0, pos (B, P), log-distance targets (B, P,
    4)) of each point (`loss` :126-159); area ties take the first gt."""
    xs, ys = points[:, 0, None], points[:, 1, None]  # (P, 1)
    gb = gt_boxes[:, None]  # (B, 1, G, 4)
    cx = (gb[..., 0] + gb[..., 2]) / 2
    cy = (gb[..., 1] + gb[..., 3]) / 2
    gw = gb[..., 2] - gb[..., 0] + 1
    gh = gb[..., 3] - gb[..., 1] + 1
    in_fovea = (
        (xs > cx - sigma * gw / 2) & (xs < cx + sigma * gw / 2) & (ys > cy - sigma * gh / 2) & (ys < cy + sigma * gh / 2)
    )
    scale = torch.sqrt(gw * gh)  # (B, 1, G)
    in_range = (scale >= ranges[:, 0:1]) & (scale <= ranges[:, 1:2])
    area = gw * gh
    areas = torch.where(gt_mask[:, None, :] & in_fovea & in_range, area, torch.full_like(area, 1e9))
    min_area, idx = areas.amin(dim=-1), areas.argmin(dim=-1)
    pos = min_area < 1e9
    labels = torch.where(pos, torch.gather(gt_labels, 1, idx), 0)
    g = take(gt_boxes, idx)  # (B, P, 4)
    x, y = xs[:, 0], ys[:, 0]
    t = torch.stack([(x - g[..., 0]) / bases, (y - g[..., 1]) / bases, (g[..., 2] - x) / bases, (g[..., 3] - y) / bases], -1)
    return labels, pos, torch.log(t.clamp(1.0 / 16, 16.0))


class FoveaBox(SingleStageDetector):
    INIT = {"bbox_head.*.weight": ("normal", 0.01), "bbox_head.fovea_cls.bias": ("constant", FOCAL_BIAS)}

    def __init__(self, cfg: FoveaConfig, dtype: torch.dtype = torch.float32, depth: int = 50):
        super().__init__(cfg, FoveaHead(cfg), dtype, depth)

    def _level_meta(self, images: torch.Tensor):
        """(points (P, 2), base edges (P,), scale ranges (P, 2)) of all levels."""
        c = self.cfg
        sizes = self._level_sizes(images)

        def make():
            pts = [_points(lh, lw, s) for (lh, lw), s in zip(sizes, c.strides)]
            bases = [np.full(len(p), be, np.float32) for p, be in zip(pts, c.base_edges)]
            ranges = [np.tile(np.asarray(rr, np.float32), (len(p), 1)) for p, rr in zip(pts, c.scale_ranges)]
            return tuple(torch.from_numpy(np.concatenate(a)).to(images.device) for a in (pts, bases, ranges))

        return self._cached(("meta", *sizes, images.device), make)

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes) -> Dict[str, torch.Tensor]:
        num_fg = self.cfg.num_classes - 1
        outs = self(images)
        points, bases, ranges = self._level_meta(images)
        with torch.no_grad():
            labels, pos, tgt = fovea_targets(points, bases, ranges, gt_boxes.float(), gt_labels, gt_mask, self.cfg.sigma)
        cls_logits = torch.cat([flat(o[0].float(), num_fg) for o in outs], dim=1)
        reg = torch.cat([flat(o[1].float(), 4) for o in outs], dim=1)
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = sigmoid_focal_loss(cls_logits, focal_targets(labels, pos, num_fg), avg_factor=num_pos)
        loss_bbox = smooth_l1(reg, tgt, beta=0.11, weight=pos[..., None].float(), avg_factor=num_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        points = self._level_meta(images)[0]
        offset = 0
        boxes_all, scores_all = [], []
        for (cls_map, reg_map), be in zip(outs, c.base_edges):
            n = cls_map.shape[2] * cls_map.shape[3]
            p = points[offset : offset + n]
            offset += n
            scores, idx = level_top_k(flat(cls_map, num_fg), min(c.nms_pre, n))
            t = torch.exp(take(flat(reg_map, 4), idx).float()) * be
            boxes_all.append(clip_to_image(ltrb_boxes(p[idx], t), img_shapes.float()))
            scores_all.append(scores)
        return self._detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1), scale_factors, rescale)
