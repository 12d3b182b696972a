"""RetinaNet (JAX `models/retinanet.py`: `RetinaNetConfig` :34, `RetinaHead`
:67, `RetinaNet` :106, `loss` :139, `predict` :189).

An R50-FPN on C3-C5 with two stride-2 max-pool extras, a four-conv class and
box tower at each level, nine anchors a cell (three octave scales x three
ratios, base sizes the strides), max-IoU assignment inside the image (0.5 /
0.4), the focal loss over every assigned anchor and smooth-L1 (beta 0.11)
over the positives, both averaged over the positives. `predict` takes each
level's top `nms_pre` anchors by their best class score, decodes them
clipped to the image, and runs the class-agnostic multiclass NMS (K6, then
K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AssignerConfig
from ..core.anchors import multilevel_anchors
from ..core.assigner import assign_max_iou
from ..ops.boxes import bbox2delta, delta2bbox
from ..ops.losses import sigmoid_focal_loss, smooth_l1
from .detector import Detections
from .layers import Conv2d
from .single_stage import FOCAL_BIAS, SingleStageDetector, flat, focal_targets, level_top_k, take


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    num_classes: int = 1231  # with the background label 0 (sigmoid: C - 1 outputs)
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    octave_base_scale: float = 4.0
    scales_per_octave: int = 3
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stacked_convs: int = 4
    feat_channels: int = 256
    assigner: AssignerConfig = AssignerConfig(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    image_size: Tuple[int, int] = (800, 1344)

    @property
    def anchor_scales(self) -> Tuple[float, ...]:
        return tuple(self.octave_base_scale * 2 ** (i / self.scales_per_octave) for i in range(self.scales_per_octave))

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.ratios)


def conv_towers(head: nn.Module, names: Sequence[str], convs: int, channels: int, in_channels: int = 256) -> None:
    """`convs` 3x3 convolutions of `channels` for each tower of `names`
    ({name}_conv{i}), as the dense heads stack them."""
    for name in names:
        for i in range(convs):
            head.add_module(f"{name}_conv{i}", Conv2d(in_channels if i == 0 else channels, channels, 3, padding=1))


def tower(head: nn.Module, name: str, x: torch.Tensor, convs: int) -> torch.Tensor:
    """x through the ReLU convolutions of tower `name`."""
    for i in range(convs):
        x = F.relu(getattr(head, f"{name}_conv{i}")(x))
    return x


class RetinaHead(nn.Module):
    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        self.cfg = cfg
        c, ch = cfg, cfg.feat_channels
        conv_towers(self, ("cls", "reg"), c.stacked_convs, ch)
        self.retina_cls = Conv2d(ch, c.num_anchors * (c.num_classes - 1), 3, padding=1)
        self.retina_reg = Conv2d(ch, c.num_anchors * 4, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (class logits (B, A * num_fg, H, W), deltas (B, A * 4, H, W))."""
        n = self.cfg.stacked_convs
        return [(self.retina_cls(tower(self, "cls", x, n)), self.retina_reg(tower(self, "reg", x, n))) for x in feats]


class RetinaNet(SingleStageDetector):
    INIT = {"bbox_head.*.weight": ("normal", 0.01), "bbox_head.retina_cls.bias": ("constant", FOCAL_BIAS)}

    def __init__(self, cfg: RetinaNetConfig, dtype: torch.dtype = torch.float32, depth: int = 50):
        super().__init__(cfg, RetinaHead(cfg), dtype, depth)

    def _anchors(self, images: torch.Tensor) -> list[torch.Tensor]:
        """Each level's (H * W * A, 4) anchors, base sizes the strides."""
        c = self.cfg
        sizes = self._level_sizes(images)
        return self._cached(("anchors", *sizes, images.device), lambda: [
            torch.from_numpy(a).to(images.device)
            for a in multilevel_anchors(sizes, c.strides, c.anchor_scales, c.ratios, base_sizes=c.strides)
        ])

    def targets(self, anchors, gt_boxes, gt_labels, gt_mask, img_shapes):
        """(labels (B, N) 1-based or 0, pos, neg (B, N) bool, deltas (B, N, 4))
        of max-IoU assignment over the anchors inside each image (`loss`
        :146-164)."""
        c = self.cfg
        b = gt_boxes.shape[0]
        a = anchors[None].expand(b, -1, -1)
        shapes = img_shapes.float()
        inside = (a[..., 0] >= 0) & (a[..., 1] >= 0) & (a[..., 2] < shapes[:, 1, None]) & (a[..., 3] < shapes[:, 0, None])
        assign = assign_max_iou(
            a, inside, gt_boxes, gt_labels, gt_mask,
            c.assigner.pos_iou_thr, c.assigner.neg_iou_thr, c.assigner.min_pos_iou,
        )
        pos = assign.gt_inds > 0
        neg = assign.gt_inds == 0
        labels = torch.where(pos, assign.labels, 0)
        gt_idx = (assign.gt_inds - 1).clamp(0, gt_boxes.shape[1] - 1)
        deltas = bbox2delta(a, take(gt_boxes, gt_idx), c.target_means, c.target_stds)
        return labels, pos, neg, deltas

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes) -> Dict[str, torch.Tensor]:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        with torch.no_grad():
            labels, pos, neg, deltas_t = self.targets(torch.cat(self._anchors(images)), gt_boxes, gt_labels, gt_mask, img_shapes)
        cls_logits = torch.cat([flat(o[0].float(), num_fg) for o in outs], dim=1)
        reg = torch.cat([flat(o[1].float(), 4) for o in outs], dim=1)
        num_pos = pos.sum().float().clamp(min=1.0)
        loss_cls = sigmoid_focal_loss(
            cls_logits, focal_targets(labels, pos, num_fg), weight=(pos | neg)[..., None].float(),
            gamma=c.focal_gamma, alpha=c.focal_alpha, avg_factor=num_pos,
        )
        loss_bbox = smooth_l1(reg, deltas_t, beta=0.11, weight=pos[..., None].float(), avg_factor=num_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        shapes = img_shapes.float()
        boxes_all, scores_all = [], []
        for (cls_map, reg_map), anc in zip(outs, self._anchors(images)):
            logits = flat(cls_map, num_fg)
            scores, idx = level_top_k(logits, min(c.nms_pre, logits.shape[1]))
            boxes = delta2bbox(
                anc[idx], take(flat(reg_map, 4), idx).float(), c.target_means, c.target_stds,
                max_shape=(shapes[:, 0, None, None], shapes[:, 1, None, None]),
            )
            boxes_all.append(boxes)
            scores_all.append(scores)
        return self._detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1), scale_factors, rescale)
