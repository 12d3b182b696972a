"""SSD300 (JAX `models/ssd.py`: `SSDConfig` :32, `L2Norm` :48, `SSDVGG`
:60, `ssd_anchors` :103, `SSDHead` :139, `SSD` :157, `loss` :171,
`predict` :218).

A VGG16 with ceil-mode 2 x 2 pools (75 -> 38 at pool3), a 3 x 3 stride-1
pool5, a dilated fc6 and fc7 as convolutions, L2Norm on conv4_3 and four
extra blocks: six levels (38, 19, 10, 5, 3, 1 at 300 px), each with a
3 x 3 class and box conv over 4 or 6 anchors a cell. Max-IoU assignment
(0.5 / 0.5), softmax cross-entropy over the positives and the hardest
negatives, three for each positive, picked by the value threshold `ce >=`
the k-th largest (deterministic under ties), and smooth-L1 (beta 1) over
the positives, both over the positives' count. `predict` decodes every
anchor, softmax-scores it, and runs the class-agnostic multiclass NMS (K6,
then K5): 20 foreground classes, no class cap.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.assigner import assign_max_iou
from ..ops.boxes import bbox2delta, delta2bbox
from ..ops.losses import smooth_l1
from .detector import Detections
from .layers import Conv2d
from .single_stage import DenseDetector, flat, take

VGG_CFG = (2, 2, 3, 3, 3)  # convolutions a block
VGG_CH = (64, 128, 256, 512, 512)
EXTRA = ((256, 512, 2), (128, 256, 2), (128, 256, 1), (128, 256, 1))  # (1x1 width, 3x3 width, stride)
LEVEL_CHANNELS = (512, 1024, 512, 256, 256, 256)
DELTA_STDS = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int = 21  # VOC-style, with the background label 0
    input_size: int = 300
    strides: Tuple[int, ...] = (8, 16, 32, 64, 100, 300)
    base_sizes: Tuple[int, ...] = (21, 45, 99, 153, 207, 261)
    max_sizes: Tuple[int, ...] = (45, 99, 153, 207, 261, 315)
    ratios: Tuple[Tuple[float, ...], ...] = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    neg_pos_ratio: float = 3.0
    score_thr: float = 0.02
    nms_iou_thr: float = 0.45
    max_per_img: int = 200


class L2Norm(nn.Module):
    """x over its L2 norm across channels (eps 1e-10 inside the root), times
    a learned per-channel `scale` (20 to start), computed in f32 (f64 for an
    f64 x) and returned in x's dtype."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        return (xf / n * self.scale[:, None, None]).to(x.dtype)


class SSDVGG(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for b, (n, ch) in enumerate(zip(VGG_CFG, VGG_CH)):
            for i in range(n):
                self.add_module(f"conv{b + 1}_{i + 1}", Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
        self.l2norm = L2Norm(512)
        self.fc6 = Conv2d(512, 1024, 3, padding=6, dilation=6)
        self.fc7 = Conv2d(1024, 1024, 1)
        in_ch = 1024
        for i, (c1, c2, stride) in enumerate(EXTRA):
            self.add_module(f"extra{i}_1", Conv2d(in_ch, c1, 1))
            self.add_module(f"extra{i}_2", Conv2d(c1, c2, 3, stride=stride, padding=1 if stride == 2 else 0))
            in_ch = c2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 3, H, W) -> the six levels (conv4_3 L2-normed, fc7, the extras)."""
        outs = []
        for b, n in enumerate(VGG_CFG):
            for i in range(n):
                x = F.relu(getattr(self, f"conv{b + 1}_{i + 1}")(x))
            if b == 3:
                outs.append(self.l2norm(x))  # conv4_3
            # ceil-mode pooling, as flax pads an odd side's end with -inf; pool5 3 x 3 stride 1
            x = F.max_pool2d(x, 2, 2, ceil_mode=True) if b < 4 else F.max_pool2d(x, 3, 1, padding=1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        outs.append(x)
        for i in range(len(EXTRA)):
            x = F.relu(getattr(self, f"extra{i}_2")(F.relu(getattr(self, f"extra{i}_1")(x))))
            outs.append(x)
        return outs


def ssd_anchors(cfg: SSDConfig, featmap_sizes) -> list[np.ndarray]:
    """Each level's (H * W * A, 4) anchors, A = 2 + 2 x len(ratios) a cell
    (scale 1 and sqrt(max / base) at ratio 1, then scale 1 at each other
    ratio), the A of a cell contiguous."""
    all_anchors = []
    for (h, w), stride, base, maxs, ratios in zip(featmap_sizes, cfg.strides, cfg.base_sizes, cfg.max_sizes, cfg.ratios):
        scales = [1.0, float(np.sqrt(maxs / base))]
        ars = [1.0]
        for r in ratios:
            ars += [float(r), 1.0 / r]
        anchor_params = [(scales[0], 1.0), (scales[1], 1.0)] + [(scales[0], a) for a in ars[1:]]
        ctr = (stride - 1) / 2.0
        ys = np.arange(h) * stride + ctr
        xs = np.arange(w) * stride + ctr
        grid_x, grid_y = np.tile(xs, h), np.repeat(ys, w)
        anchors = []
        for s, a in anchor_params:
            bw = base * s * np.sqrt(a)
            bh = base * s / np.sqrt(a)
            anchors.append(np.stack(
                [grid_x - (bw - 1) / 2, grid_y - (bh - 1) / 2, grid_x + (bw - 1) / 2, grid_y + (bh - 1) / 2], axis=-1
            ))
        all_anchors.append(np.stack(anchors, axis=1).reshape(-1, 4).astype(np.float32))
    return all_anchors


class SSDHead(nn.Module):
    def __init__(self, cfg: SSDConfig):
        super().__init__()
        self.cfg = cfg
        for i, ch in enumerate(LEVEL_CHANNELS):
            a = 2 + 2 * len(cfg.ratios[i])
            self.add_module(f"cls{i}", Conv2d(ch, a * cfg.num_classes, 3, padding=1))
            self.add_module(f"reg{i}", Conv2d(ch, a * 4, 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (class logits (B, A * C, H, W), deltas (B, A * 4, H, W))."""
        return [(getattr(self, f"cls{i}")(x), getattr(self, f"reg{i}")(x)) for i, x in enumerate(feats)]


class SSD(DenseDetector):
    def __init__(self, cfg: SSDConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.backbone = SSDVGG()
        self.bbox_head = SSDHead(cfg)

    def forward(self, images: torch.Tensor):
        """images (B, H, W, 3) -> the head's outputs at each level."""
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self.bbox_head(self.backbone(x))

    def _anchors(self, outs) -> torch.Tensor:
        """(N, 4) anchors of all levels, from the levels' sizes."""
        sizes = [tuple(o[0].shape[2:]) for o in outs]
        dev = outs[0][0].device
        return self._cached(("anchors", *sizes, dev), lambda: torch.from_numpy(np.concatenate(ssd_anchors(self.cfg, sizes))).to(dev))

    def _flat_outs(self, outs):
        """(class logits (B, N, C), deltas (B, N, 4)), f32."""
        c = self.cfg
        cls = torch.cat([flat(o[0].float(), c.num_classes) for o in outs], dim=1)
        return cls, torch.cat([flat(o[1].float(), 4) for o in outs], dim=1)

    def targets(self, anchors, gt_boxes, gt_labels, gt_mask):
        """(labels (B, N) 1-based or 0, pos (B, N), deltas (B, N, 4)) of
        max-IoU assignment over every anchor (`loss` :401-414)."""
        a = anchors[None].expand(gt_boxes.shape[0], -1, -1)
        assign = assign_max_iou(
            a, torch.ones(a.shape[:2], dtype=torch.bool, device=a.device), gt_boxes, gt_labels, gt_mask,
            pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
        )
        pos = assign.gt_inds > 0
        labels = torch.where(pos, assign.labels, 0)
        gt_idx = (assign.gt_inds - 1).clamp(0, gt_boxes.shape[1] - 1).long()
        return labels, pos, bbox2delta(a, take(gt_boxes, gt_idx), stds=DELTA_STDS)

    def loss(self, images, gt_boxes, gt_labels, gt_mask) -> Dict[str, torch.Tensor]:
        """The losses; SSD's takes no image shapes (JAX `ssd.py:394`)."""
        outs = self(images)
        with torch.no_grad():
            labels, pos, deltas_t = self.targets(self._anchors(outs), gt_boxes.float(), gt_labels, gt_mask)
        cls_logits, reg = self._flat_outs(outs)
        ce = -torch.gather(F.log_softmax(cls_logits, dim=-1), -1, labels.long()[..., None])[..., 0]
        num_pos = pos.sum(dim=1)
        with torch.no_grad():
            # hard negatives: every negative at or above the k-th largest
            # negative CE, k = 3 x the image's positives
            k_neg = (num_pos.float() * self.cfg.neg_pos_ratio).int().clamp(1, ce.shape[1])
            neg_ce = torch.where(pos, -torch.inf, ce)
            thresh = torch.gather(neg_ce.sort(dim=1, descending=True).values, 1, (k_neg - 1).long()[:, None])
            weight = (pos | (~pos & (ce >= thresh) & torch.isfinite(neg_ce))).float()
        total_pos = num_pos.sum().float().clamp(min=1.0)
        loss_cls = (ce * weight).sum() / total_pos
        loss_bbox = smooth_l1(reg, deltas_t, beta=1.0, weight=pos[..., None].float(), avg_factor=total_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        c = self.cfg
        outs = self(images)
        cls_logits, reg = self._flat_outs(outs)
        boxes = delta2bbox(self._anchors(outs), reg, stds=DELTA_STDS, max_shape=(c.input_size, c.input_size))
        return self._detections(boxes, torch.softmax(cls_logits, dim=-1), scale_factors, rescale, background=True)
