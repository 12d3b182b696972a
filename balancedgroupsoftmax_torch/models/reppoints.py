"""RepPoints (JAX `models/reppoints.py`: `RepPointsConfig` :38, `_DCN_BASE`
:54, `RepPointsHead` :59, `points_to_boxes` :130, `RepPoints` :142, `loss`
:177, `predict` :260).

Each cell predicts nine points (the init stage, offsets in strides from the
cell centre); the class and refine branches read their features through
deformable convolutions driven by those points (K7 forward, K7b backward, at
the exact bilinear gather, D = 0); the refine branch adds deltas to the
detached init points, and a point set's box is its min-max. Init targets:
each gt claims the point nearest its centre on its scale's level; refine
targets: max-IoU assignment on the init boxes (0.5 / 0.4). The losses are
smooth-L1 (beta 0.11) on both stages' boxes over 4 x stride, the init stage
at half weight, and the focal loss. `predict` boxes each level's top
`nms_pre` refined point sets, clips them to the image, and runs the
class-agnostic multiclass NMS (K6, then K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.assigner import assign_max_iou
from ..ops.deform_conv import _DeformConv
from ..ops.losses import sigmoid_focal_loss, smooth_l1
from .detector import Detections
from .fcos import _points
from .layers import Conv2d
from .retinanet import conv_towers, tower
from .single_stage import FOCAL_BIAS, SingleStageDetector, clip_to_image, flat, focal_targets, level_top_k, take

NUM_POINTS = 9


@dataclasses.dataclass(frozen=True)
class RepPointsConfig:
    num_classes: int = 1231
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    point_base_scale: int = 4  # the init box's half-extent in strides
    stacked_convs: int = 3
    feat_channels: int = 256
    gradient_mul: float = 0.1
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    image_size: Tuple[int, int] = (800, 1344)


# the base offsets (dy, dx) of a 3 x 3 kernel's taps, row-major, interleaved:
# a point's offset from its tap
_DCN_BASE = np.stack([np.repeat(np.arange(-1, 2), 3), np.tile(np.arange(-1, 2), 3)], axis=-1).reshape(-1).astype(np.float32)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A 3 x 3 deformable convolution, stride 1, padding 1, one group, no
    mask, at the exact bilinear gather (D = 0), batched over images: x (B, C,
    H, W), offsets (B, 18, H, W) f32, weight (C_out, C, 3, 3) -> (B, C_out,
    H, W) in x's dtype (K7, and K7b for its gradient)."""
    out = _DeformConv.apply(
        x.permute(0, 2, 3, 1).contiguous(), offsets.permute(0, 2, 3, 1).contiguous(),
        weight.to(x.dtype).contiguous(), None, 1, 1, 1, 0,
    )
    return out.permute(0, 3, 1, 2)


class RepPointsHead(nn.Module):
    def __init__(self, cfg: RepPointsConfig):
        super().__init__()
        self.cfg = cfg
        c, ch = cfg, cfg.feat_channels
        conv_towers(self, ("cls", "pts"), c.stacked_convs, ch)
        self.pts_init_conv = Conv2d(ch, ch, 3, padding=1)
        self.pts_init_out = Conv2d(ch, 2 * NUM_POINTS, 1)
        # the deformable kernels as (C_out, C_in, 3, 3); flax holds them (3, 3, C_in, C_out)
        self.cls_dcn_kernel = nn.Parameter(torch.zeros(ch, ch, 3, 3))
        self.cls_out = Conv2d(ch, c.num_classes - 1, 1)
        self.refine_dcn_kernel = nn.Parameter(torch.zeros(ch, ch, 3, 3))
        self.pts_refine_out = Conv2d(ch, 2 * NUM_POINTS, 1)
        self.register_buffer("dcn_base", torch.from_numpy(_DCN_BASE)[None, :, None, None], persistent=False)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (class logits (B, num_fg, H, W), init points (B, 18, H,
        W) f32, refined points (B, 18, H, W) f32), points (dy, dx) in strides."""
        n, g = self.cfg.stacked_convs, self.cfg.gradient_mul
        outs = []
        for x in feats:
            cf, pf = tower(self, "cls", x, n), tower(self, "pts", x, n)
            pts_init = self.pts_init_out(F.relu(self.pts_init_conv(pf))).float()
            # gradient_mul: the offsets carry a tenth of the init points' gradient
            pts_for_dcn = pts_init.detach() * (1 - g) + pts_init * g
            dcn_off = pts_for_dcn - self.dcn_base
            cls_score = self.cls_out(F.relu(deform_conv(cf, dcn_off, self.cls_dcn_kernel)))
            pts_delta = self.pts_refine_out(F.relu(deform_conv(pf, dcn_off, self.refine_dcn_kernel))).float()
            outs.append((cls_score, pts_init, pts_init.detach() + pts_delta))
        return outs


def points_to_boxes(pts: torch.Tensor, centers: torch.Tensor, stride) -> torch.Tensor:
    """The min-max box (..., 4) of (..., 18) point offsets (dy, dx
    interleaved, in strides) around (..., 2) centres (x, y)."""
    dy = pts[..., 0::2] * stride
    dx = pts[..., 1::2] * stride
    x = centers[..., 0:1] + dx
    y = centers[..., 1:2] + dy
    return torch.stack([x.amin(dim=-1), y.amin(dim=-1), x.amax(dim=-1), y.amax(dim=-1)], dim=-1)


def reppoints_targets(centers, lvl_ids, boxes_init, gt_boxes, gt_labels, gt_mask, point_base_scale, strides):
    """(init_pos (B, P), init targets (B, P, 4), labels (B, P), ref_pos (B,
    P), refine targets (B, P, 4)) (`loss` :198-233). A gt claims the point
    nearest its centre (the first on ties) on the level log2(scale / (4 x
    the finest stride)); a point claimed twice takes the higher gt index, as
    JAX's scatter-max."""
    b, g = gt_mask.shape
    gw = gt_boxes[..., 2] - gt_boxes[..., 0] + 1
    gh = gt_boxes[..., 3] - gt_boxes[..., 1] + 1
    scale = torch.sqrt(gw * gh)
    gt_lvl = torch.floor(torch.log2(scale / (point_base_scale * strides[0]) + 1e-6)).clamp(0, len(strides) - 1).int()
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    d2 = (centers[:, 0, None] - cx[:, None, :]) ** 2 + (centers[:, 1, None] - cy[:, None, :]) ** 2  # (B, P, G)
    same_lvl = lvl_ids[:, None] == gt_lvl[:, None, :]
    d2 = torch.where(same_lvl & gt_mask[:, None, :], d2, torch.full_like(d2, torch.inf))
    best_pt = d2.argmin(dim=1)  # (B, G)
    zeros = torch.zeros(b, centers.shape[0], dtype=torch.int32, device=centers.device)
    init_pos = zeros.scatter_reduce(1, best_pt, gt_mask.int(), "amax") > 0
    gt_index = torch.arange(g, dtype=torch.int32, device=centers.device).expand(b, g)
    init_gt = zeros.scatter_reduce(1, best_pt, torch.where(gt_mask, gt_index, 0), "amax")
    init_tgt = take(gt_boxes, init_gt.long())

    assign = assign_max_iou(
        boxes_init, torch.ones(boxes_init.shape[:2], dtype=torch.bool, device=centers.device),
        gt_boxes, gt_labels, gt_mask, pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
    )
    ref_pos = assign.gt_inds > 0
    labels = torch.where(ref_pos, assign.labels, 0)
    ref_tgt = take(gt_boxes, (assign.gt_inds - 1).clamp(0, g - 1).long())
    return init_pos, init_tgt, labels, ref_pos, ref_tgt


class RepPoints(SingleStageDetector):
    INIT = {
        "bbox_head.pts_init_out.weight": ("constant", 0.0),
        "bbox_head.pts_refine_out.weight": ("constant", 0.0),
        "bbox_head.*.weight": ("normal", 0.01),
        "bbox_head.*_dcn_kernel": ("normal", 0.01),
        "bbox_head.cls_out.bias": ("constant", FOCAL_BIAS),
    }

    def __init__(self, cfg: RepPointsConfig, dtype: torch.dtype = torch.float32, depth: int = 50):
        super().__init__(cfg, RepPointsHead(cfg), dtype, depth)

    def _meta(self, images: torch.Tensor):
        """(centres (P, 2), strides (P,), level ids (P,)) of all levels."""
        c = self.cfg
        sizes = self._level_sizes(images)

        def make():
            pts = [_points(lh, lw, s) for (lh, lw), s in zip(sizes, c.strides)]
            strides = [np.full(len(p), s, np.float32) for p, s in zip(pts, c.strides)]
            lvl_ids = [np.full(len(p), li, np.int32) for li, p in enumerate(pts)]
            return tuple(torch.from_numpy(np.concatenate(a)).to(images.device) for a in (pts, strides, lvl_ids))

        return self._cached(("meta", *sizes, images.device), make)

    def loss(self, images, gt_boxes, gt_labels, gt_mask, img_shapes) -> Dict[str, torch.Tensor]:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        centers, strides, lvl_ids = self._meta(images)
        cls_logits = torch.cat([flat(o[0].float(), num_fg) for o in outs], dim=1)
        pts_init = torch.cat([flat(o[1], 2 * NUM_POINTS) for o in outs], dim=1)
        pts_refine = torch.cat([flat(o[2], 2 * NUM_POINTS) for o in outs], dim=1)
        boxes_init = points_to_boxes(pts_init, centers[None], strides[None, :, None])
        boxes_refine = points_to_boxes(pts_refine, centers[None], strides[None, :, None])
        with torch.no_grad():
            init_pos, init_tgt, labels, ref_pos, ref_tgt = reppoints_targets(
                centers, lvl_ids, boxes_init.detach(), gt_boxes.float(), gt_labels, gt_mask, c.point_base_scale, c.strides
            )

        num_init = init_pos.sum().float().clamp(min=1.0)
        num_ref = ref_pos.sum().float().clamp(min=1.0)
        norm = (c.point_base_scale * strides)[None, :, None]
        loss_init = smooth_l1(
            boxes_init / norm, init_tgt / norm, beta=0.11, weight=init_pos[..., None].float() * 0.5, avg_factor=num_init
        )
        loss_refine = smooth_l1(
            boxes_refine / norm, ref_tgt / norm, beta=0.11, weight=ref_pos[..., None].float(), avg_factor=num_ref
        )
        loss_cls = sigmoid_focal_loss(cls_logits, focal_targets(labels, ref_pos, num_fg), avg_factor=num_ref)
        return {"loss_cls": loss_cls, "loss_pts_init": loss_init, "loss_pts_refine": loss_refine}

    @torch.inference_mode()
    def predict(self, images, img_shapes, scale_factors, rescale: bool = True) -> Detections:
        c = self.cfg
        num_fg = c.num_classes - 1
        outs = self(images)
        centers = self._meta(images)[0]
        offset = 0
        boxes_all, scores_all = [], []
        for (cls_map, _, pts_ref), s in zip(outs, c.strides):
            n = cls_map.shape[2] * cls_map.shape[3]
            ctr = centers[offset : offset + n]
            offset += n
            scores, idx = level_top_k(flat(cls_map, num_fg), min(c.nms_pre, n))
            boxes = points_to_boxes(take(flat(pts_ref, 2 * NUM_POINTS), idx), ctr[idx], float(s))
            boxes_all.append(clip_to_image(boxes, img_shapes.float()))
            scores_all.append(scores)
        return self._detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1), scale_factors, rescale)
