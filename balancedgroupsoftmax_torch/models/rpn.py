"""RPN head, proposal generation and the RPN loss
(JAX `models/rpn.py` `RPNHead` :29, `rpn_proposals_batched` :72,
`rpn_loss` :181).

Score maps flatten as (H, W, A), matching the location-major anchors of
core/anchors.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ProposalConfig, RPNTrainConfig
from ..core.targets import anchor_targets
from ..kernels import batched_nms_topk
from ..ops.boxes import delta2bbox
from ..ops.losses import binary_cross_entropy_with_logits, smooth_l1
from ..ops.topk import top_k
from .layers import Conv2d


class RPNHead(nn.Module):
    def __init__(self, feat_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = Conv2d(feat_channels, feat_channels, 3, padding=1)
        self.rpn_cls = Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (cls_logits (B, H * W * A), deltas (B, H * W * A, 4))."""
        outs = []
        for x in feats:
            y = F.relu(self.rpn_conv(x))
            b = x.shape[0]
            cls = self.rpn_cls(y).permute(0, 2, 3, 1).reshape(b, -1)
            reg = self.rpn_reg(y).permute(0, 2, 3, 1).reshape(b, -1, 4)
            outs.append((cls, reg))
        return outs


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, P, 4)
    scores: torch.Tensor  # (B, P)
    valid: torch.Tensor  # (B, P) bool


def rpn_proposals_batched(
    level_outs,  # per level (cls (B, N_l), deltas (B, N_l, 4))
    anchors: Sequence[torch.Tensor],  # per level (N_l, 4)
    img_shapes: torch.Tensor,  # (B, 2) content (h, w)
    cfg: ProposalConfig,
) -> Proposals:
    """Per-level top `nms_pre`, decode, clip to the image, greedy NMS and top
    `nms_post`; then the global top `max_num` over the levels.

    All levels go through one NMS launch: level rows are padded with invalid
    slots to the longest (P6 has fewer than `nms_pre` anchors at 800 x 1344),
    and an invalid slot neither keeps nor suppresses, so each row's result is
    that of its own level."""
    b = img_shapes.shape[0]
    hmax = img_shapes[:, 0:1]
    wmax = img_shapes[:, 1:2]
    rows = []
    for (cls, deltas), anc in zip(level_outs, anchors):
        scores = torch.sigmoid(cls.float())
        k = min(cfg.nms_pre, scores.shape[1])
        top_scores, top_idx = top_k(scores, k)
        top_deltas = torch.gather(deltas.float(), 1, top_idx[..., None].expand(-1, -1, 4))
        boxes = delta2bbox(anc[top_idx], top_deltas)
        boxes = torch.stack(
            [
                torch.minimum(boxes[..., 0].clamp(min=0), wmax - 1),
                torch.minimum(boxes[..., 1].clamp(min=0), hmax - 1),
                torch.minimum(boxes[..., 2].clamp(min=0), wmax - 1),
                torch.minimum(boxes[..., 3].clamp(min=0), hmax - 1),
            ],
            dim=-1,
        )
        valid = torch.ones(b, k, dtype=torch.bool, device=boxes.device)
        rows.append((boxes, top_scores, valid))

    kmax = max(r[1].shape[1] for r in rows)
    pad = lambda t: F.pad(t, (0, 0, 0, kmax - t.shape[1]) if t.dim() == 3 else (0, kmax - t.shape[1]))
    nb, ns, nv = batched_nms_topk(
        torch.cat([pad(r[0]) for r in rows]),
        torch.cat([pad(r[1]) for r in rows]),
        torch.cat([pad(r[2]) for r in rows]),
        cfg.nms_thr,
        cfg.nms_post,
    )  # rows ordered (level, image)
    num_levels = len(rows)
    split = lambda t: torch.cat(t.reshape(num_levels, b, *t.shape[1:]).unbind(0), dim=1)
    boxes, scores, valid = split(nb), split(ns), split(nv)

    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top, idx = top_k(masked, cfg.max_num)
    out_valid = torch.isfinite(top)
    return Proposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(out_valid, top, torch.zeros_like(top)),
        valid=out_valid,
    )


def rpn_loss(
    level_outs,  # per level (cls (B, N_l), deltas (B, N_l, 4))
    anchors_flat: torch.Tensor,  # (N, 4) all levels concatenated
    anchor_valid: torch.Tensor,  # (N,) bool grid validity
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_mask: torch.Tensor,  # (B, G) bool
    img_shape: tuple[int, int],  # padded (H, W) of the batch
    cfg: RPNTrainConfig,
    generator: Optional[torch.Generator] = None,
    beta: float = 1.0 / 9.0,
):
    """(loss_cls, loss_bbox): sigmoid BCE and smooth-L1 over the sampled
    anchors, both averaged over the sampled count (anchor_head.py:162-208)."""
    t = anchor_targets(anchors_flat, anchor_valid, gt_boxes, gt_mask, img_shape, cfg, generator)
    cls_logits = torch.cat([c.float() for c, _ in level_outs], dim=1)  # (B, N)
    deltas = torch.cat([r.float() for _, r in level_outs], dim=1)  # (B, N, 4)
    num_total = t.num_pos.sum() + t.num_neg.sum()
    loss_cls = binary_cross_entropy_with_logits(
        cls_logits, t.labels.float(), weight=t.label_weights, avg_factor=num_total
    )
    loss_bbox = smooth_l1(deltas, t.bbox_targets, beta=beta, weight=t.bbox_weights, avg_factor=num_total)
    return loss_cls, loss_bbox
