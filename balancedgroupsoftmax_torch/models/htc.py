"""Hybrid Task Cascade at inference: the cascade with a semantic branch and
mask heads with information flow (JAX `models/htc.py`: `HTC` :43, `setup`
:48, `_pool_semantic` :136, `_run_stages` :169, `predict` :405,
`_predict_feats` :417, `predict_with_masks` :461, `_masks_feats` :488,
`build_htc` :522).

It is the port's `CascadeRCNN` (backbone, FPN, RPN with K1, three
class-agnostic stages over K2, the multiclass NMS with K6 then K5) plus:
- a `FusedSemanticHead` over the FPN levels, whose stride-8 feature is
  pooled (K2 over a one-level pyramid) for every RoI and added to its FPN
  RoI feature, for the bbox stages and for the masks (`semantic_fusion`);
- one `FCNMaskHead` a stage. At test time all three run on the detections'
  boxes (14 x 14 RoIs), each stage's head taking the previous one's conv
  feature through its `conv_res` (`mask_info_flow`); the class-selected
  logits of the three are averaged and passed through a sigmoid.
With the HTC-DCN backbone (X101-64x4d, deformable c3-c5) the backbone runs
K7 in 30 of its blocks. Training (`HTC.loss`) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import DetectorConfig
from ..gs.partition import GSPartition
from ..kernels import batched_multilevel_roi_align
from .cascade import CascadeRCNN
from .detector import Detections
from .mask_head import FCNMaskHead
from .semantic_head import FusedSemanticHead


class HTC(CascadeRCNN):
    def _init_roi_heads(self) -> None:
        super()._init_roi_heads()
        c = self.cfg
        self.semantic_head = FusedSemanticHead(
            num_ins=c.fpn.num_outs,
            fusion_level=c.htc.fusion_level,
            in_channels=c.fpn.out_channels,
            conv_out_channels=c.fpn.out_channels,
            num_classes=c.htc.semantic_num_classes,
        )
        self.mask_heads = nn.ModuleList(
            FCNMaskHead(c.mask_head, with_conv_res=c.htc.mask_info_flow and i > 0)
            for i in range(c.cascade.num_stages)
        )

    def _init_special(self) -> dict:
        # the mask heads' convs and upsampling are he-normal, their 1x1
        # logits normal(0.001) (JAX mask_head.py :29, :90, :102)
        special = super()._init_special()
        for head in self.mask_heads:
            special.update({conv: ("he", None) for conv in head.convs})
            special.update({head.upsample: ("he", None), head.conv_logits: ("normal", 0.001)})
        return special

    def loss(self, *args, **kwargs):
        raise NotImplementedError("HTC training is not ported yet")

    def _semantic(self, feats) -> torch.Tensor:
        """The semantic feature (B, C, H / 8, W / 8), channels-last, so that K2
        reads it as NHWC in every pooling without a copy."""
        return self.semantic_head(feats).contiguous(memory_format=torch.channels_last)

    def _pool_semantic(self, sem_feat: torch.Tensor, rois: torch.Tensor, out_size: int) -> torch.Tensor:
        """RoIAlign (K2) of the stride-8 semantic feature: a one-level
        pyramid, to which every roi is routed."""
        c = self.cfg
        return batched_multilevel_roi_align(
            [sem_feat.permute(0, 2, 3, 1)],
            rois,
            (c.anchors.strides[c.htc.fusion_level],),
            out_size,
            c.roi_extractor.sample_num,
            c.roi_extractor.finest_scale,
        )

    def _fused_pool(self, sem_feat: torch.Tensor, branch: str, out_size: Optional[int] = None):
        """pool(feats, rois): the FPN RoI features, plus the semantic ones
        when `cfg.htc.semantic_fusion` names `branch` ("bbox" or "mask")."""
        size = out_size or self.cfg.roi_extractor.out_size

        def pool(feats, rois):
            pooled = self._pool(feats, rois, size)
            if branch in self.cfg.htc.semantic_fusion:
                pooled = pooled + self._pool_semantic(sem_feat, rois, size).to(pooled.dtype)
            return pooled

        return pool

    def _predict_feats(self, feats, images, img_shapes, scale_factors, rescale=True, sem_feat=None) -> Detections:
        if sem_feat is None:
            sem_feat = self._semantic(feats)
        return super()._predict_feats(
            feats, images, img_shapes, scale_factors, rescale, self._fused_pool(sem_feat, "bbox")
        )

    @torch.inference_mode()
    def predict_with_masks(
        self,
        images: torch.Tensor,  # (B, H, W, 3)
        img_shapes: torch.Tensor,  # (B, 2) content (h, w) in network scale
        scale_factors: torch.Tensor,  # (B,) network / original scale
        rescale: bool = True,
    ) -> tuple[Detections, torch.Tensor]:
        """Detections and their masks (B, M, 28, 28) in the model dtype from
        one backbone and semantic pass (htc.py simple_test :157-199)."""
        feats = self.extract_feats(images)
        sem_feat = self._semantic(feats)
        dets = self._predict_feats(feats, images, img_shapes, scale_factors, rescale, sem_feat)
        # the rois pool at network scale: with rescale=False the boxes are there already
        sf = scale_factors if rescale else torch.ones_like(scale_factors)
        return dets, self._masks_feats(feats, dets.boxes, dets.labels, sf, sem_feat)

    def _masks_feats(self, feats, det_boxes, det_labels, scale_factors, sem_feat) -> torch.Tensor:
        c = self.cfg
        rois = det_boxes * scale_factors.float()[:, None, None]
        size = c.mask_head.mask_size // 2
        pooled = self._fused_pool(sem_feat, "mask", size)(feats, rois)  # (B, M, S, S, C)
        b, m = pooled.shape[:2]
        x = pooled.flatten(0, 1).permute(0, 3, 1, 2)
        labels = None if c.mask_head.class_agnostic else det_labels.flatten()
        last = agg = None
        for i, head in enumerate(self.mask_heads):
            logits, feat = head(x, res_feat=last if i > 0 else None, labels=labels)
            if c.htc.mask_info_flow:
                last = feat
            agg = logits if agg is None else agg + logits
        # divided by a tensor, so the card rounds as the CPU does
        avg = agg.float() / torch.tensor(float(len(self.mask_heads)), device=agg.device)
        if c.mask_head.class_agnostic:
            avg = avg[:, 0]
        return torch.sigmoid(avg).to(self.dtype).reshape(b, m, *avg.shape[-2:])


def build_htc(
    cfg: DetectorConfig, partition: Optional[GSPartition] = None, dtype: torch.dtype = torch.float32
) -> HTC:
    if cfg.htc is None or cfg.cascade is None or cfg.mask_head is None:
        raise ValueError("HTC needs cfg.htc, cfg.cascade and cfg.mask_head")
    if cfg.bbox_head.use_gs and partition is None:
        raise ValueError("GS heads require a GSPartition")
    return HTC(cfg, partition=partition, dtype=dtype)
