"""What the single-stage detectors share (JAX `models/retinanet.py`,
`fcos.py`, `fovea.py`, `reppoints.py` and `guided_anchor.py`): the ResNet-50
and FPN, seeded initialisation, the head outputs flattened as flax lays them
out, the per-level top-k of `predict` and its class-agnostic multiclass NMS
(K6, then K5).

Head outputs are NCHW tensors in the model dtype. flax emits them NHWC, its
channels grouped per location (A anchors of `last` values each), and JAX
flattens them with `reshape(b, -1, last)`; `flat` permutes to NHWC first, so
the port's rows are JAX's rows.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Sequence

import torch
from torch import nn

from ..kernels import batched_multiclass_nms
from ..ops.topk import top_k
from .detector import Detections
from .fpn import FPN
from .resnet import ResNet

FOCAL_BIAS = -4.595  # the focal heads' classification bias: prior probability 0.01


def flat(x: torch.Tensor, last: int) -> torch.Tensor:
    """(B, A * last, H, W) -> (B, H * W * A, last), flax's row order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, last)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (B, K) of each image's (B, N, ...) `x`."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def clip_to_image(boxes: torch.Tensor, img_shapes: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) boxes clipped to [0, w - 1] x [0, h - 1] of each image's
    (B, 2) content shape, as `jnp.clip` does it."""
    h = img_shapes[:, 0, None] - 1
    w = img_shapes[:, 1, None] - 1
    hi = torch.stack([w, h, w, h], dim=-1)
    return torch.minimum(boxes.clamp(min=0.0), hi)


def level_top_k(logits: torch.Tensor, k: int, gate: torch.Tensor | None = None):
    """The top `k` rows of a level by their best class score: (sigmoid
    scores (B, K, C) of those rows, their indices (B, K)). The score is
    sigmoid(logit), times the row's sigmoid `gate` (FCOS's centerness) when
    given. JAX takes the sigmoid of every logit and the best of each row; the
    sigmoid and the product with a positive gate are monotonic, so the best
    score is the score of the best logit, and only the K rows taken are
    scored."""
    best = torch.sigmoid(logits.amax(dim=-1).float())
    if gate is not None:
        best = best * gate
    _, idx = top_k(best, k)
    scores = torch.sigmoid(take(logits, idx).float())
    if gate is not None:
        scores = scores * take(gate, idx)[..., None]
    return scores, idx


class DenseDetector(nn.Module):
    """A model whose dense head's name (`HEAD`) and initialisers (`INIT`)
    the subclass gives; images enter (B, H, W, 3), as in JAX."""

    HEAD = "bbox_head"
    INIT: dict = {}  # parameter name pattern -> ("normal", std) | ("constant", value)

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self._grid_cache: dict = {}

    @property
    def head(self) -> nn.Module:
        return getattr(self, self.HEAD)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "DenseDetector":
        """Seeded random weights, drawn on the CPU so every device gets the
        same ones, after the JAX initialisers: lecun-normal convolutions and
        zero biases (flax's defaults), the head's own laws of `INIT`, and
        the constructed values of everything else (identity BatchNorm, FCOS's
        scales of 1, SSD's L2Norm scale of 20)."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            rule = next((r for pat, r in self.INIT.items() if fnmatch.fnmatchcase(name, pat)), None)
            if rule is None:
                if name.endswith(".bias"):
                    rule = ("constant", 0.0)
                elif p.dim() == 4:
                    rule = ("normal", 1.0 / math.sqrt(p[0].numel()))
                else:
                    continue
            kind, value = rule
            if kind == "normal":
                p.copy_(torch.randn(p.shape, generator=gen) * value)
            else:
                p.fill_(value)
        return self

    def _cached(self, key, make):
        """`make()` once a key: the static tables of a padded image shape,
        made as normal tensors even under `predict`'s inference mode, so that
        a later `loss` may save them for backward."""
        if key not in self._grid_cache:
            with torch.inference_mode(False):
                self._grid_cache[key] = make()
        return self._grid_cache[key]

    def _detections(self, boxes, scores, scale_factors, rescale: bool, background: bool = False) -> Detections:
        """(B, N, 4) class-agnostic boxes and (B, N, C) scores -> the
        class-agnostic multiclass NMS (K6, then K5). The sigmoid heads'
        scores get a zero background column first (`background=False`), as
        the JAX models give them."""
        c = self.cfg
        if rescale:
            boxes = boxes / scale_factors.float()[:, None, None]
        if not background:
            scores = torch.cat([scores.new_zeros(*scores.shape[:2], 1), scores], dim=-1)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
        return Detections(*batched_multiclass_nms(boxes, scores, valid, c.score_thr, c.nms_iou_thr, c.max_per_img))


class SingleStageDetector(DenseDetector):
    """A ResNet-50 and an FPN of five levels on the stages `fpn_inputs`
    (C3-C5 with two stride-2 max-pool extras by default) under a dense head."""

    fpn_inputs: Sequence[int] = (1, 2, 3)

    def __init__(self, cfg, head: nn.Module, dtype: torch.dtype = torch.float32, depth: int = 50):
        super().__init__(cfg, dtype)
        self.backbone = ResNet(depth)
        self.neck = FPN(tuple(256 * 2**i for i in self.fpn_inputs), 256, 5)
        self.add_module(self.HEAD, head)

    def extract(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) -> the five FPN levels (B, 256, H / s, W / s),
        in channels-last memory (the deformable convs read them as NHWC)."""
        stages = self.backbone(images.permute(0, 3, 1, 2).to(self.dtype))
        feats = self.neck([stages[i] for i in self.fpn_inputs])
        return tuple(f.contiguous(memory_format=torch.channels_last) for f in feats)

    def forward(self, images: torch.Tensor):
        """The head's outputs at each FPN level."""
        return self.head(self.extract(images))

    def _level_sizes(self, images: torch.Tensor) -> list[tuple[int, int]]:
        # the grid follows the actual padded batch shape (landscape or portrait)
        h, w = images.shape[1], images.shape[2]
        return [(-(-h // s), -(-w // s)) for s in self.cfg.strides]


def focal_targets(labels: torch.Tensor, pos: torch.Tensor, num_fg: int) -> torch.Tensor:
    """JAX's `one_hot(labels - 1, num_fg) * pos`: 1 at each positive's
    1-based label, made in place of f32 (no int64 one-hot of the whole
    (B, N, num_fg) block)."""
    onehot = torch.zeros(*labels.shape, num_fg, device=labels.device)
    return onehot.scatter_(-1, (labels.long() - 1).clamp(min=0)[..., None], pos[..., None].float())
