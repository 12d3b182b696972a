"""The single-card training step (JAX `parallel/train.py`: `TrainState` :36,
`create_train_state` :44, `make_train_step` :53).

One card: the loss and its backward, the gradient's global norm clipped over
the trainable parameters, an SGD step and a schedule step. Data parallelism
over several cards is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.optim.lr_scheduler import LambdaLR

from ..config import TrainConfig
from ..models.detector import FasterRCNN
from .optim import make_optimizer

BATCH_KEYS = ("images", "gt_boxes", "gt_labels", "gt_mask", "img_shapes")


@dataclasses.dataclass
class TrainState:
    model: FasterRCNN
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    grad_clip_norm: float
    step: int = 0


def create_train_state(model: FasterRCNN, cfg: TrainConfig, steps_per_epoch: int = 1) -> TrainState:
    """Freeze the parameters `cfg.selectp` and the backbone's
    `frozen_stages` leave out, and set up SGD over the rest."""
    optimizer, scheduler = make_optimizer(cfg, model, steps_per_epoch, model.cfg.backbone.frozen_stages)
    return TrainState(model, optimizer, scheduler, cfg.grad_clip_norm)


def make_train_step(state: TrainState) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, generator) -> metrics: the loss dict, detached,
    plus "loss", the sum of its "loss*" entries. `batch` holds images
    (B, H, W, 3), gt_boxes (B, G, 4), gt_labels (B, G), gt_mask (B, G) and
    img_shapes (B, 2) as tensors or arrays (`data.pipeline.collate`); they
    are moved to the model's device. Sampling draws from `generator`."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    device = next(state.model.parameters()).device

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        inputs = [torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS]
        state.optimizer.zero_grad(set_to_none=True)
        losses = state.model.loss(*inputs, generator=generator)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        total.backward()
        torch.nn.utils.clip_grad_norm_(params, state.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        return metrics

    return step
