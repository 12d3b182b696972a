"""The single-card training step (JAX `parallel/train.py`: `TrainState` :36,
`create_train_state` :44, `make_train_step` :53).

One card: the loss and its backward, the gradient's global norm clipped over
the trainable parameters, an SGD step and a schedule step. Any detector with
`loss` trains (Faster R-CNN, Cascade R-CNN, HTC, whose batches also hold
`gt_mask_crops`). The total sums every entry whose
name holds "loss", as mmdet's `parse_losses` does, so the cascade's
"s{i}.loss_*" stage losses count. Data parallelism over several cards is not
ported yet.

`TrainState.state_dict` is what a resume needs beside the model's weights:
the optimizer's state (SGD momentum), the schedule's, the step and the
sampling generator's state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from ..config import TrainConfig
from .optim import make_optimizer

BATCH_KEYS = ("images", "gt_boxes", "gt_labels", "gt_mask", "img_shapes")
MASK_KEY = "gt_mask_crops"  # (B, G, CROP, CROP), in the batches of models with a mask head


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # a detector with `cfg` and `loss`
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    grad_clip_norm: float
    step: int = 0
    generator: Optional[torch.Generator] = None  # the sampling draws', where the step is given none

    def trained(self) -> list[str]:
        """The names of the parameters the optimizer trains, in its order."""
        names = {p: n for n, p in self.model.named_parameters()}
        return [names[p] for group in self.optimizer.param_groups for p in group["params"]]

    def state_dict(self) -> dict:
        return dict(
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            step=self.step,
            generator=None if self.generator is None else self.generator.get_state(),
            trained=self.trained(),
        )

    def load_state_dict(self, state: dict) -> None:
        """Restore what `state_dict` gave. Refuses a state whose optimizer
        trained other parameters (another `selectp`): its momentum would
        land on the wrong tensors, or restart unseen. The generator's state
        is set on the generator's own device."""
        if state["trained"] != self.trained():
            raise ValueError(
                f"the checkpoint's optimizer trains {len(state['trained'])} parameters "
                f"({', '.join(state['trained'][:3])}, ...), this run {len(self.trained())}: "
                "resume with the selectp the checkpoint was trained with"
            )
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        if state["generator"] is not None and self.generator is not None:
            self.generator.set_state(state["generator"].cpu())


def create_train_state(
    model: nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1, generator: Optional[torch.Generator] = None
) -> TrainState:
    """Freeze the parameters `cfg.selectp` and the backbone's
    `frozen_stages` leave out, and set up SGD over the rest."""
    optimizer, scheduler = make_optimizer(cfg, model, steps_per_epoch, model.cfg.backbone.frozen_stages)
    return TrainState(model, optimizer, scheduler, cfg.grad_clip_norm, generator=generator)


def make_train_step(state: TrainState) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, generator) -> metrics: the loss dict, detached,
    plus "loss", the sum of the entries whose name holds "loss". `batch` holds images
    (B, H, W, 3), gt_boxes (B, G, 4), gt_labels (B, G), gt_mask (B, G) and
    img_shapes (B, 2) as tensors or arrays (`data.pipeline.collate`), and
    gt_mask_crops (B, G, CROP, CROP) where the model has a mask head (JAX
    `parallel/train.py:84`); they are moved to the model's device. Sampling
    draws from `generator`, or else from the state's."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    device = next(state.model.parameters()).device

    def step(batch, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        inputs = [torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS + ((MASK_KEY,) if MASK_KEY in batch else ())]
        state.optimizer.zero_grad(set_to_none=True)
        losses = state.model.loss(*inputs, generator=state.generator if generator is None else generator)
        total = sum(v for k, v in losses.items() if "loss" in k)
        total.backward()
        torch.nn.utils.clip_grad_norm_(params, state.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        return metrics

    return step
