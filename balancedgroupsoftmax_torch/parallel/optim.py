"""The SGD recipe and parameter freezing (JAX `parallel/optim.py`:
`lr_schedule` :25, `trainable_mask` :53, `make_optimizer` :96).

SGD(lr 0.01, momentum 0.9, weight decay 1e-4) with the gradient's global
norm clipped at 35, a linear warmup from lr / 3 over 500 steps and x0.1 steps
at epochs 8 and 11 (bg8.py:170-178). Frozen parameters get
`requires_grad_(False)`, the reference's own semantics (apis/train.py:100):
no gradient, no weight decay, no part in the clip.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from ..config import TrainConfig


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of step `step` (counted from 0)."""
    boundaries = [e * steps_per_epoch for e in cfg.lr_step_epochs]

    def schedule(step: int) -> float:
        warm = cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * min(step / cfg.warmup_iters, 1.0)
        decay = 1.0
        for b in sorted(boundaries):
            decay *= 0.1 if step >= b else 1.0
        return cfg.lr * warm * decay

    return schedule


def trainable_mask(model: nn.Module, selectp: int = 0, frozen_stages: int = 1) -> Dict[str, bool]:
    """Parameter name -> trains (tools/train.py:143-158): selectp 0 trains
    everything but the stem and the first `frozen_stages` ResNet stages; 1
    only fc_cls (the BAGS phase 2); 2 the whole bbox head (every stage's, in
    a cascade); 3 every cascade stage's fc_cls; 4 the bbox and mask heads
    (every stage's, in HTC)."""
    if selectp not in (0, 1, 2, 3, 4):
        raise ValueError(f"selectp={selectp}: 0-4")
    frozen = set()
    if frozen_stages >= 0:
        frozen |= {"conv1", "bn1"}
    frozen |= {f"layer{s}" for s in range(1, frozen_stages + 1)}

    def decide(name: str) -> bool:
        if selectp in (1, 3):
            return "fc_cls" in name
        if selectp == 2:
            return name.startswith("bbox_head")
        if selectp == 4:
            return name.startswith(("bbox_head", "mask_head"))
        parts = name.split(".")
        return not (parts[0] == "backbone" and parts[1] in frozen)

    return {name: decide(name) for name, _ in model.named_parameters()}


def make_optimizer(
    cfg: TrainConfig, model: nn.Module, steps_per_epoch: int = 1, frozen_stages: int = 1
) -> tuple[torch.optim.SGD, LambdaLR]:
    """Freeze what `trainable_mask` leaves out and return SGD over the rest
    with its schedule. Step the schedule once after each optimizer step."""
    mask = trainable_mask(model, cfg.selectp, frozen_stages)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    optimizer = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    schedule = lr_schedule(cfg, steps_per_epoch)
    return optimizer, LambdaLR(optimizer, lambda step: schedule(step) / cfg.lr)
