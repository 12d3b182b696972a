"""Checkpoints: save, restore and resume, the phase-2 warm start, and
torchvision ResNet weights (JAX `utils/checkpoint.py`: `save_checkpoint`
:34, `restore_checkpoint` :72, `warm_start` :85-116,
`convert_torchvision_resnet` :124-170, `load_torchvision_resnet` :173-184).

A checkpoint is one `torch.save`d dict, read back with `weights_only=True`:
"model", the model's `state_dict`; for a training run also "train", the
`TrainState.state_dict()` (optimizer, schedule, step, sampling generator),
and "loader", where the run stood in its data ({"epoch", "batch"}: batches of
that epoch already taken). A `.meta.json` sidecar beside it says what wrote it
(the JAX train CLI writes the same, tools/train.py:424-436).

The reference warm-starts BAGS phase 2 from the baseline with mmcv's
non-strict load, so the widened GS `fc_cls` (1231 -> 1236 logits) keeps its
fresh initialisation. `nn.Module.load_state_dict(strict=False)` raises on a
shape mismatch, so `warm_start` leaves such tensors out before loading.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


def save_checkpoint(path: str, checkpoint: dict, meta: Optional[dict] = None) -> None:
    """Write `checkpoint` to `path` through a temporary file, so a run
    stopped mid-write leaves no partial checkpoint, and `meta` to the
    sidecar `<path without its extension>.meta.json`."""
    tmp = path + ".tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(os.path.splitext(path)[0] + ".meta.json", "w") as f:
            json.dump(meta, f, indent=1, default=str)


def restore_checkpoint(path: str) -> dict:
    """The dict `save_checkpoint` wrote, on the CPU. A bare state_dict (as
    `torch.save(model.state_dict())` writes it) comes back as {"model": it}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" not in ckpt:
        ckpt = {"model": ckpt}
    return ckpt


def warm_start(model: nn.Module, loaded: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Copy into `model` every tensor of its state_dict whose name and shape
    `loaded` has. Returns (copied, fresh): the names copied, and those left
    at their initialisation (missing or of another shape)."""
    copied, fresh = [], []
    take = {}
    for name, t in model.state_dict().items():
        src = loaded.get(name)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            take[name] = src
            copied.append(name)
        else:
            fresh.append(name)
    model.load_state_dict(take, strict=False)
    return copied, fresh


def convert_torchvision_resnet(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet's state_dict -> the port's backbone tensors. The
    port's ResNet keeps torchvision's names (conv1, bn1, layer{s}.{b}.conv{i},
    bn{i}, downsample.0/1), under "backbone."; the classifier `fc` and BN's
    `num_batches_tracked` have no counterpart."""
    stem = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")
    return {
        f"backbone.{k}": v.float()
        for k, v in state_dict.items()
        if k.startswith(stem) and not k.endswith("num_batches_tracked")
    }


def load_torchvision_resnet(path: str) -> Dict[str, torch.Tensor]:
    """`convert_torchvision_resnet` of a torchvision .pth (a state_dict, or a
    dict holding one under "state_dict")."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torchvision_resnet(sd.get("state_dict", sd))
