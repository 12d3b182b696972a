"""Weights of the JAX detector -> the port's `state_dict`.

`params_from_flax` reads the flax variables of the JAX `models/detector.py`
`FasterRCNN` (Mask R-CNN's with its `mask_head`), `models/cascade.py`
`CascadeRCNN` (whose stage heads `bbox_head_{i}` become `bbox_heads.{i}`) or
`models/htc.py` `HTC` (with `semantic_head` and `mask_head_{i}`, which become
`mask_heads.{i}`) or a variant of `models/variants.py` (Fast R-CNN's, with no
`rpn_head`; Grid R-CNN's `grid_head` and its GroupNorm `scale`s; Mask-Scoring
R-CNN's `mask_iou_head`; the Double-Head's `bbox_head` convs and FCs) or a
single-stage detector of `models/{retinanet,fcos,fovea,reppoints,
guided_anchor,ssd}.py` (whose heads, GA-RPN's `rpn_head` and SSD's VGG keep
their flax names; the RepPoints and GA-RPN deformable kernels are raw
(3, 3, C_in, C_out) parameters) as a
tree of dicts of arrays ({"params": ..., "batch_stats": ...}; anything `np.asarray` reads) and returns the tensors of the port's model
under their names, refusing a top-level node it has no mapping for: conv
kernels HWIO -> OIHW (a grouped kernel (kh, kw, C / g, C) becomes the
(C, C / g, kh, kw) that `Conv2d(groups=g)` holds; a deformable conv's
`kernel` and its `conv_offset` alike), dense kernels (in, out) -> (out, in),
the frozen BatchNorm statistics into the running buffers, and transposed-conv
kernels with both spatial axes flipped (flax's `ConvTranspose` reads its
kernel in the opposite spatial order to `torch.nn.ConvTranspose2d`).
`utils/checkpoint.py:119-196` of the JAX package maps names the other way.

The RoI features flatten H-W-C in both packages, so `shared_fc0` needs no
permutation. `save_flax_checkpoint` writes the converted weights as a
checkpoint of the train CLI's format, which `tools.test_lvis --checkpoint`,
`--load-from` and `apis.init_detector` read.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from .utils.checkpoint import save_checkpoint


def _conv(sd, dst, node) -> None:
    """A conv's kernel and bias, and any nested conv (a DCN's `conv_offset`)."""
    sd[f"{dst}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
    for name, sub in node.items():
        if name == "bias":
            sd[f"{dst}.bias"] = np.asarray(sub)
        elif isinstance(sub, Mapping):
            _conv(sd, f"{dst}.{name}", sub)


def _conv_transpose(sd, dst, node) -> None:
    """flax ConvTranspose (kh, kw, in, out) -> torch (in, out, kh, kw), flipped."""
    sd[f"{dst}.weight"] = np.transpose(np.asarray(node["kernel"])[::-1, ::-1], (2, 3, 0, 1))
    sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _dense(sd, dst, node) -> None:
    sd[f"{dst}.weight"] = np.asarray(node["kernel"]).T
    sd[f"{dst}.bias"] = np.asarray(node["bias"])


def _bn(sd, dst, p, s) -> None:
    sd[f"{dst}.weight"] = np.asarray(p["scale"])
    sd[f"{dst}.bias"] = np.asarray(p["bias"])
    sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
    sd[f"{dst}.running_var"] = np.asarray(s["var"])


def _bottleneck(sd, dst, node, stats) -> None:
    for i in (1, 2, 3):
        _conv(sd, f"{dst}.conv{i}", node[f"conv{i}"])
        _bn(sd, f"{dst}.bn{i}", node[f"bn{i}"], stats[f"bn{i}"])
    if "downsample_conv" in node:
        _conv(sd, f"{dst}.downsample.0", node["downsample_conv"])
        _bn(sd, f"{dst}.downsample.1", node["downsample_bn"], stats["downsample_bn"])


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # np.array, not np.ascontiguousarray, keeps a 0-d scalar 0-d (FCOS's `scale{lvl}`)
    return {k: torch.tensor(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def conv_from_flax(node: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One flax conv (or `DeformConv`) -> the state_dict of the port's layer."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "", node)
    return _tensors({k[1:]: v for k, v in sd.items()})


def conv_transpose_from_flax(node: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One flax `ConvTranspose` -> the state_dict of the port's `ConvTranspose2d`."""
    sd: Dict[str, np.ndarray] = {}
    _conv_transpose(sd, "", node)
    return _tensors({k[1:]: v for k, v in sd.items()})


def bottleneck_from_flax(params: Dict[str, Any], stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One flax `Bottleneck` -> the state_dict of the port's `Bottleneck`."""
    sd: Dict[str, np.ndarray] = {}
    _bottleneck(sd, "", params, stats)
    return _tensors({k[1:]: v for k, v in sd.items()})


def _mask_head(sd, dst, head) -> None:
    """An `FCNMaskHead`: conv{i} -> convs.{i}, the flipped `upsample`,
    `conv_logits` and HTC's `conv_res` as they are."""
    for name, node in head.items():
        m = re.fullmatch(r"conv(\d+)", name)
        if name == "upsample":
            _conv_transpose(sd, f"{dst}.upsample", node)
        else:
            _conv(sd, f"{dst}.convs.{m[1]}" if m else f"{dst}.{name}", node)


def _layer(sd, dst, node, transposed: bool = False) -> None:
    """A layer or parameter that keeps its flax name: a raw parameter (a
    deformable kernel (kh, kw, C_in, C_out) -> (C_out, C_in, kh, kw), FCOS's
    scalar `scale{lvl}`), a GroupNorm (`scale`, `bias`), SSD's L2Norm
    (`scale`), a dense layer (2-D kernel), a transposed conv (flipped) or a
    conv."""
    if not isinstance(node, Mapping):
        a = np.asarray(node)
        sd[dst] = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a
    elif "scale" in node and "bias" not in node:
        sd[f"{dst}.scale"] = np.asarray(node["scale"])
    elif "scale" in node:
        sd[f"{dst}.weight"] = np.asarray(node["scale"])
        sd[f"{dst}.bias"] = np.asarray(node["bias"])
    elif np.ndim(node["kernel"]) == 2:
        _dense(sd, dst, node)
    elif transposed:
        _conv_transpose(sd, dst, node)
    else:
        _conv(sd, dst, node)


# the top-level nodes of the JAX detectors' params that the port maps
MAPPED = r"backbone|neck|rpn_head|bbox_head(_\d+)?|semantic_head|mask_head(_\d+)?|grid_head|mask_iou_head"


def params_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    unmapped = sorted(k for k in params if re.fullmatch(MAPPED, k) is None)
    unmapped += sorted(f"batch_stats/{k}" for k in stats if k != "backbone")
    if unmapped:
        raise ValueError(f"no mapping to the port's model for the flax nodes {unmapped}")
    sd: Dict[str, np.ndarray] = {}

    bb = params["backbone"]
    if "bn1" not in bb:  # SSD's VGG: no BatchNorm, and its layers keep their flax names
        for name, node in bb.items():
            _layer(sd, f"backbone.{name}", node)
    else:
        bs = stats["backbone"]
        _conv(sd, "backbone.conv1", bb["conv1"])
        _bn(sd, "backbone.bn1", bb["bn1"], bs["bn1"])
        for name, node in bb.items():
            m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
            if m is not None:
                _bottleneck(sd, f"backbone.layer{m[1]}.{m[2]}", node, bs[name])

    # SSD has no FPN
    for name, node in params.get("neck", {}).items():
        kind, i = re.fullmatch(r"(lateral|fpn)(\d+)", name).groups()
        _conv(sd, f"neck.{kind}.{i}", node)
    # Fast R-CNN and the single-stage detectors have no RPN; GA-RPN's keeps its
    # flax names, its deformable kernel among them
    for name, node in params.get("rpn_head", {}).items():
        _layer(sd, f"rpn_head.{name}", node)
    for key, head in params.items():
        stage = re.fullmatch(r"bbox_head(?:_(\d+))?", key)
        if stage is None:
            continue
        dst = "bbox_head" if stage[1] is None else f"bbox_heads.{stage[1]}"
        for name, node in head.items():
            # the shared FCs, or the Double-Head's convs and FCs, or a dense
            # head's towers, convs and raw parameters, under their own names
            m = re.fullmatch(r"shared_fc(\d+)", name)
            _layer(sd, f"{dst}.shared_fcs.{m[1]}" if m else f"{dst}.{name}", node)

    for name, node in params.get("semantic_head", {}).items():
        m = re.fullmatch(r"(lateral|conv)(\d+)", name)
        kind = {"lateral": "lateral", "conv": "convs"}[m[1]] if m else None
        _conv(sd, f"semantic_head.{kind}.{m[2]}" if m else f"semantic_head.{name}", node)
    for key, head in params.items():
        stage = re.fullmatch(r"mask_head(?:_(\d+))?", key)
        if stage is not None:
            _mask_head(sd, "mask_head" if stage[1] is None else f"mask_heads.{stage[1]}", head)
    # Grid R-CNN's and Mask-Scoring R-CNN's heads keep the flax names
    for key in ("grid_head", "mask_iou_head"):
        for name, node in params.get(key, {}).items():
            _layer(sd, f"{key}.{name}", node, transposed=name.startswith("up"))

    return _tensors(sd)


def save_flax_checkpoint(variables: Dict[str, Any], path: str) -> None:
    """The JAX detector's variables (numpy) -> a port checkpoint at `path`."""
    save_checkpoint(path, {"model": params_from_flax(variables)}, meta={"converted_from": "flax variables"})
