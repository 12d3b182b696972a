"""Weights of the JAX detector -> the port's `state_dict`.

`params_from_flax` reads the flax variables of
the JAX `models/detector.py` `FasterRCNN` or `models/cascade.py`
`CascadeRCNN` (whose stage heads `bbox_head_{i}` become `bbox_heads.{i}`) as
a tree of dicts of arrays ({"params": ..., "batch_stats": ...}; anything `np.asarray` reads) and
returns the tensors of `models.detector.FasterRCNN` under their names: conv
kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), and the frozen
BatchNorm statistics into the running buffers. `utils/checkpoint.py:119-196`
of the JAX package maps names the other way.

The RoI features flatten H-W-C in both packages, so `shared_fc0` needs no
permutation.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def params_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def conv(dst, node):
        sd[f"{dst}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
        if "bias" in node:
            sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def dense(dst, node):
        sd[f"{dst}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = np.asarray(p["scale"])
        sd[f"{dst}.bias"] = np.asarray(p["bias"])
        sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
        sd[f"{dst}.running_var"] = np.asarray(s["var"])

    bb, bs = params["backbone"], stats["backbone"]
    conv("backbone.conv1", bb["conv1"])
    bn("backbone.bn1", bb["bn1"], bs["bn1"])
    for name, node in bb.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m is None:
            continue
        dst = f"backbone.layer{m[1]}.{m[2]}"
        for i in (1, 2, 3):
            conv(f"{dst}.conv{i}", node[f"conv{i}"])
            bn(f"{dst}.bn{i}", node[f"bn{i}"], bs[name][f"bn{i}"])
        if "downsample_conv" in node:
            conv(f"{dst}.downsample.0", node["downsample_conv"])
            bn(f"{dst}.downsample.1", node["downsample_bn"], bs[name]["downsample_bn"])

    for name, node in params["neck"].items():
        kind, i = re.fullmatch(r"(lateral|fpn)(\d+)", name).groups()
        conv(f"neck.{kind}.{i}", node)
    for name, node in params["rpn_head"].items():
        conv(f"rpn_head.{name}", node)
    for key, head in params.items():
        stage = re.fullmatch(r"bbox_head(?:_(\d+))?", key)
        if stage is None:
            continue
        dst = "bbox_head" if stage[1] is None else f"bbox_heads.{stage[1]}"
        for name, node in head.items():
            m = re.fullmatch(r"shared_fc(\d+)", name)
            dense(f"{dst}.shared_fcs.{m[1]}" if m else f"{dst}.{name}", node)

    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}
