"""RetinaNet of the PyTorch port against the JAX package: the shared
single-stage parity tests of tests/torch_single_stage_suite.py (conversion,
head outputs, predict, the losses and every gradient), and its targets: the
labels, positives and negatives of every anchor equal to those JAX's loss
computes, exactly, and the regression targets within 1e-6 of their largest
value (XLA's `log` and its fused multiply-adds part from PyTorch's in the
last bits; ROADMAP "Known differences")."""

import numpy as np
import torch

from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import model_fixture, port_model, recorded
from balancedgroupsoftmax_torch.models.single_stage import focal_targets

model = model_fixture("retinanet")


def test_targets_equal_jax(model):
    m = port_model(model)
    images, gt_boxes, gt_labels, gt_mask, img_shapes = model["batch"]
    labels, pos, neg, deltas = m.targets(torch.cat(m._anchors(images)), gt_boxes, gt_labels, gt_mask, img_shapes)
    focal, l1 = recorded(model, "sigmoid_focal_loss"), recorded(model, "smooth_l1")
    np.testing.assert_array_equal(focal_targets(labels, pos, m.cfg.num_classes - 1).numpy(), focal["1"])
    np.testing.assert_array_equal((pos | neg)[..., None].float().numpy(), focal["weight"])
    np.testing.assert_array_equal(pos[..., None].float().numpy(), l1["weight"])
    assert pos.sum() > 0 and neg.sum() > 0 and (~(pos | neg)).sum() > 0
    np.testing.assert_allclose(deltas.numpy(), l1["1"], rtol=0, atol=1e-6 * np.abs(l1["1"]).max())
