"""FoveaBox of the PyTorch port against the JAX package: the shared
single-stage parity tests of tests/torch_single_stage_suite.py and its
targets: the labels and positives of every cell equal to those JAX's loss
computes, exactly, and the log-distance targets within 1e-6 of their
largest value (XLA's `log` parts from PyTorch's in the last bit; ROADMAP
"Known differences")."""

import numpy as np

from balancedgroupsoftmax_torch.models.fovea import fovea_targets
from balancedgroupsoftmax_torch.models.single_stage import focal_targets
from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import model_fixture, port_model, recorded

model = model_fixture("fovea")


def test_targets_equal_jax(model):
    m = port_model(model)
    images, gt_boxes, gt_labels, gt_mask, _ = model["batch"]
    points, bases, ranges = m._level_meta(images)
    labels, pos, tgt = fovea_targets(points, bases, ranges, gt_boxes, gt_labels, gt_mask, m.cfg.sigma)
    focal, l1 = recorded(model, "sigmoid_focal_loss"), recorded(model, "smooth_l1")
    np.testing.assert_array_equal(focal_targets(labels, pos, m.cfg.num_classes - 1).numpy(), focal["1"])
    np.testing.assert_array_equal(pos[..., None].float().numpy(), l1["weight"])
    assert 0 < int(pos.sum()) < pos.numel()
    np.testing.assert_allclose(tgt.numpy(), l1["1"], rtol=0, atol=1e-6 * np.abs(l1["1"]).max())
