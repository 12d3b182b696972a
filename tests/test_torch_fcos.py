"""FCOS of the PyTorch port against the JAX package: the shared single-stage
parity tests of tests/torch_single_stage_suite.py, its point grid, its
targets (labels, positives, the ltrb targets as the boxes JAX's IoU loss
decodes) equal to those JAX's loss computes, exactly, and the centerness
targets within 1e-6 (the jitted JAX loss rounds one of them a bit apart), and `bbox_overlaps(is_aligned=True)`, which its IoU loss and
GA-RPN's shape loss call, equal to JAX's, degenerate boxes included."""

import jax.numpy as jnp
import numpy as np
import torch

from balancedgroupsoftmax_tpu.models.fcos import _points as jax_points
from balancedgroupsoftmax_tpu.ops.boxes import bbox_overlaps as jax_bbox_overlaps
from balancedgroupsoftmax_torch.models.fcos import _points, fcos_targets, ltrb_boxes
from balancedgroupsoftmax_torch.models.single_stage import focal_targets
from balancedgroupsoftmax_torch.ops.boxes import bbox_overlaps
from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import model_fixture, port_model, recorded

model = model_fixture("fcos")


def test_points_equal_jax():
    for h, w, s in ((16, 16, 8), (13, 21, 64), (1, 1, 128), (7, 11, 128)):
        np.testing.assert_array_equal(_points(h, w, s), jax_points(h, w, s))


def test_targets_equal_jax(model):
    m = port_model(model)
    images, gt_boxes, gt_labels, gt_mask, _ = model["batch"]
    points, ranges = m._level_points(images)
    labels, pos, tgt, ctr_t = fcos_targets(points, ranges, gt_boxes, gt_labels, gt_mask)
    focal = recorded(model, "sigmoid_focal_loss")
    np.testing.assert_array_equal(focal_targets(labels, pos, m.cfg.num_classes - 1).numpy(), focal["1"])
    assert 0 < int(pos.sum()) < pos.numel()
    np.testing.assert_array_equal(ltrb_boxes(points, tgt).numpy(), recorded(model, "bbox_overlaps")["1"])
    bce = recorded(model, "binary_cross_entropy_with_logits")
    # a root of two quotients: the jitted loss rounds one in 682 a bit apart
    np.testing.assert_allclose(ctr_t.numpy(), bce["1"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pos.float().numpy(), bce["weight"])


def test_aligned_overlaps_equal_jax():
    """Random boxes, and degenerate ones: zero and negative widths after the
    +1, points, disjoint and identical pairs (the 1e-6 floor)."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (2, 64, 2)).astype(np.float32)
    a = np.concatenate([xy, xy + rng.uniform(-3, 60, (2, 64, 2)).astype(np.float32)], -1)
    b = np.concatenate([xy + rng.uniform(-20, 20, (2, 64, 2)), xy + rng.uniform(-5, 60, (2, 64, 2))], -1).astype(np.float32)
    a[:, 0] = b[:, 0] = [10, 10, 8, 8]  # x2 - x1 + 1 < 0 in both
    a[:, 1] = b[:, 1] = [5, 5, 4, 5]  # zero width after the +1
    a[:, 2], b[:, 2] = [0, 0, 0, 0], [50, 50, 60, 60]  # a one-pixel point, disjoint
    a[:, 3] = b[:, 3] = [20, 20, 40, 50]  # identical
    got = bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), is_aligned=True)
    want = np.asarray(jax_bbox_overlaps(jnp.asarray(a), jnp.asarray(b), is_aligned=True))
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all() and want[:, 3].min() == 1.0
