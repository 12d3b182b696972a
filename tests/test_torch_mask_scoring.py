"""Mask-Scoring R-CNN of the PyTorch port against the JAX package: the
shared variant parity tests of tests/torch_variant_suite.py (`build_model`
and the conversion, `predict_with_masks` with its masks and mask scores,
the loss dict with "loss_mask_iou" and every gradient, `trainable_mask`, a
training step), and:

- `MaskIoUHead` on converted flax weights (its 2x2 max-pooled prediction
  channel, stride-2 last conv and NHWC flatten into `fc0`) and
  `mask_iou_target`, against JAX's;
- the mask and MaskIoU branch in f64 on JAX's features, targets (eight
  slots an image) and pooling, with gt crops of seeded values in [0, 1] (no
  resampled target on the 0.5 threshold): "loss_mask", "loss_mask_iou" and
  every gradient of the mask and MaskIoU heads within 1e-5 (the f32 check
  leaves both heads to it: see tests/torch_variant_suite.py). The target's
  gradient is stopped; the prediction's reaches the mask head.
"""

import jax
import numpy as np
import torch

from balancedgroupsoftmax_tpu.models.extra_heads import MaskIoUHead as JaxMaskIoUHead
from balancedgroupsoftmax_tpu.models.extra_heads import mask_iou_target as jax_mask_iou_target
from balancedgroupsoftmax_torch import convert
from balancedgroupsoftmax_torch.models.extra_heads import MaskIoUHead, mask_iou_target
from torch_variant_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_variant_suite import F64_HELD, branch_in_f64, setup_of, variant_fixture

variant = variant_fixture(["mask_scoring"])


def test_mask_iou_head_matches_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(5, 14, 14, 256).astype(np.float32)
    pred = rng.rand(5, 28, 28).astype(np.float32)
    jhead = JaxMaskIoUHead(num_classes=9)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(1), feats, pred)
    want = np.asarray(jax.jit(jhead.apply)(params, feats, pred))
    sd = {}
    for name, node in jax.tree_util.tree_map(np.asarray, params["params"]).items():
        convert._layer(sd, name, node)
    head = MaskIoUHead(9)
    head.load_state_dict(convert._tensors(sd))
    with torch.no_grad():
        got = head(torch.from_numpy(feats).permute(0, 3, 1, 2), torch.from_numpy(pred)).numpy()
    assert got.shape == want.shape == (5, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mask_iou_target_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.rand(16, 28, 28).astype(np.float32)
    targets = (rng.rand(16, 28, 28) > 0.6).astype(np.float32)
    areas = rng.uniform(0.0, 1.2, 16).astype(np.float32)  # beyond both clip ends
    areas[:2] = [0.0, 1.0]
    want = np.asarray(jax.jit(jax_mask_iou_target)(pred, targets, areas))
    got = mask_iou_target(*map(torch.from_numpy, (pred, targets, areas))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = torch.ones(2, 28, 28)
    np.testing.assert_allclose(mask_iou_target(m, m, torch.full((2,), 0.5)).numpy(), 0.5, atol=1e-6)


def test_mask_scoring_branch_in_f64_matches_jax():
    setup = setup_of("mask_scoring")
    crops = np.random.RandomState(5).rand(*setup["batch"][5].shape).astype(np.float32)
    want, jgrads, losses, model = branch_in_f64(setup, crops, slots=8, pooled_from_jax=True)
    assert sorted(losses) == sorted(want) == ["loss_mask", "loss_mask_iou"]
    for k, w in want.items():
        np.testing.assert_allclose(losses[k].item(), w, rtol=1e-6, err_msg=k)
    held = [(n, p) for n, p in model.named_parameters() if n.startswith(F64_HELD["mask_scoring"])]
    assert {n.split(".")[0] for n, _ in held} == {"mask_head", "mask_iou_head"}
    for name, p in held:
        w = jgrads[name].double().numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
