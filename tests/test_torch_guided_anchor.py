"""GA-RPN of the PyTorch port against the JAX package: the shared
single-stage parity tests of tests/torch_single_stage_suite.py (`propose`
through K1's plain version; the adaption DCN through K7's at D = 0), its
location targets (`ga_loc_targets`, per image as JAX's and batched) and its
generated anchors against JAX's, the location targets JAX's loss hands its
focal loss, exactly, and the RPN logits and deltas of the adapted features
in f64 against JAX in f64 within 1e-5 of their largest value (in f32 the
adaption DCN's sums part from the port's own f64 by up to 7.7e-6 of it), with
every gradient there."""

import jax.numpy as jnp
import numpy as np
import torch

from balancedgroupsoftmax_tpu.models.guided_anchor import GAConfig as JaxGAConfig
from balancedgroupsoftmax_tpu.models.guided_anchor import _generated_anchors as jax_generated_anchors
from balancedgroupsoftmax_tpu.models.guided_anchor import ga_loc_targets as jax_ga_loc_targets
from balancedgroupsoftmax_torch.models.guided_anchor import GAConfig, _generated_anchors, ga_loc_targets
from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import f64_run, model_fixture, port_model, recorded

model = model_fixture("guided_anchor")


def test_loc_targets_equal_jax(model):
    m = port_model(model)
    images, gt_boxes, _, gt_mask, _ = model["batch"]
    points, strides, lvls = m._meta(images)
    cfg = GAConfig(image_size=(128, 128))
    got = ga_loc_targets(points, strides, lvls, gt_boxes, gt_mask, cfg)
    for i in range(gt_boxes.shape[0]):
        want = jax_ga_loc_targets(jnp.asarray(points.numpy()), jnp.asarray(strides.numpy()), jnp.asarray(lvls.numpy()),
                                  jnp.asarray(gt_boxes[i].numpy()), jnp.asarray(gt_mask[i].numpy()), JaxGAConfig(image_size=(128, 128)))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(ga_loc_targets(points, strides, lvls, gt_boxes[i], gt_mask[i], cfg).numpy(), np.asarray(want))
    assert {-1, 0, 1} <= set(np.unique(got.numpy()))
    focal = recorded(model, "sigmoid_focal_loss")
    np.testing.assert_array_equal((got == 1).float().numpy(), focal["1"])
    np.testing.assert_array_equal((got >= 0).float().numpy(), focal["weight"])


def test_generated_anchors_equal_jax(model):
    """exp of the clipped shape (ROADMAP "Known differences": XLA's
    transcendentals may part from PyTorch's in the last bit), so within 1e-6
    of the largest coordinate."""
    m = port_model(model)
    points, strides, _ = m._meta(model["batch"][0])
    shape_pred = np.random.RandomState(3).randn(points.shape[0], 2).astype(np.float32) * 3  # some beyond the clip at 4
    got = _generated_anchors(torch.from_numpy(shape_pred), points, strides, 8.0)
    want = np.asarray(jax_generated_anchors(jnp.asarray(shape_pred), jnp.asarray(points.numpy()), jnp.asarray(strides.numpy()), 8.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_adapted_outputs_and_every_gradient_match_jax_in_f64(model):
    (jheads, jgrads), (heads, grads) = f64_run(model)
    for lvl, (got, want) in enumerate(zip(heads, jheads)):
        for i, (g, w) in enumerate(zip(got, want)):
            g = g.permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=f"level {lvl} output {i}")
    assert sorted(grads) == sorted(jgrads)
    for name, w in jgrads.items():
        w = w.double().numpy()
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-300, err_msg=name)
