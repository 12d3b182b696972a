"""RepPoints of the PyTorch port against the JAX package: the shared
single-stage parity tests of tests/torch_single_stage_suite.py (its two
deformable convolutions run K7's plain version at D = 0 on offsets spread
over several cells), `points_to_boxes`, the init stage's targets (the
point each gt claims and its box, over 4 x stride) equal to those JAX's loss
computes, exactly, and the NCHW deformable convolution of the head against
JAX `ops/deform_conv.py deform_conv2d` at `shift_window=0` on RepPoints-shaped
offsets (nine points spread over several cells, some far outside the
image), forward within 1e-5 and every gradient within 1e-3 of its largest
value; and the routes K7 and K7b take at the single-stage layers (256 -> 256,
one group): no grouped plan fits, so the dense route takes them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from balancedgroupsoftmax_tpu.models.reppoints import _DCN_BASE as JAX_DCN_BASE
from balancedgroupsoftmax_tpu.models.reppoints import points_to_boxes as jax_points_to_boxes
from balancedgroupsoftmax_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from balancedgroupsoftmax_torch.models.reppoints import _DCN_BASE, deform_conv, points_to_boxes, reppoints_targets
from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn
from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import model_fixture, port_model, recorded

model = model_fixture("reppoints")


def test_points_to_boxes_equal_jax():
    rng = np.random.RandomState(1)
    pts = rng.randn(2, 50, 18).astype(np.float32) * 3
    centers = rng.uniform(0, 128, (50, 2)).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], 50).astype(np.float32)
    got = points_to_boxes(torch.from_numpy(pts), torch.from_numpy(centers)[None], torch.from_numpy(strides)[None, :, None])
    want = jax_points_to_boxes(jnp.asarray(pts), jnp.asarray(centers)[None], jnp.asarray(strides)[None, :, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_DCN_BASE, JAX_DCN_BASE)


def test_init_targets_equal_jax(model):
    m = port_model(model)
    images, gt_boxes, gt_labels, gt_mask, _ = model["batch"]
    centers, strides, lvl_ids = m._meta(images)
    init = recorded(model, "smooth_l1", 0)  # the init stage's call, then the refine stage's
    norm = (m.cfg.point_base_scale * strides)[None, :, None]
    boxes_init = torch.from_numpy(init["0"]) * norm  # JAX's init boxes: the refine targets' input
    init_pos, init_tgt, _, _, _ = reppoints_targets(
        centers, lvl_ids, boxes_init, gt_boxes, gt_labels, gt_mask, m.cfg.point_base_scale, m.cfg.strides
    )
    np.testing.assert_array_equal((init_pos[..., None].float() * 0.5).numpy(), init["weight"])
    assert int(init_pos.sum()) == int(gt_mask.sum())
    np.testing.assert_array_equal((init_tgt / norm).numpy(), init["1"])


def test_deform_conv_at_d0_equals_jax_on_reppoints_offsets():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 12, 20, 32
    x = rng.randn(b, h, w, c).astype(np.float32)
    pts = (rng.randn(b, h, w, 18) * 2.5).astype(np.float32)
    pts[0, :2] += 9.0  # points far below the image's last row
    off = pts - _DCN_BASE
    weight = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)  # flax layout
    cot = rng.randn(b, h, w, c).astype(np.float32)

    def jax_fn(x, off, weight):
        out = jax.vmap(lambda xi, oi: jax_deform_conv2d(xi, oi, weight, shift_window=0))(x, off)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True))(x, off, weight)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    toff = torch.from_numpy(off).permute(0, 3, 1, 2).requires_grad_()
    tw = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()).requires_grad_()
    out = deform_conv(tx, toff, tw)
    want = np.asarray(want)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    for name, got, jg in (("x", tx.grad.permute(0, 2, 3, 1), jgrads[0]), ("offsets", toff.grad.permute(0, 2, 3, 1), jgrads[1]),
                          ("weight", tw.grad.permute(2, 3, 1, 0), jgrads[2])):
        jg = np.asarray(jg)
        np.testing.assert_allclose(got.numpy(), jg, rtol=0, atol=1e-3 * np.abs(jg).max(), err_msg=name)


# (B, Ho, Wo) of the deformable layers at 800 x 1344, batch 2: RepPoints' five
# levels (strides 8-128), then GA-RPN's stride-4 level
SINGLE_STAGE_LAYERS = [(2, 100, 168), (2, 50, 84), (2, 25, 42), (2, 13, 21), (2, 7, 11), (2, 200, 336)]


def test_single_stage_layers_take_the_dense_route():
    for b, h, w in SINGLE_STAGE_LAYERS:
        assert ops_dcn.launch_plan(b, h, w, 256, 1, 256, 3, 3, 1, 0) is None
        assert ops_dcn.backward_plan(b, h, w, 256, 1, 256, 3, 3, 1, 0) is None
        assert ops_dcn.backward_plan_f32(b * h * w, 256, 1, 256, 3, 3) is None
        assert ops_dcn.takes_dense(1, 3, 3, None)
        splits = ops_dcn.dense_splits(b, h, w, 256, 256)
        blocks = (256 // ops_dcn.DENSE_OC) * (256 // ops_dcn.DENSE_CC) * splits
        assert 1 <= splits <= b * -(-(h * w) // ops_dcn.DENSE_TILE) and blocks >= 2 * ops_dcn.SMS
    # a mask (v2), another kernel size or several groups: no dense route
    assert not ops_dcn.takes_dense(1, 3, 3, object()) and not ops_dcn.takes_dense(1, 1, 1, None)
    assert not ops_dcn.takes_dense(2, 3, 3, None)
