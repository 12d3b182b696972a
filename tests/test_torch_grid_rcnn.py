"""Grid R-CNN of the PyTorch port against the JAX package: the shared
variant parity tests of tests/torch_variant_suite.py (`build_model` and the
conversion, `predict` with the grid's refined boxes, the loss dict with
"loss_grid" and every gradient, `trainable_mask`, a training step), and:

- `GroupNorm` against flax's (epsilon 1e-6, f32 statistics, E[x^2] - E[x]^2);
- `GridHead` on converted flax weights, at the tiny heatmap (28, pooled at
  7) and the published one (56, pooled at 14);
- `grid_targets` bit for bit, points outside the roi included, and
  `grid_to_boxes` on heatmaps with tied maxima (both take the first);
- the grid branch in f64 on JAX's features and targets: "loss_grid" and the
  grid head's every gradient within 1e-5 (the f32 check leaves the grid
  head to it: see tests/torch_variant_suite.py);
- `jitter_rois` at the default jitter (0.15): inside the image and within
  15% of each roi's size of the original.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models.grid_head import GridHead as JaxGridHead
from balancedgroupsoftmax_tpu.models.grid_head import grid_targets as jax_grid_targets
from balancedgroupsoftmax_tpu.models.grid_head import grid_to_boxes as jax_grid_to_boxes
from balancedgroupsoftmax_torch import convert
from balancedgroupsoftmax_torch.models.grid_head import GridHead, grid_targets, grid_to_boxes
from balancedgroupsoftmax_torch.models.layers import GroupNorm
from balancedgroupsoftmax_torch.models.variants import jitter_rois
from torch_variant_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_variant_suite import F64_HELD, branch_in_f64, setup_of, variant_fixture

variant = variant_fixture(["grid"])


def test_group_norm_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 6, 64) * 2 + 3).astype(np.float32)  # a mean well off 0
    scale, bias = rng.rand(64).astype(np.float32) + 0.5, rng.randn(64).astype(np.float32)
    want = fnn.GroupNorm(num_groups=8).apply({"params": {"scale": scale, "bias": bias}}, x)
    gn = GroupNorm(8, 64)
    assert gn.eps == 1e-6
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert gn(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("heatmap", [28, 56])
def test_grid_head_matches_jax(heatmap):
    s = heatmap // 4
    x = np.random.RandomState(1).randn(3, s, s, 256).astype(np.float32)
    jhead = JaxGridHead(heatmap_size=heatmap)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(2), x)
    want = np.asarray(jax.jit(jhead.apply)(params, x))  # (N, hm, hm, 9)
    head = GridHead(256, heatmap_size=heatmap)
    sd = params_from_flax_grid(params)
    assert set(sd) == set(head.state_dict())
    head.load_state_dict(sd)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (3, heatmap, heatmap, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def params_from_flax_grid(params):
    """A flax `GridHead`'s params converted as `convert.params_from_flax`
    converts a detector's `grid_head` node."""
    sd = {}
    for name, node in jax.tree_util.tree_map(np.asarray, params["params"]).items():
        convert._layer(sd, name, node, transposed=name.startswith("up"))
    return convert._tensors(sd)


def grid_cases():
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 80, (64, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 60, (64, 2))], 1).astype(np.float32)
    # gts around and across their rois: some grid points outside
    c = (rois[:, :2] + rois[:, 2:]) / 2 + rng.uniform(-20, 20, (64, 2))
    half = rng.uniform(2, 50, (64, 2))
    gts = np.concatenate([c - half, c + half], 1).astype(np.float32)
    rois[0], gts[0] = [10, 10, 40, 40], [5, 5, 60, 60]  # JAX test_grid_points_outside_roi_invalid
    rois[1], gts[1] = [10, 10, 65, 65], [20, 15, 50, 60]
    return rois, gts


@pytest.mark.parametrize("heatmap", [28, 56])
def test_grid_targets_equal_jax(heatmap):
    rois, gts = grid_cases()
    heat, valid = jax.jit(jax_grid_targets, static_argnums=2)(rois, gts, heatmap)
    got_heat, got_valid = grid_targets(torch.from_numpy(rois), torch.from_numpy(gts), heatmap)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(got_heat.permute(0, 2, 3, 1).numpy(), np.asarray(heat))
    v = got_valid.numpy()
    assert not v[0, 0] and v[0, 4] and v.all(1)[1] and 0 < v.mean() < 1
    assert got_heat.sum() > 0 and not got_heat[~got_valid].any()


def test_grid_to_boxes_equals_jax_with_ties():
    rois, _ = grid_cases()
    rng = np.random.RandomState(4)
    # logits on a coarse grid of values: many cells tie for the maximum
    heat = rng.randint(0, 3, (64, 28, 28, 9)).astype(np.float32)
    heat[:4] = 1.0  # all tied: the first cell, (0, 0)
    want = np.asarray(jax.jit(jax_grid_to_boxes)(heat, rois))
    got = grid_to_boxes(torch.from_numpy(heat).permute(0, 3, 1, 2), torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    w = np.maximum(rois[:4, 2] - rois[:4, 0] + 1, 1)
    np.testing.assert_allclose(got[:4, 0], rois[:4, 0] + 0.5 / 28 * w, rtol=1e-6)
    # decoding the targets recovers the gts within a cell (JAX test_grid_targets_and_decode_roundtrip)
    r, g = torch.tensor([[10.0, 10.0, 65.0, 65.0]]), torch.tensor([[20.0, 15.0, 50.0, 60.0]])
    t, _ = grid_targets(r, g, 56)
    np.testing.assert_allclose(grid_to_boxes(torch.where(t > 0, 10.0, -10.0), r)[0].numpy(), g[0].numpy(), atol=1.5)


def test_grid_branch_in_f64_matches_jax():
    want, jgrads, losses, model = branch_in_f64(setup_of("grid"))
    assert sorted(losses) == sorted(want) == ["loss_grid"]
    np.testing.assert_allclose(losses["loss_grid"].item(), want["loss_grid"], rtol=1e-6)
    held = [(n, p) for n, p in model.named_parameters() if n.startswith(F64_HELD["grid"])]
    assert len(held) == 2 * (8 + 8 + 9 + 24 + 18)  # the convs, norms, points, fusions and upsamplings
    for name, p in held:
        w = jgrads[name].double().numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_jitter_stays_in_the_image_and_within_its_range():
    rois, _ = grid_cases()
    rois = torch.from_numpy(rois).reshape(2, 32, 4)
    shapes = torch.tensor([[100.0, 128.0], [128.0, 96.0]])
    gen = torch.Generator().manual_seed(0)
    out = jitter_rois(rois, shapes, 0.15, gen)
    hi = torch.stack([shapes[:, 1], shapes[:, 0]], -1)[:, None] - 1
    assert (out >= 0).all() and (out[..., :2] <= hi).all() and (out[..., 2:] <= hi).all()
    wh = rois[..., 2:] - rois[..., :2]
    # unclipped, each corner moves at most 0.15 of the size (centre) plus 0.075 (half the scale change)
    inside = ((rois[..., :2] >= 0.225 * wh) & (rois[..., 2:] <= hi - 0.225 * wh)).all(-1)
    moved = (out - rois).abs() / wh.repeat(1, 1, 2)
    assert inside.any() and (moved[inside] <= 0.225 + 1e-6).all() and moved[inside].max() > 0.1
    centre = ((out[..., :2] + out[..., 2:]) - (rois[..., :2] + rois[..., 2:])).abs() / 2 / wh
    size = (out[..., 2:] - out[..., :2]) / wh
    assert (centre[inside] <= 0.15 + 1e-6).all() and ((size[inside] - 1).abs() <= 0.15 + 1e-6).all()
    assert torch.equal(jitter_rois(rois, shapes, 0.0, gen), jitter_rois(rois, shapes, 0.0))
