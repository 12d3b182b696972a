"""K2 (multi-level RoIAlign forward) of the PyTorch port against the JAX
package's `kernels.batched_multilevel_roi_align`, which runs its XLA
formulation on the CPU. On the CPU the port runs its plain version.

Tolerances: in f32 both sides do the same operations, but XLA may fuse a
multiply and an add into one rounding, so values agree to 1e-5 (features of
unit scale). In bf16 the port sums in f32 and rounds once, so it is held to
the f32 result on the same bf16 inputs within half a bf16 step (2^-8
relative) plus 1e-6.

The sample geometry the kernels build once a roi (the per-axis tables of
`axis_samples`) is held bit for bit to the per-sample computation the plain
version did before it was built from them, and the levels K2 routes by are
the ones the backward is handed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.ops.roi_align import map_roi_levels as jax_map_roi_levels
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.roi_align import (
    axis_samples,
    map_roi_levels,
    multilevel_roi_align,
    roi_align_backward,
    roi_align_forward,
    sample_points,
)
from test_torch_cuda import IMAGE, STRIDES, pyramid, rois_all_levels


def test_rois_span_all_levels_and_levels_match_jax():
    rois = rois_all_levels(np.random.RandomState(0))
    lv = map_roi_levels(torch.from_numpy(rois), 4).numpy()
    assert set(np.unique(lv)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(lv, np.asarray(jax_map_roi_levels(jnp.asarray(rois.reshape(-1, 4)), 4)).reshape(lv.shape))


@pytest.mark.parametrize("out_size", [7, 3])
def test_f32_matches_jax(out_size):
    rng = np.random.RandomState(out_size)
    feats = pyramid(rng)
    rois = rois_all_levels(rng)
    expected = np.asarray(
        jkernels.batched_multilevel_roi_align(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, out_size
        )
    )
    got = tkernels.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), STRIDES, out_size
    )
    assert got.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)


def test_bf16_rounds_the_f32_result_once():
    rng = np.random.RandomState(1)
    feats = [torch.from_numpy(f).to(torch.bfloat16) for f in pyramid(rng)]
    rois = rois_all_levels(rng)
    expected = np.asarray(
        jkernels.batched_multilevel_roi_align(
            [jnp.asarray(f.float().numpy()) for f in feats], jnp.asarray(rois), STRIDES
        )
    )
    got = multilevel_roi_align(feats, torch.from_numpy(rois), STRIDES)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=2.0**-8, atol=1e-6)


def direct_sample_points(shapes, rois, strides, out_size, sample_num, finest_scale=56):
    """The sample geometry computed per sample, (y, x) pair by pair, without
    the axis tables: what `sample_points` returned before it was built from
    `axis_samples`."""
    b, r = rois.shape[:2]
    lvls = map_roi_levels(rois, len(shapes), finest_scale).long().reshape(-1)
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))])
    h = torch.tensor([s[0] for s in shapes])[lvls][:, None, None]
    w = torch.tensor([s[1] for s in shapes])[lvls][:, None, None]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32)[lvls]
    base = (torch.arange(b).repeat_interleave(r) * sum(sizes) + offsets[lvls])[:, None, None]
    rois = rois.float().reshape(-1, 4)
    start_w, start_h = rois[:, 0] * scale, rois[:, 1] * scale
    end_w, end_h = (rois[:, 2] + 1.0) * scale, (rois[:, 3] + 1.0) * scale
    bin_w = (end_w - start_w).clamp(min=0.0) / torch.full_like(end_w, out_size)
    bin_h = (end_h - start_h).clamp(min=0.0) / torch.full_like(end_h, out_size)
    sub = torch.arange(sample_num, dtype=torch.float32) + 0.5
    sub = sub / torch.full_like(sub, sample_num)
    pos = (torch.arange(out_size, dtype=torch.float32)[:, None] + sub[None, :]).reshape(-1)
    n = pos.shape[0]
    y = (start_h[:, None] + bin_h[:, None] * pos)[:, :, None].expand(-1, -1, n)
    x = (start_w[:, None] + bin_w[:, None] * pos)[:, None, :].expand(-1, n, -1)
    valid = (y >= -1.0) & (y <= h.float()) & (x >= -1.0) & (x <= w.float())
    y, x = y.clamp(min=0.0), x.clamp(min=0.0)
    y_low, x_low = torch.floor(y).to(torch.int64), torch.floor(x).to(torch.int64)
    cy, cx = y_low >= h - 1, x_low >= w - 1
    y_low = torch.where(cy, h - 1, y_low)
    y = torch.where(cy, y_low.float(), y)
    y_high = torch.where(cy, h - 1, y_low + 1)
    x_low = torch.where(cx, w - 1, x_low)
    x = torch.where(cx, x_low.float(), x)
    x_high = torch.where(cx, w - 1, x_low + 1)
    ly, lx = y - y_low, x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    index = torch.stack([base + y_low * w + x_low, base + y_low * w + x_high,
                         base + y_high * w + x_low, base + y_high * w + x_high])
    return index, torch.stack([hy * hx, hy * lx, ly * hx, ly * lx]), valid


def geometry_rois(rng):
    """Rois of every level (some past the image), rois with x2 < x1 (both
    sides reversed, or by less than a pixel), zero-width and zero-area rois,
    and rois wholly outside the image."""
    rois = rois_all_levels(rng)
    x1 = rng.uniform(0, IMAGE[1], (2, 8)).astype(np.float32)
    y1 = rng.uniform(0, IMAGE[0], (2, 8)).astype(np.float32)
    odd = np.stack([
        np.stack([x1[:, 0], y1[:, 0], x1[:, 0] - 30, y1[:, 0] - 12], -1),  # both sides reversed
        np.stack([x1[:, 1], y1[:, 1], x1[:, 1] - 0.5, y1[:, 1] + 20], -1),  # x2 < x1 by half a pixel
        np.stack([x1[:, 2], y1[:, 2], x1[:, 2] - 1, y1[:, 2] - 1], -1),  # zero area
        np.stack([x1[:, 3], y1[:, 3], x1[:, 3], y1[:, 3]], -1),  # one pixel
        np.stack([x1[:, 4] + 2000, y1[:, 4], x1[:, 4] + 2300, y1[:, 4] + 300], -1),  # right of the image
        np.stack([-x1[:, 5] - 400, -y1[:, 5] - 300, -x1[:, 5] - 50, -y1[:, 5] - 20], -1),  # above left
        np.stack([x1[:, 6] - 0.25, y1[:, 6] - 0.75, x1[:, 6] + 111.5, y1[:, 6] + 223.5], -1),
        np.stack([np.full(2, -1.0), np.full(2, -1.0), np.full(2, IMAGE[1]), np.full(2, IMAGE[0])], -1),
    ], 1).astype(np.float32)
    return torch.from_numpy(np.concatenate([rois, odd], 1))


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("strides", [STRIDES, (8,)], ids=["fpn", "one_level"])
def test_separable_geometry_matches_direct(out_size, strides):
    """`sample_points`, built from the per-roi axis tables, equals the
    per-sample computation bit for bit: index, weight and valid."""
    rois = geometry_rois(np.random.RandomState(out_size))
    shapes = [(-(-IMAGE[0] // s), -(-IMAGE[1] // s)) for s in strides]
    got = sample_points(shapes, rois, strides, out_size)
    want = direct_sample_points(shapes, rois, strides, out_size, 2)
    valid = want[2]
    assert valid.any() and not valid.all()
    assert torch.equal(got[2], valid)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if len(strides) > 1:
        assert set(map_roi_levels(rois, 4).unique().tolist()) == {0, 1, 2, 3}


def test_axis_samples_give_the_roi_its_bins():
    """One axis of one roi: sample k of bin k // 2 at start + bin * pos,
    clamped at 0 and collapsing on the last row."""
    start = torch.tensor([-0.75, 10.0])
    bin_size = torch.tensor([1.5, 0.0])
    size = torch.tensor([6, 11])
    low, high, frac, rest, valid = axis_samples(start, bin_size, size, out_size=3, sample_num=2)
    # positions -0.375, 0.375, 1.125, 1.875, 2.625, 3.375 -> clamped at 0 first
    assert low[0].tolist() == [0, 0, 1, 1, 2, 3] and high[0].tolist() == [1, 1, 2, 2, 3, 4]
    assert frac[0].tolist() == [0.0, 0.375, 0.125, 0.875, 0.625, 0.375]
    assert torch.equal(rest, 1.0 - frac) and bool(valid.all())
    # a zero bin at y = 10 on 11 rows: the last row, both corners
    assert low[1].tolist() == [10] * 6 and high[1].tolist() == [10] * 6 and frac[1].abs().sum() == 0


def test_forward_returns_the_levels_it_routed_by():
    rng = np.random.RandomState(3)
    feats = [torch.from_numpy(f) for f in pyramid(rng)]
    rois = geometry_rois(rng)
    out, levels = roi_align_forward(feats, rois, STRIDES, return_levels=True)
    assert levels.dtype == torch.int32 and torch.equal(levels, map_roi_levels(rois, 4))
    assert torch.equal(out, roi_align_forward(feats, rois, STRIDES))


def test_backward_routes_by_the_levels_it_is_given():
    """K2b's plain version pools each roi's gradient on the level it is
    handed: the forward's levels give the autograd gradient, and another
    level moves the roi's gradient there."""
    rng = np.random.RandomState(4)
    feats = [torch.from_numpy(f).requires_grad_() for f in pyramid(rng)]
    rois = geometry_rois(rng)
    grad = torch.from_numpy(rng.randn(*rois.shape[:2], 7, 7, feats[0].shape[-1]).astype(np.float32))
    multilevel_roi_align(feats, rois, STRIDES).backward(grad)
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    levels = map_roi_levels(rois, 4)
    got = roi_align_backward(grad, rois, shapes, STRIDES, levels=levels)
    for f, g in zip(feats, got):
        assert torch.equal(f.grad, g)
    moved = roi_align_backward(grad, rois, shapes, STRIDES, levels=torch.zeros_like(levels))
    assert all(m.abs().max() == 0 for m in moved[1:]) and moved[0].abs().max() > 0
