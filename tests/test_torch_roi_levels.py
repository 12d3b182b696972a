"""FPN level routing at the level boundaries: the port's `map_roi_levels`
and `multilevel_roi_align_reference` on the CPU against the JAX model as it
runs, jitted.

Under `jit` XLA turns sqrt(area) / 56 into a product with f32(1 / 56), which
rounds otherwise than the exact division just below sqrt(area) = 112 and
224, and so sends such a roi one level up. The port multiplies by the same
f32 reciprocal on every device, so its CPU plain version routes as the
jitted model does (and as K2 does on the card). Levels must be equal; on a
pyramid whose level l holds the constant l + 1 the pooled values show the
level each roi was pooled from, and agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.ops.roi_align import map_roi_levels as jax_map_roi_levels
from balancedgroupsoftmax_torch.ops.roi_align import map_roi_levels, multilevel_roi_align_reference
from test_torch_cuda import STRIDES, boundary_rois

BOUNDARIES = [112, 224, 448]  # sqrt(area) / 56 = 2, 4, 8
IMAGE = 960  # side of a square image that holds every roi below


def rois_at(boundary: int) -> np.ndarray:
    """(R, 4) rois around sqrt(area) = boundary: `boundary_rois`' squares and
    rectangles, and squares whose side sweeps 200 f32 steps either side of
    `boundary` (sqrt(area) = 111.99994 among them)."""
    block = BOUNDARIES.index(boundary)
    swept = boundary_rois()[0, 405 * block:405 * (block + 1)]
    side = (np.array([boundary], np.float32).view(np.int32) + np.arange(-200, 201, dtype=np.int32)).view(np.float32)
    zero = np.zeros_like(side)
    squares = np.stack([zero, zero, side - 1, side - 1], -1)
    return np.concatenate([swept, squares]).astype(np.float32)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_levels_match_jitted_jax_at_the_level_boundaries(boundary):
    rois = rois_at(boundary)
    want = np.asarray(jax.jit(jax_map_roi_levels, static_argnums=1)(jnp.asarray(rois), 4))
    below = BOUNDARIES.index(boundary)
    assert set(np.unique(want).tolist()) == {below, below + 1}  # the rois straddle the boundary
    got = map_roi_levels(torch.from_numpy(rois), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_pooling_matches_jitted_jax_at_the_level_boundaries(boundary):
    rois = rois_at(boundary)[None]
    assert rois.min() >= 0 and rois.max() < IMAGE - 1  # every sample inside the image
    feats = [np.full((1, IMAGE // s, IMAGE // s, 2), level + 1, np.float32) for level, s in enumerate(STRIDES)]
    pool = jax.jit(lambda f, r: jkernels.batched_multilevel_roi_align(f, r, STRIDES))
    want = np.asarray(pool([jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    got = multilevel_roi_align_reference([torch.from_numpy(f) for f in feats], torch.from_numpy(rois), STRIDES)
    assert got.shape == want.shape
    pooled_from = np.rint(want[0, :, 0, 0, 0]).astype(np.int32) - 1
    routed = jax.jit(jax_map_roi_levels, static_argnums=1)(jnp.asarray(rois[0]), 4)
    np.testing.assert_array_equal(pooled_from, np.asarray(routed))
    np.testing.assert_array_equal(np.rint(got.numpy()), np.rint(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
