"""K2 (multi-level RoIAlign forward) of the PyTorch port against the JAX
package's `kernels.batched_multilevel_roi_align`, which runs its XLA
formulation on the CPU. On the CPU the port runs its plain version.

Tolerances: in f32 both sides do the same operations, but XLA may fuse a
multiply and an add into one rounding, so values agree to 1e-5 (features of
unit scale). In bf16 the port sums in f32 and rounds once, so it is held to
the f32 result on the same bf16 inputs within half a bf16 step (2^-8
relative) plus 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.ops.roi_align import map_roi_levels as jax_map_roi_levels
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.roi_align import map_roi_levels, multilevel_roi_align
from test_torch_cuda import STRIDES, pyramid, rois_all_levels


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
