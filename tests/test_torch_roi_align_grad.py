"""The gradient of the port's multi-level RoIAlign (the autograd Function
whose backward is K2b; on the CPU its plain version) against the JAX package:
`jax.grad` of `kernels.batched_multilevel_roi_align` (its XLA gather path on
the CPU) and the TPU path's own backward, `pallas/roi_align.py _bwd_dense`
("dense2"), called directly.

Tolerances: every side sums the same f32 products in another order (XLA's
scatter, two matrix products, `index_add_`), so gradients agree to 1e-5
relative to their largest value. In bf16 the port sums in f32 and rounds once
per element, so it is held to the f32 gradient of the same inputs within one
bf16 step (2^-7) of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.pallas.roi_align import _bwd_dense
from balancedgroupsoftmax_torch.ops.roi_align import multilevel_roi_align
from test_torch_cuda import STRIDES, pyramid, rois_all_levels


def case(seed, out_size, dtype=np.float32):
    rng = np.random.RandomState(seed)
    feats = pyramid(rng)
    rois = rois_all_levels(rng)
    cot = rng.randn(*rois.shape[:2], out_size, out_size, feats[0].shape[-1]).astype(np.float32)
    return feats, rois, cot


def port_grad(feats, rois, cot, out_size, dtype=torch.float32):
    tf = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
    trois = torch.from_numpy(rois).requires_grad_()
    out = multilevel_roi_align(tf, trois, STRIDES, out_size)
    out.backward(torch.from_numpy(cot).to(dtype))
    assert trois.grad is None  # no gradient for the rois, as in JAX
    return [f.grad for f in tf]


def assert_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("out_size", [7, 3])
def test_grad_matches_jax_grad(out_size):
    feats, rois, cot = case(out_size, out_size)
    want = jax.grad(
        lambda fs: jnp.sum(
            jkernels.batched_multilevel_roi_align(fs, jnp.asarray(rois), STRIDES, out_size) * cot
        )
    )([jnp.asarray(f) for f in feats])
    got = port_grad(feats, rois, cot, out_size)
    assert all(np.abs(np.asarray(w)).max() > 0 for w in want)  # every level receives rois
    assert_close(got, want)


def test_grad_matches_dense2_backward():
    feats, rois, cot = case(1, 7)
    want, rois_grad = _bwd_dense(
        STRIDES, 7, 2, 56, (tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois)), jnp.asarray(cot),
        variant="dense2",
    )
    assert rois_grad is None
    assert_close(port_grad(feats, rois, cot, 7), want)


def test_bf16_gradient_rounds_the_f32_sum_once():
    feats, rois, cot = case(2, 7)
    cot = torch.from_numpy(cot).to(torch.bfloat16).float().numpy()  # bf16-exact cotangent
    want = port_grad(feats, rois, cot, 7)
    got = port_grad(feats, rois, cot, 7, torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert (g.float() - w).abs().max().item() <= 2.0**-7 * w.abs().max().item()
