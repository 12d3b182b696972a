"""SSD300 of the PyTorch port against the JAX package: the shared
single-stage parity tests of tests/torch_single_stage_suite.py (the six
levels' head outputs at 38, 19, 10, 5, 3 and 1 cells, `predict`, the loss
with its hard-negative mining and every gradient but the first VGG block's),
the first block's gradients in f64 against JAX in f64 within 1e-5 of their
largest value (in f32 the VGG's backward cancels there, and JAX's f32 parts
from the port's f64 by up to 2.3e-3), and `ssd_anchors` equal to JAX's,
exactly."""

import numpy as np

from balancedgroupsoftmax_tpu.models.ssd import SSDConfig as JaxSSDConfig
from balancedgroupsoftmax_tpu.models.ssd import ssd_anchors as jax_ssd_anchors
from balancedgroupsoftmax_torch.models.ssd import SSDConfig, ssd_anchors
from torch_single_stage_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_single_stage_suite import f64_run, model_fixture

model = model_fixture("ssd")
SSD300_SIZES = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]


def test_ssd_anchors_equal_jax(model):
    assert [tuple(o[0].shape[1:3]) for o in model["heads"]] == SSD300_SIZES
    got = ssd_anchors(SSDConfig(num_classes=9), SSD300_SIZES)
    want = jax_ssd_anchors(JaxSSDConfig(num_classes=9), SSD300_SIZES)
    assert [a.shape[0] for a in got] == [38 * 38 * 4, 19 * 19 * 6, 10 * 10 * 6, 5 * 5 * 6, 3 * 3 * 4, 1 * 1 * 4]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_first_block_gradients_match_jax_in_f64(model):
    """On the batch's first image: XLA's f64 convolutions on the CPU take
    about a minute an image of the VGG's backward."""
    (_, want), (_, got) = f64_run(model, images=1)
    assert sorted(got) == sorted(want) == sorted(
        f"backbone.conv1_{i}.{k}" for i in (1, 2) for k in ("weight", "bias"))
    for name, w in want.items():
        w = w.double().numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
