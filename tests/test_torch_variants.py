"""Fast R-CNN and Double-Head R-CNN of the PyTorch port against the JAX
package: the shared variant parity tests of tests/torch_variant_suite.py
(`build_model` and the conversion, serving, the loss dict and every
gradient, `trainable_mask`, a training step), plus each variant's own:

- Fast R-CNN refuses `loss` and `predict` without proposals, and its
  proposals' validity mask drops the proposals it marks invalid, as JAX's;
- `DoubleConvFCBBoxHead` on converted flax weights, with and without its
  separate regression features;
- the Double-Head's conv branch reads the rois inflated by
  `reg_roi_scale_factor`: inflating them changes the regression and leaves
  the class logits as they are (JAX `test_double_head_reg_scale_changes_
  regression_only`), and `_bbox_forward` equals JAX's at 1.0 and 1.3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models.detector import build_model as jax_build_model
from balancedgroupsoftmax_tpu.models.extra_heads import DoubleConvFCBBoxHead as JaxDoubleConvFCBBoxHead
from balancedgroupsoftmax_torch import convert
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.models.extra_heads import DoubleConvFCBBoxHead
from test_detector_variants import make_batch, synth_proposals
from test_torch_detector import to_port
from torch_variant_suite import *  # noqa: F401,F403 (the shared tests and the one-thread fixture)
from torch_variant_suite import PROPOSALS, as_tensors, port_model, setup_of, to_torch_tree, variant_config, variant_fixture

variant = variant_fixture(["fast", "double_head"])


def test_fast_rcnn_needs_its_proposals():
    setup = setup_of("fast")
    model = port_model(setup).eval()
    with pytest.raises(ValueError, match="proposals"):
        model.predict(*setup["serve_inputs"])
    with pytest.raises(ValueError, match="proposals"):
        model.loss(*setup["batch"])
    with pytest.raises(ValueError, match="no RPN"):
        model.propose(*setup["serve_inputs"][:2])


def test_fast_rcnn_proposal_valid_matches_jax():
    """Half the proposals marked invalid: the port's detections equal JAX's."""
    jcfg = variant_config("fast")
    jmodel = jax_build_model(jcfg)
    images = make_batch()[0]
    v = setup_of("fast")["variables"]
    props = synth_proposals(p=PROPOSALS)
    valid = jnp.asarray(np.arange(PROPOSALS)[None].repeat(2, 0) % 2 == 0)
    shapes, sf = jnp.full((2, 2), 128.0), jnp.ones(2)
    want = jax.jit(lambda v: jmodel.apply(v, images, shapes, sf, proposals=props, proposal_valid=valid,
                                          method="predict"))(v)
    model = build_model(to_port(tconfig.DetectorConfig, jcfg))
    model.load_state_dict(to_torch_tree(v))
    got = model.eval().predict(*as_tensors((images, shapes, sf)), proposals=torch.from_numpy(np.array(props)),
                               proposal_valid=torch.from_numpy(np.array(valid)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)


@pytest.mark.parametrize("factor", [1.0, 1.3])
def test_double_head_bbox_forward_matches_jax(factor):
    """`_bbox_forward` on eight seeded rois of one image against JAX's, and
    the inflated rois change the deltas, not the class logits."""
    jcfg = variant_config("double_head")
    jcfg = dataclasses.replace(jcfg, variant=dataclasses.replace(jcfg.variant, reg_roi_scale_factor=factor))
    jmodel = jax_build_model(jcfg)
    images = make_batch(1)[0]
    rois = synth_proposals(1, p=8)
    v = setup_of("double_head")["variables"]
    jcls, jreg = jax.jit(lambda v: jmodel.apply(v, jmodel.apply(v, images, method="extract_feats"), rois,
                                                method="_bbox_forward"))(v)
    model = build_model(to_port(tconfig.DetectorConfig, jcfg))
    model.load_state_dict(to_torch_tree(v))
    with torch.no_grad():
        feats = model.extract_feats(torch.from_numpy(np.array(images)))
        cls, reg = model._bbox_forward(feats, torch.from_numpy(np.array(rois)))
        plain = dataclasses.replace(model.cfg, variant=dataclasses.replace(model.cfg.variant, reg_roi_scale_factor=1.0))
        model.cfg = plain
        cls1, reg1 = model._bbox_forward(feats, torch.from_numpy(np.array(rois)))
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=0, atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cls.numpy(), cls1.numpy())
    assert (factor == 1.0) == np.array_equal(reg.numpy(), reg1.numpy())


@pytest.mark.parametrize("separate", [False, True])
def test_double_conv_fc_bbox_head_matches_jax(separate):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 7, 256).astype(np.float32)
    reg = rng.randn(2, 5, 7, 7, 256).astype(np.float32) if separate else None
    jhead = JaxDoubleConvFCBBoxHead(num_classes=9, fc_out_channels=64)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(1), x, reg)
    jcls, jreg = jax.jit(jhead.apply)(params, x, reg)
    sd = {}
    for name, node in jax.tree_util.tree_map(np.asarray, params["params"]).items():
        convert._layer(sd, name, node)
    head = DoubleConvFCBBoxHead(9, fc_out_channels=64)
    head.load_state_dict(convert._tensors(sd))
    with torch.no_grad():
        cls, deltas = head(torch.from_numpy(x), None if reg is None else torch.from_numpy(reg))
    assert cls.shape == (2, 5, 9) and deltas.shape == (2, 5, 36)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=0, atol=1e-5 * np.abs(jcls).max())
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jreg), rtol=0, atol=1e-5 * np.abs(jreg).max())
