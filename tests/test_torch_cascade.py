"""Cascade R-CNN inference of the PyTorch port against the JAX package, at
the tiny cascade of tests/test_cascade.py (128 x 128 input, 9 classes, f32,
full-width ResNet-50, three class-agnostic stages), with the GS heads and
with softmax heads, on weights converted by `convert.params_from_flax`.

Stage by stage: the rois each stage's regression refines (from the JAX
stage's input rois, so the comparison does not compound), the port's whole
stage loop (its last rois and the stage-averaged scores), and the final
detections, which take the class-agnostic multiclass NMS (K6, then K5).

Tolerances, as tests/test_torch_detector.py: convolutions sum in another
order in XLA and PyTorch, so boxes agree within 1e-3 px and scores within
1e-5, with labels, validity and order equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.models.cascade import build_cascade as jax_build_cascade
from balancedgroupsoftmax_tpu.models.rpn import rpn_proposals_batched as jax_rpn_proposals
from balancedgroupsoftmax_tpu.ops.boxes import delta2bbox as jax_delta2bbox
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.cascade import CascadeRCNN, build_cascade
from balancedgroupsoftmax_torch.models.detector import FasterRCNN, build_model
from balancedgroupsoftmax_torch.models.rpn import rpn_proposals_batched
from tests.test_cascade import cascade_tiny
from tests.test_detector import make_batch, tiny_partition
from test_torch_detector import COUNTS, to_port


def _jax_stages(mdl, images, img_shapes, sf):
    """The JAX model's proposals, each stage's refinement of the rois it is
    given, its stage loop and its detections."""
    c = mdl.cfg
    feats = mdl.extract_feats(images)
    props = jax_rpn_proposals(mdl.rpn_head(feats), mdl._anchors(images), img_shapes, c.rpn_proposal_test)
    rois = [props.boxes]
    for i in range(c.cascade.num_stages - 1):
        _, deltas = mdl.bbox_heads[i](mdl._pool(feats, rois[-1]))
        stds = c.cascade.stage_target_stds[i]
        rois.append(
            jax.vmap(
                lambda r, d, sh: jax_delta2bbox(r, d.astype(jnp.float32), c.bbox_head.target_means, stds, max_shape=(sh[0], sh[1]))
            )(rois[-1], deltas, img_shapes)
        )
    last_rois, scores, _ = mdl._run_stages(feats, props.boxes, img_shapes)
    return props, rois, last_rois, scores, mdl.predict(images, img_shapes, sf)


@pytest.fixture(scope="module", params=[True, False], ids=["gs", "softmax"])
def both(request):
    use_gs = request.param
    jcfg = cascade_tiny(use_gs=use_gs)
    jmodel = jax_build_cascade(jcfg, partition=tiny_partition() if use_gs else None)
    images, _, _, _, img_shapes = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(0), images[:1])
    sf = jnp.asarray([1.0, 0.5], jnp.float32)
    jax_out = jax.jit(lambda v, im, sh, s: jmodel.apply(v, im, sh, s, method=_jax_stages))(variables, images, img_shapes, sf)

    tmodel = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    tmodel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    tmodel.eval()
    inputs = tuple(torch.from_numpy(np.array(x)) for x in (images, img_shapes, sf))
    return jax_out, tmodel, inputs


def test_build_model_makes_the_cascade_with_class_agnostic_stages(both):
    _, tmodel, _ = both
    assert type(tmodel) is CascadeRCNN and len(tmodel.bbox_heads) == 3
    sd = tmodel.state_dict()
    num_logits = 9 + (5 if tmodel.cfg.bbox_head.use_gs else 0)
    for i in range(3):
        assert sd[f"bbox_heads.{i}.fc_reg.weight"].shape == (4, 64)
        assert sd[f"bbox_heads.{i}.fc_cls.weight"].shape == (num_logits, 64)
    assert not any(k.startswith("bbox_head.") for k in sd)


def test_each_stage_refines_the_rois_as_jax(both):
    (jprops, jrois, *_), tmodel, (images, img_shapes, _) = both
    c = tmodel.cfg
    v = np.asarray(jprops.valid)
    with torch.no_grad():
        feats = tmodel.extract_feats(images)
        props = rpn_proposals_batched(tmodel.rpn_head(feats), tmodel._anchors(images), img_shapes, c.rpn_proposal_test)
        np.testing.assert_array_equal(props.valid.numpy(), v)
        np.testing.assert_allclose(props.boxes.numpy()[v], np.asarray(jrois[0])[v], rtol=0, atol=1e-3)
        for i in range(c.cascade.num_stages - 1):
            rois = torch.from_numpy(np.array(jrois[i]))
            _, deltas = tmodel.bbox_heads[i](tmodel._pool(feats, rois))
            got = tmodel._decode(rois, deltas, c.cascade.stage_target_stds[i], img_shapes)
            np.testing.assert_allclose(got.numpy()[v], np.asarray(jrois[i + 1])[v], rtol=0, atol=1e-3, err_msg=f"stage {i}")


def test_stage_loop_rois_and_averaged_scores_match(both):
    (jprops, _, jlast, jscores, _), tmodel, (images, img_shapes, _) = both
    c = tmodel.cfg
    v = np.asarray(jprops.valid)
    with torch.no_grad():
        feats = tmodel.extract_feats(images)
        props = rpn_proposals_batched(tmodel.rpn_head(feats), tmodel._anchors(images), img_shapes, c.rpn_proposal_test)
        rois, scores, deltas = tmodel._run_stages(feats, props.boxes, img_shapes)
    assert deltas.shape == (*rois.shape[:2], 4)
    np.testing.assert_allclose(rois.numpy()[v], np.asarray(jlast)[v], rtol=0, atol=1e-3)
    assert scores.shape == jscores.shape == (2, v.shape[1], 9)
    np.testing.assert_allclose(scores.numpy()[v], np.asarray(jscores)[v], rtol=0, atol=1e-5)


def test_predict_matches_jax(both):
    (*_, jdets), tmodel, inputs = both
    dets = tmodel.predict(*inputs)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    np.testing.assert_array_equal(dets.labels.numpy(), np.asarray(jdets.labels))
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(jdets.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jdets.boxes), rtol=0, atol=1e-3)
    assert dets.valid.all() and dets.boxes.shape == (2, 10, 4)


@pytest.mark.parametrize("use_gs", [True, False])
def test_zoo_cascade_matches_jax_zoo(use_gs):
    jcfg, _ = jzoo.cascade_rcnn_r50_fpn_lvis(use_gs=use_gs)
    assert tzoo.cascade_rcnn_r50_fpn_lvis(use_gs=use_gs) == to_port(tconfig.DetectorConfig, jcfg)


def test_build_model_dispatches_on_the_config():
    cfg = tzoo.cascade_rcnn_r50_fpn_lvis(num_classes=9)
    assert type(build_model(cfg)) is CascadeRCNN
    assert type(build_model(dataclasses.replace(cfg, cascade=None))) is FasterRCNN
    with pytest.raises(ValueError):  # GS heads need a partition
        build_model(tzoo.cascade_rcnn_r50_fpn_lvis(num_classes=9, use_gs=True))
    with pytest.raises(ValueError):
        build_cascade(dataclasses.replace(cfg, cascade=None))
