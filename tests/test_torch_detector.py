"""The whole inference slice of the PyTorch port against the JAX detector,
at the tiny configuration of tests/test_detector.py (128 x 128 input, 9
classes, GS partition, f32, full-width ResNet-50), on weights converted by
`convert.params_from_flax`.

Tolerances: convolutions sum in another order in XLA and PyTorch, so FPN
features agree to 1e-4 relative to their largest value; this moves RPN
scores, merged class scores and decoded boxes by ~1e-6 relative, so
proposals and detections are held to atol 1e-3 px (boxes) and 1e-5
(scores), with their order and labels equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.gs.head import gs_merge_scores as jax_gs_merge_scores
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_tpu.models.rpn import rpn_proposals_batched as jax_rpn_proposals
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.head import gs_merge_scores
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.models.rpn import rpn_proposals_batched
from tests.test_detector import make_batch, tiny_config, tiny_partition

COUNTS = np.array([0, 5, 50, 500, 5000, 7, 70, 700, 7000])


def to_port(cls, obj):
    """The port's config dataclass `cls` with the values of the JAX `obj`;
    a nested JAX dataclass becomes the port's class of the same name."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = to_port(getattr(tconfig, type(v).__name__), v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def _jax_intermediates(mdl, images, img_shapes, sf):
    c = mdl.cfg
    feats = mdl.extract_feats(images)
    props = jax_rpn_proposals(mdl.rpn_head(feats), mdl._anchors(images), img_shapes, c.rpn_proposal_test)
    cls_logits, _ = mdl._bbox_forward(feats, props.boxes)
    scores = jax.vmap(lambda lg: jax_gs_merge_scores(lg, mdl.partition))(cls_logits)
    return feats, props, scores, mdl._predict_feats(feats, images, img_shapes, sf)


@pytest.fixture(scope="module")
def both():
    jcfg = tiny_config(use_gs=True)
    jmodel = jax_build_detector(jcfg, partition=tiny_partition())
    images, _, _, _, img_shapes = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(0), images[:1])
    sf = jnp.asarray([1.0, 0.5], jnp.float32)
    jax_out = jax.jit(
        lambda v, im, sh, s: jmodel.apply(v, im, sh, s, method=_jax_intermediates)
    )(variables, images, img_shapes, sf)

    tmodel = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS))
    tmodel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    tmodel.eval()
    inputs = tuple(torch.from_numpy(np.array(x)) for x in (images, img_shapes, sf))
    return jax_out, tmodel, inputs


def test_state_dict_covers_every_tensor(both):
    _, tmodel, _ = both
    sd = tmodel.state_dict()
    assert sd["bbox_head.shared_fcs.0.weight"].shape == (64, 7 * 7 * 256)
    assert sd["bbox_head.fc_cls.weight"].shape == (9 + 5, 64)
    assert sd["backbone.layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)


@pytest.mark.parametrize("level", range(5))
def test_fpn_features_match(both, level):
    (jfeats, *_), tmodel, (images, _, _) = both
    with torch.no_grad():
        got = tmodel.extract_feats(images)[level].permute(0, 2, 3, 1).numpy()
    want = np.asarray(jfeats[level])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_proposals_and_merged_scores_match(both):
    (_, jprops, jscores, _), tmodel, (images, img_shapes, _) = both
    with torch.no_grad():
        feats = tmodel.extract_feats(images)
        props = rpn_proposals_batched(
            tmodel.rpn_head(feats), tmodel._anchors(images), img_shapes, tmodel.cfg.rpn_proposal_test
        )
        cls_logits, _ = tmodel._bbox_forward(feats, props.boxes)
        scores = gs_merge_scores(cls_logits.reshape(-1, cls_logits.shape[-1]), tmodel.partition)
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(jprops.valid))
    v = props.valid.numpy()
    np.testing.assert_allclose(props.boxes.numpy()[v], np.asarray(jprops.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(props.scores.numpy(), np.asarray(jprops.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        scores.reshape(jscores.shape).numpy(), np.asarray(jscores), rtol=0, atol=1e-5
    )


def test_predict_matches_jax(both):
    (*_, jdets), tmodel, inputs = both
    dets = tmodel.predict(*inputs)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    np.testing.assert_array_equal(dets.labels.numpy(), np.asarray(jdets.labels))
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(jdets.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jdets.boxes), rtol=0, atol=1e-3)
    assert dets.valid.all()


def test_zoo_matches_jax_zoo():
    from balancedgroupsoftmax_tpu import zoo as jzoo

    for name in ("gs_faster_rcnn_r50_fpn_lvis", "faster_rcnn_r50_fpn_lvis"):
        jcfg, _ = getattr(jzoo, name)()
        assert getattr(tzoo, name)() == to_port(tconfig.DetectorConfig, jcfg)


def test_build_detector_needs_partition_for_gs():
    with pytest.raises(ValueError):
        build_detector(tzoo.gs_faster_rcnn_r50_fpn_lvis())
