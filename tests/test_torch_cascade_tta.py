"""The cascade's test-time augmentation pieces and BAGS Cascade X101-64x4d
of the PyTorch port against the JAX package, on weights converted by
`convert.params_from_flax`.

- `propose` and `rescore` of the tiny GS cascade of tests/test_cascade.py
  (128 x 128, 9 classes, f32, full-width ResNet-50) against JAX's
  (`cascade.py:309-345`): proposals, then the stage loop over JAX's own
  proposals, its class-agnostic boxes from the last stage's rois (not
  rescaled) and the stage-averaged scores.
- `--aug-rescore` over the base view and its flip through
  `tools.test_lvis.predict_aug_rescore` against JAX's pieces composed as
  tools/test_lvis.py:311-442 composes them: the final multiclass NMS takes
  its class-agnostic branch (K6 then K5 on the card).
- Cascade X101: the zoo's configurations and the CLI names against JAX's
  (`zoo.py:92`, tools/train.py:141-142), and a narrow X101 cascade (depth
  101, 8 groups of width 4) converted whole and its `predict` against JAX's
  (boxes within 1e-3 px, as tests/test_torch_cascade.py holds the R50
  cascade's detections: 101 layers of f32 convolutions).

Elsewhere the bounds of tests/test_torch_cli.py: boxes 1e-4 px, scores
1e-5, labels and validity equal. About 90 s on one worker, most of it JAX's compiles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.config import BackboneConfig as JBackboneConfig
from balancedgroupsoftmax_tpu.eval import aug as jaug
from balancedgroupsoftmax_tpu.kernels import batched_multiclass_nms as jax_multiclass_nms
from balancedgroupsoftmax_tpu.models.cascade import build_cascade as jax_build_cascade
from balancedgroupsoftmax_tpu.ops import boxes as jboxes
from balancedgroupsoftmax_tpu.ops import nms as jnms
from balancedgroupsoftmax_torch import apis
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.cascade import CascadeRCNN
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.tools import test_lvis
from tests.test_cascade import cascade_tiny
from tests.test_detector import make_batch, tiny_partition
from test_torch_detector import COUNTS, to_port

SHAPES = np.array([[128.0, 128.0], [100.0, 120.0]], np.float32)
SFS = np.array([1.0, 0.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def converted(jcfg):
    jmodel = jax_build_cascade(jcfg, partition=tiny_partition())
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    tmodel = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS))
    tmodel.load_state_dict(params_from_flax(variables))
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def cascade():
    return converted(cascade_tiny(use_gs=True))


def assert_dets(got, want, box_atol=1e-4):
    boxes, scores, labels, valid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), boxes, rtol=0, atol=box_atol)
    assert valid.sum() > 0


def test_propose_and_rescore_equal_jax(cascade):
    jmodel, variables, tmodel = cascade
    images = np.array(make_batch()[0])
    jprops = jax.jit(lambda v, im, sh: jmodel.apply(v, im, sh, method="propose"))(variables, images, SHAPES)
    props = tmodel.propose(torch.from_numpy(images), torch.from_numpy(SHAPES))
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(jprops.valid))
    np.testing.assert_allclose(props.boxes.numpy(), np.asarray(jprops.boxes), rtol=0, atol=1e-4)
    rois = np.array(jprops.boxes)
    jboxes_, jscores = jax.jit(lambda v, im, r, sh: jmodel.apply(v, im, r, sh, method="rescore"))(
        variables, images, rois, SHAPES)
    boxes, scores = tmodel.rescore(torch.from_numpy(images), torch.from_numpy(rois), torch.from_numpy(SHAPES))
    assert boxes.shape == (2, 64, 4) and scores.shape == (2, 64, 9)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes_), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-5)
    assert (boxes[1, :, 2] <= 119).all() and (boxes[1, :, 3] <= 99).all()  # the view's frame, clipped


def test_aug_rescore_equals_jax(cascade):
    jmodel, variables, tmodel = cascade
    c = jmodel.cfg
    images = np.array(make_batch()[0])
    views = [(images, False), (jaug.flip_image_content(images, SHAPES), True)]
    flip = lambda b: jax.vmap(jboxes.bbox_flip)(b, SHAPES)
    propose = jax.jit(lambda v, im, sh: jmodel.apply(v, im, sh, method="propose"))
    rescore = jax.jit(lambda v, im, r, sh: jmodel.apply(v, im, r, sh, method="rescore"))
    parts = []
    for im, fl in views:
        pr = propose(variables, im, SHAPES)
        parts.append(((flip(pr.boxes) if fl else pr.boxes) / SFS[:, None, None], pr.scores, pr.valid))
    t = c.rpn_proposal_test
    merged_b, _, merged_v = jax.vmap(lambda b, s, v: jnms.nms(b, s, v, t.nms_thr, t.max_num))(
        *(jnp.concatenate([p[i] for p in parts], axis=1) for i in range(3)))
    acc = []
    for im, fl in views:
        r = merged_b * SFS[:, None, None]
        bx, sc = rescore(variables, im, flip(r) if fl else r, SHAPES)
        acc.append(((flip(bx) if fl else bx) / SFS[:, None, None], sc))
    r = c.rcnn_test
    want = jax_multiclass_nms(sum(a[0] for a in acc) / 2.0, sum(a[1] for a in acc) / 2.0, merged_v, r.score_thr,
                              r.nms_iou_thr, r.max_per_img, candidates_per_class=r.nms_candidates_per_class)

    tviews = [test_lvis.View(torch.from_numpy(im), torch.from_numpy(SHAPES), torch.from_numpy(SFS), fl)
              for im, fl in views]
    assert_dets(test_lvis.predict_aug_rescore(tmodel, tviews), want)


def test_cascade_x101_configs_and_names_match_jax():
    for use_gs in (False, True):
        jdet, jtrain = jzoo.cascade_rcnn_x101_64x4d_fpn_lvis(use_gs=use_gs)
        cfg = tzoo.cascade_rcnn_x101_64x4d_fpn_lvis(use_gs=use_gs)
        assert cfg == to_port(tconfig.DetectorConfig, jdet)
        name = ("gs_" if use_gs else "") + "cascade_rcnn_x101"
        build, key = apis.MODELS[name]
        assert build(num_classes=9) == tzoo.cascade_rcnn_x101_64x4d_fpn_lvis(num_classes=9, use_gs=use_gs)
        assert key == ("gs_" if use_gs else "") + "cascade_rcnn_x101_64x4d_fpn_lvis"
        assert tzoo.TRAIN_CONFIGS[key] == to_port(tconfig.TrainConfig, jtrain)
        assert (cfg.backbone.depth, cfg.backbone.groups, cfg.backbone.base_width) == (101, 64, 4)


def test_narrow_cascade_x101_converts_whole_and_predicts_as_jax():
    jcfg = dataclasses.replace(cascade_tiny(use_gs=True), backbone=JBackboneConfig(depth=101, groups=8, base_width=4))
    jmodel, variables, tmodel = converted(jcfg)
    assert type(tmodel) is CascadeRCNN
    sd = tmodel.state_dict()
    assert sd["backbone.layer3.22.conv2.weight"].shape == (128, 16, 3, 3)  # 23 blocks in c4, width 128 in 8 groups
    # strict: every converted tensor has a place, every place a tensor
    assert set(params_from_flax(variables)) == set(sd)
    images = np.array(make_batch()[0])
    want = jax.jit(lambda v, im, sh, sf: jmodel.apply(v, im, sh, sf, method="predict"))(variables, images, SHAPES, SFS)
    got = tmodel.predict(*(torch.from_numpy(x) for x in (images, SHAPES, SFS)))
    # 101 layers of f32 convolutions summed in other orders: the 1e-3 px of
    # tests/test_torch_cascade.py (5e-4 read here), scores still within 1e-5
    assert_dets(got, want, box_atol=1e-3)
