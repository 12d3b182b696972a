"""HTC's test-time augmentation pieces of the PyTorch port against the JAX
package, at the tiny GS HTC of tests/test_htc.py (128 x 128, 9 classes, f32,
full-width ResNet-50, three class-agnostic stages, two-conv mask heads) on
weights converted by `convert.params_from_flax`:

- `propose` and `rescore` as JAX tests/test_htc.py:108 shapes them
  (`htc.py:200-237`): the proposals, then the semantic-fused stage loop over
  JAX's own proposals, its class-agnostic boxes and averaged scores;
- `--aug-rescore` over the base view and its flip
  (`tools.test_lvis.predict_aug_rescore`), then the inherited
  `predict_masks` on the merged boxes, against JAX's pieces composed as
  tools/test_lvis.py:311-442 and :576-585 compose them, and JAX's
  `predict_masks` (htc.py:450, which computes its own semantic feature) on
  the same merged boxes.

Bounds of tests/test_torch_cli.py: boxes 1e-4 px, scores 1e-5, labels and
validity equal; masks 1e-5. About 70 s on one worker, most of it JAX's
compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.eval import aug as jaug
from balancedgroupsoftmax_tpu.kernels import batched_multiclass_nms as jax_multiclass_nms
from balancedgroupsoftmax_tpu.models.htc import build_htc as jax_build_htc
from balancedgroupsoftmax_tpu.ops import boxes as jboxes
from balancedgroupsoftmax_tpu.ops import nms as jnms
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.models.htc import HTC
from balancedgroupsoftmax_torch.tools import test_lvis
from tests.test_detector import make_batch, tiny_partition
from tests.test_htc import htc_tiny
from test_torch_cascade_tta import SFS, SHAPES, assert_dets
from test_torch_detector import COUNTS, to_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def htc():
    jcfg = htc_tiny(use_gs=True)
    jmodel = jax_build_htc(jcfg, partition=tiny_partition())
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    tmodel = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS))
    tmodel.load_state_dict(params_from_flax(variables))
    return jmodel, variables, tmodel.eval()


def test_propose_and_rescore_equal_jax(htc):
    jmodel, variables, tmodel = htc
    assert type(tmodel) is HTC
    images = np.array(make_batch()[0])
    jprops = jax.jit(lambda v, im, sh: jmodel.apply(v, im, sh, method="propose"))(variables, images, SHAPES)
    props = tmodel.propose(torch.from_numpy(images), torch.from_numpy(SHAPES))
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(jprops.valid))
    np.testing.assert_allclose(props.boxes.numpy(), np.asarray(jprops.boxes), rtol=0, atol=1e-4)
    rois = np.array(jprops.boxes)
    jb, js = jax.jit(lambda v, im, r, sh: jmodel.apply(v, im, r, sh, method="rescore"))(variables, images, rois, SHAPES)
    boxes, scores = tmodel.rescore(torch.from_numpy(images), torch.from_numpy(rois), torch.from_numpy(SHAPES))
    assert boxes.shape == (2, 64, 4) and scores.shape == (2, 64, 9)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    # without the semantic feature the scores would differ
    _, plain = tmodel._run_stages(tmodel.extract_feats(torch.from_numpy(images)), torch.from_numpy(rois),
                                  torch.from_numpy(SHAPES))[:2]
    assert (plain - scores).abs().max() > 1e-3


def test_aug_rescore_and_masks_on_merged_boxes_equal_jax(htc):
    jmodel, variables, tmodel = htc
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
    dets = test_lvis.predict_aug_rescore(tmodel, tviews)
    assert_dets(dets, want)

    # the mask branch on the merged boxes (JAX's, so both pool the same rois)
    db, dl = np.array(want[0]), np.array(want[2])
    jmasks = jax.jit(lambda v, im, b, lab, sf: jmodel.apply(v, im, b, lab, sf, method="predict_masks"))(
        variables, images, db, dl, SFS)
    masks = tmodel.predict_masks(*(torch.from_numpy(x) for x in (images, db, dl, SFS)))
    assert masks.shape == (2, 10, 28, 28)
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), rtol=0, atol=1e-5)
