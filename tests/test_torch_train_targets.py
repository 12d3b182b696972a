"""Training targets of the PyTorch port against the JAX package: max-IoU
assignment, positive / negative sampling, gt-as-proposals, and the RPN and
RCNN targets, at the tiny configuration of tests/test_detector.py (128 x 128,
8 gt slots).

JAX draws its sampling priorities from `jax.random`; the tests draw the same
uniforms from the same keys and hand them to the port, whose priorities are
otherwise drawn from a `torch.Generator`. Both sides compute IoUs in the same
f32 operation order, so every output is compared for equality except the
regression targets: their `log` comes from two libraries (XLA's and
PyTorch's), which differ in the last bit, so they agree to 1e-6 relative.
JAX's RCNN `bbox_weights` are (S, 1) and broadcast over the four deltas; the
port's are (B, S, 4), compared with JAX's broadcast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.config import RCNNTrainConfig as JRCNNTrainConfig
from balancedgroupsoftmax_tpu.config import RPNTrainConfig as JRPNTrainConfig
from balancedgroupsoftmax_tpu.config import SamplerConfig as JSamplerConfig
from balancedgroupsoftmax_tpu.core.assigner import assign_max_iou as jax_assign
from balancedgroupsoftmax_tpu.core.sampler import add_gt_as_proposals as jax_add_gt
from balancedgroupsoftmax_tpu.core.sampler import sample_pos_neg as jax_sample
from balancedgroupsoftmax_tpu.core.targets import anchor_targets_single, roi_targets_single
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.core.anchors import multilevel_anchors
from balancedgroupsoftmax_torch.core.assigner import AssignResult, assign_max_iou
from balancedgroupsoftmax_torch.core.sampler import add_gt_as_proposals, sample_pos_neg
from balancedgroupsoftmax_torch.core.targets import anchor_targets, roi_targets
from tests.test_detector import make_batch
from test_torch_detector import to_port

B = 2


def gts():
    _, boxes, labels, mask, _ = make_batch(b=B)
    boxes, labels, mask = (np.array(x) for x in (boxes, labels, mask))
    boxes[1, 3] = boxes[1, 0]  # a duplicate gt: both claim the same proposals
    labels[1, 3] = 7
    mask[1, 3] = True
    return boxes, labels, mask


def proposals(seed, p=64):
    """Boxes near the gts (positives, ties at the same overlap) and
    elsewhere, with padded slots."""
    rng = np.random.RandomState(seed)
    boxes, _, _ = gts()
    near = boxes[:, :3][:, rng.randint(0, 3, p // 2)] + rng.randint(-6, 7, (B, p // 2, 4))
    far = rng.uniform(0, 100, (B, p - p // 2, 2))
    far = np.concatenate([far, far + rng.uniform(4, 40, far.shape)], -1)
    props = np.concatenate([near, far], 1).astype(np.float32)
    props[:, 5] = props[:, 4]  # exact duplicate proposals tie in every argmax
    valid = rng.rand(B, p) > 0.1
    return props, valid


def T(x):
    return torch.from_numpy(np.asarray(x))


def jax_per_image(fn, *arrays):
    """Run a single-image JAX function per image and stack the results."""
    outs = [fn(*(jnp.asarray(a[i]) for a in arrays)) for i in range(B)]
    return type(outs[0])(*(np.stack([np.asarray(o[f]) for o in outs]) for f in range(len(outs[0]))))


def assert_equal_tuples(got, want):
    for name, g, w in zip(want._fields, got, want):
        if name == "bbox_targets":
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            w = np.broadcast_to(np.asarray(w), g.shape)
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)


@pytest.mark.parametrize("assign_all", [True, False])
def test_assign_max_iou_matches_jax(assign_all):
    props, pvalid = proposals(0)
    gb, gl, gm = gts()
    args = (0.5, 0.4, 0.3, assign_all)
    want = jax_per_image(lambda p, pv, b, l, m: jax_assign(p, pv, b, l, m, *args), props, pvalid, gb, gl, gm)
    got = assign_max_iou(T(props), T(pvalid), T(gb), T(gl), T(gm), *args)
    assert (want.gt_inds > 0).sum() > 10 and (want.gt_inds == 0).sum() > 10 and (want.gt_inds < 0).any()
    assert_equal_tuples(got, want)


def random_assign(seed, n=300):
    rng = np.random.RandomState(seed)
    gt_inds = rng.choice([-1, 0, 0, 0, 1, 2, 3], (B, n)).astype(np.int32)
    return AssignResult(
        gt_inds=gt_inds,
        max_overlaps=rng.rand(B, n).astype(np.float32),
        labels=np.where(gt_inds > 0, gt_inds + 3, 0).astype(np.int32),
    )


@pytest.mark.parametrize("num,frac", [(64, 0.25), (512, 0.5), (1000, 1.0)])
def test_sample_pos_neg_matches_jax_on_the_same_priorities(num, frac):
    assign = random_assign(num)
    rng = np.random.RandomState(1)
    pos_p, neg_p = rng.rand(2, B, assign.gt_inds.shape[1]).astype(np.float32)
    pos_p[:, :20] = 0.5  # equal priorities rank by index in both
    want = [
        jax_sample(
            jax.random.PRNGKey(0), AssignResult(*(jnp.asarray(x[i]) for x in assign)), num, frac,
            jnp.asarray(pos_p[i]), jnp.asarray(neg_p[i]),
        )
        for i in range(B)
    ]
    got = sample_pos_neg(AssignResult(*map(T, assign)), num, frac, pos_priority=T(pos_p), neg_priority=T(neg_p))
    for i in range(B):
        for name, g, w in zip(want[i]._fields, got, want[i]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=name)


def test_sampler_draws_from_the_generator():
    assign = AssignResult(*map(T, random_assign(3)))
    a = sample_pos_neg(assign, 64, 0.25, torch.Generator().manual_seed(0))
    b = sample_pos_neg(assign, 64, 0.25, torch.Generator().manual_seed(0))
    c = sample_pos_neg(assign, 64, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(a.inds, b.inds) and not torch.equal(a.inds, c.inds)
    assert (a.num_pos == 16).all() and (a.num_neg == 48).all()


def test_add_gt_as_proposals_matches_jax():
    props, pvalid = proposals(2)
    gb, gl, gm = gts()
    assign = random_assign(4, n=props.shape[1])
    want = [
        jax_add_gt(props[i], pvalid[i], AssignResult(*(jnp.asarray(x[i]) for x in assign)), gb[i], gl[i], gm[i])
        for i in range(B)
    ]
    got = add_gt_as_proposals(T(props), T(pvalid), AssignResult(*map(T, assign)), T(gb), T(gl), T(gm))
    for i in range(B):
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[i][0]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[i][1]))
        for name, g, w in zip(AssignResult._fields, got[2], want[i][2]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=name)


def jax_priorities(keys, n):
    """The uniforms JAX's sample_pos_neg draws from each image's key."""
    pairs = [jax.random.split(k) for k in keys]
    pos = np.stack([np.asarray(jax.random.uniform(kp, (n,))) for kp, _ in pairs])
    neg = np.stack([np.asarray(jax.random.uniform(kn, (n,))) for _, kn in pairs])
    return T(pos), T(neg)


@pytest.mark.parametrize("num,frac", [(256, 0.5), (64, 0.25)])
def test_anchor_targets_match_jax(num, frac):
    jcfg = JRPNTrainConfig(sampler=JSamplerConfig(num=num, pos_fraction=frac, add_gt_as_proposals=False))
    anchors = np.concatenate(multilevel_anchors([(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)], (4, 8, 16, 32, 64), (8.0,), (0.5, 1.0, 2.0)))
    valid = np.ones(anchors.shape[0], bool)
    valid[::17] = False
    gb, _, gm = gts()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax_per_image(
        lambda k, b, m: anchor_targets_single(k, jnp.asarray(anchors), jnp.asarray(valid), b, m, (128, 128), jcfg),
        keys, gb, gm,
    )
    pos_p, neg_p = jax_priorities(keys, anchors.shape[0])
    got = anchor_targets(
        T(anchors), T(valid), T(gb), T(gm), (128, 128), to_port(tconfig.RPNTrainConfig, jcfg),
        pos_priority=pos_p, neg_priority=neg_p,
    )
    assert (want.labels.sum(1) > 0).all()
    assert_equal_tuples(got, want)


@pytest.mark.parametrize("add_gt", [True, False])
def test_roi_targets_match_jax(add_gt):
    jcfg = JRCNNTrainConfig(sampler=JSamplerConfig(num=48, pos_fraction=0.25, add_gt_as_proposals=add_gt))
    props, pvalid = proposals(5)
    gb, gl, gm = gts()
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    want = jax_per_image(
        lambda k, p, pv, b, l, m: roi_targets_single(k, p, pv, b, l, m, jcfg), keys, props, pvalid, gb, gl, gm
    )
    pos_p, neg_p = jax_priorities(keys, props.shape[1] + (gb.shape[1] if add_gt else 0))
    got = roi_targets(
        T(props), T(pvalid), T(gb), T(gl), T(gm), to_port(tconfig.RCNNTrainConfig, jcfg),
        pos_priority=pos_p, neg_priority=neg_p,
    )
    assert (want.labels > 0).sum() > 4
    assert_equal_tuples(got, want)
