"""The long-tail loss baselines of the PyTorch port against the JAX package
(BASELINE.md rows 6-9 and GS-reweight): the sigmoid focal loss and the
class-weighted CE of `ops/losses.py`, the bbox head's `loss_cls_type`
branch, GS-reweight's `class_weights` in `gs_loss`,
`class_weights_from_counts`, and `FasterRCNN.loss` with every gradient for
the focal, re-weight and GS-reweight heads at selectp 0 and 1 (the pattern of
JAX tests/test_losses.py:112, held to JAX's values); then the RPN's
`min_bbox_size` and the zoo's baseline configurations.

Tolerances: the loss functions alone as tests/test_torch_losses.py (1e-5
relative, 1e-7 absolute); the whole model as tests/test_torch_train_step.py
(losses 1e-4 relative, each gradient 1e-3 of its tensor's largest value:
convolutions sum in other orders), at its tiny configuration with sampling
made deterministic by the configuration, PyTorch on one thread (ROADMAP
caveat v). About 70 s on one worker, most of it JAX's compiles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.config import ProposalConfig as JProposalConfig
from balancedgroupsoftmax_tpu.gs.head import gs_loss as jax_gs_loss
from balancedgroupsoftmax_tpu.gs.partition import class_weights_from_counts as jax_class_weights
from balancedgroupsoftmax_tpu.models.bbox_head import bbox_head_loss as jax_bbox_head_loss
from balancedgroupsoftmax_tpu.models.detector import FasterRCNN as JFasterRCNN
from balancedgroupsoftmax_tpu.models.rpn import rpn_proposals_batched as jax_rpn_proposals
from balancedgroupsoftmax_tpu.ops import losses as jlosses
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.config import TrainConfig
from balancedgroupsoftmax_torch.gs.head import gs_loss
from balancedgroupsoftmax_torch.gs.partition import class_weights_from_counts, make_partition
from balancedgroupsoftmax_torch.models.bbox_head import bbox_head_loss
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.models.rpn import rpn_proposals_batched
from balancedgroupsoftmax_torch.ops import losses as tlosses
from balancedgroupsoftmax_torch.parallel.train import create_train_state
from tests.test_detector import make_batch, tiny_config, tiny_partition
from test_torch_detector import COUNTS, to_port
from test_torch_losses import both_grads, close
from test_torch_train_step import deterministic_config, to_torch_tree

WEIGHTS = jax_class_weights(COUNTS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_class_weights_equal_jax():
    clipped = []
    for counts in (COUNTS, np.random.RandomState(0).randint(0, 3000, 1231)):
        got = class_weights_from_counts(counts)
        assert got.dtype == np.float32 and got[0] == 1.0
        np.testing.assert_array_equal(got, jax_class_weights(counts))
        clipped += [got.min() == np.float32(0.1), got.max() == np.float32(5.0)]
    assert clipped == [True, False, True, True]  # both clips act


def cls_case(seed, n=48, c=9):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    weight = (rng.rand(n) > 0.2).astype(np.float32)
    return logits, labels, weight


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
def test_focal_and_weighted_ce_equal_jax(gamma, alpha):
    logits, labels, weight = cls_case(1)
    onehot = np.eye(9, dtype=np.float32)[labels]
    both_grads(
        lambda x, t, w: jlosses.sigmoid_focal_loss(x, t, w[:, None], gamma, alpha, avg_factor=37.0),
        lambda x, t, w: tlosses.sigmoid_focal_loss(x, t, w[:, None], gamma, alpha, avg_factor=37.0),
        logits, onehot, weight,
    )
    both_grads(
        lambda x, w: jlosses.weighted_softmax_cross_entropy_per_class(x, jnp.asarray(labels), jnp.asarray(WEIGHTS), w, 23.0),
        lambda x, w: tlosses.weighted_softmax_cross_entropy_per_class(x, torch.from_numpy(labels), torch.from_numpy(WEIGHTS), w, 23.0),
        logits, weight,
    )


@pytest.mark.parametrize("loss_cls_type", ["softmax", "focal", "reweight"])
def test_bbox_head_loss_types_equal_jax(loss_cls_type):
    logits, labels, label_weights = cls_case(2)
    rng = np.random.RandomState(3)
    deltas = rng.randn(48, 36).astype(np.float32)
    targets = rng.randn(48, 4).astype(np.float32)
    bbox_weights = (labels[:, None] > 0).repeat(4, 1).astype(np.float32)
    kw = dict(loss_cls_type=loss_cls_type, focal_gamma=2.0, focal_alpha=0.25)
    jcw = jnp.asarray(WEIGHTS) if loss_cls_type == "reweight" else None
    tcw = torch.from_numpy(WEIGHTS) if loss_cls_type == "reweight" else None
    jfn = lambda x: jax_bbox_head_loss(x, deltas, labels, label_weights, targets, bbox_weights, class_weights=jcw, **kw)
    tfn = lambda x: bbox_head_loss(x, *(torch.from_numpy(a) for a in (deltas, labels, label_weights, targets, bbox_weights)),
                                   class_weights=tcw, **kw)
    both_grads(lambda x: jfn(x)[0], lambda x: tfn(x)[0], logits)
    for got, want in zip(tfn(torch.from_numpy(logits)), jfn(jnp.asarray(logits))):
        close(got, want)
    if loss_cls_type == "reweight":
        with pytest.raises(ValueError):
            bbox_head_loss(*(torch.from_numpy(a) for a in (logits, deltas, labels, label_weights, targets, bbox_weights)),
                           loss_cls_type="reweight")


def test_gs_reweight_loss_equals_jax():
    """`class_weights` scale the foreground rois inside their own bin; the
    others' budget covers them all, so no draw matters."""
    partition = make_partition(COUNTS)
    logits, labels, _ = cls_case(4, n=64, c=9 + partition.num_bins)
    labels = np.random.RandomState(4).randint(0, 9, 64).astype(np.int32)
    valid = np.random.RandomState(5).rand(64) > 0.1
    jfn = lambda x, cw: sum(jax_gs_loss(jax.random.PRNGKey(0), x, labels, valid, tiny_partition(), 1e4, cw).values())
    tfn = lambda x, cw: sum(gs_loss(x, torch.from_numpy(labels), torch.from_numpy(valid), partition, 1e4,
                                    class_weights=cw).values())
    both_grads(lambda x: jfn(x, jnp.asarray(WEIGHTS)), lambda x: tfn(x, torch.from_numpy(WEIGHTS)), logits)
    assert abs(tfn(torch.from_numpy(logits), torch.from_numpy(WEIGHTS)) - tfn(torch.from_numpy(logits), None)) > 1e-3


VARIANTS = {"focal": (False, "focal"), "reweight": (False, "reweight"), "gs-reweight": (True, "reweight")}
INITS = {}


@pytest.fixture(scope="module", params=list(VARIANTS))
def trained(request):
    """JAX's loss dict and gradients of one baseline head, and the port's
    model on the same weights."""
    use_gs, loss_type = VARIANTS[request.param]
    jcfg = deterministic_config()
    head = dataclasses.replace(jcfg.bbox_head, use_gs=use_gs, loss_cls_type=loss_type)
    jcfg = dataclasses.replace(jcfg, bbox_head=head)
    partition = tiny_partition() if use_gs else None
    jmodel = JFasterRCNN(cfg=jcfg, partition=partition, class_weights=tuple(WEIGHTS.tolist()))
    images, gt_boxes, gt_labels, gt_mask, img_shapes = make_batch()
    if use_gs not in INITS:  # the loss type leaves the parameters as they are
        INITS[use_gs] = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, 128, 128, 3)))
    variables = INITS[use_gs]

    def loss_fn(params):
        losses = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, images, gt_boxes,
                              gt_labels, gt_mask, img_shapes, method="loss", rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = to_torch_tree({"params": grads, "batch_stats": variables["batch_stats"]})
    batch = [torch.from_numpy(np.array(x)) for x in (images, gt_boxes, gt_labels, gt_mask, img_shapes)]

    def port_model():
        m = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None,
                           class_weights=WEIGHTS)
        m.load_state_dict(to_torch_tree(variables))
        return m

    return dict(name=request.param, losses=losses, grads=jgrads, port_model=port_model, batch=batch)


@pytest.mark.parametrize("selectp", [0, 1])
def test_loss_and_every_gradient_match_jax(trained, selectp):
    model = trained["port_model"]()
    assert "class_weights" not in model.state_dict()
    create_train_state(model, TrainConfig(selectp=selectp))  # freezes all but the selected tensors
    losses = model.loss(*trained["batch"], generator=torch.Generator().manual_seed(0))
    want = trained["losses"]
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if selectp == 1:
        assert sorted(named) == ["bbox_head.fc_cls.bias", "bbox_head.fc_cls.weight"]
    assert all(p.grad is None for n, p in model.named_parameters() if n not in named)
    for name, p in named.items():
        w = trained["grads"][name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)


def test_the_weights_move_the_loss(trained):
    """Without its class weights (or as plain softmax) the head's loss differs."""
    if trained["name"] == "focal":
        return
    model = trained["port_model"]()
    with torch.no_grad():
        weighted = model.loss(*trained["batch"], generator=torch.Generator().manual_seed(0))
        model.class_weights = torch.ones(9)
        ones = model.loss(*trained["batch"], generator=torch.Generator().manual_seed(0))
    moved = {k: abs(ones[k].item() - v.item()) for k, v in weighted.items() if k.startswith("loss_cls")}
    if trained["name"] == "reweight":
        assert moved["loss_cls"] > 1e-3
    else:  # bin 0 weighs every roi alike; the foreground bins move
        assert moved["loss_cls_bin0"] == 0.0 and max(moved.values()) > 1e-4


@pytest.mark.parametrize("min_size", [0.0, 6.0, 20.0])
def test_min_bbox_size_proposals_equal_jax(min_size):
    """The RPN drops boxes under `min_bbox_size` (+1 sides, after the clip,
    before NMS) as JAX's does, on seeded score and delta maps."""
    rng = np.random.RandomState(7)
    anchors = [rng.uniform(0, 120, (n, 2)) for n in (3072, 768, 192)]
    anchors = [np.concatenate([a, a + rng.uniform(2, 30, a.shape)], -1).astype(np.float32) for a in anchors]
    outs = [(rng.randn(2, len(a)).astype(np.float32), (rng.randn(2, len(a), 4) * 0.5).astype(np.float32))
            for a in anchors]
    shapes = np.array([[128.0, 128.0], [100.0, 120.0]], np.float32)
    jcfg = JProposalConfig(nms_pre=300, nms_post=100, max_num=150, nms_thr=0.7, min_bbox_size=min_size)
    want = jax_rpn_proposals([(jnp.asarray(c), jnp.asarray(d)) for c, d in outs], [jnp.asarray(a) for a in anchors],
                             jnp.asarray(shapes), jcfg)
    got = rpn_proposals_batched([(torch.from_numpy(c), torch.from_numpy(d)) for c, d in outs],
                                [torch.from_numpy(a) for a in anchors], torch.from_numpy(shapes),
                                to_port(tconfig.ProposalConfig, jcfg))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    b = got.boxes[got.valid]
    small = ((b[:, 2] - b[:, 0] + 1) < 20) | ((b[:, 3] - b[:, 1] + 1) < 20)
    assert bool(small.any()) == (min_size < 20)


def test_baseline_configs_match_jax():
    cases = {
        "faster_rcnn_r50_fpn_rfs_lvis": jzoo.faster_rcnn_r50_fpn_rfs_lvis,
        "faster_rcnn_r50_fpn_focal_lvis": jzoo.faster_rcnn_r50_fpn_focal_lvis,
        "faster_rcnn_r50_fpn_reweight_lvis": jzoo.faster_rcnn_r50_fpn_reweight_lvis,
    }
    for name, jfn in cases.items():
        jdet, jtrain = jfn()
        assert getattr(tzoo, name)() == to_port(tconfig.DetectorConfig, jdet), name
        assert tzoo.TRAIN_CONFIGS[name] == to_port(tconfig.TrainConfig, jtrain), name
    # the full-training rows (cls_only=False) take the default recipe
    for jfn in (jzoo.faster_rcnn_r50_fpn_focal_lvis, jzoo.faster_rcnn_r50_fpn_reweight_lvis):
        assert to_port(tconfig.TrainConfig, jfn(cls_only=False)[1]) == TrainConfig()
