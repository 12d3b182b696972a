"""The training losses of the PyTorch port against the JAX package, values
and gradients (`torch.autograd` against `jax.grad`): the weighted CE, BCE and
smooth-L1 of `ops/losses.py`, accuracy, the bbox head's losses, the
grouped-softmax loss and the RPN loss.

Inputs are made with numpy from a seed. Tolerance: both sides compute in
f32 with the same formulas, but exp, log and sums come from two libraries,
so values and gradients agree to 1e-5 relative (1e-7 absolute).

`gs_loss` subsamples each bin's "others" with random priorities; the tests
either hand the port the uniforms JAX draws from the same key (budget below
the others' count), or set the budget above the others' count, where all of
them are taken and no draw matters (ROADMAP caveat C-iv). The RPN loss
samples anchors; its test takes every candidate (`num` above the anchor
count, `pos_fraction` 1), so the sums do not depend on the draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.config import RPNTrainConfig as JRPNTrainConfig
from balancedgroupsoftmax_tpu.config import SamplerConfig as JSamplerConfig
from balancedgroupsoftmax_tpu.gs.head import gs_loss as jax_gs_loss
from balancedgroupsoftmax_tpu.models.bbox_head import bbox_head_loss as jax_bbox_head_loss
from balancedgroupsoftmax_tpu.models.rpn import rpn_loss as jax_rpn_loss
from balancedgroupsoftmax_tpu.ops import losses as jlosses
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.core.anchors import multilevel_anchors
from balancedgroupsoftmax_torch.gs.head import gs_loss
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.bbox_head import bbox_head_loss
from balancedgroupsoftmax_torch.models.rpn import rpn_loss
from balancedgroupsoftmax_torch.ops import losses as tlosses
from tests.test_detector import make_batch
from test_torch_detector import COUNTS, to_port
from test_torch_train_targets import gts

RTOL, ATOL = 1e-5, 1e-7


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=RTOL, atol=ATOL)


def both_grads(jfn, tfn, *arrays, argnums=(0,)):
    """Value and gradients of a scalar function in JAX and in the port."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=argnums)(*(jnp.asarray(a) for a in arrays))
    tin = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    tval = tfn(*tin)
    tval.backward()
    close(tval, jval)
    for i, jg in zip(argnums, jgrads):
        close(tin[i].grad, jg)


@pytest.mark.parametrize("avg", [None, 37.0])
def test_weighted_losses_and_gradients(avg):
    rng = np.random.RandomState(0)
    logits = rng.randn(50, 7).astype(np.float32) * 3
    labels = rng.randint(0, 7, 50).astype(np.int32)
    weight = (rng.rand(50) > 0.3).astype(np.float32)
    both_grads(
        lambda x: jlosses.softmax_cross_entropy(x, labels, weight, avg),
        lambda x: tlosses.softmax_cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(weight), avg),
        logits,
    )
    targets = (rng.rand(50, 7) > 0.5).astype(np.float32)
    both_grads(
        lambda x: jlosses.binary_cross_entropy_with_logits(x, targets, weight[:, None], avg),
        lambda x: tlosses.binary_cross_entropy_with_logits(x, torch.from_numpy(targets), torch.from_numpy(weight)[:, None], avg),
        logits,
    )
    pred, target = rng.randn(2, 50, 4).astype(np.float32) * 0.3
    for beta in (1.0, 1.0 / 9.0):
        both_grads(
            lambda x: jlosses.smooth_l1(x, target, beta, weight[:, None], avg),
            lambda x: tlosses.smooth_l1(x, torch.from_numpy(target), beta, torch.from_numpy(weight)[:, None], avg),
            pred,
        )
    close(
        tlosses.accuracy(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weight)),
        jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight)),
    )


def test_bbox_head_loss_and_gradients():
    rng = np.random.RandomState(1)
    n, c = 64, 9
    logits = rng.randn(n, c).astype(np.float32)
    deltas = rng.randn(n, 4 * c).astype(np.float32) * 0.2
    labels = rng.randint(0, c, n).astype(np.int32)
    lw = (rng.rand(n) > 0.2).astype(np.float32)
    targets = rng.randn(n, 4).astype(np.float32) * 0.2
    bw = np.repeat((labels > 0).astype(np.float32)[:, None], 4, 1)
    rest = (labels, lw, targets, bw)
    jout = jax_bbox_head_loss(jnp.asarray(logits), jnp.asarray(deltas), *map(jnp.asarray, rest))
    tout = bbox_head_loss(torch.from_numpy(logits), torch.from_numpy(deltas), *map(torch.from_numpy, rest))
    for g, w in zip(tout, jout):
        close(g, w)
    both_grads(
        lambda x, d: sum(jax_bbox_head_loss(x, d, *map(jnp.asarray, rest))[:2]),
        lambda x, d: sum(bbox_head_loss(x, d, *map(torch.from_numpy, rest))[:2]),
        logits, deltas, argnums=(0, 1),
    )


def gs_case(seed, n=120):
    rng = np.random.RandomState(seed)
    part = make_partition(COUNTS)
    logits = rng.randn(n, part.num_logits).astype(np.float32)
    # mostly background: the foreground bins have more others than 8 x their fg
    labels = np.where(rng.rand(n) < 0.15, rng.randint(1, 9, n), 0).astype(np.int32)
    valid = rng.rand(n) > 0.1
    return part, logits, labels, valid


def jax_gs_priorities(key, num_bins, n):
    keys = jax.random.split(key, num_bins)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys]))


@pytest.mark.parametrize("ratio", [8.0, 1e4])  # budget below / above the others' count
def test_gs_loss_and_gradients(ratio):
    part, logits, labels, valid = gs_case(2)
    key = jax.random.PRNGKey(5)
    prio = jax_gs_priorities(key, part.num_bins, logits.shape[0])

    def jfn(x):
        return jax_gs_loss(key, x, jnp.asarray(labels), jnp.asarray(valid), part, ratio)

    def tfn(x):
        return gs_loss(
            x, torch.from_numpy(labels), torch.from_numpy(valid), part, ratio,
            others_priority=prio if ratio < 100 else None,
        )

    jout = jfn(jnp.asarray(logits))
    tout = tfn(torch.from_numpy(logits))
    assert list(tout) == list(jout)
    for k in jout:
        close(tout[k], jout[k])
    both_grads(lambda x: sum(jfn(x).values()), lambda x: sum(tfn(x).values()), logits)


def test_gs_loss_skips_a_bin_without_foreground():
    part, logits, labels, valid = gs_case(3)
    labels[np.isin(labels, np.nonzero(part.label2bin == 2)[0])] = 0
    out = gs_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(valid), part,
                  generator=torch.Generator().manual_seed(0))
    assert out["loss_cls_bin2"].item() == 0.0
    assert all(out[f"loss_cls_bin{i}"].item() > 0 for i in (0, 1, 3, 4))


def test_rpn_loss_and_gradients_when_every_anchor_is_sampled():
    sizes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    anchors = multilevel_anchors(sizes, (4, 8, 16, 32, 64), (8.0,), (0.5, 1.0, 2.0))
    flat = np.concatenate(anchors)
    valid = np.ones(flat.shape[0], bool)
    jcfg = JRPNTrainConfig(sampler=JSamplerConfig(num=flat.shape[0], pos_fraction=1.0, add_gt_as_proposals=False))
    gb, _, gm = gts()
    rng = np.random.RandomState(4)
    cls = [rng.randn(2, h, w, 3).astype(np.float32) for h, w in sizes]
    reg = [rng.randn(2, h, w, 12).astype(np.float32) * 0.1 for h, w in sizes]

    def jfn(cls, reg):
        outs = list(zip(cls, reg))
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        return sum(jax_rpn_loss(outs, jnp.asarray(flat), jnp.asarray(valid), gb, gm, (128, 128), keys, jcfg))

    def tfn(cls, reg):
        outs = [(c.reshape(2, -1), r.reshape(2, -1, 4)) for c, r in zip(cls, reg)]
        return sum(rpn_loss(
            outs, torch.from_numpy(flat), torch.from_numpy(valid), torch.from_numpy(gb), torch.from_numpy(gm),
            (128, 128), to_port(tconfig.RPNTrainConfig, jcfg), torch.Generator().manual_seed(0),
        ))

    jval, (jgc, jgr) = jax.value_and_grad(jfn, argnums=(0, 1))([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    tcls = [torch.tensor(c, requires_grad=True) for c in cls]
    treg = [torch.tensor(r, requires_grad=True) for r in reg]
    tval = tfn(tcls, treg)
    tval.backward()
    close(tval, jval)
    for t, j in zip(tcls + treg, list(jgc) + list(jgr)):
        close(t.grad, j)
