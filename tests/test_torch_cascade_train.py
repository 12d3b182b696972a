"""Cascade R-CNN training of the PyTorch port against the JAX package, at
the tiny cascade of tests/test_cascade.py (128 x 128, 9 classes, f32,
full-width ResNet-50) on weights converted by `convert.params_from_flax`:
the loss dict of `CascadeRCNN.loss` and every parameter's gradient (GS
heads), the loss dict with softmax heads, `trainable_mask` at selectp 2 and
3 on the cascade, and one BAGS phase-2 step (selectp=3) against optax.

Sampling is made deterministic through the configuration, as in
tests/test_torch_train_step.py (ROADMAP caveat C-iv): every sampler has more
slots than any stage has valid candidates (the RCNN's 64 proposals plus 3 gt
boxes an image, and the gt boxes again at each later stage) and takes
positives up to all of them, and the GS others' budget covers them all.

The total is the sum of the entries whose name holds "loss", as mmdet's
`parse_losses` and the port's train step take it; the JAX train step
(`parallel/train.py:88`) sums only names that start with "loss", which drops
the cascade's stage losses, so these tests take the gradient of the JAX
loss dict themselves.

Tolerances, as tests/test_torch_train_step.py: losses within 1e-4
relative, each gradient within 1e-3 of its tensor's largest value,
parameters after an SGD step within 1e-6; PyTorch on one CPU thread.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from balancedgroupsoftmax_tpu.config import TrainConfig
from balancedgroupsoftmax_tpu.models.cascade import build_cascade as jax_build_cascade
from balancedgroupsoftmax_tpu.parallel.optim import make_optimizer as jax_make_optimizer
from balancedgroupsoftmax_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.parallel.optim import trainable_mask
from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
from tests.test_cascade import cascade_tiny
from tests.test_detector import make_batch, tiny_partition
from test_torch_detector import COUNTS, to_port
from test_torch_train_step import NUM_ANCHORS

TCFG = TrainConfig(lr=0.02, warmup_iters=2, grad_clip_norm=2.0)


def deterministic_cascade(use_gs):
    cfg = cascade_tiny(use_gs=use_gs)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    return dataclasses.replace(
        cfg,
        rpn_train=take_all(cfg.rpn_train, NUM_ANCHORS),
        rcnn_train=take_all(cfg.rcnn_train, cfg.rpn_proposal_train.max_num + 3 * cfg.max_gt_boxes),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )


def total_loss(losses):
    return sum(v for k, v in losses.items() if "loss" in k)


def to_torch_tree(variables):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_model(jcfg, variables, use_gs):
    m = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    m.load_state_dict(to_torch_tree(variables))
    return m


def torch_batch():
    return [torch.from_numpy(np.array(x)) for x in make_batch()]


@pytest.fixture(scope="module")
def gs_setup():
    jcfg = deterministic_cascade(use_gs=True)
    jmodel = jax_build_cascade(jcfg, partition=tiny_partition())
    batch = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(0), batch[0][:1])

    def loss_fn(params):
        losses = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *batch,
            method="loss", rngs={"sampling": jax.random.PRNGKey(0)},
        )
        return total_loss(losses), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return dict(jcfg=jcfg, variables=variables, losses=losses, grads=grads)


def port_tree(setup, params):
    return to_torch_tree({"params": params, "batch_stats": setup["variables"]["batch_stats"]})


def test_loss_dict_and_every_gradient_match_jax(gs_setup):
    model = port_model(gs_setup["jcfg"], gs_setup["variables"], True)
    losses = model.loss(*torch_batch(), generator=torch.Generator().manual_seed(0))
    want = gs_setup["losses"]
    assert sorted(losses) == sorted(want)
    assert {f"s{i}.loss_cls_bin{b}" for i in range(3) for b in range(5)} | {"s2.loss_bbox"} <= set(losses)
    for k, v in want.items():
        assert float(v) > 0, k  # every stage and bin has foreground in this batch
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    total_loss(losses).backward()
    jgrads = port_tree(gs_setup, gs_setup["grads"])
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads) - {k for k in jgrads if "running" in k}
    for name, p in named.items():
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)
    for i in range(3):  # every stage learns
        assert named[f"bbox_heads.{i}.fc_cls.weight"].grad.abs().sum() > 0


def test_sampling_takes_every_candidate(gs_setup):
    model = port_model(gs_setup["jcfg"], gs_setup["variables"], True)
    with torch.no_grad():
        a, b = (model.loss(*torch_batch(), generator=torch.Generator().manual_seed(s)) for s in (0, 1))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=0)


def test_softmax_heads_loss_matches_jax():
    jcfg = deterministic_cascade(use_gs=False)
    jmodel = jax_build_cascade(jcfg)
    batch = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(1), batch[0][:1])
    want = jax.jit(
        lambda v: jmodel.apply(v, *batch, method="loss", rngs={"sampling": jax.random.PRNGKey(0)})
    )(variables)
    model = port_model(jcfg, variables, False)
    with torch.no_grad():
        got = model.loss(*torch_batch())
    assert sorted(got) == sorted(want) == sorted(
        ["loss_rpn_cls", "loss_rpn_bbox"] + [f"s{i}.loss_{n}" for i in range(3) for n in ("cls", "bbox")]
    )
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("selectp", [0, 1, 2, 3])
def test_trainable_mask_selects_the_jax_tensors_on_the_cascade(gs_setup, selectp):
    params = gs_setup["variables"]["params"]
    jmask = jax_trainable_mask(params, selectp)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in port_tree(gs_setup, as_arrays).items()}
    got = trainable_mask(port_model(gs_setup["jcfg"], gs_setup["variables"], True), selectp)
    assert got == {k: want[k] for k in got}
    if selectp == 3:
        assert sorted(k for k, v in got.items() if v) == sorted(
            f"bbox_heads.{i}.fc_cls.{t}" for i in range(3) for t in ("weight", "bias")
        )
    if selectp == 2:
        assert {k.split(".")[0] for k, v in got.items() if v} == {"bbox_heads"}


def test_selectp3_step_trains_every_stage_fc_cls_as_optax(gs_setup):
    cfg = dataclasses.replace(TCFG, selectp=3)
    params = gs_setup["variables"]["params"]
    tx = jax_make_optimizer(cfg, params)
    updates, _ = tx.update(gs_setup["grads"], tx.init(params), params)
    want = port_tree(gs_setup, optax.apply_updates(params, updates))

    model = port_model(gs_setup["jcfg"], gs_setup["variables"], True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, to_port(tconfig.TrainConfig, cfg))
    metrics = make_train_step(state)(
        dict(zip(("images", "gt_boxes", "gt_labels", "gt_mask", "img_shapes"), torch_batch())),
        torch.Generator().manual_seed(0),
    )
    np.testing.assert_allclose(metrics["loss"].item(), float(total_loss(gs_setup["losses"])), rtol=1e-4)
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == ("fc_cls" in name), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
