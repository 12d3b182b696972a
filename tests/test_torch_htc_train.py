"""HTC training of the PyTorch port against the JAX package, at the tiny HTC
of tests/test_torch_htc.py (128 x 128, 9 classes, f32, three stages, two-conv
mask heads, a ResNeXt-50 backbone with deformable conv v1 in c3-c5 whose
offset convs get seeded non-zero weights) on weights converted by
`convert.params_from_flax`: the loss dict of `HTC.loss` and every
parameter's gradient, the deformable layers' weights and offset convs
included, with GS heads at D = 4 and softmax heads at D = 0;
`trainable_mask` at selectp 0-4 on the HTC; and one selectp=3 and one
selectp=4 SGD step against optax.

Sampling is made deterministic through the configuration, as in
tests/test_torch_cascade_train.py: every sampler has more slots than any
stage has valid candidates, also for the interleaved mask targets (which
sample the refined rois again), and takes positives up to all of them; the
mask branch then takes every row (mask_cap = slots x 1.0), and the GS
others' budget covers them all. Every loss is a sum or mean over the sampled
set, so the slots' order does not matter. The gt masks are seeded ellipses
in their crops, and a seeded stuff map with ignored pixels drives the
semantic loss.

The total sums the entries whose name holds "loss" (the JAX train step sums
only names that start with "loss", which drops the stage losses), so the
JAX gradient is taken here. Tolerances as the cascade's: losses within 1e-4
relative, each gradient within 1e-3 of its tensor's largest value,
parameters after a step within 1e-6; PyTorch on one CPU thread.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from balancedgroupsoftmax_tpu.config import TrainConfig
from balancedgroupsoftmax_tpu.models.htc import build_htc as jax_build_htc
from balancedgroupsoftmax_tpu.parallel.optim import make_optimizer as jax_make_optimizer
from balancedgroupsoftmax_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.models.htc import HTC
from balancedgroupsoftmax_torch.ops.mask import GT_MASK_CROP
from balancedgroupsoftmax_torch.parallel.optim import trainable_mask
from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
from tests.test_detector import make_batch, tiny_partition
from tests.test_htc import htc_tiny
from test_torch_cascade_train import to_torch_tree, total_loss
from test_torch_deform_conv import _np, _offset_params
from test_torch_detector import COUNTS, to_port
from test_torch_htc import DCN_BACKBONE
from test_torch_train_step import NUM_ANCHORS

TCFG = TrainConfig(lr=0.02, warmup_iters=2, grad_clip_norm=2.0)
# the offset convs' weights, times 1 / sqrt(fan_in): offsets of up to about
# 3 cells. At 1.0 the port's f32 gradients part from JAX's by up to 8e-3 of a
# tensor's largest value: f32 rounding puts two of the semantic head's ReLU
# inputs, within 1e-5 of 0, on the other side, and the jump spreads through
# the backward (tests/f64_witness.py). The port in f64 matches JAX there
# (test_at_offset_scale_one_the_port_in_f64_matches_jax); the clamp at +-D is
# held by tests/test_torch_deform_conv_grad.py
OFFSET_SCALE = 0.5


def deterministic_htc(use_gs, window):
    cfg = htc_tiny(use_gs=use_gs)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(DCN_BACKBONE, dcn_shift_window=window),
        rpn_train=take_all(cfg.rpn_train, NUM_ANCHORS),
        rcnn_train=take_all(cfg.rcnn_train, cfg.rpn_proposal_train.max_num + 3 * cfg.max_gt_boxes),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )


def mask_inputs(gt_mask, seed=3):
    """Seeded gt crops (B, G, CROP, CROP): an ellipse in each valid gt's
    crop; and a (B, 16, 16) stuff map of 12 classes, a fifth ignored (255)."""
    rng = np.random.RandomState(seed)
    b, g = gt_mask.shape
    yy, xx = np.mgrid[:GT_MASK_CROP, :GT_MASK_CROP] / GT_MASK_CROP
    crops = np.zeros((b, g, GT_MASK_CROP, GT_MASK_CROP), np.float32)
    for i in range(b):
        for j in range(g):
            if gt_mask[i, j]:
                cy, cx = rng.uniform(0.3, 0.7, 2)
                ry, rx = rng.uniform(0.2, 0.5, 2)
                crops[i, j] = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(np.float32)
    seg = rng.randint(0, 12, (b, 16, 16)).astype(np.int32)
    seg[rng.rand(b, 16, 16) < 0.2] = 255
    return crops, seg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def make_setup(use_gs, window):
    """The JAX model's loss dict and gradient (one jit), its variables, the
    jitted gradient function and the variables before the offset convs are
    set, and the batch as tensors."""
    jcfg = deterministic_htc(use_gs, window)
    jmodel = jax_build_htc(jcfg, partition=tiny_partition() if use_gs else None)
    batch = make_batch()
    crops, seg = mask_inputs(np.asarray(batch[3]))
    inputs = (*batch, jnp.asarray(crops), jnp.asarray(seg))
    # jitted, the init takes half the time eager init does
    init = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch[0][:1]))
    variables = _offset_params(np.random.RandomState(7), copy.deepcopy(init), OFFSET_SCALE)

    def loss_fn(params):
        losses = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *inputs,
            method="loss", rngs={"sampling": jax.random.PRNGKey(0)},
        )
        return total_loss(losses), losses

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, losses), grads = value_and_grad(variables["params"])
    return dict(jcfg=jcfg, use_gs=use_gs, variables=variables, losses=losses, grads=grads, init=init,
                value_and_grad=value_and_grad, inputs=[torch.from_numpy(np.array(x)) for x in inputs])


# the softmax heads at D = 0 add a second JAX compile of the loss's gradient
@pytest.fixture(scope="module", params=[pytest.param((True, 4), id="gs-D4"),
                                        pytest.param((False, 0), id="softmax-D0", marks=pytest.mark.slow)])
def setup(request):
    return make_setup(*request.param)


@pytest.fixture(scope="module")
def gs_setup():
    return make_setup(True, 4)


def port_model(setup, dtype=torch.float32):
    m = build_model(to_port(tconfig.DetectorConfig, setup["jcfg"]),
                    partition=make_partition(COUNTS) if setup["use_gs"] else None, dtype=dtype)
    m.load_state_dict(to_torch_tree(setup["variables"]))
    return m.to(dtype)


def port_tree(setup, params):
    return to_torch_tree({"params": params, "batch_stats": setup["variables"]["batch_stats"]})


def test_loss_dict_and_every_gradient_match_jax(setup):
    model = port_model(setup)
    assert isinstance(model, HTC)
    losses = model.loss(*setup["inputs"], generator=torch.Generator().manual_seed(0))
    want = setup["losses"]
    assert sorted(losses) == sorted(want)
    assert {f"s{i}.loss_mask" for i in range(3)} | {"loss_semantic_seg"} <= set(losses)
    for k, v in want.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    total_loss(losses).backward()
    jgrads = port_tree(setup, setup["grads"])
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads) - {k for k in jgrads if "running" in k}
    for name, p in named.items():
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)
    # the deformable layers learn: their weights and offset convs get a gradient
    dcn = [n for n in named if n.startswith("backbone.layer") and "conv2.conv_offset.weight" in n]
    assert len(dcn) == 4 + 6 + 3
    for n in dcn:
        assert named[n].grad.abs().max() > 0 and named[n.replace("conv_offset.", "")].grad.abs().max() > 0, n
    for i in range(3):  # every stage's mask head learns, and stage 0's also from the later stages' flow
        assert named[f"mask_heads.{i}.conv_logits.weight"].grad.abs().sum() > 0


def test_at_offset_scale_one_the_port_in_f64_matches_jax(gs_setup):
    """The offset convs at a scale of 1.0, where the port's f32 gradients
    part from JAX's at ReLU inputs that rounding puts on the other side of 0
    (OFFSET_SCALE's note): the port in f64, on JAX's f32 weights and inputs,
    computes JAX's f32 loss dict and gradient within the same limits, 1e-4
    relative and 1e-3 of each tensor's largest value (the JAX function is
    the one compiled for the setup)."""
    variables = _offset_params(np.random.RandomState(7), copy.deepcopy(gs_setup["init"]), 1.0)
    (_, want), jgrads = gs_setup["value_and_grad"](variables["params"])
    setup = dict(gs_setup, variables=variables)
    model = port_model(setup, torch.float64)
    inputs = [x.double() if x.is_floating_point() else x for x in setup["inputs"]]
    losses = model.loss(*inputs, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    total_loss(losses).backward()
    jgrads = port_tree(setup, jgrads)
    for name, p in model.named_parameters():
        w = jgrads[name].double().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)


@pytest.mark.parametrize("selectp", [0, 1, 2, 3, 4])
def test_trainable_mask_selects_the_jax_tensors_on_the_htc(gs_setup, selectp):
    setup = gs_setup
    params = setup["variables"]["params"]
    jmask = jax_trainable_mask(params, selectp)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in port_tree(setup, as_arrays).items()}
    got = trainable_mask(port_model(setup), selectp)
    assert got == {k: want[k] for k in got}
    heads = {k.split(".")[0] for k, v in got.items() if v}
    assert heads == {0: {"backbone", "neck", "rpn_head", "semantic_head", "bbox_heads", "mask_heads"},
                     1: {"bbox_heads"}, 2: {"bbox_heads"}, 3: {"bbox_heads"}, 4: {"bbox_heads", "mask_heads"}}[selectp]


@pytest.mark.parametrize("selectp", [3, 4])
def test_phase2_step_trains_what_selectp_names_as_optax(gs_setup, selectp):
    """One SGD step through `make_train_step` (which passes the batch's
    gt_mask_crops) against optax with the JAX gradient: selectp 3 moves only
    every stage's fc_cls, 4 only the bbox and mask heads."""
    setup = gs_setup
    cfg = dataclasses.replace(TCFG, selectp=selectp)
    params = setup["variables"]["params"]
    tx = jax_make_optimizer(cfg, params)
    # jitted: eager optax compiles each op for each parameter shape
    sgd = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want = port_tree(setup, sgd(setup["grads"], params))

    model = port_model(setup)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, to_port(tconfig.TrainConfig, cfg))
    images, gt_boxes, gt_labels, gt_mask, img_shapes, crops, _ = setup["inputs"]
    batch = dict(images=images, gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask, img_shapes=img_shapes,
                 gt_mask_crops=crops)
    metrics = make_train_step(state)(batch, torch.Generator().manual_seed(0))
    # the train step gives no stuff map, as the JAX one: the semantic loss is left out
    np.testing.assert_allclose(
        metrics["loss"].item(), float(total_loss(setup["losses"]) - setup["losses"]["loss_semantic_seg"]), rtol=1e-4
    )
    moved = set()
    for name, p in model.named_parameters():
        named = "fc_cls" in name if selectp == 3 else name.startswith(("bbox_heads", "mask_heads"))
        if not torch.equal(p.detach(), before[name]):
            moved.add(name.split(".")[0] if selectp == 4 else name)
        if named:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    assert moved == ({f"bbox_heads.{i}.fc_cls.{t}" for i in range(3) for t in ("weight", "bias")}
                     if selectp == 3 else {"bbox_heads", "mask_heads"})
