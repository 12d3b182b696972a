"""The training slice of the PyTorch port against the JAX package, at the
tiny configuration of tests/test_detector.py (128 x 128, 9 classes, GS
partition, f32, full-width ResNet-50) on weights converted by
`convert.params_from_flax`: the loss dict of `FasterRCNN.loss` (GS and
plain heads), every parameter's gradient, the parameters after one and two SGD steps against
optax, `trainable_mask` at selectp 0 to 3, `lr_schedule`, and the
training branch of the input pipeline.

Sampling is made deterministic through the configuration, not by seeding
(ROADMAP caveat C-iv): the RPN and RCNN samplers take every candidate
(`num` above the candidates' count, `pos_fraction` 1) and the GS head's
others budget exceeds the others' count, so the losses do not depend on the
draws of `jax.random` or of the port's generator, only their order of
summation does.

Tolerances: convolutions sum in another order in XLA and PyTorch (the
inference test holds FPN features to 1e-4 of their largest value), so the
losses agree to 1e-4 relative and each parameter's gradient to 1e-3 of that
tensor's largest value; the parameters after SGD steps, which move by the
learning rate times those gradients, agree to 1e-6 absolute. PyTorch runs on
one CPU thread in this file: with several, its convolutions take another
path, which on this input moves layer3.4's gradients by 4e-4 of their
largest value against JAX (one thread: 2e-6), so the result would depend on
the host's core count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.config import SamplerConfig, TrainConfig
from balancedgroupsoftmax_tpu.data.pipeline import PipelineConfig as JPipelineConfig
from balancedgroupsoftmax_tpu.data.pipeline import collate as jax_collate
from balancedgroupsoftmax_tpu.data.pipeline import preprocess_image as jax_preprocess_image
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_tpu.parallel.optim import lr_schedule as jax_lr_schedule
from balancedgroupsoftmax_tpu.parallel.optim import make_optimizer as jax_make_optimizer
from balancedgroupsoftmax_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig, collate, preprocess_image
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.parallel.optim import lr_schedule, trainable_mask
from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
from tests.test_detector import make_batch, tiny_config, tiny_partition
from test_torch_detector import COUNTS, to_port

NUM_ANCHORS = 3 * (32 * 32 + 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2)  # at 128 x 128
TCFG = TrainConfig(lr=0.02, warmup_iters=2, grad_clip_norm=2.0)  # warmup and clip both act


def deterministic_config():
    cfg = tiny_config(use_gs=True)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    return dataclasses.replace(
        cfg,
        rpn_train=take_all(cfg.rpn_train, NUM_ANCHORS),
        rcnn_train=take_all(cfg.rcnn_train, cfg.rpn_proposal_train.max_num + cfg.max_gt_boxes),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )


def to_torch_tree(variables):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg = deterministic_config()
    jmodel = jax_build_detector(jcfg, partition=tiny_partition())
    images, gt_boxes, gt_labels, gt_mask, img_shapes = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(0), images[:1])
    batch = dict(images=images, gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask, img_shapes=img_shapes)

    def loss_fn(params, key):
        losses = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            images, gt_boxes, gt_labels, gt_mask, img_shapes, method="loss", rngs={"sampling": key},
        )
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = [variables["params"]]
    losses, grads = [], []
    tx = jax_make_optimizer(TCFG, params[0])
    opt_state = tx.init(params[0])
    for step in range(2):  # two optax steps, from a different sampling key each
        (_, l), g = value_and_grad(params[-1], jax.random.PRNGKey(step))
        updates, opt_state = tx.update(g, opt_state, params[-1])
        params.append(optax.apply_updates(params[-1], updates))
        losses.append(l)
        grads.append(g)

    def port_model():
        m = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS))
        m.load_state_dict(to_torch_tree(variables))
        return m

    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return dict(
        variables=variables, params=params, losses=losses, grads=grads,
        port_model=port_model, batch=tbatch, jmodel=jmodel,
    )


def port_tree(setup, params):
    """JAX parameters as the port's named tensors."""
    return to_torch_tree({"params": params, "batch_stats": setup["variables"]["batch_stats"]})


def test_deterministic_config_takes_every_candidate(setup):
    model = setup["port_model"]()
    b = setup["batch"]
    a = model.loss(b["images"], b["gt_boxes"], b["gt_labels"], b["gt_mask"], b["img_shapes"], generator=torch.Generator().manual_seed(0))
    c = model.loss(b["images"], b["gt_boxes"], b["gt_labels"], b["gt_mask"], b["img_shapes"], generator=torch.Generator().manual_seed(1))
    for k in a:
        torch.testing.assert_close(a[k], c[k], rtol=1e-6, atol=0)


def test_loss_dict_and_every_gradient_match_jax(setup):
    model = setup["port_model"]()
    b = setup["batch"]
    losses = model.loss(b["images"], b["gt_boxes"], b["gt_labels"], b["gt_mask"], b["img_shapes"], generator=torch.Generator().manual_seed(0))
    want = setup["losses"][0]
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        assert float(v) > 0, k  # every bin has foreground in this batch
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    jgrads = port_tree(setup, setup["grads"][0])
    named = dict(model.named_parameters())
    assert set(named) <= set(jgrads)
    for name, p in named.items():
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)


def test_softmax_head_loss_matches_jax():
    """The plain head (faster_rcnn_r50's): softmax CE, regression and
    accuracy beside the RPN's losses, forward only."""
    jcfg = dataclasses.replace(deterministic_config(), bbox_head=tiny_config().bbox_head)
    jmodel = jax_build_detector(jcfg)
    images, gt_boxes, gt_labels, gt_mask, img_shapes = make_batch()
    variables = jmodel.init(jax.random.PRNGKey(1), images[:1])
    want = jax.jit(
        lambda v: jmodel.apply(
            v, images, gt_boxes, gt_labels, gt_mask, img_shapes, method="loss",
            rngs={"sampling": jax.random.PRNGKey(0)},
        )
    )(variables)
    model = build_detector(to_port(tconfig.DetectorConfig, jcfg))
    model.load_state_dict(to_torch_tree(variables))
    with torch.no_grad():
        got = model.loss(*(torch.from_numpy(np.array(x)) for x in (images, gt_boxes, gt_labels, gt_mask, img_shapes)))
    assert sorted(got) == sorted(want) == ["acc", "loss_bbox", "loss_cls", "loss_rpn_bbox", "loss_rpn_cls"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-4, err_msg=k)


def test_two_sgd_steps_match_optax(setup):
    model = setup["port_model"]()
    state = create_train_state(model, to_port(tconfig.TrainConfig, TCFG))
    step = make_train_step(state)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert "backbone.conv1.weight" in frozen and "backbone.layer1.0.conv1.weight" in frozen
    for i in (1, 2):
        metrics = step(setup["batch"], torch.Generator().manual_seed(i))
        assert np.isfinite(metrics["loss"].item())
        want = port_tree(setup, setup["params"][i])
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=f"step {i} {name}")
    assert state.step == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(lr_schedule(to_port(tconfig.TrainConfig, TCFG), 1)(2))


def test_selectp1_trains_only_fc_cls_in_both(setup):
    cfg = dataclasses.replace(TCFG, selectp=1)
    tx = jax_make_optimizer(cfg, setup["params"][0])
    updates, _ = tx.update(setup["grads"][0], tx.init(setup["params"][0]), setup["params"][0])
    want = port_tree(setup, optax.apply_updates(setup["params"][0], updates))

    model = setup["port_model"]()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, to_port(tconfig.TrainConfig, cfg))
    make_train_step(state)(setup["batch"], torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == ("fc_cls" in name), name
        assert (p.grad is not None) == ("fc_cls" in name), name
        jmoved = not np.array_equal(want[name].numpy(), before[name].numpy())
        assert jmoved == ("fc_cls" in name), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("selectp", [0, 1, 2, 3])
@pytest.mark.parametrize("frozen_stages", [1, 2])
def test_trainable_mask_selects_the_jax_tensors(setup, selectp, frozen_stages):
    params = setup["variables"]["params"]
    jmask = jax_trainable_mask(params, selectp, frozen_stages)
    # each JAX leaf becomes ones where it trains and zeros where not, carried
    # across by the weight converter: the port's names of the JAX mask
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in port_tree(setup, as_arrays).items()}
    got = trainable_mask(setup["port_model"](), selectp, frozen_stages)
    assert got == {k: want[k] for k in got}
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("selectp", [4])
def test_trainable_mask_refuses_what_is_not_ported(setup, selectp):
    """selectp 4 (the bbox and mask heads) is ported: on Faster R-CNN it
    trains the bbox head alone. A selectp beyond it is refused."""
    got = trainable_mask(setup["port_model"](), selectp=selectp)
    assert {k.split(".")[0] for k, v in got.items() if v} == {"bbox_head"}
    with pytest.raises(ValueError):
        trainable_mask(setup["port_model"](), selectp=selectp + 1)


def test_lr_schedule_matches_jax():
    cfg = TrainConfig(lr=0.01, warmup_iters=500, lr_step_epochs=(8, 11))
    want = jax_lr_schedule(cfg, 100)
    got = lr_schedule(to_port(tconfig.TrainConfig, cfg), 100)
    for step in (0, 1, 250, 499, 500, 799, 800, 1099, 1100, 5000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step


def test_zoo_train_configs_match_jax():
    # the JAX zoo returns the GS Mask R-CNN's, GS cascades' and GS HTC's recipes from their use_gs argument
    jax_configs = {
        "gs_mask_rcnn_r50_fpn_lvis": lambda: jzoo.mask_rcnn_r50_fpn_lvis(use_gs=True),
        "gs_cascade_rcnn_r50_fpn_lvis": lambda: jzoo.cascade_rcnn_r50_fpn_lvis(use_gs=True),
        "gs_htc_x101_64x4d_fpn_lvis": lambda: jzoo.htc_x101_64x4d_fpn_lvis(use_gs=True),
        "gs_cascade_rcnn_x101_64x4d_fpn_lvis": lambda: jzoo.cascade_rcnn_x101_64x4d_fpn_lvis(use_gs=True),
    }
    assert {"cascade_rcnn_r50_fpn_lvis", "gs_cascade_rcnn_r50_fpn_lvis"} <= set(tzoo.TRAIN_CONFIGS)
    for name, cfg in tzoo.TRAIN_CONFIGS.items():
        jax_zoo_entry = jax_configs.get(name) or getattr(jzoo, name)
        assert cfg == to_port(tconfig.TrainConfig, jax_zoo_entry()[1]), name


@pytest.mark.parametrize("seed", [0, 1, 2, 3])  # flips and does not flip
def test_train_preprocess_and_collate_match_jax(seed):
    rng = np.random.RandomState(seed)
    hw = (480, 640) if seed % 2 else (640, 427)
    img = rng.randint(0, 255, (*hw, 3), np.uint8)
    boxes = np.sort(rng.uniform(0, min(hw), (5, 2, 2)), axis=1).reshape(5, 4).astype(np.float32)[:, [0, 2, 1, 3]]
    labels = rng.randint(1, 1231, 5).astype(np.int32)
    jcfg, tcfg = JPipelineConfig(max_gt_boxes=8), PipelineConfig(max_gt_boxes=8)
    want = [jax_preprocess_image(img, boxes.copy(), labels, jcfg, True, np.random.RandomState(seed + s)) for s in (0, 10)]
    got = [preprocess_image(img, boxes.copy(), labels, tcfg, True, np.random.RandomState(seed + s)) for s in (0, 10)]
    for g, w in zip(got, want):
        assert g["flipped"] == w["flipped"] and g["bucket"] == w["bucket"]
    for key, w in jax_collate(want).items():
        np.testing.assert_array_equal(collate(got)[key], w, err_msg=key)
