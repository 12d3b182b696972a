"""Mask R-CNN of the PyTorch port against the JAX package, at the tiny
configuration of tests/test_detector.py with its mask head (:214-225: two
3x3 convs of 32 channels, 28 x 28 class-selected masks; 128 x 128, 9
classes, f32, full-width ResNet-50), GS and softmax, on weights converted by
`convert.params_from_flax`:

- `build_model` builds the mask head and `params_from_flax` maps the flax
  `mask_head` node onto it (both dropped it silently before), and refuses a
  node it has no mapping for;
- `predict_with_masks` equals JAX's (boxes 1e-4 px, scores 1e-5, mask
  probabilities 1e-5), with and without `rescale`; `predict_masks` on its
  detections equals its masks;
- `loss` with the gt crops equals JAX's loss dict, "loss_mask" included
  (1e-4 relative), and every gradient is within 1e-3 of its tensor's largest
  value (the tolerance of tests/test_torch_train_step.py); sampling is made
  deterministic by the configuration (ROADMAP caveat iv), so the mask branch
  takes every slot. In f32 the mask head's gradients part from JAX's there
  by up to 9.7e-4 of their largest value, and the port's own f32 gradient
  parts as far from its f64 one: three ReLU inputs after the mask head's
  upsampling lie within 6.2e-7 of 0 (the largest is 7.0) and change side in
  f32. Two JAX compiles of the same loss part by up to 4.5e-3, because
  against the 0/1 crops some resampled targets sit exactly on 0.5 and
  rounding decides them (`python tests/f64_witness.py mask` prints these
  readings). Hence the issue's 1e-5 is held in f64: with crops of seeded
  values in [0, 1] (no sample on 0.5), the whole model's loss dict and
  every gradient, the mask head's included, within 1e-5 of JAX's in f64.
  Against the 0/1 crops, on JAX's rois, the port's targets equal JAX's off
  the 0.5 samples; given JAX's FPN features, RoI targets and the soft
  crops, the port's mask branch gives JAX's targets bit for bit, its
  "loss_mask" and every mask-head gradient within 1e-5 in f32;
- `trainable_mask` at selectp 0, 1 and 4 picks JAX's tensors, and a selectp=4
  SGD step moves exactly `bbox_head.*` and `mask_head.*`, as optax does;
- the train CLI gives `mask_rcnn_r50` the gt crops and logs "loss_mask", and
  the test CLI on its checkpoint writes segm records and prints the segm
  table.

PyTorch runs on one CPU thread in this file (ROADMAP caveat v).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.config import MaskHeadConfig, TrainConfig
from balancedgroupsoftmax_tpu.models.detector import build_model as jax_build_model
from balancedgroupsoftmax_tpu.parallel.optim import make_optimizer as jax_make_optimizer
from balancedgroupsoftmax_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import FasterRCNN, build_model
from balancedgroupsoftmax_torch.models.mask_head import FCNMaskHead
from balancedgroupsoftmax_torch.ops.mask import mask_targets
from balancedgroupsoftmax_torch.parallel.optim import trainable_mask
from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
from balancedgroupsoftmax_torch.tools import test_lvis, train
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture
from tests.test_detector import make_batch, tiny_config, tiny_partition
from test_torch_cascade_train import total_loss
from test_torch_detector import COUNTS, to_port
from test_torch_htc_train import mask_inputs
from test_torch_train_step import NUM_ANCHORS

TCFG = TrainConfig(lr=0.02, warmup_iters=2, grad_clip_norm=2.0)


def mask_config(use_gs):
    return dataclasses.replace(
        tiny_config(use_gs=use_gs), mask_head=MaskHeadConfig(num_classes=9, conv_out_channels=32, num_convs=2)
    )


def deterministic_mask_config(use_gs):
    """Every anchor and RoI candidate sampled, positives up to all of them,
    and the GS others' budget covering them: the mask branch takes every
    one of the 64 proposals and 8 gt slots."""
    cfg = mask_config(use_gs)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    return dataclasses.replace(
        cfg,
        rpn_train=take_all(cfg.rpn_train, NUM_ANCHORS),
        rcnn_train=take_all(cfg.rcnn_train, cfg.rpn_proposal_train.max_num + cfg.max_gt_boxes),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )


def to_torch_tree(variables):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


def port_model(jcfg, variables, use_gs):
    m = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    m.load_state_dict(to_torch_tree(variables))
    return m


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[True, False], ids=["gs", "softmax"])
def served(request):
    """JAX `predict_with_masks` with and without rescale, and the port's
    model on the same weights."""
    use_gs = request.param
    jcfg = mask_config(use_gs)
    jmodel = jax_build_model(jcfg, partition=tiny_partition() if use_gs else None)
    images, _, _, _, img_shapes = make_batch()
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), images[:1]))
    sf = jnp.asarray([1.0, 0.5], jnp.float32)
    predict = jax.jit(
        lambda v, im, sh, s, r: jmodel.apply(v, im, sh, s, r, method="predict_with_masks"), static_argnums=4
    )
    want = {rescale: predict(variables, images, img_shapes, sf, rescale) for rescale in (True, False)}
    tmodel = port_model(jcfg, variables, use_gs).eval()
    inputs = tuple(torch.from_numpy(np.array(x)) for x in (images, img_shapes, sf))
    return dict(want=want, model=tmodel, inputs=inputs, variables=variables)


def test_build_model_builds_the_mask_head_and_takes_every_converted_tensor(served):
    model = served["model"]
    assert type(model) is FasterRCNN and isinstance(model.mask_head, FCNMaskHead)
    assert model.mask_head.conv_logits.weight.shape == (8, 32, 1, 1)
    converted = to_torch_tree(served["variables"])
    assert {k for k in converted if k.startswith("mask_head.")} == {
        "mask_head.convs.0.weight", "mask_head.convs.0.bias", "mask_head.convs.1.weight", "mask_head.convs.1.bias",
        "mask_head.upsample.weight", "mask_head.upsample.bias", "mask_head.conv_logits.weight",
        "mask_head.conv_logits.bias",
    }
    assert set(model.state_dict()) == set(converted)
    # the upsampling kernel arrives flipped, as HTC's
    np.testing.assert_array_equal(
        converted["mask_head.upsample.weight"].numpy(),
        np.transpose(served["variables"]["params"]["mask_head"]["upsample"]["kernel"][::-1, ::-1], (2, 3, 0, 1)),
    )


def test_params_from_flax_refuses_a_node_it_cannot_map(served):
    variables = served["variables"]
    for extra in ({"params": {**variables["params"], "bfp": {"refine": {"kernel": np.zeros((1, 1, 2, 2))}}}},
                  {"batch_stats": {**variables["batch_stats"], "neck": {}}}):
        with pytest.raises(ValueError, match="no mapping"):
            params_from_flax({**variables, **extra})


@pytest.mark.parametrize("rescale", [True, False])
def test_predict_with_masks_matches_jax(served, rescale):
    jdets, jmasks = served["want"][rescale]
    dets, masks = served["model"].predict_with_masks(*served["inputs"], rescale=rescale)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    np.testing.assert_array_equal(dets.labels.numpy(), np.asarray(jdets.labels))
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(jdets.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jdets.boxes), rtol=0, atol=1e-4)
    assert dets.valid.all() and masks.shape == jmasks.shape == (2, 10, 28, 28) and masks.dtype == torch.float32
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), rtol=0, atol=1e-5)
    # the masks are probabilities with spread, not a constant
    assert 0 < masks.min() and masks.max() < 1 and masks.std() > 1e-4


def test_predict_masks_equals_predict_with_masks(served):
    model = served["model"]
    images, shapes, sf = served["inputs"]
    dets, masks = model.predict_with_masks(images, shapes, sf)
    np.testing.assert_array_equal(model.predict_masks(images, dets.boxes, dets.labels, sf).numpy(), masks.numpy())
    for got, want in zip(model.predict(images, shapes, sf), dets):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("use_gs", [False, True])
def test_zoo_mask_rcnn_matches_jax_zoo(use_gs):
    jdet, jtrain = jzoo.mask_rcnn_r50_fpn_lvis(use_gs=use_gs)
    assert tzoo.mask_rcnn_r50_fpn_lvis(use_gs=use_gs) == to_port(tconfig.DetectorConfig, jdet)
    key = ("gs_" if use_gs else "") + "mask_rcnn_r50_fpn_lvis"
    assert tzoo.TRAIN_CONFIGS[key] == to_port(tconfig.TrainConfig, jtrain)


@pytest.fixture(scope="module", params=[True, False], ids=["gs", "softmax"])
def trained(request):
    """JAX's loss dict and gradient with the gt crops (one jit), the
    variables and the batch as tensors."""
    use_gs = request.param
    jcfg = deterministic_mask_config(use_gs)
    jmodel = jax_build_model(jcfg, partition=tiny_partition() if use_gs else None)
    batch = make_batch()
    crops, _ = mask_inputs(np.asarray(batch[3]))
    inputs = (*batch, jnp.asarray(crops))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch[0][:1]))

    def loss_fn(params):
        losses = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *inputs,
            method="loss", rngs={"sampling": jax.random.PRNGKey(0)},
        )
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    # the mask branch alone, on the FPN features and RoI targets of JAX's loss
    _, feats, targets = jax.jit(lambda v: jmodel.apply(
        v, *batch, method=lambda m, *a: m._loss_core(*a), rngs={"sampling": jax.random.PRNGKey(0)}))(variables)

    # against crops of seeded values in [0, 1], which no target meets at 0.5
    soft_crops = np.random.RandomState(5).rand(*crops.shape).astype(np.float32)

    def branch(m, f, t, gb, c):
        out = {}
        m_targets = m._mask_branch(f, t, gb, c, out)["m_targets"]
        return out["loss_mask"], m_targets

    branch_fn = jax.jit(jax.value_and_grad(lambda p, c: jmodel.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, feats, targets, batch[1], c, method=branch),
        has_aux=True))
    (branch_loss, branch_targets), branch_grads = branch_fn(variables["params"], jnp.asarray(soft_crops))
    # and against the 0/1 crops (the same compile)
    (_, binary_targets), _ = branch_fn(variables["params"], jnp.asarray(crops))
    return dict(jcfg=jcfg, use_gs=use_gs, variables=variables, losses=losses, grads=grads,
                inputs=[torch.from_numpy(np.array(x)) for x in inputs],
                branch=dict(feats=feats, targets=targets, crops=torch.from_numpy(soft_crops), loss=branch_loss,
                            m_targets=np.asarray(branch_targets), grads=branch_grads,
                            binary_targets=np.asarray(binary_targets)))


def grads_as_port(setup, params):
    return to_torch_tree({"params": params, "batch_stats": setup["variables"]["batch_stats"]})


def test_loss_with_masks_and_every_gradient_match_jax(trained):
    model = port_model(trained["jcfg"], trained["variables"], trained["use_gs"])
    losses = model.loss(*trained["inputs"], generator=torch.Generator().manual_seed(0))
    want = trained["losses"]
    assert "loss_mask" in want and sorted(losses) == sorted(want)
    for k, v in want.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    total_loss(losses).backward()
    jgrads = grads_as_port(trained, trained["grads"])
    named = dict(model.named_parameters())
    assert set(named) <= set(jgrads)
    for name, p in named.items():
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)
    assert all(named[f"mask_head.{n}.weight"].grad.abs().max() > 0 for n in ("convs.0", "upsample", "conv_logits"))


def test_mask_branch_on_jax_features_matches_jax(trained):
    """`_mask_loss` on JAX's FPN levels (as channels-last NCHW), RoI
    targets and soft crops: the resampled targets bit for bit, "loss_mask"
    and every mask-head gradient to 1e-5."""
    model = port_model(trained["jcfg"], trained["variables"], trained["use_gs"])
    br = trained["branch"]
    feats = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in br["feats"]]
    t = br["targets"]
    t = types.SimpleNamespace(**{k: torch.from_numpy(np.array(getattr(t, k)))
                                 for k in ("rois", "labels", "roi_valid", "pos_gt_inds")})
    gt_boxes = trained["inputs"][1]
    pos = (t.labels > 0) & t.roi_valid
    assert t.rois.shape[1] == 72 and int(pos.sum()) > 8
    np.testing.assert_array_equal(mask_targets(t.rois, gt_boxes, t.pos_gt_inds, br["crops"], pos).numpy(),
                                  br["m_targets"])
    loss = model._mask_loss(feats, t, gt_boxes, br["crops"])
    np.testing.assert_allclose(loss.item(), float(br["loss"]), rtol=1e-5)
    loss.backward()
    jgrads = grads_as_port(trained, br["grads"])
    for name, p in model.mask_head.named_parameters():
        w = jgrads[f"mask_head.{name}"].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def sampled_crops(rois, gt_boxes, gt_inds, crops, size=28) -> np.ndarray:
    """The bilinear samples of the gt crops that `ops/mask.py mask_targets`
    thresholds at 0.5, in f64."""
    rois, gt_boxes, crops = (np.asarray(a, np.float64) for a in (rois, gt_boxes, crops))
    b, s = rois.shape[:2]
    g = np.clip(np.asarray(gt_inds).astype(int), 0, gt_boxes.shape[1] - 1)
    gb = np.take_along_axis(gt_boxes, g[..., None], 1)
    cr = crops[np.arange(b)[:, None], g]
    n = cr.shape[-1]
    u = (np.arange(size) + 0.5) / size
    grid = lambda lo, hi, glo, ghi: ((u * np.maximum(hi - lo + 1, 1)[..., None] + lo[..., None] - glo[..., None])
                                     / np.maximum(ghi - glo + 1, 1)[..., None] * n - 0.5)
    cx = grid(rois[..., 0], rois[..., 2], gb[..., 0], gb[..., 2])
    cy = grid(rois[..., 1], rois[..., 3], gb[..., 1], gb[..., 3])
    x0, y0 = np.clip(np.floor(cx), 0, n - 1).astype(int), np.clip(np.floor(cy), 0, n - 1).astype(int)
    x1, y1 = np.minimum(x0 + 1, n - 1), np.minimum(y0 + 1, n - 1)
    wx, wy = np.clip(cx - x0, 0, 1)[..., None, :], np.clip(cy - y0, 0, 1)[..., :, None]
    bi, si = np.arange(b)[:, None, None, None], np.arange(s)[None, :, None, None]
    at = lambda yy, xx: cr[bi, si, yy[..., :, None], xx[..., None, :]]
    vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx + at(y1, x0) * wy * (1 - wx)
            + at(y1, x1) * wy * wx)
    inside = (cx[..., None, :] >= -1) & (cx[..., None, :] <= n) & (cy[..., :, None] >= -1) & (cy[..., :, None] <= n)
    return np.where(inside, vals, 0.0)


def test_mask_targets_on_binary_crops_part_from_jax_only_on_the_threshold(trained):
    """Against the 0/1 crops the card trains on, many bilinear samples are
    exactly 0.5 in exact arithmetic, and f32 rounding decides their side:
    on JAX's own rois the port's targets equal JAX's branch compile's at
    every pixel whose sample lies off 0.5. (Two JAX compiles of the same
    loss part at such pixels too: `python tests/f64_witness.py mask`.)"""
    br = trained["branch"]
    t = br["targets"]
    rois, gt_inds, labels, valid = (np.array(getattr(t, k)) for k in ("rois", "pos_gt_inds", "labels", "roi_valid"))
    crops = trained["inputs"][5]
    pos = torch.from_numpy((labels > 0) & valid)
    got = mask_targets(torch.from_numpy(rois), trained["inputs"][1], torch.from_numpy(gt_inds), crops, pos).numpy()
    want = br["binary_targets"]
    assert want.any() and (want == 1).sum() < want.size
    samples = sampled_crops(rois, trained["inputs"][1].numpy(), gt_inds, crops.numpy())
    on_threshold = (np.abs(samples - 0.5) < 1e-6) & pos.numpy()[..., None, None]
    differ = got != want
    print(f"{int(on_threshold.sum())} samples on 0.5; {int(differ.sum())} target pixels differ from JAX's")
    assert not (differ & ~on_threshold).any()


def test_in_f64_the_loss_and_every_gradient_match_jax_to_1e_5():
    """The whole GS model in f64, the port against JAX (`jax.enable_x64`),
    with the crops of seeded values in [0, 1] (so that no sample lies on the
    0.5 threshold): the loss dict to 1e-6 relative and every gradient, the
    mask head's included, within 1e-5 of its tensor's largest value (the
    f32 check above is at 1e-3: see the module's docstring)."""
    jcfg = deterministic_mask_config(True)
    batch = make_batch()
    crops, _ = mask_inputs(np.asarray(batch[3]))
    soft_crops = np.random.RandomState(5).rand(*crops.shape).astype(np.float32)
    inputs = [np.asarray(x) for x in (*batch, soft_crops)]
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_build_model(jcfg, partition=tiny_partition()).init)(
        jax.random.PRNGKey(0), batch[0][:1]))
    with jax.enable_x64(True):
        jmodel = jax_build_model(jcfg, partition=tiny_partition(), dtype=jnp.float64)
        cast = lambda a: jnp.asarray(a, jnp.float64 if np.issubdtype(np.asarray(a).dtype, np.floating) else None)
        v = jax.tree_util.tree_map(cast, variables)
        ins = [cast(x) for x in inputs]

        def loss_fn(params):
            losses = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins, method="loss",
                                  rngs={"sampling": jax.random.PRNGKey(0)})
            return total_loss(losses), losses

        (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        want = {k: float(x) for k, x in want.items()}
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    model = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS), dtype=torch.float64)
    model.load_state_dict(to_torch_tree(variables))
    model.to(torch.float64)
    tin = [torch.from_numpy(np.array(x)) for x in inputs]
    losses = model.loss(*[x.double() if x.is_floating_point() else x for x in tin],
                        generator=torch.Generator().manual_seed(0))
    assert "loss_mask" in want and sorted(losses) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(losses[k].item(), w, rtol=1e-6, err_msg=k)
    total_loss(losses).backward()
    jgrads = grads_as_port(dict(variables=variables), jgrads)
    for name, p in model.named_parameters():
        w = jgrads[name].double().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-30, err_msg=name)


def test_loss_without_crops_has_no_mask_loss(trained):
    model = port_model(trained["jcfg"], trained["variables"], trained["use_gs"])
    with torch.no_grad():
        losses = model.loss(*trained["inputs"][:5], generator=torch.Generator().manual_seed(0))
    assert "loss_mask" not in losses and sorted(losses) == sorted(k for k in trained["losses"] if k != "loss_mask")


@pytest.mark.parametrize("selectp", [0, 1, 4])
def test_trainable_mask_selects_the_jax_tensors(trained, selectp):
    params = trained["variables"]["params"]
    jmask = jax_trainable_mask(params, selectp)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in grads_as_port(trained, as_arrays).items()}
    got = trainable_mask(port_model(trained["jcfg"], trained["variables"], trained["use_gs"]), selectp)
    assert got == {k: want[k] for k in got}
    heads = {k.split(".")[0] for k, v in got.items() if v}
    assert heads == {0: {"backbone", "neck", "rpn_head", "bbox_head", "mask_head"}, 1: {"bbox_head"},
                     4: {"bbox_head", "mask_head"}}[selectp]


def test_selectp4_step_moves_the_bbox_and_mask_heads_as_optax(trained):
    cfg = dataclasses.replace(TCFG, selectp=4)
    params = trained["variables"]["params"]
    tx = jax_make_optimizer(cfg, params)
    sgd = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want = grads_as_port(trained, sgd(trained["grads"], params))

    model = port_model(trained["jcfg"], trained["variables"], trained["use_gs"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    images, gt_boxes, gt_labels, gt_mask, img_shapes, crops = trained["inputs"]
    batch = dict(images=images, gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask, img_shapes=img_shapes,
                 gt_mask_crops=crops)
    metrics = make_train_step(create_train_state(model, to_port(tconfig.TrainConfig, cfg)))(
        batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), float(total_loss(trained["losses"])), rtol=1e-4)
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])}
    assert moved == {n for n in before if n.startswith(("bbox_head.", "mask_head."))}
    for name in moved:
        np.testing.assert_allclose(model.get_parameter(name).detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.slow
def test_train_and_test_cli_on_mask_rcnn(tmp_path):
    """One `mask_rcnn_r50` step through the train CLI (the full-width R50,
    the mini fixture's 9 classes, 128 x 96) with the gt crops in its batch,
    then the test CLI on its checkpoint: segm records and both tables."""
    ann, imgs = write_lvis_fixture(str(tmp_path / "lvis"), image_sizes=((120, 160),) * 2 + ((160, 120),) * 2)
    common = ["--ann", ann, "--img-prefix", imgs, "--device", "cpu", "--scale", "128", "96", "--batch-size", "2"]
    out = train.main(["--model", "mask_rcnn_r50", *common, "--work-dir", str(tmp_path / "w"), "--selectp", "0",
                      "--max-steps", "1", "--log-interval", "1"])
    assert len(out["log"]) == 1 and np.isfinite(out["log"][0]["loss_mask"]) and out["log"][0]["loss_mask"] > 0
    res = test_lvis.main(["--model", "mask_rcnn_r50", *common, "--checkpoint", out["checkpoint"],
                          "--out", str(tmp_path / "res.json")])
    records = json.loads((tmp_path / "res.json").read_text())
    assert records == json.loads(json.dumps(res["records"]))
    sizes = {i["id"]: (i["height"], i["width"]) for i in json.loads(open(ann).read())["images"]}
    assert {r["image_id"] for r in records} == set(sizes)
    assert all(r["segmentation"]["size"] == list(sizes[r["image_id"]]) for r in records)
    assert set(res["times"]) == {"preprocess", "predict", "records", "masks", "evaluate"}
    assert res["segm_evaluator"] is not None and res["segm_evaluator"].iou_type == "segm"
    assert all(np.isfinite(v) for v in res["segm_evaluator"].results.values())
