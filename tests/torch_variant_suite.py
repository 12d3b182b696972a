"""The parity tests that every detector variant of the port passes against
the JAX package, shared by tests/test_torch_variants.py (Fast and
Double-Head R-CNN), tests/test_torch_grid_rcnn.py and
tests/test_torch_mask_scoring.py, which import them and give them their
`variant` fixture (`variant_fixture`), one JAX build a variant and process.

The configuration is JAX's tiny variant one (tests/test_detector_variants.py
`tiny_cfg`, `make_batch`, `synth_proposals`: 9 classes, 128 x 128, the
full-width ResNet-50, f32; the grid at heatmap 28, pooled at 7), with its
sampling made deterministic by the configuration (ROADMAP caveat iv): every
anchor and RoI candidate sampled, positives up to all of them, and no grid
jitter (`grid_jitter=0.0`). Weights come from flax `init`, converted by
`convert.params_from_flax`. The tests:

- `build_model` builds the variant and takes every converted tensor with
  `load_state_dict(strict=True)` (Fast R-CNN's tree has no `rpn_head`);
- serving (`predict`, Mask-Scoring's `predict_with_masks`) equals JAX's,
  with and without rescale: boxes within 1e-4 px, scores, mask
  probabilities and mask scores within 1e-5;
- the loss dict equals JAX's within 1e-4 relative, "loss_grid" and
  "loss_mask_iou" included, and every gradient is within 1e-3 of its
  tensor's largest value (the tolerance of tests/test_torch_train_step.py),
  but those of `F64_HELD`: there ReLU inputs within f32 rounding of 0 take
  the other side in the port's f32 than in its f64 and JAX's f32, and the
  port's f32 gradient parts from its own f64 one as far as from JAX's (up to
  2.1e-3 on the grid head's point 7, 1.3e-3 on Mask-Scoring's mask head;
  `python tests/f64_witness.py variants` prints the readings), so the
  variant's own file holds them in f64 to 1e-5, on JAX's features and
  targets (`branch_in_f64`);
- `trainable_mask` at selectp 0, 1, 2 and 4 picks JAX's tensors;
- one training step (`make_train_step`; Fast R-CNN's through `model.loss`
  with its proposals, as in JAX, whose train step passes none) gives finite
  losses and moves what selectp 0 trains, each head of the variant among it.

PyTorch runs on one CPU thread in these files (ROADMAP caveat v).
"""

import dataclasses
import types
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.kernels import batched_multilevel_roi_align as jax_roi_align
from balancedgroupsoftmax_tpu.models.detector import build_model as jax_build_model
from balancedgroupsoftmax_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.config import TrainConfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.models.variants import VARIANTS
from balancedgroupsoftmax_torch.parallel.optim import trainable_mask
from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
from test_detector_variants import make_batch, synth_proposals, tiny_cfg
from test_torch_cascade_train import total_loss
from test_torch_detector import to_port
from test_torch_train_step import NUM_ANCHORS

PROPOSALS = 24  # synth_proposals' boxes an image (Fast R-CNN)
GT_SLOTS = 8
# the heads whose gradients the f32 check leaves to `branch_in_f64`
F64_HELD = {"grid": ("grid_head.",), "mask_scoring": ("mask_head.", "mask_iou_head.")}


def variant_config(kind: str):
    """`tiny_cfg(kind)` with every candidate sampled and no grid jitter."""
    extra = dict(grid_heatmap_size=28, grid_jitter=0.0) if kind == "grid" else {}
    cfg = tiny_cfg(kind, mask=kind == "mask_scoring", **extra)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    candidates = (PROPOSALS if kind == "fast" else cfg.rpn_proposal_train.max_num) + GT_SLOTS
    return dataclasses.replace(cfg, rpn_train=take_all(cfg.rpn_train, NUM_ANCHORS),
                               rcnn_train=take_all(cfg.rcnn_train, candidates))


def to_torch_tree(variables):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


def port_model(setup):
    model = build_model(to_port(tconfig.DetectorConfig, setup["jcfg"]))
    model.load_state_dict(to_torch_tree(setup["variables"]))
    return model


def as_tensors(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def build_setup(kind: str) -> dict:
    """JAX's model of `kind` on the tiny batch: its variables, its serving
    outputs with and without rescale, its loss dict and gradient (one jit
    each)."""
    jcfg = variant_config(kind)
    jmodel = jax_build_model(jcfg)
    batch = list(make_batch(mask=kind == "mask_scoring"))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    images, img_shapes = batch[0], batch[4]
    sf = jnp.asarray([1.0, 0.5], jnp.float32)
    extra = dict(proposals=synth_proposals(p=PROPOSALS)) if kind == "fast" else {}
    method = "predict_with_masks" if kind == "mask_scoring" else "predict"
    predict = jax.jit(lambda v, r: jmodel.apply(v, images, img_shapes, sf, rescale=r, method=method, **extra),
                      static_argnums=1)
    served = {r: jax.tree_util.tree_map(np.asarray, predict(variables, r)) for r in (True, False)}

    def loss_fn(params):
        losses = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, *batch, **extra,
                              method="loss", rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return dict(kind=kind, jcfg=jcfg, variables=variables, served=served, losses=jax.device_get(losses),
                grads=jax.tree_util.tree_map(np.asarray, grads), batch=as_tensors(batch),
                serve_inputs=as_tensors((images, img_shapes, sf)),
                extra={k: torch.from_numpy(np.array(v)) for k, v in extra.items()})


_SETUPS: dict = {}


def setup_of(kind: str) -> dict:
    """`build_setup(kind)`, built once a process."""
    if kind not in _SETUPS:
        _SETUPS[kind] = build_setup(kind)
    return _SETUPS[kind]


def variant_fixture(kinds):
    @pytest.fixture(scope="module", params=kinds)
    def variant(request):
        return setup_of(request.param)

    return variant


def branch_in_f64(setup: dict, crops=None, slots=None, pooled_from_jax=False):
    """The variant's own loss branch (what its `loss` adds after
    `_loss_core`) in f64, JAX's and the port's, on JAX's f32 FPN levels and
    RoI targets of the setup's batch cast to f64, with `crops` as the gt
    masks: (JAX's loss dict, JAX's gradient as the port's tensors, the port's
    loss dict, the port's model after its backward). Only the branch's heads
    get a gradient: the features are constants. `slots` sets the sampler's
    slots an image (all positive where they can be), so that fewer RoIs
    take XLA's f64 convolutions on the CPU (naive loops: 170 s at 144 mask
    RoIs). With `pooled_from_jax`, the port's branch is handed JAX's f64
    pooling of its RoIs (K2's plain version samples and sums in f32; in the
    f64 MaskIoU head a ReLU input within that rounding of 0 then takes the
    other side), after its own pooling of them is checked against it."""
    jcfg, variables = setup["jcfg"], setup["variables"]
    if slots is not None:
        jcfg = dataclasses.replace(jcfg, rcnn_train=dataclasses.replace(
            jcfg.rcnn_train, sampler=dataclasses.replace(jcfg.rcnn_train.sampler, num=slots)))
    jmodel = jax_build_model(jcfg)
    batch = [x.numpy() for x in setup["batch"][:5]] + ([] if crops is None else [np.asarray(crops, np.float32)])
    key = jax.random.PRNGKey(0)
    _, feats, targets = jax.jit(lambda v: jmodel.apply(
        v, *batch[:5], method=lambda m, *a: m._loss_core(*a), rngs={"sampling": key}))(variables)
    with jax.enable_x64(True):
        cast = lambda a: jnp.asarray(a, jnp.float64 if np.issubdtype(np.asarray(a).dtype, np.floating) else None)
        feats64, targets64 = jax.tree_util.tree_map(cast, (feats, targets))

        class Given(type(jmodel)):
            given: Any = None  # (feats, targets)

            def _loss_core(self, *args, **kwargs):
                return {}, *self.given

        v64 = jax.tree_util.tree_map(cast, variables)

        def loss_fn(params, given):
            losses = Given(cfg=jcfg, dtype=jnp.float64, given=given).apply(
                {"params": params, "batch_stats": v64["batch_stats"]}, *map(cast, batch), method="loss",
                rngs={"sampling": key})
            return sum(v for k, v in losses.items() if k.startswith("loss")), losses

        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v64["params"], (feats64, targets64))
        want = {k: float(v) for k, v in want.items()}
        grads = jax.tree_util.tree_map(np.asarray, grads)
        if pooled_from_jax:
            r, cap = jcfg.roi_extractor, jcfg.rcnn_train.sampler.num
            jpooled = np.array(jax.jit(lambda f, rois: jax_roi_align(
                f[: len(r.featmap_strides)], rois, r.featmap_strides, jcfg.mask_head.mask_size // 2, r.sample_num,
                r.finest_scale))(feats64, targets64.rois[:, :cap]))
    model = build_model(to_port(tconfig.DetectorConfig, jcfg), dtype=torch.float64)
    model.load_state_dict(to_torch_tree(variables))
    model.to(torch.float64)
    t = types.SimpleNamespace(**{k: torch.from_numpy(np.array(getattr(targets64, k)))
                                 for k in ("rois", "labels", "roi_valid", "pos_gt_inds")})
    tfeats = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats64]
    model._loss_core = lambda *args, **kwargs: ({}, tfeats, t)
    if pooled_from_jax:
        own = model._pool(tfeats, t.rois[:, :cap].contiguous(), jcfg.mask_head.mask_size // 2)
        np.testing.assert_allclose(own.numpy(), jpooled, rtol=0, atol=1e-6 * np.abs(jpooled).max())
        model._pool = lambda *args, **kwargs: torch.from_numpy(jpooled)
    tin = [torch.from_numpy(np.array(x)) for x in batch]
    losses = model.loss(*[x.double() if x.is_floating_point() else x for x in tin],
                        generator=torch.Generator().manual_seed(0))
    total_loss(losses).backward()
    jgrads = to_torch_tree({"params": grads, "batch_stats": variables["batch_stats"]})
    return want, jgrads, losses, model


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_build_model_builds_the_variant_and_takes_every_converted_tensor(variant):
    model = port_model(variant)
    assert type(model) is VARIANTS[variant["kind"]]
    converted = to_torch_tree(variant["variables"])
    assert set(model.state_dict()) == set(converted)
    model.load_state_dict(converted, strict=True)
    heads = {k.split(".")[0] for k in converted}
    want = {"backbone", "neck", "rpn_head", "bbox_head"}
    want = {"fast": want - {"rpn_head"}, "grid": want | {"grid_head"}, "double_head": want,
            "mask_scoring": want | {"mask_head", "mask_iou_head"}}[variant["kind"]]
    assert heads == want and (model.rpn_head is None) == (variant["kind"] == "fast")


@pytest.mark.parametrize("rescale", [True, False])
def test_serving_matches_jax(variant, rescale):
    model = port_model(variant).eval()
    want = variant["served"][rescale]
    if variant["kind"] == "mask_scoring":
        dets, masks, mask_scores = model.predict_with_masks(*variant["serve_inputs"], rescale=rescale)
        jdets, jmasks, jscores = want
        assert masks.shape == (2, 10, 28, 28) and mask_scores.shape == (2, 10) and mask_scores.dtype == torch.float32
        np.testing.assert_allclose(masks.numpy(), jmasks, rtol=0, atol=1e-5)
        np.testing.assert_allclose(mask_scores.numpy(), jscores, rtol=0, atol=1e-5)
        # the predicted IoUs rescore the detections: the mask scores are not the scores
        assert not np.allclose(mask_scores.numpy(), dets.scores.numpy(), atol=1e-4)
    else:
        dets, jdets = model.predict(*variant["serve_inputs"], rescale=rescale, **variant["extra"]), want
    np.testing.assert_array_equal(dets.valid.numpy(), jdets.valid)
    np.testing.assert_array_equal(dets.labels.numpy(), jdets.labels)
    np.testing.assert_allclose(dets.scores.numpy(), jdets.scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), jdets.boxes, rtol=0, atol=1e-4)
    assert dets.valid.all()


def test_loss_and_every_gradient_match_jax(variant):
    model = port_model(variant)
    losses = model.loss(*variant["batch"], **variant["extra"], generator=torch.Generator().manual_seed(0))
    want = variant["losses"]
    extra = {"grid": "loss_grid", "mask_scoring": "loss_mask_iou"}.get(variant["kind"])
    assert sorted(losses) == sorted(want) and (extra is None or extra in want)
    assert ("loss_rpn_cls" in want) == (variant["kind"] != "fast")
    for k, v in want.items():
        assert float(v) > 0 or k == "acc", k
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    total_loss(losses).backward()
    jgrads = to_torch_tree({"params": variant["grads"], "batch_stats": variant["variables"]["batch_stats"]})
    named = dict(model.named_parameters())
    assert set(named) <= set(jgrads)
    for name, p in named.items():
        if name.startswith(F64_HELD.get(variant["kind"], ())):
            continue
        w = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)
    head = {"grid": "grid_head.", "mask_scoring": "mask_iou_head.", "double_head": "bbox_head.res"}.get(
        variant["kind"], "bbox_head.")
    assert any(p.grad.abs().max() > 0 for n, p in named.items() if n.startswith(head))


@pytest.mark.parametrize("selectp", [0, 1, 2, 4])
def test_trainable_mask_selects_the_jax_tensors(variant, selectp):
    params = variant["variables"]["params"]
    jmask = jax_trainable_mask(params, selectp)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    want = {k: bool(v.all()) for k, v in to_torch_tree({"params": as_arrays,
                                                        "batch_stats": variant["variables"]["batch_stats"]}).items()}
    got = trainable_mask(port_model(variant), selectp)
    assert got == {k: want[k] for k in got}
    if selectp == 4:  # the MaskIoU head is not a mask head: it stays frozen, as in JAX
        assert not any(v for k, v in got.items() if k.startswith("mask_iou_head."))


def test_one_train_step_moves_what_selectp_0_trains(variant):
    model = port_model(variant)
    state = create_train_state(model, TrainConfig(selectp=0))
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    keys = ("images", "gt_boxes", "gt_labels", "gt_mask", "img_shapes", "gt_mask_crops")
    batch = dict(zip(keys, variant["batch"]))
    gen = torch.Generator().manual_seed(0)
    if variant["kind"] == "fast":
        # Fast R-CNN trains through `loss` with its proposals
        state.optimizer.zero_grad()
        metrics = model.loss(*variant["batch"], **variant["extra"], generator=gen)
        total_loss(metrics).backward()
        state.optimizer.step()
    else:
        metrics = make_train_step(state)(batch, gen)
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = {n for n, p in named.items() if not torch.equal(p.detach(), before[n])}
    trainable = {n for n, p in named.items() if p.requires_grad}
    assert moved <= trainable
    heads = {n.split(".")[0] for n in trainable}
    assert heads == {n.split(".")[0] for n in moved}
    assert {"grid": "grid_head", "mask_scoring": "mask_iou_head"}.get(variant["kind"], "bbox_head") in heads
