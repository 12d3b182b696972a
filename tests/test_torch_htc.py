"""HTC-DCN inference of the PyTorch port against the JAX package, at the tiny
HTC of tests/test_htc.py (128 x 128 input, 9 classes, f32, three
class-agnostic stages, two-conv mask heads) on a ResNeXt-50 backbone
(groups 8, base width 4) with deformable conv v1 in c3-c5 at D = 4, with the
GS heads and with softmax heads, on weights converted by
`convert.params_from_flax`. Every `conv_offset` gets seeded non-zero weights
before conversion, so both packages deform with the same offsets.

Compared: the backbone's four outputs and the semantic feature (within 1e-4
of their largest value: thirty-odd f32 convolutions, eight of them
deformable, sum in another order in XLA and PyTorch), each stage's refined
rois (from the JAX stage's input rois), the stage loop's last rois and
averaged scores, and the detections (boxes within 1e-3 px, scores within
1e-5, labels, validity and order equal, as tests/test_torch_cascade.py), and
the masks of `predict_with_masks` (probabilities within 1e-5).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.config import BackboneConfig as JBackboneConfig
from balancedgroupsoftmax_tpu.models.htc import build_htc as jax_build_htc
from balancedgroupsoftmax_tpu.models.resnet import ResNet as JaxResNet
from balancedgroupsoftmax_tpu.models.rpn import rpn_proposals_batched as jax_rpn_proposals
from balancedgroupsoftmax_tpu.ops.boxes import delta2bbox as jax_delta2bbox
from balancedgroupsoftmax_torch import apis
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.convert import conv_from_flax, conv_transpose_from_flax, params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models.detector import FasterRCNN, build_model
from balancedgroupsoftmax_torch.models.htc import HTC, build_htc
from balancedgroupsoftmax_torch.models.layers import Conv2d, ConvTranspose2d
from balancedgroupsoftmax_torch.models.rpn import rpn_proposals_batched
from balancedgroupsoftmax_torch.ops.deform_conv import DeformConv
from tests.test_detector import make_batch, tiny_partition
from tests.test_htc import htc_tiny
from test_torch_deform_conv import _np, _offset_params
from test_torch_detector import COUNTS, to_port

DCN_BACKBONE = JBackboneConfig(
    depth=50, groups=8, base_width=4, dcn_stages=(False, True, True, True), dcn_shift_window=4
)


def _jax_all(mdl, images, img_shapes, sf):
    """The JAX model's backbone outputs, semantic feature, proposals, each
    stage's refinement of the rois it is given, its stage loop, and
    `predict_with_masks`."""
    c = mdl.cfg
    backbone = mdl.backbone(images)
    feats = mdl.neck(backbone)
    _, sem = mdl.semantic_head(feats)
    props = jax_rpn_proposals(mdl.rpn_head(feats), mdl._anchors(images), img_shapes, c.rpn_proposal_test)
    rois = [props.boxes]
    for i in range(c.cascade.num_stages - 1):
        pooled = mdl._pool(feats, rois[-1]) + mdl._pool_semantic(sem, rois[-1], c.roi_extractor.out_size)
        _, deltas = mdl.bbox_heads[i](pooled)
        stds = c.cascade.stage_target_stds[i]
        rois.append(
            jax.vmap(
                lambda r, d, sh: jax_delta2bbox(r, d, c.bbox_head.target_means, stds, max_shape=(sh[0], sh[1]))
            )(rois[-1], deltas, img_shapes)
        )
    last_rois, scores, _ = mdl._run_stages(feats, sem, props.boxes, img_shapes)
    dets, masks = mdl.predict_with_masks(images, img_shapes, sf)
    return backbone, sem, props, rois, last_rois, scores, dets, masks


@pytest.fixture(scope="module", params=[True, False], ids=["gs", "softmax"])
def both(request):
    use_gs = request.param
    jcfg = dataclasses.replace(htc_tiny(use_gs=use_gs), backbone=DCN_BACKBONE)
    jmodel = jax_build_htc(jcfg, partition=tiny_partition() if use_gs else None)
    images, _, _, _, img_shapes = make_batch()
    variables = _np(jmodel.init(jax.random.PRNGKey(0), images[:1]))
    variables = _offset_params(np.random.RandomState(7), variables, 3.0)
    sf = jnp.asarray([1.0, 0.5], jnp.float32)
    jax_out = jax.jit(lambda v, im, sh, s: jmodel.apply(v, im, sh, s, method=_jax_all))(variables, images, img_shapes, sf)

    tmodel = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    tmodel.load_state_dict(params_from_flax(variables))
    tmodel.eval()
    inputs = tuple(torch.from_numpy(np.array(x)) for x in (images, img_shapes, sf))
    return jax_out, tmodel, inputs


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_build_model_makes_the_htc(both):
    _, tmodel, _ = both
    assert type(tmodel) is HTC and len(tmodel.bbox_heads) == 3 and len(tmodel.mask_heads) == 3
    dcn = [m for m in tmodel.backbone.modules() if isinstance(m, DeformConv)]
    assert len(dcn) == 4 + 6 + 3 and {m.groups for m in dcn} == {8} and {m.shift_window for m in dcn} == {4}
    sd = tmodel.state_dict()
    assert sd["backbone.layer2.0.conv2.weight"].shape == (64, 8, 3, 3)  # width 64 in 8 groups
    assert sd["backbone.layer2.0.conv2.conv_offset.weight"].shape == (18, 64, 3, 3)
    assert sd["mask_heads.0.conv_logits.weight"].shape == (8, 32, 1, 1)
    assert "mask_heads.0.conv_res.weight" not in sd and sd["mask_heads.2.conv_res.weight"].shape == (256, 32, 1, 1)
    assert sd["semantic_head.conv_logits.weight"].shape == (12, 256, 1, 1)


def test_offsets_are_spread_and_clamped(both):
    """The seeded offset convs give fractional offsets over a few cells, a
    few beyond +-4, in every deformable stage."""
    _, tmodel, (images, _, _) = both
    seen = {}
    hooks = [
        m.conv_offset.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(name, out.detach()))
        for name, m in tmodel.backbone.named_modules()
        if isinstance(m, DeformConv)
    ]
    try:
        with torch.no_grad():
            tmodel.extract_feats(images)
    finally:
        for h in hooks:
            h.remove()
    for stage in ("layer2", "layer3", "layer4"):
        d = torch.cat([v.flatten() for k, v in seen.items() if k.startswith(stage)]).abs()
        assert 0.5 < d.median().item() < 4, stage
        assert 0.005 < (d > 4).float().mean().item() < 0.3, stage


def test_backbone_and_semantic_feature_match(both):
    (jbackbone, jsem, *_), tmodel, (images, _, _) = both
    with torch.no_grad():
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        outs = tmodel.backbone(x)
        sem = tmodel._semantic(tmodel.neck(outs))
    for got, want in zip(outs, jbackbone):
        _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)
    _close(sem.permute(0, 2, 3, 1).numpy(), jsem, 1e-4)


def test_each_stage_refines_the_rois_as_jax(both):
    (_, _, jprops, jrois, *_), tmodel, (images, img_shapes, _) = both
    c = tmodel.cfg
    v = np.asarray(jprops.valid)
    with torch.no_grad():
        feats = tmodel.extract_feats(images)
        pool = tmodel._fused_pool(tmodel._semantic(feats), "bbox")
        props = rpn_proposals_batched(tmodel.rpn_head(feats), tmodel._anchors(images), img_shapes, c.rpn_proposal_test)
        np.testing.assert_array_equal(props.valid.numpy(), v)
        np.testing.assert_allclose(props.boxes.numpy()[v], np.asarray(jrois[0])[v], rtol=0, atol=1e-3)
        for i in range(c.cascade.num_stages - 1):
            rois = torch.from_numpy(np.array(jrois[i]))
            _, deltas = tmodel.bbox_heads[i](pool(feats, rois))
            got = tmodel._decode(rois, deltas, c.cascade.stage_target_stds[i], img_shapes)
            np.testing.assert_allclose(got.numpy()[v], np.asarray(jrois[i + 1])[v], rtol=0, atol=1e-3, err_msg=f"stage {i}")


def test_stage_loop_rois_and_averaged_scores_match(both):
    (_, _, jprops, _, jlast, jscores, *_), tmodel, (images, img_shapes, _) = both
    c = tmodel.cfg
    v = np.asarray(jprops.valid)
    with torch.no_grad():
        feats = tmodel.extract_feats(images)
        pool = tmodel._fused_pool(tmodel._semantic(feats), "bbox")
        props = rpn_proposals_batched(tmodel.rpn_head(feats), tmodel._anchors(images), img_shapes, c.rpn_proposal_test)
        rois, scores, _ = tmodel._run_stages(feats, props.boxes, img_shapes, pool)
    np.testing.assert_allclose(rois.numpy()[v], np.asarray(jlast)[v], rtol=0, atol=1e-3)
    assert scores.shape == jscores.shape == (2, v.shape[1], 9)
    np.testing.assert_allclose(scores.numpy()[v], np.asarray(jscores)[v], rtol=0, atol=1e-5)


def test_predict_with_masks_matches_jax(both):
    (*_, jdets, jmasks), tmodel, inputs = both
    dets, masks = tmodel.predict_with_masks(*inputs)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    np.testing.assert_array_equal(dets.labels.numpy(), np.asarray(jdets.labels))
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(jdets.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jdets.boxes), rtol=0, atol=1e-3)
    assert dets.valid.all() and masks.shape == jmasks.shape == (2, 10, 28, 28)
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), rtol=0, atol=1e-5)
    # predict gives the same detections as predict_with_masks
    for got, want in zip(tmodel.predict(*inputs), dets):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_upsample_conversion_flips_the_kernel():
    """flax ConvTranspose and torch ConvTranspose2d read the kernel in
    opposite spatial orders: a single 1 through the 2 x 2 stride-2 flax layer
    with kernel [[1, 2], [3, 4]] gives [[4, 3], [2, 1]]."""
    layer = fnn.ConvTranspose(1, (2, 2), strides=(2, 2), use_bias=False)
    kernel = jnp.asarray([[1.0, 2.0], [3.0, 4.0]]).reshape(2, 2, 1, 1)
    one = jnp.ones((1, 1, 1, 1))
    np.testing.assert_array_equal(np.asarray(layer.apply({"params": {"kernel": kernel}}, one))[0, :, :, 0], [[4, 3], [2, 1]])

    rng = np.random.RandomState(0)
    layer = fnn.ConvTranspose(6, (2, 2), strides=(2, 2))
    params = {"kernel": rng.randn(2, 2, 5, 6).astype(np.float32), "bias": rng.randn(6).astype(np.float32)}
    x = rng.randn(2, 7, 9, 5).astype(np.float32)
    want = np.asarray(layer.apply({"params": params}, x))
    port = ConvTranspose2d(5, 6, 2, stride=2)
    port.load_state_dict(conv_transpose_from_flax(params))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("groups", [4, 8])
def test_grouped_conv_conversion(groups):
    rng = np.random.RandomState(groups)
    layer = fnn.Conv(16, (3, 3), padding=[(1, 1), (1, 1)], feature_group_count=groups, use_bias=False)
    params = {"kernel": rng.randn(3, 3, 32 // groups, 16).astype(np.float32)}
    x = rng.randn(2, 9, 11, 32).astype(np.float32)
    want = np.asarray(layer.apply({"params": params}, x))
    port = Conv2d(32, 16, 3, padding=1, groups=groups, bias=False)
    port.load_state_dict(conv_from_flax(params))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_gs", [True, False])
@pytest.mark.parametrize("dcn", [True, False])
def test_zoo_htc_and_x101_match_jax_zoo(use_gs, dcn):
    jcfg, _ = jzoo.htc_x101_64x4d_fpn_lvis(use_gs=use_gs, dcn=dcn)
    assert tzoo.htc_x101_64x4d_fpn_lvis(use_gs=use_gs, dcn=dcn) == to_port(tconfig.DetectorConfig, jcfg)
    jcfg, _ = jzoo.faster_rcnn_x101_64x4d_fpn_lvis()
    assert tzoo.faster_rcnn_x101_64x4d_fpn_lvis() == to_port(tconfig.DetectorConfig, jcfg)


def test_build_model_dispatches_htc_and_init_detector_builds_x101():
    cfg = tzoo.htc_x101_64x4d_fpn_lvis(num_classes=9)
    assert type(build_model(dataclasses.replace(cfg, backbone=tconfig.BackboneConfig()))) is HTC
    with pytest.raises(ValueError):  # GS heads need a partition
        build_model(tzoo.htc_x101_64x4d_fpn_lvis(num_classes=9, use_gs=True))
    with pytest.raises(ValueError):
        build_htc(dataclasses.replace(cfg, mask_head=None))
    detector = apis.init_detector("faster_rcnn_x101", device="cpu", seed=0)
    assert type(detector.model) is FasterRCNN
    sd = detector.model.state_dict()
    assert sd["backbone.layer3.22.conv2.weight"].shape == (1024, 16, 3, 3)  # c4: width 1024, 64 groups
    assert sd["backbone.layer4.0.conv1.weight"].shape == (2048, 1024, 1, 1)


@pytest.mark.slow  # about 70 s here: JAX traces and compiles 33 full-width blocks
def test_full_width_x101_dcn_backbone_matches_jax():
    """The zoo's X101-64x4d backbone with deformable c3-c5 (64 groups, D = 4)
    at full width on a 64 x 64 input, on converted weights with non-zero
    offsets. c2 and c3 agree within 1e-4 of their largest value. The 26
    deformable blocks of c4 and c5 amplify rounding: on these weights a
    1e-7 relative perturbation of the input moves the port's own c4 and c5 by
    2.2e-3 and 4.3e-3 of their largest value, and the port and JAX lie
    1.3e-3 / 9.0e-4 (c4) and 3.0e-3 / 2.1e-3 (c5) from a float64 run of the
    port, so c4 and c5 are held within 1e-2."""
    bb = jzoo.htc_x101_64x4d_fpn_lvis(dcn=True)[0].backbone
    kw = dict(depth=bb.depth, groups=bb.groups, base_width=bb.base_width, dcn_stages=bb.dcn_stages,
              dcn_shift_window=bb.dcn_shift_window)
    jmod = JaxResNet(**kw)
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    variables = _offset_params(np.random.RandomState(1), _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), x)), 3.0)
    want = jax.jit(jmod.apply)(variables, x)
    model = build_model(tzoo.htc_x101_64x4d_fpn_lvis(num_classes=9, dcn=True)).eval()
    sd = {k[len("backbone."):]: v for k, v in params_from_flax(_with_heads(variables)).items() if k.startswith("backbone.")}
    model.backbone.load_state_dict(sd)
    with torch.no_grad():
        outs = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for got, w, rel in zip(outs, want, (1e-4, 1e-4, 1e-2, 1e-2)):
        _close(got.permute(0, 2, 3, 1).numpy(), w, rel)


def _with_heads(backbone_variables):
    """A detector tree around bare backbone variables, as `params_from_flax` reads it."""
    return {
        "params": {"backbone": backbone_variables["params"], "neck": {}, "rpn_head": {}},
        "batch_stats": {"backbone": backbone_variables["batch_stats"]},
    }
