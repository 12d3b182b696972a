"""The port's deformable convolution (plain version of K7, `DeformConv`, the
DCN `Bottleneck`) against JAX `ops/deform_conv.py`, in f32 on the CPU.

JAX's `DeformConv` runs the XLA formulation off the TPU, so the port is held
to `deform_conv2d` (vmapped over a batch of 2): `_shift_window_cols` at
D = 4, `_bilinear_hw` at D = 0. The offsets are integer, fractional, beyond
+-D, and put samples in the (-1, 0) and (H - 1, H) border bands. The samples
are the same f32 operations in the same order on both sides; the grouped
contraction sums in another order, so outputs agree within 1e-5 of the
largest |output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models.resnet import Bottleneck as JaxBottleneck
from balancedgroupsoftmax_tpu.ops.deform_conv import DeformConv as JaxDeformConv
from balancedgroupsoftmax_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch.convert import bottleneck_from_flax, conv_from_flax
from balancedgroupsoftmax_torch.models.resnet import Bottleneck
from balancedgroupsoftmax_torch import zoo
from balancedgroupsoftmax_torch.models.resnet import ARCH_SETTINGS
from balancedgroupsoftmax_torch.ops.deform_conv import (
    SHARED_BYTES,
    SMS,
    DeformConv,
    deform_conv2d,
    deform_conv2d_reference,
    launch_plan,
    plan_shared_bytes,
)
from test_torch_cuda import DEFORM_CASES, DEFORM_HW, DEFORM_SHAPES, WINDOW_EDGE, deform_case

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("window", [4, 0])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("groups,c_in,c_out", [(1, 16, 16), (4, 32, 24), (8, 64, 64)])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_plain_version_matches_jax(window, stride, groups, c_in, c_out, modulated):
    x, offsets, weight, mask = deform_case(stride * 7 + groups, c_in, c_out, groups, stride, window, modulated)
    wj = jnp.transpose(weight, (2, 3, 1, 0))  # OIHW -> flax HWIO
    if modulated:
        want = jax.vmap(lambda xi, oi, mi: jax_deform_conv2d(xi, oi, wj, mi, stride, 1, groups, window))(x, offsets, mask)
    else:
        want = jax.vmap(lambda xi, oi: jax_deform_conv2d(xi, oi, wj, None, stride, 1, groups, window))(x, offsets)
    T = torch.from_numpy
    before = [k.launches for k in cuda.KERNELS]
    got = deform_conv2d(T(x), T(offsets), T(weight), T(mask) if modulated else None, stride, 1, groups, window)
    assert [k.launches for k in cuda.KERNELS] == before  # the plain version, on the CPU
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_offsets_cover_the_cases():
    """The shared inputs hold integer and fractional offsets, offsets beyond
    +-4, and samples in both border bands."""
    x, offsets, _, _ = deform_case(0, 16, 16, 1, 1, 4, False)
    d = offsets.reshape(-1)
    assert (d == np.round(d)).mean() > 0.1 and (d != np.round(d)).mean() > 0.5
    assert 0.01 < (np.abs(d) > 4).mean() < 0.3
    h = x.shape[1]
    ys = np.arange(offsets.shape[1])[:, None, None] - 1 + np.repeat(np.arange(3), 3)[None, None, :] + offsets[0, ..., 0::2]
    assert ((ys > -1) & (ys < 0)).any() and ((ys > h - 1) & (ys < h)).any()


def test_window_clamps_and_zero_window_does_not():
    x, offsets, weight, _ = deform_case(1, 16, 16, 4, 1, 4, False)
    T = torch.from_numpy
    # D = 0 on offsets clipped to +-4 samples where D = 4 does; the fractions
    # come from the absolute, not the relative, position, so only to rounding
    clamped = deform_conv2d_reference(T(x), T(np.clip(offsets, -4, 4)), T(weight), None, 1, 1, 4, 0)
    _close(deform_conv2d_reference(T(x), T(offsets), T(weight), None, 1, 1, 4, 4).numpy(), clamped.numpy())
    assert not np.allclose(deform_conv2d_reference(T(x), T(offsets), T(weight), None, 1, 1, 4, 0).numpy(), clamped.numpy())


def _offset_params(rng, variables, scale):
    """Seeded non-zero conv_offset kernel and bias, in place."""
    for node in _walk(variables["params"]):
        if "conv_offset" in node:
            k = node["conv_offset"]["kernel"]
            fan_in = k.shape[0] * k.shape[1] * k.shape[2]
            node["conv_offset"] = {
                "kernel": (rng.randn(*k.shape) * scale / np.sqrt(fan_in)).astype(np.float32),
                "bias": (rng.randn(*node["conv_offset"]["bias"].shape) * 0.5).astype(np.float32),
            }
    return variables


def _walk(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _walk(v)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree, is_leaf=lambda v: not isinstance(v, dict))


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("window", [4, 0])
def test_deform_conv_layer_matches_jax(modulated, window):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 10, 32).astype(np.float32)
    jmod = JaxDeformConv(48, stride=2, modulated=modulated, groups=8, shift_window=window)
    variables = _offset_params(rng, _np(jmod.init(jax.random.PRNGKey(0), x)), 3.0)
    want = jmod.apply(variables, x)
    layer = DeformConv(32, 48, stride=2, modulated=modulated, groups=8, shift_window=window)
    layer.load_state_dict(conv_from_flax(variables["params"]))
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    _close(got.permute(0, 2, 3, 1).detach().numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_bottleneck_matches_jax(stride):
    """A ResNeXt bottleneck (groups 8, base width 4) whose 3x3 is a DCN v1
    with D = 4, on converted weights with non-zero offsets."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 14, 12, 128).astype(np.float32)
    kw = dict(planes=64, stride=stride, groups=8, base_width=4, use_dcn=True, dcn_shift_window=4)
    jmod = JaxBottleneck(**kw)
    variables = _offset_params(rng, _np(jmod.init(jax.random.PRNGKey(1), x)), 3.0)
    want = jmod.apply(variables, x)
    block = Bottleneck(128, 64, stride, groups=8, base_width=4, use_dcn=True, dcn_shift_window=4)
    block.load_state_dict(bottleneck_from_flax(variables["params"], variables["batch_stats"]))
    assert block.conv2.weight.shape == (32, 4, 3, 3)  # width int(64 * 4 / 64) * 8, 8 groups
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    _close(got.permute(0, 2, 3, 1).detach().numpy(), want)


def htc_dcn_layers(batch=2, size=(800, 1344)):
    """(B, H, W, C, groups, stride, D) of the input of each deformable layer
    of gs HTC X101-64x4d DCN c3-c5 at `size`, from the zoo's config and the
    port's ResNet (stem: a 7x7 stride-2 conv and a stride-2 max pool; the
    stride on the first 3x3 of each stage after the first)."""
    cfg = zoo.htc_x101_64x4d_fpn_lvis(use_gs=True, dcn=True).backbone
    h, w = ((s + 2 * 3 - 7) // 2 + 1 for s in size)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    layers = []
    for stage, blocks in enumerate(ARCH_SETTINGS[cfg.depth]):
        width = int(64 * 2**stage * cfg.base_width / 64) * cfg.groups
        for blk in range(blocks):
            stride = (1 if stage == 0 else 2) if blk == 0 else 1
            if cfg.dcn_stages[stage]:
                layers.append((batch, h, w, width, cfg.dcn_groups or cfg.groups, stride, cfg.dcn_shift_window))
            h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
    return layers


def card_test_layers():
    """The same tuples, with C_out, for every K7 shape of tests/test_torch_cuda.py."""
    cases = [(2, *DEFORM_HW, c_in, g, s, d, c_out) for d, s, g, c_in, c_out, _ in DEFORM_CASES]
    cases += [(2, *hw, c_in, g, s, d, c_out) for d, s, g, c_in, c_out, hw in DEFORM_SHAPES + [WINDOW_EDGE]]
    return cases


def test_htc_dcn_layers_are_the_x101s():
    layers = htc_dcn_layers()
    assert len(layers) == 30
    assert layers[0] == (2, 200, 336, 512, 64, 2, 4)  # c3's first block: stride 2 on the 200 x 336 map
    assert layers[4] == (2, 100, 168, 1024, 64, 2, 4) and layers[5] == (2, 50, 84, 1024, 64, 1, 4)
    assert layers[-1] == (2, 25, 42, 2048, 64, 1, 4)


@pytest.mark.parametrize(
    "layer",
    [(*shape, shape[3]) for shape in htc_dcn_layers()] + card_test_layers(),
    ids=[f"htc{i}" for i in range(30)] + [f"card{i}" for i in range(len(card_test_layers()))],
)
def test_launch_plan_fits_and_fills_the_card(layer):
    """K7's bf16 launch plan at every HTC-DCN layer (800 x 1344, batch 2) and
    every card-test shape: whole groups in chunks of 16-byte pieces, shared
    memory within 227 KB (and what csrc/deform_conv.cu lays out), and a grid
    of at least two blocks an SM, or all the blocks the layer has."""
    b, h, w, c, groups, stride, window, c_out = layer
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    c_g, o_g = c // groups, c_out // groups
    plan = launch_plan(b, ho, wo, c, groups, c_out, 3, 3, stride, window)
    assert plan is not None
    assert plan.cc % 8 == 0 and plan.cc % c_g == 0 and c % plan.cc == 0 and (c // plan.cc) % plan.nch == 0
    assert plan.smem == plan_shared_bytes(plan.th, plan.tw, plan.cc, c_g, o_g, 3, 3, stride, window)
    assert plan.smem <= SHARED_BYTES
    tiles = b * -(-ho // plan.th) * -(-wo // plan.tw)
    assert plan.blocks == tiles * (c // plan.cc) // plan.nch
    assert plan.blocks >= 2 * SMS or plan.nch == 1
