"""The port's fused bottleneck (plain versions of K8 and K9, the FrozenBN
fold) against JAX `pallas/fused_block.py`, in f32 on the CPU.

JAX's kernels run in interpret mode, as `tests/test_fused_block.py` runs
them, on the same flax variables converted into the port's `Bottleneck`, with
non-trivial BN statistics (scales and variances in [0.5, 2]) so the fold
changes the weights. Both sides sum in f32 in other orders, so outputs agree
within 1e-4 of the largest |output| (the JAX tests hold the kernel to flax at
1e-3); the folds are the same f32 operations and agree within 1e-6. Against
the port's unfused modules the fold reassociates the BN scale into the
weights, which is again within 1e-4 of the largest |output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models.resnet import Bottleneck as JaxBottleneck
from balancedgroupsoftmax_tpu.pallas import fused_block as jfb
from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch.convert import bottleneck_from_flax
from balancedgroupsoftmax_torch.models.resnet import Bottleneck, FrozenBatchNorm, ResNet
from balancedgroupsoftmax_torch.ops import fused_block as fb

TOL = 1e-4
FOLD_TOL = 1e-6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def jax_block(cin, planes, seed):
    """A flax Bottleneck's variables with seeded weights and BN statistics
    (as tests/test_fused_block.py `make_block` draws them), and the port's
    `Bottleneck` holding the same values."""
    rng = np.random.RandomState(seed)
    m = JaxBottleneck(planes=planes, stride=1, dtype=jnp.float32)
    v = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, cin), jnp.float32))
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape), a.dtype), v["batch_stats"])
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape) * 0.1, a.dtype), v["params"])
    block = Bottleneck(cin, planes)
    block.load_state_dict(bottleneck_from_flax(params, stats))
    return params, stats, block


def nhwc(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cin,planes", [(64, 32), (64, 16)], ids=["downsample", "identity"])
def test_fold_matches_jax(cin, planes):
    params, stats, block = jax_block(cin, planes, seed=cin + planes)
    want = jfb.fold_bottleneck(params, stats)
    got = fb.fold_bottleneck(block)
    for name, g, w in zip(fb.FusedBlockParams._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            _close(g.numpy(), w, FOLD_TOL)


def _chain_case(name):
    """(input (B, H, W, Cin), [(cin, planes, seed)] of the chained blocks)."""
    rng = np.random.RandomState(len(name))
    cases = {
        "downsample-64-32": (nhwc(rng, 2, 20, 24, 64), [(64, 32, 64)]),
        "downsample-128-16": (nhwc(rng, 2, 20, 24, 128), [(128, 16, 128)]),
        "downsample-96-64": (nhwc(rng, 2, 20, 24, 96), [(96, 64, 96)]),
        "identity": (nhwc(rng, 2, 16, 16, 64), [(64, 16, 3)]),
        "garbage-halo": (nhwc(rng, 2, 8, 16, 64), [(64, 16, 5)]),
        "chain": (nhwc(rng, 2, 16, 24, 64), [(64, 16, 7), (64, 16, 8)]),
    }
    return cases[name]


@pytest.mark.parametrize(
    "case", ["downsample-64-32", "downsample-128-16", "downsample-96-64", "identity", "garbage-halo", "chain"]
)
def test_fused_bottleneck_matches_jax_interpret(case):
    x, specs = _chain_case(case)
    blocks = [jax_block(cin, planes, seed) for cin, planes, seed in specs]
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    if case == "garbage-halo":  # the halo rows must never reach the math
        xp[:, 0] = 1e9
        xp[:, -1] = -1e9
    want, got = jnp.asarray(xp), torch.from_numpy(xp)
    before = [k.launches for k in cuda.KERNELS]
    for params, stats, block in blocks:
        want = jfb.fused_bottleneck(want, jfb.fold_bottleneck(params, stats), interpret=True)
        got = fb.fused_bottleneck(got, fb.fold_bottleneck(block))
    assert [k.launches for k in cuda.KERNELS] == before  # the CPU runs the plain version
    assert got.shape == (x.shape[0], x.shape[1] + 2, x.shape[2], specs[-1][1] * 4)
    _close(fb.unpad_rows(got).numpy(), jfb.unpad_rows(want))


@pytest.mark.parametrize("case", ["three-blocks-th4", "three-blocks-thH", "channel-change"])
def test_fused_layer_matches_jax_interpret(case):
    rng = np.random.RandomState(11)
    if case == "channel-change":  # the layer1 entry block: a downsample at stride 1
        x, specs, th = nhwc(rng, 1, 8, 16, 32), [(32, 16, 30), (64, 16, 31), (64, 16, 32)], 4
    else:
        x, specs = nhwc(rng, 2, 16, 24, 64), [(64, 16, 20), (64, 16, 21), (64, 16, 22)]
        th = 4 if case == "three-blocks-th4" else 16
    blocks = [jax_block(cin, planes, seed) for cin, planes, seed in specs]
    want = jfb.fused_layer(jnp.asarray(x), [jfb.fold_bottleneck(p, s) for p, s, _ in blocks], th=th, interpret=True)
    got = fb.fused_layer(torch.from_numpy(x), [fb.fold_bottleneck(b) for _, _, b in blocks])
    _close(got.numpy(), want)


def seeded_block(cin, planes, rng):
    """A port `Bottleneck` with seeded weights and BN statistics in [0.5, 2]."""
    block = Bottleneck(cin, planes)
    with torch.no_grad():
        for mod in block.modules():
            if isinstance(mod, FrozenBatchNorm):
                for t in (mod.weight, mod.bias, mod.running_mean, mod.running_var):
                    t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))
            elif isinstance(mod, torch.nn.Conv2d):
                mod.weight.copy_(torch.from_numpy((rng.randn(*mod.weight.shape) * 0.1).astype(np.float32)))
    return block.eval()


@pytest.mark.parametrize("entry", ["fused_bottleneck", "fused_layer"])
def test_fused_matches_the_port_modules_at_a_ragged_size(entry):
    """25 x 42, layer4's H x W, which JAX's `th` (H % th == 0 at th = 8 or 4)
    refuses: both entry points against the unfused modules."""
    rng = np.random.RandomState(17)
    x = nhwc(rng, 2, 25, 42, 32)
    blocks = [seeded_block(32, 16, rng), seeded_block(64, 16, rng), seeded_block(64, 16, rng)]
    with torch.no_grad():
        want = torch.from_numpy(x).permute(0, 3, 1, 2)
        for block in blocks:
            want = block(want)
        want = want.permute(0, 2, 3, 1)
    folded = [fb.fold_bottleneck(b) for b in blocks]
    if entry == "fused_layer":
        got = fb.fused_layer(torch.from_numpy(x), folded)
    else:
        got = fb.pad_rows(torch.from_numpy(x))
        for p in folded:
            got = fb.fused_bottleneck(got, p)
        got = fb.unpad_rows(got)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["stride-2", "grouped", "deformable"])
def test_fold_refuses_what_the_kernels_do_not_take(kind):
    if kind == "stride-2":
        block = Bottleneck(64, 16, stride=2)
    elif kind == "grouped":
        block = Bottleneck(64, 16, groups=8)
    else:
        block = Bottleneck(64, 16, use_dcn=True)
    with pytest.raises(ValueError):
        fb.fold_bottleneck(block)


def test_stride1_runs_of_the_r50():
    runs = fb.stride1_runs(ResNet(depth=50))
    assert [len(r) for r in runs] == [3, 3, 5, 2]
    assert [b.downsample is not None for b in runs[0]] == [True, False, False]
    assert not any(b.downsample is not None for r in runs[1:] for b in r)
    dims = [[(p.w1.shape[0], p.w1.shape[1], p.w3.shape[1]) for p in map(fb.fold_bottleneck, r)] for r in runs]
    assert dims[0] == [(64, 64, 256), (256, 64, 256), (256, 64, 256)]
    assert dims[3] == [(2048, 512, 2048)] * 2


# the R50's stride-1 runs at 800 x 1344, batch 2: (H, W) of each run's input
R50_RUN_SIZES = [(200, 336), (100, 168), (50, 84), (25, 42)]
SMEM = 232448  # a block's shared memory on the H100


def _check_plan(plan, b, h, w, sms=fb.H100_SMS):
    assert plan.smem <= SMEM
    if plan.route == "halo":  # conv1 over (TH + 2) rows of 32 halo pixels, the rest over TH rows of 32
        assert (plan.rows + 2) * 32 % 64 == 0 and plan.rows * 32 % 64 == 0
    else:
        assert plan.rows % 64 == 0
    assert min(plan.units) >= sms or plan.note


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("run", range(4), ids=["layer1", "layer2", "layer3", "layer4"])
def test_plan_of_the_r50_blocks(run, dtype):
    """Every plan of the R50's 13 stride-1 blocks at 800 x 1344, batch 2, fits
    shared memory, runs whole 64-row blocks and gives every phase at least
    one work unit an SM; in bf16 layer1 takes the halo route, layer2-4 the
    phase route."""
    h, w = R50_RUN_SIZES[run]
    blocks = [fb.fold_bottleneck(blk) for blk in fb.stride1_runs(ResNet(depth=50))[run]]
    cin = blocks[0].w1.shape[0]
    plans = fb.run_plans(2, h, w, cin, blocks, dtype)
    for plan in plans:
        _check_plan(plan, 2, h, w)
        assert not plan.note
        if dtype == torch.bfloat16:
            assert plan.route == ("halo" if run == 0 else "phase")


# the card tests' sizes (tests/test_torch_cuda.py FUSED_RAGGED) and widths
CARD_SIZES = [(2, 13, 37), (1, 5, 7), (1, 31, 61), (1, 19, 45), (2, 19, 35), (2, 11, 21), (2, 7, 18)]
CARD_WIDTHS = [(64, 64, 256), (256, 64, 256), (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048)]


@pytest.mark.parametrize("route", [None, "halo", "phase"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_at_the_card_tests_sizes(dtype, route):
    """At ragged sizes (H and W not multiples of a tile, W < 16, one image)
    every plan that is given fits; a forced halo route is refused only where
    its y1 and y2 cannot fit (layer3 in f32, layer4)."""
    for b, h, w in CARD_SIZES:
        for cin, cm, cout in CARD_WIDTHS:
            try:
                plan = fb.fused_plan(b, h, w, cin, cm, cout, dtype, route=route)
            except ValueError:
                assert route == "halo" and (cm == 512 or (cm == 256 and dtype == torch.float32))
                continue
            _check_plan(plan, b, h, w)
            assert route is None or plan.route == route


def test_k8_and_k9_take_the_same_plan():
    """K9 runs each block of a run with the plan K8 computes for that block
    alone (`fused_plan` on the block's own cin), at every R50 run and size."""
    runs = fb.stride1_runs(ResNet(depth=50))
    for run, (h, w) in zip(runs, R50_RUN_SIZES):
        blocks = [fb.fold_bottleneck(blk) for blk in run]
        for dtype in (torch.bfloat16, torch.float32):
            plans = fb.run_plans(2, h, w, blocks[0].w1.shape[0], blocks, dtype)
            for p, plan in zip(blocks, plans):
                assert plan == fb.fused_plan(2, h, w, p.w1.shape[0], p.w1.shape[1], p.w3.shape[1], dtype)


@pytest.mark.parametrize("case", ["halo-layer4", "odd-rows", "phase-32-rows", "route"])
def test_plan_refuses_what_fits_nothing(case):
    with pytest.raises(ValueError):
        if case == "halo-layer4":  # y1 and y2 of 512 channels do not fit 227 KB
            fb.fused_plan(2, 25, 42, 2048, 512, 2048, torch.bfloat16, route="halo")
        elif case == "odd-rows":  # conv1's halo would not be whole 64-row blocks
            fb.fused_plan(2, 200, 336, 256, 64, 256, torch.bfloat16, route="halo", rows=5)
        elif case == "phase-32-rows":
            fb.fused_plan(2, 25, 42, 2048, 512, 2048, torch.bfloat16, route="phase", rows=32)
        else:
            fb.fused_plan(2, 25, 42, 2048, 512, 2048, torch.bfloat16, route="cluster")
