"""The deformable convolution's gradient: the plain version of K7b
(`deform_conv2d_backward_reference`) against `jax.grad` of JAX
`ops/deform_conv.py` `deform_conv2d`, and the autograd Function that
`DeformConv` goes through, in f32 on the CPU.

The offsets are integer, fractional, beyond +-D, exactly +-D and put samples
in the border bands and off the image. JAX's `jnp.clip` halves the gradient
at exactly +-D; the port's plain forward clamps with max then min, as
`jnp.clip` does, and its written-out backward takes the same slope. The
products sum in another order, so gradients agree within 1e-5 of the largest
|value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.ops.deform_conv import DeformConv as JaxDeformConv
from balancedgroupsoftmax_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch.convert import conv_from_flax
from balancedgroupsoftmax_torch.ops.deform_conv import (
    SHARED_BYTES,
    DeformConv,
    _DeformConv,
    backward_plan,
    deform_conv2d_backward,
    deform_conv2d_backward_reference,
    deform_conv2d_reference,
    geometry,
)
from test_torch_cuda import DCN_LAYER_SHAPES, deform_case, window_edge_offsets
from test_torch_deform_conv import _np, _offset_params, htc_dcn_layers

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * np.abs(want).max())


def grad_case(seed, c_in, c_out, groups, stride, window, modulated):
    """deform_case's inputs (integer offsets, offsets beyond +-4, border
    bands), with a few offsets exactly +-D and some that put a whole sample
    off the image, and a seeded cotangent."""
    x, off, weight, mask = deform_case(seed, c_in, c_out, groups, stride, window, modulated)
    rng = np.random.RandomState(seed + 100)
    if window:
        edge = window_edge_offsets(off, window, seed + 1)
        take = rng.rand(*off.shape) < 0.3
        off[take] = edge[take]
    off[:, 1, 1, :2] = [-30.0, 25.0]  # far off the image: no gradient at D = 0
    gout = rng.randn(*off.shape[:3], c_out).astype(np.float32)
    return x, off, weight, mask if modulated else None, gout


def jax_grads(x, off, weight, mask, gout, stride, groups, window):
    """jax.grad of sum(deform_conv2d * gout) in x, the offsets, the weight
    (OIHW) and the mask."""

    def f(xj, oj, wj, mj):
        wf = jnp.transpose(wj, (2, 3, 1, 0))  # OIHW -> flax HWIO
        if mj is None:
            out = jax.vmap(lambda a, o: jax_deform_conv2d(a, o, wf, None, stride, 1, groups, window))(xj, oj)
        else:
            out = jax.vmap(lambda a, o, m: jax_deform_conv2d(a, o, wf, m, stride, 1, groups, window))(xj, oj, mj)
        return jnp.sum(out * gout)

    argnums = (0, 1, 2, 3) if mask is not None else (0, 1, 2)
    return [np.asarray(g) for g in jax.grad(f, argnums=argnums)(x, off, weight, mask)]


CASES = [
    (window, stride, groups, modulated)
    for window in (0, 4)
    for stride in (1, 2)
    for groups in (1, 4)
    for modulated in (False, True)
]


@pytest.mark.parametrize("window,stride,groups,modulated", CASES,
                         ids=[f"D{d}-s{s}-g{g}-{'v2' if m else 'v1'}" for d, s, g, m in CASES])
def test_plain_backward_matches_jax_grad(window, stride, groups, modulated):
    x, off, weight, mask, gout = grad_case(window * 10 + stride * 3 + groups, 16, 16, groups, stride, window, modulated)
    want = jax_grads(x, off, weight, mask, gout, stride, groups, window)
    T = lambda a: None if a is None else torch.from_numpy(a)
    before = [k.launches for k in cuda.KERNELS]
    got = deform_conv2d_backward(T(gout), T(x), T(off), T(weight), T(mask), stride, 1, groups, window)
    assert [k.launches for k in cuda.KERNELS] == before  # the plain version, on the CPU
    assert (got[3] is None) == (mask is None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g.numpy(), w)


def test_clamp_edge_gradient_is_jaxs():
    """At exactly +-4 the clamp's slope is 1/2 (jnp.clip's), and at exactly
    +4 on the last tap row or column JAX's shift sum has no high neighbour,
    so the high corners drop out of that offset's gradient; both agree with
    jax.grad, and differ from the full bilinear derivative there."""
    x, off, weight, _, gout = grad_case(5, 8, 8, 1, 1, 4, False)
    off[:] = 0.3
    off[0, 2, 3, 0] = 4.0  # tap (0, 0) dy: slope 1/2
    off[0, 2, 3, 1] = -4.0
    off[0, 2, 4, 0] = 4.0 - 2.0**-20  # just inside: slope 1
    off[0, 3, 3, 16:18] = 4.0  # tap (2, 2): the top of the shift range in y and x
    want = jax_grads(x, off, weight, None, gout, 1, 1, 4)[1]
    T = torch.from_numpy
    got = deform_conv2d_backward_reference(T(gout), T(x), T(off), T(weight), None, 1, 1, 1, 4)[1].numpy()
    _close(got, want)
    g = geometry(x.shape[1], x.shape[2], T(off), 3, 3, 1, 1, 4)
    assert g.gy[0, 2, 3, 0] == 0.5 and g.gx[0, 2, 3, 0] == 0.5 and g.gy[0, 2, 4, 0] == 1.0
    assert g.hy[0, 3, 3, 8] == 0 and g.hx[0, 3, 3, 8] == 0 and g.hy[0, 2, 3, 0] == 1
    assert g.hy.sum() == g.hy.numel() - 1 and g.hx.sum() == g.hx.numel() - 1
    # the plain forward's autograd keeps the high corners: it differs only there
    ins = [T(a).requires_grad_() for a in (x, off, weight)]
    full = torch.autograd.grad((deform_conv2d_reference(*ins, None, 1, 1, 1, 4) * T(gout)).sum(), ins[1])[0]
    differs = np.abs(full.numpy() - want) > TOL * np.abs(want).max()
    assert differs[0, 3, 3, 16:18].all() and differs.sum() == 2


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("window", [4, 0])
def test_plain_backward_is_autograd_of_the_plain_forward(window, modulated):
    """In f32 the written-out backward is the plain forward's autograd, away
    from the top of JAX's shift range (`test_clamp_edge_gradient_is_jaxs`)."""
    x, off, weight, mask, gout = grad_case(11, 16, 24, 4, 2, window, modulated)
    off[off == window] -= 0.25
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, off, weight)]
    m = None if mask is None else torch.from_numpy(mask).requires_grad_()
    out = deform_conv2d_reference(*ins, m, 2, 1, 4, window)
    want = torch.autograd.grad((out * torch.from_numpy(gout)).sum(), ins + ([m] if m is not None else []))
    got = deform_conv2d_backward_reference(torch.from_numpy(gout), *[t.detach() for t in ins],
                                           None if m is None else m.detach(), 2, 1, 4, window)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_function_respects_needs_input_grad():
    """Through the Function: only the inputs that ask get a gradient, and the
    ones that do equal the plain backward's."""
    x, off, weight, mask, gout = grad_case(12, 16, 16, 4, 1, 4, True)
    xt, ot, wt, mt = (torch.from_numpy(a) for a in (x, off, weight, mask))
    wt.requires_grad_()
    ot.requires_grad_()
    out = _DeformConv.apply(xt, ot, wt, mt, 1, 1, 4, 4)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_DeformConvBackward"
    out.backward(torch.from_numpy(gout))
    assert xt.grad is None and mt.grad is None
    ref = deform_conv2d_backward_reference(torch.from_numpy(gout), xt, ot.detach(), wt.detach(), mt, 1, 1, 4, 4)
    _close(ot.grad.numpy(), ref[1].numpy())
    _close(wt.grad.numpy(), ref[2].numpy())
    skipped = deform_conv2d_backward_reference(torch.from_numpy(gout), xt, ot.detach(), wt.detach(), mt, 1, 1, 4, 4,
                                               needs=(False, False, True, False))
    assert skipped[0] is None and skipped[1] is None and skipped[3] is None
    _close(skipped[2].numpy(), ref[2].numpy())


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("window", [4, 0])
def test_deform_conv_layer_gradients_match_jax(window, modulated):
    """`DeformConv` (offset conv, Function) on converted weights with
    non-zero offsets: the input's, the offset conv's and the weight's
    gradients equal jax.grad of the flax layer."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 10, 32).astype(np.float32)
    jmod = JaxDeformConv(48, stride=2, modulated=modulated, groups=8, shift_window=window)
    variables = _offset_params(rng, _np(jmod.init(jax.random.PRNGKey(0), x)), 3.0)
    gout = rng.randn(2, 6, 5, 48).astype(np.float32)

    def f(params, xj):
        return jnp.sum(jmod.apply({"params": params}, xj) * gout)

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], x)
    layer = DeformConv(32, 48, stride=2, modulated=modulated, groups=8, shift_window=window)
    layer.load_state_dict(conv_from_flax(variables["params"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = layer(xt)
    (out * torch.from_numpy(gout).permute(0, 3, 1, 2)).sum().backward()
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx)
    want = conv_from_flax(_np(gp))
    for name, p in layer.named_parameters():
        _close(p.grad.numpy(), want[name].numpy())


@pytest.mark.parametrize("layer", sorted(set(htc_dcn_layers())), ids=lambda t: "x".join(map(str, t[1:4])) + f"-s{t[5]}")
def test_backward_plan_fits_at_the_x101_layers(layer):
    """K7b's plan at the six distinct shapes of the 30 HTC-DCN layers: whole
    groups a data chunk, a weight block of whole groups or a divisor of one,
    at most 16 sums a thread, shared memory within 227 KB, two blocks an SM
    in the weight pass where the positions allow."""
    b, h, w, c, groups, stride, _ = layer
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    n = b * ho * wo
    plan = backward_plan(n, c, groups, c, 3, 3)
    c_g = c // groups
    assert plan is not None and groups % plan.gpc == 0 and plan.gpc * c_g <= 64
    assert (plan.oc % c_g == 0 and groups % (plan.oc // c_g) == 0) or c_g % plan.oc == 0
    assert plan.oc * 9 * c_g <= 256 * 16
    assert max(plan.smem_data, plan.smem_weight) <= SHARED_BYTES
    tiles = -(-n // plan.tp)
    per = -(-tiles // plan.splits)
    assert (plan.splits - 1) * per < tiles  # no empty range
    assert (c // plan.oc) * plan.splits >= 2 * 132 or plan.splits == tiles


def test_backward_plan_refuses_what_does_not_fit():
    assert backward_plan(100, 1024, 1, 1024, 3, 3) is None  # one group of 1024: no weight block fits


def test_card_tests_take_the_x101_layer_shapes():
    """tests/test_torch_cuda.py holds K7b at exactly the six distinct
    (input, stride) shapes of the 30 HTC-DCN layers."""
    want = sorted({(h, w, c, groups, stride) for _, h, w, c, groups, stride, _ in htc_dcn_layers()})
    assert sorted(DCN_LAYER_SHAPES) == want and len(want) == 6
