"""Deformable convolution v1/v2: kernels K7 and K7b, their plain versions,
and the layer.

`deform_conv2d` replaces JAX `pallas/deform_conv.py` `deform_conv2d_fused`
(:501): the forward of a deformable convolution with the grouped weight
contracted in the same kernel. It launches `bags_deform_conv_forward` of
`csrc/deform_conv.cu` on a CUDA tensor and runs `deform_conv2d_reference` on a
CPU tensor. `deform_conv2d_backward` (K7b, `bags_deform_conv_backward`) is
its gradient, as JAX's custom VJP (:499-564) takes it from the XLA path;
`_DeformConv` joins the two into one autograd Function, which `DeformConv`
goes through, so a deformable layer trains on the card. It saves the inputs,
not the sampled columns: K7b samples again.

Semantics (JAX `ops/deform_conv.py` `deform_conv2d` :240): tap k = (ky, kx)
of output position (i, j) samples the input bilinearly at
(i * stride - padding + ky + dy, j * stride - padding + kx + dx), the offsets
(dy, dx) being channels 2k and 2k + 1 of `offsets`. With `shift_window` D > 0
each offset is first clamped to [-D, D] cells and the bilinear fractions come
from the clamped position relative to the output's base, ky + clip(dy)
(`_shift_window_cols` :136); with D = 0 they come from the absolute position
(`_bilinear_hw` :45). A sample whose (clamped) absolute position lies outside
(-1, H) x (-1, W) is 0, and a corner outside the image reads 0. Samples are
blended in f32 in the order of the four corners (low-low, low-high,
high-low, high-high) and rounded to x's dtype; a v2 `mask` then scales them,
in x's dtype. Input group g contracts only with output slice g (the CUDA
reference's `group`), in f32, and the output is in x's dtype.

Layouts: x (B, H, W, C) and the output (B, Ho, Wo, C_out) are channels-last,
the offsets (B, Ho, Wo, 2 * taps) and the mask (B, Ho, Wo, taps) are f32, and
the weight is (C_out, C / groups, kh, kw), as `Conv2d(groups=...)` holds it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from .. import cuda
from ..models.layers import Conv2d

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

SHARED_BYTES = 227 * 1024  # the most shared memory one block may have on an H100
TWO_A_SM = 113 * 1024  # two blocks an SM: 228 KB less 1 KB reserved a block, halved
SMS = 132  # H100 SXM
_TILES = ((8, 8), (4, 8), (4, 4))  # (rows, columns) of output positions a block, in order of preference


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class LaunchPlan(NamedTuple):
    """How K7's bf16 route cuts one layer: tiles of `th` x `tw` output
    positions, each block walking `nch` chunks of `cc` channels."""

    th: int
    tw: int
    cc: int
    nch: int
    smem: int  # shared memory a block, bytes
    blocks: int


def plan_shared_bytes(th: int, tw: int, cc: int, c_g: int, o_g: int, kh: int, kw: int, stride: int, window: int) -> int:
    """Shared memory of one block of K7's bf16 route (`lay_out` in
    csrc/deform_conv.cu, which checks that it gets the same): per (position,
    tap) a corner index (int, or int4 without a window), float4 weights and a
    float mask; A, positions x (groups, taps * c_g padded to 16), rows padded
    by 8; B, (groups, o_g padded to 8) x (taps * c_g padded to 16, + 8); and
    two window buffers at D > 0."""
    m = th * tw
    pt = m * kh * kw
    gc = cc // c_g
    kp = _round_up(kh * kw * c_g, 16)
    size = _round_up(pt * (4 if window > 0 else 16), 16) + pt * 16 + _round_up(pt * 4, 16)
    size += m * (gc * kp + 8) * 2
    size += gc * _round_up(o_g, 8) * (kp + 8) * 2
    if window > 0:
        wr = (th - 1) * stride + kh + 2 * window + 1
        wc = (tw - 1) * stride + kw + 2 * window + 1
        size += 2 * wr * wc * cc * 2
    return size


def launch_plan(
    b: int, ho: int, wo: int, c: int, groups: int, c_out: int, kh: int, kw: int, stride: int, window: int
) -> Optional[LaunchPlan]:
    """K7's bf16 launch plan for one layer, or None if no plan fits.

    A chunk is whole groups and a multiple of 8 channels, preferably the
    smallest such of at least 32 channels. The first tile and chunk, in order
    of preference, whose shared memory lets two blocks share an SM is taken
    (else the first that fits at all). Then the chunks a block walks: of the
    counts that keep the grid at two blocks an SM or more (all counts give
    fewer: one chunk a block, all the blocks there are), the one with the
    least (waves of blocks) x (chunks + 1), the 1 standing for a block's
    corners and first window copy, which no chunk overlaps."""
    c_g, o_g = c // groups, c_out // groups
    sizes = [n * c_g for n in range(1, groups + 1) if groups % n == 0 and (n * c_g) % 8 == 0]
    chunks = [s for s in sizes if s >= 32][:1] + [s for s in reversed(sizes) if s < 32]
    for limit in (TWO_A_SM, SHARED_BYTES):
        for th, tw in _TILES:
            for cc in chunks:
                smem = plan_shared_bytes(th, tw, cc, c_g, o_g, kh, kw, stride, window)
                if smem > limit:
                    continue
                tiles = b * -(-ho // th) * -(-wo // tw)
                n = c // cc
                slots = SMS * (2 if smem <= TWO_A_SM else 1)
                counts = [d for d in range(1, n + 1) if n % d == 0 and tiles * (n // d) >= 2 * SMS] or [1]
                nch = min(counts, key=lambda d: (-(-tiles * (n // d) // slots) * (d + 1), -d))
                return LaunchPlan(th, tw, cc, nch, smem, tiles * (n // nch))
    return None


class Geometry(NamedTuple):
    """Where each (position, tap) samples, (B, Ho, Wo, taps) each."""

    y0: torch.Tensor  # floor of the sampling row, long
    x0: torch.Tensor  # floor of the sampling column, long
    ly: torch.Tensor  # the row's fraction, f32
    lx: torch.Tensor  # the column's fraction, f32
    valid: torch.Tensor  # the (clamped) position lies inside (-1, H) x (-1, W)
    gy: torch.Tensor  # d(row) / d(dy): 1, or at D > 0 the clamp's slope (0.5 at exactly +-D, as jnp.clip's)
    gx: torch.Tensor  # d(column) / d(dx)
    hy: torch.Tensor  # 1 where the row's derivative counts the high corners, else 0 (see `geometry`)
    hx: torch.Tensor  # the same for the column


def geometry(h: int, w: int, offsets: torch.Tensor, kh: int, kw: int, stride: int, padding: int, window: int) -> Geometry:
    """The sampling positions of every (position, tap) of an (h, w) input.

    At D > 0, JAX's `_shift_window_cols` blends over the static shifts -D to
    k - 1 + D, so a relative position whose floor is k - 1 + D (the last tap
    at an offset of exactly +D) has no high neighbour in its sum: its value
    is the same (that corner's weight is 0) but its derivative in the
    fraction loses the high corners' term. `hy`/`hx` are 0 there, so that
    the gradient is JAX's."""
    _, ho, wo, _ = offsets.shape
    dev = offsets.device
    tap_y = torch.arange(kh, dtype=torch.float32, device=dev).repeat_interleave(kw)
    tap_x = torch.arange(kw, dtype=torch.float32, device=dev).repeat(kh)
    base_yi = torch.arange(ho, device=dev) * stride - padding
    base_xi = torch.arange(wo, device=dev) * stride - padding
    base_y = base_yi.float()[:, None, None]
    base_x = base_xi.float()[None, :, None]
    dy = offsets[..., 0::2].float()
    dx = offsets[..., 1::2].float()
    if window > 0:
        d = float(window)
        # max then min, as jnp.clip: the gradient at exactly +-D is halved
        lo, hi = dy.new_tensor(-d), dy.new_tensor(d)
        rel_y = tap_y + torch.minimum(torch.maximum(dy, lo), hi)
        rel_x = tap_x + torch.minimum(torch.maximum(dx, lo), hi)
        ys = base_y + rel_y
        xs = base_x + rel_x
        fy = torch.floor(rel_y)
        fx = torch.floor(rel_x)
        ly = rel_y - fy
        lx = rel_x - fx
        y0 = base_yi[:, None, None] + fy.long()
        x0 = base_xi[None, :, None] + fx.long()
        slope = lambda v: torch.where(v.abs() < d, 1.0, torch.where(v.abs() == d, 0.5, 0.0))
        gy, gx = slope(dy), slope(dx)
        hy = (fy < kh - 1 + window).float()
        hx = (fx < kw - 1 + window).float()
    else:
        ys = (base_y + tap_y) + dy
        xs = (base_x + tap_x) + dx
        fy = torch.floor(ys)
        fx = torch.floor(xs)
        ly = ys - fy
        lx = xs - fx
        y0 = fy.long()
        x0 = fx.long()
        gy = gx = hy = hx = torch.ones_like(ly)
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    return Geometry(y0, x0, ly, lx, valid, gy, gx, hy, hx)


def corners(x: torch.Tensor, g: Geometry) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The four corners of every sample, in the blend's order (low-low,
    low-high, high-low, high-high): (index into x's (B * H * W) pixels,
    clamped into the image; inside the image; the value (B, Ho, Wo, taps, C)
    in f32, 0 outside)."""
    b, h, w, c = x.shape
    flat = x.reshape(-1, c)
    image = (torch.arange(b, device=x.device) * (h * w))[:, None, None, None]
    out = []
    for yy, xx in ((g.y0, g.x0), (g.y0, g.x0 + 1), (g.y0 + 1, g.x0), (g.y0 + 1, g.x0 + 1)):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = image + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c).float()
        out.append((idx, inside, torch.where(inside[..., None], v, torch.zeros((), device=x.device))))
    return out


def _blend(g: Geometry, values: list[torch.Tensor]) -> torch.Tensor:
    """The samples (B, Ho, Wo, taps, C) in f32, 0 where the position is not
    valid, blended in the corners' order."""
    hy = 1.0 - g.ly
    hx = 1.0 - g.lx
    v00, v01, v10, v11 = values
    acc = (hy * hx)[..., None] * v00
    acc = acc + (hy * g.lx)[..., None] * v01
    acc = acc + (g.ly * hx)[..., None] * v10
    acc = acc + (g.ly * g.lx)[..., None] * v11
    return torch.where(g.valid[..., None], acc, torch.zeros((), device=acc.device))


def sample_cols(
    x: torch.Tensor,  # (B, H, W, C)
    offsets: torch.Tensor,  # (B, Ho, Wo, 2 * taps) f32
    kh: int,
    kw: int,
    stride: int = 1,
    padding: int = 1,
    shift_window: int = 0,
) -> torch.Tensor:
    """The bilinear samples of every tap, (B, Ho, Wo, taps, C), blended in
    f32 and rounded to x's dtype."""
    g = geometry(x.shape[1], x.shape[2], offsets, kh, kw, stride, padding, shift_window)
    return _blend(g, [v for _, _, v in corners(x, g)]).to(x.dtype)


def deform_conv2d_reference(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weight: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    shift_window: int = 0,
) -> torch.Tensor:
    """Plain version of K7: (B, Ho, Wo, C_out) in x's dtype."""
    c_out, c_g, kh, kw = weight.shape
    b, _, _, c = x.shape
    _, ho, wo, _ = offsets.shape
    taps = kh * kw
    cols = sample_cols(x, offsets, kh, kw, stride, padding, shift_window)
    if mask is not None:
        cols = cols * mask[..., None].to(cols.dtype)
    cols = cols.float().reshape(b * ho * wo, taps, groups, c_g)
    w = weight.float().reshape(groups, c_out // groups, c_g, taps)
    out = torch.einsum("ntgc,goct->ngo", cols, w)
    return out.reshape(b, ho, wo, c_out).to(x.dtype)


def _check_args(x, offsets, weight, mask, stride, padding, groups) -> tuple:
    """Raise unless K7 and K7b take these tensors; their shapes (b, h, w, c,
    ho, wo, c_out, c_g, kh, kw)."""
    b, h, w, c = x.shape
    c_out, c_g, kh, kw = weight.shape
    taps = kh * kw
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"deform_conv kernel takes f32 or bf16 input, got {x.dtype}")
    if c_g * groups != c or c_out % groups:
        raise ValueError(f"{c} input and {c_out} output channels do not split into {groups} groups of weight {tuple(weight.shape)}")
    ho, wo = _out_size(h, kh, stride, padding), _out_size(w, kw, stride, padding)
    cuda.check(x, x.dtype, (b, h, w, c), "x")
    cuda.check(offsets, torch.float32, (b, ho, wo, 2 * taps), "offsets")
    cuda.check(weight, x.dtype, (c_out, c_g, kh, kw), "weight")
    if mask is not None:
        cuda.check(mask, torch.float32, (b, ho, wo, taps), "mask")
    return b, h, w, c, ho, wo, c_out, c_g, kh, kw


def deform_conv2d(
    x: torch.Tensor,  # (B, H, W, C) f32 or bf16, contiguous
    offsets: torch.Tensor,  # (B, Ho, Wo, 2 * taps) f32, contiguous
    weight: torch.Tensor,  # (C_out, C / groups, kh, kw) in x's dtype, contiguous
    mask: Optional[torch.Tensor] = None,  # (B, Ho, Wo, taps) f32, contiguous
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    shift_window: int = 0,
) -> torch.Tensor:
    """K7: (B, Ho, Wo, C_out) in x's dtype. In bf16 the kernel takes C a
    multiple of 8 and C / groups a multiple of 4, and refuses others."""
    if x.device.type == "cpu":
        return deform_conv2d_reference(x, offsets, weight, mask, stride, padding, groups, shift_window)
    b, h, w, c, ho, wo, c_out, c_g, kh, kw = _check_args(x, offsets, weight, mask, stride, padding, groups)
    plan = LaunchPlan(0, 0, 0, 0, 0, 0)  # the f32 route plans for itself
    if x.dtype == torch.bfloat16:
        plan = launch_plan(b, ho, wo, c, groups, c_out, kh, kw, stride, shift_window)
        if c % 8 or c_g % 4 or x.data_ptr() % 16 or plan is None:
            raise ValueError(
                f"the bf16 deform_conv kernel takes channels in 16-byte pieces (C % 8 == 0, C / groups % 4 == 0, "
                f"x aligned to 16 bytes) and a plan that fits {SHARED_BYTES} bytes of shared memory; got C {c}, "
                f"groups {groups}, weight {tuple(weight.shape)}"
            )
        weight = weight.permute(0, 2, 3, 1).contiguous()  # (C_out, kh, kw, c_g): a row of the kernel's B is one run
    out = torch.empty(b, ho, wo, c_out, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    cuda.DEFORM_CONV(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(), offsets.data_ptr(), 0 if mask is None else mask.data_ptr(),
        weight.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, c_out, kh, kw, stride, padding, groups, shift_window,
        plan.th, plan.tw, plan.cc, plan.nch, plan.smem,
    )
    return out


def deform_conv2d_backward_reference(
    grad_out: torch.Tensor,  # (B, Ho, Wo, C_out) in x's dtype
    x: torch.Tensor,
    offsets: torch.Tensor,
    weight: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    shift_window: int = 0,
    needs: Sequence[bool] = (True, True, True, True),
) -> tuple[Optional[torch.Tensor], ...]:
    """Plain version of K7b: the gradient of `deform_conv2d_reference`,
    written out. Returns (dx, d_offsets, d_weight, d_mask) in the dtypes of
    x, offsets, weight and mask; an entry is None where `needs` (x, offsets,
    weight, mask) says no, or for a v1 layer's mask.

    Everything is computed in f32 from the inputs' values, and each result is
    rounded once to its dtype. The forward's roundings to x's dtype (a sample,
    the mask, a masked sample) are kept where their values are used (the
    weight's and the mask's gradients) and pass the gradient through
    unchanged. In f32 this is JAX's autodiff of `ops/deform_conv.py`
    `deform_conv2d`: with grad_col the gradient of a sample (the grouped
    contraction of grad_out with the weight, times the mask in v2), dx gets
    each corner's bilinear weight times grad_col, scattered; the offsets get
    the channel sum of grad_col times the blend's derivative in its fraction,
    hx (v10 - v00) + lx (v11 - v01) for dy, times the clamp's slope (1 inside
    +-D, 1/2 at exactly +-D, 0 beyond); the mask gets the channel sum of the
    gradient before the mask times the sample; the weight the positions' sum
    of grad_out times the (masked) samples. An invalid sample gets no
    gradient, and a corner outside the image none. At the top of JAX's shift
    range the high corners drop out of the offsets' term (`geometry`)."""
    c_out, c_g, kh, kw = weight.shape
    b, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    taps, o_g, n = kh * kw, c_out // groups, b * ho * wo
    g = geometry(h, w, offsets, kh, kw, stride, padding, shift_window)
    cs = corners(x, g)
    v00, v01, v10, v11 = (v for _, _, v in cs)
    sample = _blend(g, [v00, v01, v10, v11]).to(x.dtype).float()
    col = sample
    if mask is not None:
        m = mask.to(x.dtype).float()[..., None]
        col = (sample * m).to(x.dtype).float()
    gout = grad_out.float().reshape(n, groups, o_g)
    dw = None
    if needs[2]:
        dw = torch.einsum("ngo,ntgc->goct", gout, col.reshape(n, taps, groups, c_g))
        dw = dw.reshape(c_out, c_g, kh, kw).to(weight.dtype)
    if not (needs[0] or needs[1] or (needs[3] and mask is not None)):
        return None, None, dw, None
    wt = weight.float().reshape(groups, o_g, c_g, taps)
    grad_col = torch.einsum("ngo,goct->ntgc", gout, wt).reshape(b, ho, wo, taps, c)
    d_mask = (grad_col * sample).sum(-1) if mask is not None and needs[3] else None
    grad_s = grad_col * m if mask is not None else grad_col
    grad_s = torch.where(g.valid[..., None], grad_s, torch.zeros((), device=x.device))
    d_off = None
    if needs[1]:
        hy, hx = 1.0 - g.ly, 1.0 - g.lx
        ky, kx = g.hy[..., None], g.hx[..., None]
        d_ly = (grad_s * (hx[..., None] * (ky * v10 - v00) + g.lx[..., None] * (ky * v11 - v01))).sum(-1)
        d_lx = (grad_s * (hy[..., None] * (kx * v01 - v00) + g.ly[..., None] * (kx * v11 - v10))).sum(-1)
        d_off = torch.stack([d_ly * g.gy, d_lx * g.gx], -1).reshape(b, ho, wo, 2 * taps)
    dx = None
    if needs[0]:
        hy, hx = 1.0 - g.ly, 1.0 - g.lx
        acc = torch.zeros(b * h * w, c, dtype=torch.float32, device=x.device)
        for (idx, inside, _), wk in zip(cs, (hy * hx, hy * g.lx, g.ly * hx, g.ly * g.lx)):
            share = torch.where(inside[..., None], wk[..., None] * grad_s, torch.zeros((), device=x.device))
            acc.index_add_(0, idx.reshape(-1), share.reshape(-1, c))
        dx = acc.reshape(b, h, w, c).to(x.dtype)
    return dx, d_off, dw, d_mask


BACKWARD_TILE_F32 = 32  # output positions a tile of K7b's f32 route
BACKWARD_ACC_F32 = 16  # weight-gradient sums a thread of the f32 route's weight pass holds
_THREADS = 256
GRAD_WARPS = _THREADS // 32
GRAD_SLOTS = 12  # weight-gradient fragments (16 x 8 sums) a warp of K7b's bf16 route holds
SM_SHARED = 228 * 1024  # shared memory of one SM, 1 KB of it reserved a block
_GRAD_TILES = ((8, 8), (4, 8), (8, 16), (4, 16), (16, 8), (8, 4), (4, 4))  # (rows, columns) of output positions
_GRAD_TILE_COST = 8192  # a tile's fixed cost (barriers, scan), in the plan's units (a sample channel's is 4)
_GRAD_ENTRY_COST = 24  # a (position, tap)'s cost whatever its channels (the table, its counts, its lists)


class BackwardPlan(NamedTuple):
    """How K7b's bf16 route cuts one layer (csrc/deform_conv.cu `lay_out_grad`
    checks the same numbers): a block takes a chunk of `gc` whole groups and
    walks `tiles_per_block` tiles of `th` x `tw` output positions; `splits`
    ranges of the tiles. The first six fields are what the kernel takes."""

    th: int
    tw: int
    gc: int
    tiles_per_block: int
    splits: int
    smem: int  # shared memory a block, bytes: the five parts below and the (position, tap) table and offsets
    smem_window: int  # two tiles' windows of x, bf16
    smem_dx: int  # the dx gather: grad_col in f32, the corners' lists, two tiles' counts a window pixel
    smem_cols: int  # the sampled columns, bf16
    smem_grad: int  # two tiles' rows of grad_out, bf16
    smem_weight: int  # the chunk's weights, bf16
    blocks: int


class BackwardPlanF32(NamedTuple):
    """How K7b's f32 route cuts one layer. Data pass: tiles of `tp` positions
    x chunks of `gpc` groups. Weight pass: blocks of `oc` output channels x
    `splits` ranges of the tiles."""

    tp: int
    gpc: int
    oc: int
    splits: int
    smem_data: int  # shared memory a block, bytes
    smem_weight: int


def backward_shared_bytes(th: int, tw: int, gc: int, c_g: int, o_g: int, kh: int, kw: int, stride: int,
                          window: int) -> dict:
    """Shared memory of one block of K7b's bf16 route, part by part (as
    `lay_out_grad` in csrc/deform_conv.cu lays it out), and the total: per
    (position, tap) an int4 table entry and the staged offsets and mask
    (12 bytes); at D > 0 two tiles' windows of x ((th - 1) s + kh + 2D + 1 by
    (tw - 1) s + kw + 2D + 1 pixels of the chunk's channels), the corners'
    lists (an int2 a corner: its pixel and grad_col row, its weight), two
    tiles' counts a pixel, and the warps' sums of them and the lists'
    length; grad_col in f32 (the chunk's channels + 4 a (position, tap));
    the columns, positions x (groups, taps * c_g padded to 16), rows padded
    by 8; two tiles' grad_out rows, (groups, o_g padded to 8) padded to 16,
    + 8; the weights, (groups, taps * c_g padded to 16) x (o_g padded to 8,
    to 16, + 8)."""
    m, taps = th * tw, kh * kw
    pt, cc = m * taps, gc * c_g
    kp, ogp = _round_up(taps * c_g, 16), _round_up(o_g, 8)
    npix = ((th - 1) * stride + kh + 2 * window + 1) * ((tw - 1) * stride + kw + 2 * window + 1) if window > 0 else 0
    parts = dict(
        window=2 * npix * cc * 2,
        dx=pt * (cc + 4) * 4 + (pt * 32 + _round_up((2 * (npix + 1) + 2 * GRAD_WARPS) * 4, 16) if window > 0 else 0),
        cols=m * (gc * kp + 8) * 2,
        grad=2 * m * (_round_up(gc * ogp, 16) + 8) * 2,
        weight=gc * kp * (_round_up(ogp, 16) + 8) * 2,
    )
    parts["total"] = pt * 16 + _round_up(pt * 12, 16) + sum(parts.values())
    return parts


def backward_plans(
    b: int, ho: int, wo: int, c: int, groups: int, c_out: int, kh: int, kw: int, stride: int, window: int
) -> list[tuple[float, BackwardPlan]]:
    """Every plan of K7b's bf16 route that fits one layer, with its cost (see
    `backward_plan`)."""
    c_g, o_g, taps = c // groups, c_out // groups, kh * kw
    plans = []
    for th, tw in _GRAD_TILES:
        for gc in (d for d in range(1, groups + 1) if groups % d == 0):
            nq = gc * c_g // 8
            if c_g % 4 or (gc * c_g) % 8 or nq > 32 or nq & (nq - 1):
                continue
            if gc * (_round_up(taps * c_g, 16) // 16) * (_round_up(o_g, 8) // 8) > GRAD_WARPS * GRAD_SLOTS:
                continue
            parts = backward_shared_bytes(th, tw, gc, c_g, o_g, kh, kw, stride, window)
            smem = parts["total"]
            npix = parts["window"] // (4 * gc * c_g)
            if smem > SHARED_BYTES or npix >= 2048 or th * tw * taps * (gc * c_g + 4) >= 1 << 20:
                continue  # (a list entry packs the pixel in 11 bits and the grad_col row in 20)
            per_sm = min(2, SM_SHARED // (smem + 1024))
            chunks = groups // gc
            tiles = max(1, b * -(-ho // th) * -(-wo // tw))
            slots = SMS * per_sm
            splits = min(tiles, max(1, slots // chunks))
            tpb = -(-tiles // splits)
            splits = -(-tiles // tpb)
            blocks = chunks * splits
            if blocks < SMS and splits < tiles:  # the grid must fill the card where the tiles allow
                continue
            work = gc * c_g * (th * tw * taps * 4 + npix) + th * tw * taps * _GRAD_ENTRY_COST + _GRAD_TILE_COST
            cost = -(-blocks // slots) * per_sm * tpb * work / (1.0 + 0.25 * (per_sm - 1))
            plans.append((cost, BackwardPlan(th, tw, gc, tpb, splits, smem, parts["window"], parts["dx"],
                                             parts["cols"], parts["grad"], parts["weight"], blocks)))
    return plans


def backward_plan(
    b: int, ho: int, wo: int, c: int, groups: int, c_out: int, kh: int, kw: int, stride: int, window: int
) -> Optional[BackwardPlan]:
    """K7b's bf16 plan for one layer, or None if no plan fits.

    A chunk is whole groups whose channels make a power-of-two count of
    16-byte pieces (at most 32), whose weight-gradient fragments fit
    `GRAD_SLOTS` a warp, and whose shared memory fits. Each block walks the
    same number of tiles; the tile ranges are as many as keep every block
    resident at once (one or two a SM, as shared memory allows), or one when
    the chunks alone are more; a grid of fewer than `SMS` blocks is taken
    only with one tile a block. Of the (tile, chunk) pairs, the one whose
    busiest SM has the least work is taken: a tile's work is its chunk's
    channels times (its samples times 4, for the sampling, the gather and
    the products, plus its window's pixels), plus a cost a (position, tap)
    and a fixed cost (weighed against `kernel_study`'s timings of every plan
    at the X101's layers); two blocks on an SM are counted a quarter faster
    than one, for hiding each other's barriers. Ties go to two blocks an
    SM, then to the larger tile."""
    plans = backward_plans(b, ho, wo, c, groups, c_out, kh, kw, stride, window)
    if not plans:
        return None
    return min(plans, key=lambda cp: (cp[0], -(SM_SHARED // (cp[1].smem + 1024)), -cp[1].th * cp[1].tw))[1]


def backward_plan_f32(n: int, c: int, groups: int, c_out: int, kh: int, kw: int) -> Optional[BackwardPlanF32]:
    """K7b's f32 plan for n = B * Ho * Wo output positions, or None if no
    plan fits. The data pass takes the most whole groups of at most 64 input
    and 64 output channels a block. The weight pass gives each block the
    most output channels (whole groups, or a divisor of one group) whose
    taps x c_g sums fit `BACKWARD_ACC_F32` a thread, and enough ranges of
    the positions that the grid holds two blocks an SM."""
    c_g, o_g, taps, tp = c // groups, c_out // groups, kh * kw, BACKWARD_TILE_F32
    per = _THREADS * BACKWARD_ACC_F32
    divisors = lambda v: [d for d in range(1, v + 1) if v % d == 0]
    gpc = max([d for d in divisors(groups) if d * c_g <= 64 and d * o_g <= 64], default=1)
    whole = [d * o_g for d in divisors(groups) if d * o_g * taps * c_g <= per]
    parts = [d for d in divisors(o_g) if d * taps * c_g <= per]
    if not (whole or parts):
        return None
    oc = max(whole) if whole else max(parts)
    pt = tp * taps
    smem_data = pt * 80 + tp * gpc * o_g * 4 + taps * gpc * o_g * c_g * 4
    smem_weight = pt * 36 + tp * oc * 4 + pt * max(oc // o_g, 1) * c_g * 4
    if max(smem_data, smem_weight) > SHARED_BYTES:
        return None
    tiles = -(-n // tp)
    splits = min(tiles, max(1, -(-2 * SMS // (c_out // oc))))
    splits = -(-tiles // -(-tiles // splits))  # every range holds at least one tile
    return BackwardPlanF32(tp, gpc, oc, splits, smem_data, smem_weight)


def deform_conv2d_backward(
    grad_out: torch.Tensor,  # (B, Ho, Wo, C_out) in x's dtype, contiguous
    x: torch.Tensor,  # (B, H, W, C) f32 or bf16, contiguous
    offsets: torch.Tensor,  # (B, Ho, Wo, 2 * taps) f32, contiguous
    weight: torch.Tensor,  # (C_out, C / groups, kh, kw) in x's dtype, contiguous
    mask: Optional[torch.Tensor] = None,  # (B, Ho, Wo, taps) f32, contiguous
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    shift_window: int = 0,
    needs: Sequence[bool] = (True, True, True, True),
) -> tuple[Optional[torch.Tensor], ...]:
    """K7b: (dx, d_offsets, d_weight, d_mask) of `deform_conv2d`, as
    `deform_conv2d_backward_reference` gives them. The kernel takes C and
    C / groups multiples of 4, x aligned to 16 bytes and a plan that fits
    (`backward_plan` in bf16, where a chunk of whole groups must also be a
    power-of-two count of 8 channels; `backward_plan_f32`), and refuses
    others."""
    if x.device.type == "cpu":
        return deform_conv2d_backward_reference(
            grad_out, x, offsets, weight, mask, stride, padding, groups, shift_window, needs
        )
    b, h, w, c, ho, wo, c_out, c_g, kh, kw = _check_args(x, offsets, weight, mask, stride, padding, groups)
    cuda.check(grad_out, x.dtype, (b, ho, wo, c_out), "grad_out")
    if x.dtype == torch.bfloat16:
        plan = backward_plan(b, ho, wo, c, groups, c_out, kh, kw, stride, shift_window)
    else:
        plan = backward_plan_f32(b * ho * wo, c, groups, c_out, kh, kw)
    if c % 4 or c_g % 4 or x.data_ptr() % 16 or plan is None:
        raise ValueError(
            f"the deform_conv backward kernel takes channels in groups of 4 (C % 4 == 0, C / groups % 4 == 0, "
            f"x aligned to 16 bytes) and a plan that fits {SHARED_BYTES} bytes of shared memory; got C {c}, "
            f"groups {groups}, weight {tuple(weight.shape)}"
        )
    want_dx, want_off, want_w = needs[0], needs[1], needs[2]
    want_mask = needs[3] and mask is not None
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=x.device)
    dx = empty(x.shape, x.dtype) if want_dx else None
    acc = (dx if x.dtype == torch.float32 else empty(x.shape, torch.float32)) if want_dx else None
    d_off = empty(offsets.shape, torch.float32) if want_off else None
    d_mask = empty(mask.shape, torch.float32) if want_mask else None
    dw = empty(weight.shape, weight.dtype) if want_w else None
    part = empty((plan.splits, *weight.shape), torch.float32) if want_w else None
    if not (want_dx or want_off or want_w or want_mask):
        return None, None, None, None
    if b * ho * wo == 0 or x.numel() == 0:
        return tuple(None if t is None else t.zero_() for t in (dx, d_off, dw, d_mask))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    cuda.DEFORM_CONV_BACKWARD(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(), offsets.data_ptr(), ptr(mask), weight.data_ptr(), grad_out.data_ptr(),
        ptr(acc), 0 if dx is None or dx is acc else dx.data_ptr(), ptr(d_off), ptr(d_mask), ptr(part), ptr(dw),
        b, h, w, c, ho, wo, c_out, kh, kw, stride, padding, groups, shift_window,
        *plan[:6],
    )
    return dx, d_off, dw, d_mask


class _DeformConv(torch.autograd.Function):
    """K7 forward, K7b backward (the custom VJP of JAX `pallas/deform_conv.py`
    `deform_conv2d_fused` :499-564). It saves x, the offsets, the weight and
    the mask, never the sampled columns: K7b samples again."""

    @staticmethod
    def forward(ctx, x, offsets, weight, mask, stride, padding, groups, shift_window):
        ctx.args = (stride, padding, groups, shift_window)
        ctx.save_for_backward(x, offsets, weight, mask)
        return deform_conv2d(x, offsets, weight, mask, stride, padding, groups, shift_window)

    @staticmethod
    def backward(ctx, grad):
        x, offsets, weight, mask = ctx.saved_tensors
        grads = deform_conv2d_backward(
            grad.contiguous(), x, offsets, weight, mask, *ctx.args, needs=ctx.needs_input_grad[:4]
        )
        return (*grads, None, None, None, None)


class DeformConv(nn.Module):
    """DCN v1/v2 layer (JAX `ops/deform_conv.py` `DeformConv` :378): a
    regular convolution predicts the offsets (and, for v2, the mask logits),
    then the deformable convolution. `conv_offset` starts at zero, so the
    layer starts as a plain (grouped) convolution. Tensors are NCHW, kept in
    channels-last memory, which K7 reads as NHWC."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 1,
        modulated: bool = True,
        groups: int = 1,
        shift_window: int = 0,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.modulated = modulated
        self.groups = groups
        self.shift_window = shift_window
        taps = kernel_size * kernel_size
        self.conv_offset = Conv2d(
            in_channels, (3 if modulated else 2) * taps, kernel_size, stride=stride, padding=padding
        )
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")

    def init_special(self) -> dict:
        """he-normal weight, zero offset conv, for `FasterRCNN.init_weights`."""
        return {self: ("he", None), self.conv_offset: ("zeros", None)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, C_out, Ho, Wo), in x's dtype."""
        taps = self.kernel_size**2
        off = self.conv_offset(x).float()
        offsets = off[:, : 2 * taps].permute(0, 2, 3, 1).contiguous()
        mask = torch.sigmoid(off[:, 2 * taps :]).permute(0, 2, 3, 1).contiguous() if self.modulated else None
        out = _DeformConv.apply(
            x.permute(0, 2, 3, 1).contiguous(),
            offsets,
            self.weight.to(x.dtype).contiguous(),
            mask,
            self.stride,
            self.padding,
            self.groups,
            self.shift_window,
        )
        return out.permute(0, 3, 1, 2)

