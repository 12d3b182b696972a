"""Multi-level RoIAlign: kernel K2, its gradient K2b, and their plain versions.

`multilevel_roi_align` replaces JAX `pallas/roi_align.py`
`multilevel_roi_align_pallas` (:511, `pallas_call` at :482) with its custom
VJP (:510-537): a `torch.autograd.Function` whose forward is K2 and whose
backward is K2b, the gradient for the features (none for the rois, as in
JAX). The TPU ran that backward as the XLA contraction `_bwd_dense` (:569).
Each launches its CUDA kernel of `csrc/roi_align.cu` on CUDA tensors and runs
its plain version (`multilevel_roi_align_reference`,
`multilevel_roi_align_backward_reference`) on CPU tensors.

Semantics (JAX `ops/roi_align.py` `roi_align` :67,
`map_roi_levels` :104, `multilevel_roi_align_reference` :113): every roi is
routed to one FPN level by floor(log2(sqrt(area) / finest_scale + 1e-6)); it
spans [x1 * scale, (x2 + 1) * scale); each of the S x S bins averages
sample_num^2 bilinear samples with the reference CUDA kernel's boundary rules.
Features and output are channels-last, (B, H, W, C) and (B, R, S, S, C), in the
feature dtype; sums are taken in f32.

The geometry is separable: a sample's y depends only on its row of bins and
x only on its column, so `axis_samples` builds, per roi and per axis, the
table of low and high rows (or columns), fractions and validity that the
kernels build once a roi in shared memory; a sample's four weights are
products of one y and one x entry. `sample_points`, which the plain versions
use, is made from those tables too.

K2 routes each roi inside the launch, with `map_roi_levels`' operations as
PyTorch runs them on the card, and writes the levels when the features need
a gradient; K2b reuses them. On the card K2 is bound by memory (the output
write and the touched pixels); K2b by its f32 buffer, which holds the whole
pyramid: one memset writes it and one cast pass reads it and writes the bf16
gradient, 0.136 ms at 3.35 TB/s for 800x1344, batch 2, C = 256
(`csrc/roi_align.cu` says more).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from .. import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _reciprocal(n: int) -> float:
    """f32(1 / n), the f32 division, as a Python float."""
    return torch.tensor(1.0, dtype=torch.float32).div(n).item()


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56) -> torch.Tensor:
    """(...,) int32 FPN level per roi (single_level.py:54-73).

    sqrt(area) / finest_scale is taken as a product with the f32 reciprocal
    of finest_scale on every device: the JAX model runs jitted, and XLA
    folds `x / 56` into `x * f32(1 / 56)`; PyTorch's CUDA division by a
    number does the same, and K2 routes with it. The exact division rounds
    otherwise just below sqrt(area) = 112 and 224, and sends such a roi to
    the level below."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0] + 1.0) * (rois[..., 3] - rois[..., 1] + 1.0))
    lvl = torch.floor(torch.log2(scale * _reciprocal(finest_scale) + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def axis_samples(
    start: torch.Tensor,  # (N,) f32: each roi's start on its level, along the axis
    bin_size: torch.Tensor,  # (N,) f32: its bin size
    size: torch.Tensor,  # (N,) int64: its level's extent along the axis (H_l or W_l)
    out_size: int = 7,
    sample_num: int = 2,
):
    """One axis of every roi's bilinear samples: the table K2 and K2b build
    once a roi. Sample k lies in bin k // sample_num at start + bin_size *
    (k // sample_num + (k % sample_num + 0.5) / sample_num), with K2's rules:
    outside [-1, size] it is invalid, it clamps at 0, and from size - 1 on its
    low and high corner are both the last row (column).

    Returns (low, high) (N, n) int64, (frac, 1 - frac) (N, n) f32, the
    weights of the high and the low corner, and valid (N, n) bool; n =
    out_size * sample_num."""
    dev = start.device
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    # divisions by tensors: PyTorch's CUDA division by a number multiplies by
    # its reciprocal, which rounds differently from the kernel's `/` (and from
    # eager XLA's; under jit XLA multiplies by the f32 reciprocal too)
    sub = torch.arange(sample_num, dtype=torch.float32, device=dev) + 0.5
    sub = sub / torch.full_like(sub, sample_num)
    pos = (grid[:, None] + sub[None, :]).reshape(-1)  # (n,)
    t = start[:, None] + bin_size[:, None] * pos
    size = size[:, None]
    valid = (t >= -1.0) & (t <= size.float())
    t = t.clamp(min=0.0)
    low = torch.floor(t).to(torch.int64)
    last = low >= size - 1
    low = torch.where(last, size - 1, low)
    t = torch.where(last, low.float(), t)
    high = torch.where(last, size - 1, low + 1)
    frac = t - low
    return low, high, frac, 1.0 - frac, valid


def sample_points(
    shapes: Sequence[tuple[int, int]],  # per level (H_l, W_l)
    rois: torch.Tensor,  # (B, R, 4)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    levels: Optional[torch.Tensor] = None,  # (B, R) routed levels; map_roi_levels' when None
):
    """Where every bilinear sample of every roi reads, and with what weight,
    from the two axis tables (`axis_samples`).

    The pyramid of each image is taken flattened, level after level, each
    level row-major; image b starts at b * sum(H_l * W_l). Returns
    (index (4, B * R, n, n) int64 corner positions in that flat pyramid,
    weight (4, B * R, n, n) f32, valid (B * R, n, n) bool), n = out_size *
    sample_num, corners in the order (low, low), (low, high), (high, low),
    (high, high) of (y, x)."""
    b, r = rois.shape[:2]
    dev = rois.device
    if levels is None:
        levels = map_roi_levels(rois, len(shapes), finest_scale)
    lvls = levels.long().reshape(-1)  # (B * R,)
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    h = torch.tensor([s[0] for s in shapes], device=dev)[lvls]
    w = torch.tensor([s[1] for s in shapes], device=dev)[lvls]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)[lvls]
    image = torch.arange(b, device=dev).repeat_interleave(r)
    base = (image * sum(sizes) + offsets[lvls])[:, None, None]

    rois = rois.float().reshape(-1, 4)
    start_w = rois[:, 0] * scale
    start_h = rois[:, 1] * scale
    end_w = (rois[:, 2] + 1.0) * scale
    end_h = (rois[:, 3] + 1.0) * scale
    bin_w = (end_w - start_w).clamp(min=0.0) / torch.full_like(end_w, out_size)
    bin_h = (end_h - start_h).clamp(min=0.0) / torch.full_like(end_h, out_size)
    y_low, y_high, ly, hy, vy = axis_samples(start_h, bin_h, h, out_size, sample_num)
    x_low, x_high, lx, hx, vx = axis_samples(start_w, bin_w, w, out_size, sample_num)

    row_low = (y_low * w[:, None])[:, :, None]
    row_high = (y_high * w[:, None])[:, :, None]
    x_low, x_high = x_low[:, None, :], x_high[:, None, :]
    index = torch.stack(
        [base + row_low + x_low, base + row_low + x_high, base + row_high + x_low, base + row_high + x_high]
    )
    ly, hy, lx, hx = ly[:, :, None], hy[:, :, None], lx[:, None, :], hx[:, None, :]
    weight = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx])
    valid = vy[:, :, None] & vx[:, None, :]
    return index, weight, valid


def multilevel_roi_align_reference(
    feats: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C)
    rois: torch.Tensor,  # (B, R, 4)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
) -> torch.Tensor:
    """Plain version of K2: (B, R, S, S, C) in the feature dtype."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    index, weight, valid = sample_points(shapes, rois, strides, out_size, sample_num, finest_scale)
    flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1).reshape(-1, c)
    corner = lambda i: flat.index_select(0, index[i].reshape(-1)).reshape(*index.shape[1:], c).float()
    vals = (
        weight[0, ..., None] * corner(0)
        + weight[1, ..., None] * corner(1)
        + weight[2, ..., None] * corner(2)
        + weight[3, ..., None] * corner(3)
    )
    vals = torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    vals = vals.reshape(b, r, out_size, sample_num, out_size, sample_num, c)
    acc = None
    for iy in range(sample_num):
        for ix in range(sample_num):
            v = vals[:, :, :, iy, :, ix]
            acc = v if acc is None else acc + v
    return (acc / torch.full_like(acc, sample_num * sample_num)).to(feats[0].dtype)


def multilevel_roi_align_backward_reference(
    grad: torch.Tensor,  # (B, R, S, S, C)
    rois: torch.Tensor,  # (B, R, 4)
    shapes: Sequence[tuple[int, int]],  # per level (H_l, W_l)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    dtype: torch.dtype = torch.float32,
    levels: Optional[torch.Tensor] = None,  # (B, R) routed levels; map_roi_levels' when None
) -> list[torch.Tensor]:
    """Plain version of K2b: the transpose of K2, per level (B, H_l, W_l, C)
    in `dtype`. Each sample adds weight * grad / sample_num^2 to the four
    corners it reads (an `index_add_` over `sample_points`), summed in f32."""
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    index, weight, valid = sample_points(shapes, rois, strides, out_size, sample_num, finest_scale, levels)
    g = grad.float()
    g = g / torch.full_like(g, sample_num * sample_num)
    n = out_size * sample_num
    g = g[:, :, :, None, :, None].expand(-1, -1, -1, sample_num, -1, sample_num, -1)
    g = g.reshape(b * r, n, n, c)
    g = torch.where(valid[..., None], g, torch.zeros((), device=g.device))
    sizes = [h * w for h, w in shapes]
    buf = torch.zeros(b * sum(sizes), c, device=grad.device)
    for q in range(4):
        buf.index_add_(0, index[q].reshape(-1), (weight[q][..., None] * g).reshape(-1, c))
    levels = buf.reshape(b, sum(sizes), c).split(sizes, dim=1)
    return [lv.reshape(b, h, w, c).to(dtype) for lv, (h, w) in zip(levels, shapes)]


@functools.lru_cache(maxsize=None)
def _level_args(shapes: tuple, strides: tuple) -> tuple:
    """The addresses of the launchers' host arrays of heights, widths and
    scales for this pyramid; the cache keeps the arrays alive."""
    n = len(shapes)
    arrays = (
        (ctypes.c_int * n)(*[h for h, _ in shapes]),
        (ctypes.c_int * n)(*[w for _, w in shapes]),
        (ctypes.c_float * n)(*[1.0 / s for s in strides]),
    )
    return arrays, tuple(map(ctypes.addressof, arrays))


def _check_sample_num(sample_num: int) -> None:
    if not 1 <= sample_num <= 4:
        raise ValueError(f"the roi_align kernels take sample_num 1-4, got {sample_num}")


def roi_align_forward(
    feats: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C), contiguous
    rois: torch.Tensor,  # (B, R, 4) f32
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    return_levels: bool = False,
):
    """K2: (B, R, S, S, C) pooled features, each roi on its routed level;
    with `return_levels`, also the (B, R) int32 levels (K2 writes them)."""
    if rois.device.type == "cpu":
        out = multilevel_roi_align_reference(feats, rois, strides, out_size, sample_num, finest_scale)
        return (out, map_roi_levels(rois, len(feats), finest_scale)) if return_levels else out
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align kernel takes f32 or bf16 features, got {dtype}")
    if len(feats) != len(strides) or not 1 <= len(feats) <= 8:
        raise ValueError(f"{len(feats)} feature levels and {len(strides)} strides")
    _check_sample_num(sample_num)
    for i, f in enumerate(feats):
        cuda.check(f, dtype, (b, f.shape[1], f.shape[2], c), f"feats[{i}]")
    cuda.check(rois, torch.float32, (b, r, 4), "rois")
    out = torch.empty(b, r, out_size, out_size, c, dtype=dtype, device=rois.device)
    levels = torch.empty(b, r, dtype=torch.int32, device=rois.device) if return_levels else None
    if b * r:
        n = len(feats)
        ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats])  # lives until the launch returns
        _, lv = _level_args(tuple((f.shape[1], f.shape[2]) for f in feats), tuple(strides))
        cuda.ROI_ALIGN(
            _DTYPE_CODES[dtype], n, ctypes.addressof(ptrs), *lv,
            rois.data_ptr(), 0 if levels is None else levels.data_ptr(), out.data_ptr(),
            b, r, c, out_size, sample_num, finest_scale,
        )
    return (out, levels) if return_levels else out


def roi_align_backward(
    grad: torch.Tensor,  # (B, R, S, S, C) f32 or bf16
    rois: torch.Tensor,  # (B, R, 4) f32
    shapes: Sequence[tuple[int, int]],  # per level (H_l, W_l)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    dtype: torch.dtype = torch.float32,
    levels: Optional[torch.Tensor] = None,  # (B, R) int32 from K2; map_roi_levels' when None
) -> list[torch.Tensor]:
    """K2b: the features' gradient, per level (B, H_l, W_l, C) in `dtype` (f32
    or bf16), accumulated in one f32 buffer that holds level after level and
    (for bf16) rounded once by the launch's cast pass; the levels are views
    of one allocation."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_backward_reference(
            grad, rois, shapes, strides, out_size, sample_num, finest_scale, dtype, levels
        )
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    if grad.dtype not in _DTYPE_CODES or dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align backward takes and gives f32 or bf16, got {grad.dtype} -> {dtype}")
    if len(shapes) != len(strides) or not 1 <= len(shapes) <= 8:
        raise ValueError(f"{len(shapes)} feature levels and {len(strides)} strides")
    _check_sample_num(sample_num)
    cuda.check(grad, grad.dtype, (b, r, out_size, out_size, c), "grad")
    cuda.check(rois, torch.float32, (b, r, 4), "rois")
    if levels is None:
        levels = map_roi_levels(rois, len(shapes), finest_scale)
    cuda.check(levels, torch.int32, (b, r), "levels")
    sizes = [b * h * w * c for h, w in shapes]
    acc = torch.empty(sum(sizes), dtype=torch.float32, device=rois.device)
    out = acc if dtype is torch.float32 else torch.empty(sum(sizes), dtype=dtype, device=rois.device)
    _, lv = _level_args(tuple(shapes), tuple(strides))
    cuda.ROI_ALIGN_BACKWARD(
        _DTYPE_CODES[grad.dtype], len(shapes), *lv,
        rois.data_ptr(), levels.data_ptr(), grad.data_ptr(), acc.data_ptr(),
        0 if out is acc else out.data_ptr(),
        b, r, c, out_size, sample_num,
    )
    return [g.view(b, h, w, c) for g, (h, w) in zip(out.split(sizes), shapes)]


class _RoIAlign(torch.autograd.Function):
    """K2 forward, K2b backward; the rois get no gradient. When a feature
    needs a gradient, K2 also writes each roi's level, which K2b reuses."""

    @staticmethod
    def forward(ctx, rois, strides, out_size, sample_num, finest_scale, *feats):
        ctx.args = (tuple((f.shape[1], f.shape[2]) for f in feats), strides, out_size, sample_num, finest_scale)
        ctx.dtype = feats[0].dtype
        if not any(ctx.needs_input_grad[5:]):
            return roi_align_forward(feats, rois, strides, out_size, sample_num, finest_scale)
        out, levels = roi_align_forward(feats, rois, strides, out_size, sample_num, finest_scale, return_levels=True)
        ctx.save_for_backward(rois, levels)
        return out

    @staticmethod
    def backward(ctx, grad):
        if not any(ctx.needs_input_grad[5:]):  # only the rois asked, and they get none
            return (None,) * len(ctx.needs_input_grad)
        rois, levels = ctx.saved_tensors
        grads = roi_align_backward(grad.contiguous(), rois, *ctx.args, dtype=ctx.dtype, levels=levels)
        return (None, None, None, None, None, *grads)


def multilevel_roi_align(
    feats: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C), contiguous
    rois: torch.Tensor,  # (B, R, 4) f32
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
) -> torch.Tensor:
    """(B, R, S, S, C) pooled features, each roi on its routed level; K2
    forward, K2b for the features' gradient."""
    return _RoIAlign.apply(rois, tuple(strides), out_size, sample_num, finest_scale, *feats)
