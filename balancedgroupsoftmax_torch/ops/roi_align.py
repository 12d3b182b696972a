"""Multi-level RoIAlign: kernel K2, its gradient K2b, and their plain versions.

`multilevel_roi_align` replaces JAX `pallas/roi_align.py`
`multilevel_roi_align_pallas` (:511) with its custom VJP (:510-537): a
`torch.autograd.Function` whose forward is K2 and whose backward is K2b, the
gradient for the features (none for the rois, as in JAX). Each launches its
CUDA kernel of `csrc/roi_align.cu` on CUDA tensors and runs its plain version
(`multilevel_roi_align_reference`, `multilevel_roi_align_backward_reference`)
on CPU tensors.

Semantics (JAX `ops/roi_align.py` `roi_align` :67,
`map_roi_levels` :104, `multilevel_roi_align_reference` :113): every roi is
routed to one FPN level by floor(log2(sqrt(area) / finest_scale + 1e-6)); it
spans [x1 * scale, (x2 + 1) * scale); each of the S x S bins averages
sample_num^2 bilinear samples with the reference CUDA kernel's boundary rules.
Features and output are channels-last, (B, H, W, C) and (B, R, S, S, C), in the
feature dtype; sums are taken in f32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56) -> torch.Tensor:
    """(...,) int32 FPN level per roi (single_level.py:54-73)."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0] + 1.0) * (rois[..., 3] - rois[..., 1] + 1.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def sample_points(
    shapes: Sequence[tuple[int, int]],  # per level (H_l, W_l)
    rois: torch.Tensor,  # (B, R, 4)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
):
    """Where every bilinear sample of every roi reads, and with what weight.

    The pyramid of each image is taken flattened, level after level, each
    level row-major; image b starts at b * sum(H_l * W_l). Returns
    (index (4, B * R, n, n) int64 corner positions in that flat pyramid,
    weight (4, B * R, n, n) f32, valid (B * R, n, n) bool), n = out_size *
    sample_num, corners in the order (low, low), (low, high), (high, low),
    (high, high) of (y, x)."""
    b, r = rois.shape[:2]
    dev = rois.device
    lvls = map_roi_levels(rois, len(shapes), finest_scale).long().reshape(-1)  # (B * R,)
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    h = torch.tensor([s[0] for s in shapes], device=dev)[lvls][:, None, None]
    w = torch.tensor([s[1] for s in shapes], device=dev)[lvls][:, None, None]
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)[lvls]
    image = torch.arange(b, device=dev).repeat_interleave(r)
    base = (image * sum(sizes) + offsets[lvls])[:, None, None]

    rois = rois.float().reshape(-1, 4)
    start_w = rois[:, 0] * scale
    start_h = rois[:, 1] * scale
    end_w = (rois[:, 2] + 1.0) * scale
    end_h = (rois[:, 3] + 1.0) * scale
    # divisions by tensors: PyTorch's CUDA division by a number multiplies by
    # its reciprocal, which rounds differently from the kernel's (and XLA's) `/`
    bin_w = (end_w - start_w).clamp(min=0.0) / torch.full_like(end_w, out_size)
    bin_h = (end_h - start_h).clamp(min=0.0) / torch.full_like(end_h, out_size)
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub = torch.arange(sample_num, dtype=torch.float32, device=dev) + 0.5
    sub = sub / torch.full_like(sub, sample_num)
    pos = (grid[:, None] + sub[None, :]).reshape(-1)  # (n,)
    n = pos.shape[0]
    y = (start_h[:, None] + bin_h[:, None] * pos)[:, :, None].expand(-1, -1, n)
    x = (start_w[:, None] + bin_w[:, None] * pos)[:, None, :].expand(-1, n, -1)

    valid = (y >= -1.0) & (y <= h.float()) & (x >= -1.0) & (x <= w.float())
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.floor(y).to(torch.int64)
    x_low = torch.floor(x).to(torch.int64)
    cy = y_low >= h - 1
    y_low = torch.where(cy, h - 1, y_low)
    y = torch.where(cy, y_low.float(), y)
    y_high = torch.where(cy, h - 1, y_low + 1)
    cx = x_low >= w - 1
    x_low = torch.where(cx, w - 1, x_low)
    x = torch.where(cx, x_low.float(), x)
    x_high = torch.where(cx, w - 1, x_low + 1)
    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    index = torch.stack(
        [base + y_low * w + x_low, base + y_low * w + x_high,
         base + y_high * w + x_low, base + y_high * w + x_high]
    )
    weight = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx])
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
) -> list[torch.Tensor]:
    """Plain version of K2b: the transpose of K2, per level (B, H_l, W_l, C)
    in `dtype`. Each sample adds weight * grad / sample_num^2 to the four
    corners it reads (an `index_add_` over `sample_points`), summed in f32."""
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    index, weight, valid = sample_points(shapes, rois, strides, out_size, sample_num, finest_scale)
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


def _level_args(shapes: Sequence[tuple[int, int]], strides: Sequence[int]):
    n = len(shapes)
    return (
        (ctypes.c_int * n)(*[h for h, _ in shapes]),
        (ctypes.c_int * n)(*[w for _, w in shapes]),
        (ctypes.c_float * n)(*[1.0 / s for s in strides]),
    )


def roi_align_forward(
    feats: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C), contiguous
    rois: torch.Tensor,  # (B, R, 4) f32
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
) -> torch.Tensor:
    """K2: (B, R, S, S, C) pooled features, each roi on its routed level."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_reference(feats, rois, strides, out_size, sample_num, finest_scale)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align kernel takes f32 or bf16 features, got {dtype}")
    if len(feats) != len(strides):
        raise ValueError(f"{len(feats)} feature levels but {len(strides)} strides")
    for i, f in enumerate(feats):
        cuda.check(f, dtype, (b, f.shape[1], f.shape[2], c), f"feats[{i}]")
    cuda.check(rois, torch.float32, (b, r, 4), "rois")
    levels = map_roi_levels(rois, len(feats), finest_scale)
    out = torch.empty(b, r, out_size, out_size, c, dtype=dtype, device=rois.device)
    if out.numel() == 0:
        return out
    n = len(feats)
    cuda.ROI_ALIGN(
        _DTYPE_CODES[dtype],
        n,
        (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats]),
        *_level_args([(f.shape[1], f.shape[2]) for f in feats], strides),
        rois.data_ptr(),
        levels.data_ptr(),
        out.data_ptr(),
        b, r, c, out_size, sample_num,
    )
    return out


def roi_align_backward(
    grad: torch.Tensor,  # (B, R, S, S, C) f32 or bf16
    rois: torch.Tensor,  # (B, R, 4) f32
    shapes: Sequence[tuple[int, int]],  # per level (H_l, W_l)
    strides: Sequence[int],
    out_size: int = 7,
    sample_num: int = 2,
    finest_scale: int = 56,
    dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """K2b: the features' gradient, per level (B, H_l, W_l, C) in `dtype`,
    accumulated in one zeroed f32 buffer that holds level after level."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_backward_reference(
            grad, rois, shapes, strides, out_size, sample_num, finest_scale, dtype
        )
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    if grad.dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align backward takes an f32 or bf16 gradient, got {grad.dtype}")
    if len(shapes) != len(strides) or not 1 <= len(shapes) <= 8:
        raise ValueError(f"{len(shapes)} feature levels and {len(strides)} strides")
    cuda.check(grad, grad.dtype, (b, r, out_size, out_size, c), "grad")
    cuda.check(rois, torch.float32, (b, r, 4), "rois")
    sizes = [b * h * w * c for h, w in shapes]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=rois.device)
    if grad.numel():
        cuda.ROI_ALIGN_BACKWARD(
            _DTYPE_CODES[grad.dtype],
            len(shapes),
            *_level_args(shapes, strides),
            rois.data_ptr(),
            map_roi_levels(rois, len(shapes), finest_scale).data_ptr(),
            grad.data_ptr(),
            buf.data_ptr(),
            b, r, c, out_size, sample_num,
        )
    return [lv.view(b, h, w, c).to(dtype) for lv, (h, w) in zip(buf.split(sizes), shapes)]


class _RoIAlign(torch.autograd.Function):
    """K2 forward, K2b backward; the rois get no gradient."""

    @staticmethod
    def forward(ctx, rois, strides, out_size, sample_num, finest_scale, *feats):
        ctx.save_for_backward(rois)
        ctx.args = (tuple((f.shape[1], f.shape[2]) for f in feats), strides, out_size, sample_num, finest_scale)
        ctx.dtype = feats[0].dtype
        return roi_align_forward(feats, rois, strides, out_size, sample_num, finest_scale)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        grads = roi_align_backward(grad.contiguous(), rois, *ctx.args, dtype=ctx.dtype)
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
