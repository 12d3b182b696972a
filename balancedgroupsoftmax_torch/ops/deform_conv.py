"""Deformable convolution v1/v2: kernel K7, its plain version, and the layer.

`deform_conv2d` replaces JAX `pallas/deform_conv.py` `deform_conv2d_fused`
(:501): the forward of a deformable convolution with the grouped weight
contracted in the same kernel. It launches `bags_deform_conv_forward` of
`csrc/deform_conv.cu` on a CUDA tensor and runs `deform_conv2d_reference` on a
CPU tensor.

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

from typing import Optional

import torch
from torch import nn

from .. import cuda
from ..models.layers import Conv2d

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


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
    b, h, w, c = x.shape
    _, ho, wo, _ = offsets.shape
    dev = x.device
    tap_y = torch.arange(kh, dtype=torch.float32, device=dev).repeat_interleave(kw)
    tap_x = torch.arange(kw, dtype=torch.float32, device=dev).repeat(kh)
    base_yi = torch.arange(ho, device=dev) * stride - padding
    base_xi = torch.arange(wo, device=dev) * stride - padding
    base_y = base_yi.float()[:, None, None]
    base_x = base_xi.float()[None, :, None]
    dy = offsets[..., 0::2].float()
    dx = offsets[..., 1::2].float()
    if shift_window > 0:
        d = float(shift_window)
        rel_y = tap_y + dy.clamp(-d, d)
        rel_x = tap_x + dx.clamp(-d, d)
        ys = base_y + rel_y
        xs = base_x + rel_x
        fy = torch.floor(rel_y)
        fx = torch.floor(rel_x)
        ly = rel_y - fy
        lx = rel_x - fx
        y0 = base_yi[:, None, None] + fy.long()
        x0 = base_xi[None, :, None] + fx.long()
    else:
        ys = (base_y + tap_y) + dy
        xs = (base_x + tap_x) + dx
        fy = torch.floor(ys)
        fx = torch.floor(xs)
        ly = ys - fy
        lx = xs - fx
        y0 = fy.long()
        x0 = fx.long()
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    hy = 1.0 - ly
    hx = 1.0 - lx
    flat = x.reshape(-1, c)
    image = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = image + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c).float()
        return torch.where(inside[..., None], v, torch.zeros((), device=dev))

    acc = (hy * hx)[..., None] * corner(y0, x0)
    acc = acc + (hy * lx)[..., None] * corner(y0, x0 + 1)
    acc = acc + (ly * hx)[..., None] * corner(y0 + 1, x0)
    acc = acc + (ly * lx)[..., None] * corner(y0 + 1, x0 + 1)
    acc = torch.where(valid[..., None], acc, torch.zeros((), device=dev))
    return acc.to(x.dtype)


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
    """K7: (B, Ho, Wo, C_out) in x's dtype."""
    if x.device.type == "cpu":
        return deform_conv2d_reference(x, offsets, weight, mask, stride, padding, groups, shift_window)
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
    out = torch.empty(b, ho, wo, c_out, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    cuda.DEFORM_CONV(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(), offsets.data_ptr(), None if mask is None else mask.data_ptr(),
        weight.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, c_out, kh, kw, stride, padding, groups, shift_window,
    )
    return out


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, C_out, Ho, Wo), in x's dtype."""
        taps = self.kernel_size**2
        off = self.conv_offset(x).float()
        offsets = off[:, : 2 * taps].permute(0, 2, 3, 1).contiguous()
        mask = torch.sigmoid(off[:, 2 * taps :]).permute(0, 2, 3, 1).contiguous() if self.modulated else None
        out = deform_conv2d(
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

