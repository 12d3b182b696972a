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

from typing import NamedTuple, Optional

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
    """K7: (B, Ho, Wo, C_out) in x's dtype. In bf16 the kernel takes C a
    multiple of 8 and C / groups a multiple of 4, and refuses others."""
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

