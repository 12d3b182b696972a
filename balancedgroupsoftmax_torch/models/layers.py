"""Convolution and linear layers that compute in their input's dtype.

The JAX modules keep f32 parameters and cast them, and the input, to the
model dtype at each call (flax `dtype=`). These layers do the same: the
detector casts the image to its dtype once, and every layer casts its f32
weights to the dtype of what it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm` on NCHW input: the statistics in f32 as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), epsilon 1e-6 (flax's
    default; torch's is 1e-5), the normalisation in f32, the result in the
    input's dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.num_groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp(min=0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)
        expand = lambda t: t.repeat_interleave(c // self.num_groups, dim=1).reshape(shape)
        mul = torch.rsqrt(expand(var) + self.eps) * self.weight.reshape(1, c, *shape[2:])
        y = (x - expand(mean)) * mul + self.bias.reshape(1, c, *shape[2:])
        return y.to(x.dtype)
