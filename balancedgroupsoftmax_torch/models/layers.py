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


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
