"""The grid head of Grid R-CNN, its targets and its box decoding (JAX
`models/grid_head.py`: `GridHead` :23, `grid_targets` :70, `grid_to_boxes`
:106).

RoI features -> eight 3x3 convs with GroupNorm (8 groups) and relu -> one
3x3 conv a point of the 3x3 grid of box points -> each point's map plus a
3x3 conv of each of its four neighbours' maps, relu (the reference's point
fusion) -> two 2x2 stride-2 transposed convs a point (relu between) -> a
heatmap a point, 4x the pooled size. The layers keep the flax names
(`conv{i}`, `gn{i}`, `point{i}`, `fuse{i}_{j}`, `up1_{i}`, `up2_{i}`), so
`convert.py` maps them one to one. Heatmaps are (N, 9, hm, hm), point k =
row k // 3, column k % 3 of the grid.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d, GroupNorm

GRID_POINTS = 9  # 3 x 3


def _neighbours(i: int) -> list:
    """The grid points next to point i (4-neighbours), in ascending order."""
    r, c = divmod(i, 3)
    return [j for j in range(GRID_POINTS) if abs(r - j // 3) + abs(c - j % 3) == 1]


class GridHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_convs: int = 8, conv_channels: int = 64, heatmap_size: int = 56):
        super().__init__()
        self.num_convs = num_convs
        self.heatmap_size = heatmap_size
        half = conv_channels // 2
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(in_channels if i == 0 else conv_channels, conv_channels, 3, padding=1))
            self.add_module(f"gn{i}", GroupNorm(8, conv_channels))
        for i in range(GRID_POINTS):
            self.add_module(f"point{i}", Conv2d(conv_channels, half, 3, padding=1))
            for j in _neighbours(i):
                self.add_module(f"fuse{i}_{j}", Conv2d(half, half, 3, padding=1))
        for i in range(GRID_POINTS):
            self.add_module(f"up1_{i}", ConvTranspose2d(half, half, 2, stride=2))
            self.add_module(f"up2_{i}", ConvTranspose2d(half, 1, 2, stride=2))

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(N, C, S, S) RoI features -> (N, 9, 4S, 4S) point heatmap logits."""
        x = roi_feats
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        points = [getattr(self, f"point{i}")(x) for i in range(GRID_POINTS)]
        outs = []
        for i in range(GRID_POINTS):
            acc = points[i]
            for j in _neighbours(i):
                acc = acc + getattr(self, f"fuse{i}_{j}")(points[j])
            y = F.relu(getattr(self, f"up1_{i}")(F.relu(acc)))
            outs.append(getattr(self, f"up2_{i}")(y)[:, 0])
        return torch.stack(outs, dim=1)


def _point_coords(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3x3 grid points of boxes (N, 4): x and y (N, 9), point k = (row
    k // 3, column k % 3), x from the column, y from the row."""
    gx = torch.stack([boxes[:, 0], (boxes[:, 0] + boxes[:, 2]) / 2, boxes[:, 2]], dim=-1)
    gy = torch.stack([boxes[:, 1], (boxes[:, 1] + boxes[:, 3]) / 2, boxes[:, 3]], dim=-1)
    return gx.repeat(1, 3), gy.repeat_interleave(3, dim=-1)


def _extent(rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rois' widths and heights with the +1 convention, at least 1."""
    one = torch.ones((), device=rois.device)
    return torch.maximum(rois[:, 2] - rois[:, 0] + 1.0, one), torch.maximum(rois[:, 3] - rois[:, 1] + 1.0, one)


def grid_targets(
    rois: torch.Tensor,  # (N, 4) positive boxes
    gt_boxes: torch.Tensor,  # (N, 4) their assigned gts
    heatmap_size: int = 56,
    radius: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heat (N, 9, hm, hm) f32, valid (N, 9) bool): each gt grid point mapped
    into its roi's heatmap frame; a heatmap is 1 on the cells within
    `radius` of its point, 0 everywhere for a point outside the roi. JAX's
    order of operations and exact comparisons."""
    w, h = _extent(rois)
    px, py = _point_coords(gt_boxes)
    hx = (px - rois[:, 0, None]) / w[:, None] * heatmap_size
    hy = (py - rois[:, 1, None]) / h[:, None] * heatmap_size
    valid = (hx >= 0) & (hx < heatmap_size) & (hy >= 0) & (hy < heatmap_size)
    cells = torch.arange(heatmap_size, dtype=torch.float32, device=rois.device)
    d2 = (cells[None, None, :, None] - hy[:, :, None, None]) ** 2 + (cells[None, None, None, :] - hx[:, :, None, None]) ** 2
    heat = (d2 <= radius**2).float()
    return heat * valid[:, :, None, None], valid


def grid_to_boxes(
    heatmaps: torch.Tensor,  # (N, 9, hm, hm) logits
    rois: torch.Tensor,  # (N, 4)
) -> torch.Tensor:
    """(N, 4) boxes from the heatmaps' first maxima (torch.argmax and
    jnp.argmax both take the first of tied maxima): each point at its cell's
    centre in the roi's frame, each edge the mean of its three points."""
    n, _, hm, _ = heatmaps.shape
    idx = heatmaps.reshape(n, GRID_POINTS, hm * hm).argmax(dim=-1)
    hm_t = torch.tensor(float(hm), device=heatmaps.device)  # divided by a tensor, as JAX divides
    py = (idx // hm).float() + 0.5
    px = (idx % hm).float() + 0.5
    w, h = _extent(rois)
    ix = rois[:, 0, None] + px / hm_t * w[:, None]
    iy = rois[:, 1, None] + py / hm_t * h[:, None]
    left = ix[:, [0, 3, 6]].mean(dim=1)
    right = ix[:, [2, 5, 8]].mean(dim=1)
    top = iy[:, [0, 1, 2]].mean(dim=1)
    bottom = iy[:, [6, 7, 8]].mean(dim=1)
    return torch.stack([left, top, right, bottom], dim=-1)
