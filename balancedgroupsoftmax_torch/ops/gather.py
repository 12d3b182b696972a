"""Lane gather from shared coordinate planes: kernel K6 and its plain version.

`gather_lanes` replaces JAX `pallas/gather.py` `gather_lanes_matmul` (:59):
out[g, r, k] = planes[g // groups_per_plane, r, idx[g, k]], exact in f32, an
index outside [0, N) giving 0 as the TPU's one-hot does. It launches
`bags_gather_lanes` of `csrc/gather.cu` on a CUDA tensor and runs
`gather_lanes_reference` on a CPU tensor. Consecutive groups share one plane,
which is never replicated: in the class-agnostic multiclass NMS each image's
decoded boxes serve all of its classes.
"""

from __future__ import annotations

import torch

from .. import cuda

_F32, _I32 = torch.float32, torch.int32


def _shape(planes: torch.Tensor, idx: torch.Tensor, groups_per_plane: int):
    p, r, n = planes.shape
    g, k = idx.shape
    if g != p * groups_per_plane:
        raise ValueError(f"{g} groups of indices for {p} planes x {groups_per_plane} groups each")
    return p, r, n, g, k


def gather_lanes_reference(planes: torch.Tensor, idx: torch.Tensor, groups_per_plane: int = 1) -> torch.Tensor:
    """Plain version of K6: planes (P, R, N), idx (G, K) int -> (G, R, K) f32."""
    p, r, n, g, k = _shape(planes, idx, groups_per_plane)
    inside = (idx >= 0) & (idx < n)
    safe = torch.where(inside, idx, torch.zeros_like(idx)).long().view(p, groups_per_plane, 1, k)
    src = planes.float()[:, None].expand(p, groups_per_plane, r, n)
    out = torch.gather(src, 3, safe.expand(-1, -1, r, -1))
    out = torch.where(inside.view(p, groups_per_plane, 1, k), out, torch.zeros_like(out))
    return out.reshape(g, r, k)


def gather_lanes(planes: torch.Tensor, idx: torch.Tensor, groups_per_plane: int = 1) -> torch.Tensor:
    """K6: planes (P, R, N) f32, idx (G, K) int32 with G = P * groups_per_plane
    -> (G, R, K) f32, bit-equal to the plain version. At the cascade's shape
    the host's cost of a launch, not the kernel, sets K6's time, so the path
    is kept short: the shapes are read from the tensors themselves, so only
    device, dtype and layout are checked (`cuda.check` runs only to refuse),
    and one allocation."""
    p, r, n = planes.shape
    g, k = idx.shape
    if g != p * groups_per_plane:
        raise ValueError(f"{g} groups of indices for {p} planes x {groups_per_plane} groups each")
    if not (planes.is_cuda and idx.is_cuda and planes.dtype is _F32 and idx.dtype is _I32
            and planes.is_contiguous() and idx.is_contiguous()):
        if planes.is_cpu:
            return gather_lanes_reference(planes, idx, groups_per_plane)
        cuda.check(planes, torch.float32, (p, r, n), "planes")  # raises, saying what the kernel takes
        cuda.check(idx, torch.int32, (g, k), "idx")
    out = planes.new_empty(g, r, k)
    if g and k and r:
        cuda.GATHER_LANES(planes.data_ptr(), idx.data_ptr(), out.data_ptr(), g, r, k, n, groups_per_plane)
    return out
