"""Lane gather from shared coordinate tables: kernel K6 and its plain version.

`gather_lanes` replaces JAX `pallas/gather.py` `gather_lanes_matmul` (:59):
out[g, r, k] = planes[g // groups_per_plane, r, idx[g, k]], exact in f32, an
index outside [0, N) giving 0 as the TPU's one-hot does. It launches
`bags_gather_lanes` of `csrc/gather.cu` on a CUDA tensor and runs
`gather_lanes_reference` on a CPU tensor. Consecutive groups share one
table, which is never replicated: in the class-agnostic multiclass NMS each
image's decoded boxes serve all of its classes. The (P, R, N) argument keeps
the JAX function's shape; on the card it may be contiguous planes or the
transposed view of contiguous (P, N, R) rows, so the decoded boxes go in
where they lie (`table_layout`).
"""

from __future__ import annotations

import torch

from .. import cuda

_F32, _I32 = torch.float32, torch.int32
PLANES, ROWS = 0, 1  # the layouts K6 takes (csrc/gather.cu)


def table_layout(planes: torch.Tensor):
    """PLANES where (P, R, N) `planes` is contiguous, ROWS where it is the
    transposed view of contiguous (P, N, R) rows (strides (N R, 1, R), what
    `boxes.transpose(1, 2)` gives), None for any other layout."""
    _, r, n = planes.shape
    stride = planes.stride()  # the strides first: this runs at every launch
    if stride == (r * n, n, 1) or planes.is_contiguous():
        return PLANES
    if stride == (n * r, 1, r) or planes.transpose(1, 2).is_contiguous():
        return ROWS
    return None


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


def _refuse(planes: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise, saying what the kernel takes."""
    cuda.check(idx, _I32, tuple(idx.shape), "idx")
    if not (planes.is_cuda and planes.dtype is _F32):
        raise ValueError(f"planes: the kernel takes a CUDA float32 tensor, got {planes.dtype} on {planes.device}")
    raise ValueError(
        f"planes: the kernel takes contiguous (P, R, N) planes or the transposed view of contiguous (P, N, R) "
        f"rows, got shape {tuple(planes.shape)} with strides {planes.stride()}"
    )


def gather_lanes(planes: torch.Tensor, idx: torch.Tensor, groups_per_plane: int = 1) -> torch.Tensor:
    """K6: planes (P, R, N) f32, contiguous or the transposed view of
    contiguous (P, N, R) rows, idx (G, K) int32 with G = P * groups_per_plane
    -> (G, R, K) f32, bit-equal to the plain version. On a CUDA tensor any
    other layout or dtype raises, with no launch. At the cascade's shape the
    host's cost of a launch, not the kernel, sets K6's time, so the path is
    kept short: the shapes are read from the tensors themselves, so only
    device, dtype and layout are checked, and one allocation."""
    p, r, n = planes.shape
    g, k = idx.shape
    if g != p * groups_per_plane:
        raise ValueError(f"{g} groups of indices for {p} planes x {groups_per_plane} groups each")
    rows = table_layout(planes)
    if not (planes.is_cuda and idx.is_cuda and planes.dtype is _F32 and idx.dtype is _I32
            and rows is not None and idx.is_contiguous()):
        if planes.is_cpu:
            return gather_lanes_reference(planes, idx, groups_per_plane)
        _refuse(planes, idx)
    out = planes.new_empty(g, r, k)
    if g and k and r:
        cuda.GATHER_LANES(planes.data_ptr(), idx.data_ptr(), out.data_ptr(), g, r, k, n, groups_per_plane, rows)
    return out
