"""K6 (lane gather from shared coordinate planes) of the PyTorch port
against the JAX package. On the CPU the port's wrapper runs its plain
version; the JAX side runs `pallas/gather.py gather_lanes_matmul` in
interpret mode. A gather selects input values, so the outputs are compared
bit for bit, on f32 values that bf16 cannot hold (the TPU kernel's three-way
bf16 split must rebuild them exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.pallas.gather import gather_lanes_matmul
from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch.ops.gather import PLANES, ROWS, gather_lanes, table_layout
from test_torch_cuda import lane_gather_case


@pytest.mark.parametrize(
    "p,groups_per_plane,k,n",
    [
        (5, 1, 30, 100),  # a plane per group
        (2, 8, 30, 100),  # shared planes, block of 8 groups
        (2, 6, 130, 200),  # shared, the block halves to 2; K and N past one lane tile
        (3, 3, 7, 9),  # odd sizes, block 1
    ],
)
def test_gather_matches_pallas_interpret_bit_for_bit(p, groups_per_plane, k, n):
    planes, idx = lane_gather_case(p * groups_per_plane + k, p, groups_per_plane, k, n)
    assert not np.array_equal(planes, np.asarray(jnp.asarray(planes).astype(jnp.bfloat16).astype(jnp.float32)))
    want = np.asarray(gather_lanes_matmul(jnp.asarray(planes), jnp.asarray(idx), groups_per_plane, interpret=True))
    before = [kk.launches for kk in cuda.KERNELS]
    got = gather_lanes(torch.from_numpy(planes), torch.from_numpy(idx), groups_per_plane).numpy()
    assert [kk.launches for kk in cuda.KERNELS] == before  # the plain version, on the CPU
    assert got.shape == want.shape == (p * groups_per_plane, 4, k)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p,groups_per_plane,k,n", [(2, 8, 30, 100), (2, 6, 130, 200), (3, 3, 7, 9)])
def test_row_view_matches_pallas_interpret_bit_for_bit(p, groups_per_plane, k, n):
    """The decoded boxes as the multiclass NMS hands them over: (P, N, 4)
    rows, seen as (P, 4, N) through `transpose(1, 2)` with no copy."""
    planes, idx = lane_gather_case(p * groups_per_plane + k, p, groups_per_plane, k, n)
    boxes = np.ascontiguousarray(planes.transpose(0, 2, 1))
    want = np.asarray(gather_lanes_matmul(jnp.asarray(planes), jnp.asarray(idx), groups_per_plane, interpret=True))
    rows = torch.from_numpy(boxes).transpose(1, 2)
    assert table_layout(rows) == ROWS and not rows.is_contiguous()
    before = [kk.launches for kk in cuda.KERNELS]
    got = gather_lanes(rows, torch.from_numpy(idx), groups_per_plane).numpy()
    assert [kk.launches for kk in cuda.KERNELS] == before
    assert got.shape == want.shape == (p * groups_per_plane, 4, k)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize(
    "make,layout",
    [
        (lambda t: t, PLANES),  # contiguous (P, R, N) planes
        (lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), ROWS),  # rows, viewed as planes
        (lambda t: t[:1].transpose(1, 2).contiguous().transpose(1, 2), ROWS),  # one image
        (lambda t: t[:, :, :10], None),  # planes cut along N
        (lambda t: t.transpose(1, 2).contiguous()[:, :10].transpose(1, 2), None),  # rows cut along N
        (lambda t: torch.cat([t.transpose(1, 2), t[:, :1].transpose(1, 2)], 2)[..., :4].transpose(1, 2), None),  # padded rows
        (lambda t: torch.stack(list(t), 2).permute(2, 0, 1), None),  # images interleaved
    ],
)
def test_table_layout_names_the_two_layouts_k6_takes(make, layout):
    planes = make(torch.from_numpy(lane_gather_case(0, 2, 1, 4, 20)[0]))
    assert table_layout(planes) == layout


def test_indices_outside_the_plane_gather_zero():
    planes, idx = lane_gather_case(0, 2, 4, 16, 20)
    idx[1, :4] = [-1, 20, 21, -2**31]
    out = gather_lanes(torch.from_numpy(planes), torch.from_numpy(idx), 4).numpy()
    assert (out[1, :, :4] == 0).all()
    g = np.arange(8)[:, None, None] // 4
    want = planes[g, np.arange(4)[None, :, None], np.clip(idx, 0, 19)[:, None, :]]
    np.testing.assert_array_equal(out[:, :, 4:], want[:, :, 4:])
    np.testing.assert_array_equal(out[[0, *range(2, 8)]], want[[0, *range(2, 8)]])


def test_group_count_must_match_the_planes():
    planes, idx = lane_gather_case(0, 2, 4, 16, 20)
    with pytest.raises(ValueError):
        gather_lanes(torch.from_numpy(planes), torch.from_numpy(idx), 3)
