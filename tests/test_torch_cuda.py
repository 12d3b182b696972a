"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc and skip without them. On the H100, where
JAX is not installed, run them without tests/conftest.py (which imports JAX):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`. Keep masks
and gathered candidates (K3, K6) must be equal; RoIAlign does the plain version's f32
operations in its order, so f32 agrees to 1e-5 and bf16 to one bf16 step
(2^-7 relative to the largest value). The fused bottleneck (K8, K9) rounds
where its plain version rounds but sums in another order, so f32 agrees to
1e-5 of the largest |output|; in bf16 a block rounds y3 and then y3 +
identity, so one step apart in y3 can be two in the output: two bf16 steps
of the largest |output| a block, added up over a chain (the identity carries
a block's difference into the next). The deformable conv (K7) samples with
the plain version's f32 operations in its order but contracts in another, so
f32 agrees to 1e-5 of the largest |output| and bf16 to one bf16 step of it. Its gradient (K2b) sums with atomics,
in an order that changes from run to run, so f32 agrees to 1e-5 relative to
the largest value and bf16 to one bf16 step. K2 routes each roi inside its
launch, so its levels must equal map_roi_levels' exactly, at the level
boundaries too.

This file imports nothing of JAX, so it also holds the numpy-built inputs
that the port's CPU tests share.
"""

import copy

import numpy as np
import pytest
import torch

from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn
from balancedgroupsoftmax_torch.ops import nms as ops_nms
from balancedgroupsoftmax_torch.ops import roi_align as ops_roi

pytestmark = pytest.mark.cuda

STRIDES = (4, 8, 16, 32)
IMAGE = (256, 384)


def tie_rows(seed, g, k, thr, spread=300):
    """(G, K, 4) integer boxes, score order = slot order, with exact
    duplicates (slot 7m + 1 repeats 7m), pairs whose IoU equals `thr` exactly
    (slots 7m + 2, 7m + 3: 10 x 10 against 10 x 10 thr at one corner) and
    ~10% invalid slots."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, spread, (g, k, 2)).astype(np.float32)
    wh = rng.randint(4, 80, (g, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    m = (k - 4) // 7 + 1
    boxes[:, 1::7][:, :m] = boxes[:, 0::7][:, :m]
    corner = boxes[:, 2::7][:, :m, :2].copy()
    boxes[:, 2::7][:, :m] = np.concatenate([corner, corner + 9], -1)
    boxes[:, 3::7][:, :m] = np.concatenate([corner, corner + [9, round(10 * thr) - 1]], -1)
    valid = rng.rand(g, k) > 0.1
    return boxes, valid


def gathered_case(seed, g=6, k=40, n=100, thr=0.5, outside=0.0):
    """Coordinate planes (G, 4, N), distinct candidate indices (G, K) and
    validity for the gathered NMS. With `outside` > 0, about that share of
    the indices lies outside [0, N) (-1, -7, N, N + 3 or 2^31 - 1), and slot
    0 of row 0 (-1) and the last slot of the last row (N) always do, both
    valid: each gathers the zero box."""
    rng = np.random.RandomState(seed)
    boxes, _ = tie_rows(seed, g, n, thr, spread=120)
    planes = np.ascontiguousarray(boxes.transpose(0, 2, 1))
    idx = np.stack([rng.permutation(n)[:k] for _ in range(g)]).astype(np.int32)
    valid = rng.rand(g, k) > 0.15
    if outside > 0:
        far = np.array([-1, -7, n, n + 3, 2**31 - 1], np.int64)[rng.randint(0, 5, (g, k))]
        idx = np.where(rng.rand(g, k) < outside, far, idx).astype(np.int32)
        idx[0, 0], idx[-1, -1] = -1, n
        valid[0, 0] = valid[-1, -1] = True
    return planes, idx, valid


def lane_gather_case(seed, p=2, groups_per_plane=8, k=30, n=100, r=4):
    """Planes (P, R, N) of f32 values with full 24-bit mantissas (no bf16
    holds them) and indices (G, K), G = P * groups_per_plane, in [0, N)."""
    rng = np.random.RandomState(seed)
    planes = (rng.uniform(-1, 1, (p, r, n)) * 1000).astype(np.float32)
    planes += np.float32(2.0**-13)  # sets low mantissa bits of every value
    idx = rng.randint(0, n, (p * groups_per_plane, k)).astype(np.int32)
    return planes, idx


def deform_case(seed, c_in, c_out, groups, stride, window, modulated, b=2, hw=(11, 13)):
    """Inputs of a 3 x 3 deformable convolution with padding 1: x (B, H, W,
    C_in), offsets (B, Ho, Wo, 18) with about a quarter integers, about a
    tenth beyond +-4 and samples in the (-1, 0) and (H - 1, H) border bands,
    the weight (C_out, C_in / groups, 3, 3) and a v2 mask (B, Ho, Wo, 9)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, c_in).astype(np.float32)
    off = rng.randn(b, ho, wo, 18) * 2.5
    whole = rng.rand(*off.shape) < 0.25
    off[whole] = np.round(off[whole])
    off[:, 0, 0, 0:2] = [0.5, 0.25]  # tap (0, 0) of output (0, 0) samples at (-0.5, -0.75)
    # tap (2, 2) of the last output samples at (H - 0.5, W - 0.5)
    off[:, -1, -1, 16:18] = [h - 0.5 - ((ho - 1) * stride + 1), w - 0.5 - ((wo - 1) * stride + 1)]
    weight = rng.randn(c_out, c_in // groups, 3, 3) / np.sqrt(9 * c_in / groups)
    mask = rng.rand(b, ho, wo, 9)
    return x, off.astype(np.float32), weight.astype(np.float32), mask.astype(np.float32)


def pyramid(rng, b=2, c=16):
    return [rng.randn(b, IMAGE[0] // s, IMAGE[1] // s, c).astype(np.float32) for s in STRIDES]


def rois_all_levels(rng, b=2, r=64):
    """Rois of side 6 to 1000 px: every FPN level, some reaching past the image."""
    side = np.exp(rng.uniform(np.log(6), np.log(1000), (b, r, 2)))
    x1 = rng.uniform(-10, IMAGE[1], (b, r))
    y1 = rng.uniform(-10, IMAGE[0], (b, r))
    return np.stack([x1, y1, x1 + side[..., 0], y1 + side[..., 1]], -1).astype(np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 60, 64, 65, 819, 1000, 1280])
def test_nms_keep_matches_plain(dev, k):
    boxes, valid = (torch.from_numpy(x).to(dev) for x in tie_rows(k, 5, k, 0.7))
    before = cuda.NMS_KEEP.launches
    keep = ops_nms.nms_keep_batched(boxes, valid, 0.7)
    assert cuda.NMS_KEEP.launches == before + 1
    assert torch.equal(keep, ops_nms.nms_keep_reference(boxes, valid, 0.7))


@pytest.mark.parametrize("k", [1337, 2000])
def test_nms_keep_tiled_matches_plain(dev, k):
    boxes, valid = (torch.from_numpy(x).to(dev) for x in tie_rows(k, 10, k, 0.7, spread=600))
    before = cuda.NMS_KEEP_TILED.launches
    keep = ops_nms.nms_keep_tiled(boxes, valid, 0.7)
    assert cuda.NMS_KEEP_TILED.launches == before + 1
    assert torch.equal(keep, ops_nms.nms_keep_reference(boxes, valid, 0.7))


NMS_ROWS = ["scattered", "all_valid", "all_invalid", "invalid_tail"]


def with_rows(valid, rows):
    """`valid` as the kind of row `rows` asks for: its own scattered invalid
    slots, all valid, none valid, or the last third invalid (the padding
    top-k leaves)."""
    k = valid.shape[1]
    if rows == "all_valid":
        valid[:] = True
    elif rows == "all_invalid":
        valid[:] = False
    elif rows == "invalid_tail":
        valid[:] = True
        valid[:, k - k // 3:] = False
    return valid


def nms_rows(seed, g, k, thr, rows, spread=600):
    """`tie_rows` with the validity of `rows` (`with_rows`)."""
    boxes, valid = tie_rows(seed, g, k, thr, spread=spread)
    return boxes, with_rows(valid, rows)


def _one_launch_of(kernel, before):
    assert [kk.launches - b for kk, b in zip(cuda.KERNELS, before)] == [int(kk is kernel) for kk in cuda.KERNELS]


@pytest.mark.parametrize("rows", NMS_ROWS)
@pytest.mark.parametrize("k", [1, 63, 64, 65, 1337, 2000, 4097])
def test_nms_keep_tiled_edges_match_plain(dev, k, rows):
    """K4 bit for bit at K of one box, around one 64-box chunk, the RPN's
    2000, and past 4096, with every kind of row."""
    g = 3 if k > 2000 else 10
    boxes, valid = (torch.from_numpy(x).to(dev) for x in nms_rows(k + 3, g, k, 0.7, rows))
    before = [kk.launches for kk in cuda.KERNELS]
    keep = ops_nms.nms_keep_tiled(boxes, valid, 0.7)
    _one_launch_of(cuda.NMS_KEEP_TILED, before)
    assert torch.equal(keep, ops_nms.nms_keep_reference(boxes, valid, 0.7))


@pytest.mark.parametrize("rows", NMS_ROWS)
@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("k", [1, 64, 300, 1344])
def test_nms_keep_coords_edges_match_plain(dev, k, thr, rows):
    """K5 bit for bit, its mask pass and its walk in one call, at K of one
    box, one 64-box chunk, the cascade's 300 (its 600 rows) and 1344, its
    largest, with every kind of row."""
    g = 600 if k == 300 else 7
    boxes, valid = nms_rows(k + 5, g, k, thr, rows, spread=300)
    coords = torch.from_numpy(np.ascontiguousarray(boxes.transpose(0, 2, 1))).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    before = [kk.launches for kk in cuda.KERNELS]
    keep = ops_nms.nms_keep_batched_coords(coords, valid, thr)
    _one_launch_of(cuda.NMS_KEEP_COORDS, before)
    assert torch.equal(keep, ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, thr))


def test_nms_keep_coords_refuses_rows_beyond_its_limit(dev):
    """K5 holds a row's mask in one block's shared memory, so K = 1345
    raises, with no launch counted and nothing computed; K = 1344 runs."""
    for k, fits in ((1344, True), (1345, False), (2000, False)):
        boxes, valid = nms_rows(k, 2, k, 0.5, "scattered")
        coords = torch.from_numpy(np.ascontiguousarray(boxes.transpose(0, 2, 1))).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        before = cuda.NMS_KEEP_COORDS.launches
        if fits:
            keep = ops_nms.nms_keep_batched_coords(coords, valid, 0.5)
            assert torch.equal(keep, ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, 0.5))
            assert cuda.NMS_KEEP_COORDS.launches == before + 1
        else:
            with pytest.raises(RuntimeError, match="bags_nms_keep_coords"):
                ops_nms.nms_keep_batched_coords(coords, valid, 0.5)
            torch.cuda.synchronize()  # and nothing was left running that fails later
            assert cuda.NMS_KEEP_COORDS.launches == before


def test_batched_nms_topk_sends_long_rows_to_k4(dev):
    from balancedgroupsoftmax_torch.kernels import batched_nms_topk

    for k, kernel in ((1000, cuda.NMS_KEEP), (2000, cuda.NMS_KEEP_TILED)):
        boxes, valid = (torch.from_numpy(x).to(dev) for x in tie_rows(k, 4, k, 0.7, spread=600))
        scores = torch.linspace(1, 0, k, device=dev).expand(4, -1).contiguous()
        before = [kk.launches for kk in cuda.KERNELS]
        batched_nms_topk(boxes, scores, valid, 0.7, 100)
        after = [kk.launches for kk in cuda.KERNELS]
        assert [a - b for a, b in zip(after, before)] == [int(kk is kernel) for kk in cuda.KERNELS]


def test_nms_keep_gathered_matches_plain(dev):
    planes, idx, valid = (torch.from_numpy(x).to(dev) for x in gathered_case(3, g=20, k=300, n=1000))
    keep, cand = ops_nms.nms_keep_gathered(planes, idx, valid, 0.5)
    ref_keep, ref_cand = ops_nms.nms_keep_gathered_reference(planes, idx, valid, 0.5)
    assert torch.equal(keep, ref_keep)
    assert torch.equal(cand.view(torch.int32), ref_cand.view(torch.int32))


@pytest.mark.parametrize("rows", NMS_ROWS)
@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("k", [1, 64, 65, 300, 1280, 1344])
def test_nms_keep_gathered_edges_match_plain(dev, k, thr, rows):
    """K3 bit for bit, keep and candidates, at K of one box, one 64-box
    chunk, the multiclass NMS's 300 (its 600 rows), 1280 and 1344, its
    largest, with indices outside [0, N) and every kind of row."""
    g = 600 if k == 300 else 7
    planes, idx, valid = gathered_case(k + 7, g, k, max(1000, k), thr, outside=0.1)
    planes, idx, valid = (torch.from_numpy(x).to(dev) for x in (planes, idx, with_rows(valid, rows)))
    before = [kk.launches for kk in cuda.KERNELS]
    keep, cand = ops_nms.nms_keep_gathered(planes, idx, valid, thr)
    _one_launch_of(cuda.NMS_KEEP_GATHERED, before)
    ref_keep, ref_cand = ops_nms.nms_keep_gathered_reference(planes, idx, valid, thr)
    assert torch.equal(keep, ref_keep)
    assert torch.equal(cand.view(torch.int32), ref_cand.view(torch.int32))


def test_nms_keep_gathered_refuses_rows_beyond_its_limit(dev):
    """K3 walks a row's mask in one block's shared memory, as K5 does, so K
    = 1345 raises, with no launch counted and nothing computed; K = 1344
    runs."""
    for k, fits in ((1344, True), (1345, False), (2000, False)):
        planes, idx, valid = (torch.from_numpy(x).to(dev) for x in gathered_case(k, 2, k, k + 10))
        before = cuda.NMS_KEEP_GATHERED.launches
        if fits:
            keep, _ = ops_nms.nms_keep_gathered(planes, idx, valid, 0.5)
            assert torch.equal(keep, ops_nms.nms_keep_gathered_reference(planes, idx, valid, 0.5)[0])
            assert cuda.NMS_KEEP_GATHERED.launches == before + 1
        else:
            with pytest.raises(RuntimeError, match="bags_nms_keep_gathered"):
                ops_nms.nms_keep_gathered(planes, idx, valid, 0.5)
            torch.cuda.synchronize()  # and nothing was left running that fails later
            assert cuda.NMS_KEEP_GATHERED.launches == before


@pytest.mark.parametrize("k", [300, 1000])
def test_nms_keep_coords_matches_plain(dev, k):
    boxes, valid = tie_rows(k + 1, 600 if k == 300 else 7, k, 0.5)
    coords = torch.from_numpy(np.ascontiguousarray(boxes.transpose(0, 2, 1))).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    before = cuda.NMS_KEEP_COORDS.launches
    keep = ops_nms.nms_keep_batched_coords(coords, valid, 0.5)
    assert cuda.NMS_KEEP_COORDS.launches == before + 1
    assert torch.equal(keep, ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, 0.5))


@pytest.mark.parametrize("groups_per_plane,k,n", [(300, 300, 1000), (1, 77, 50), (3, 4, 5)])
def test_gather_lanes_is_bit_equal_to_plain(dev, groups_per_plane, k, n):
    from balancedgroupsoftmax_torch.ops import gather as ops_gather

    planes, idx = lane_gather_case(k, 2, groups_per_plane, k, n)
    idx[0, :3] = [-1, n, n + 7]  # outside [0, N): 0
    planes, idx = torch.from_numpy(planes).to(dev), torch.from_numpy(idx).to(dev)
    before = cuda.GATHER_LANES.launches
    out = ops_gather.gather_lanes(planes, idx, groups_per_plane)
    assert cuda.GATHER_LANES.launches == before + 1
    ref = ops_gather.gather_lanes_reference(planes, idx, groups_per_plane)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (out[0, :, :3] == 0).all()


def rows_on(dev, planes, offset=0):
    """(P, R, N) numpy planes as the transposed view of contiguous (P, N, R)
    rows on `dev`, the rows starting `offset` floats into their buffer."""
    rows = np.ascontiguousarray(planes.transpose(0, 2, 1))
    flat = torch.zeros(rows.size + offset, device=dev)
    flat[offset:] = torch.from_numpy(rows.ravel()).to(dev)
    return flat[offset:].view(rows.shape).transpose(1, 2)


@pytest.mark.parametrize("offset", [0, 1])  # 1: rows not 16-byte aligned, the scalar route
@pytest.mark.parametrize("groups_per_plane,k,n", [(300, 300, 1000), (1, 77, 50), (3, 4, 5), (300, 301, 1000)])
def test_gather_lanes_rows_are_bit_equal_to_plain(dev, groups_per_plane, k, n, offset):
    """K6 on the decoded boxes' own rows, in both routes; K not a multiple
    of 4 (77, 301) takes the scalar tail; indices outside [0, N) give 0."""
    from balancedgroupsoftmax_torch.ops import gather as ops_gather

    planes, idx = lane_gather_case(k + offset, 2, groups_per_plane, k, n)
    idx[0, :3] = [-1, n, n + 7]
    idx[-1, -1] = -2**31
    rows, idx = rows_on(dev, planes, offset), torch.from_numpy(idx).to(dev)
    assert ops_gather.table_layout(rows) == ops_gather.ROWS and (rows.data_ptr() % 16 == 0) == (offset == 0)
    before = cuda.GATHER_LANES.launches
    out = ops_gather.gather_lanes(rows, idx, groups_per_plane)
    assert cuda.GATHER_LANES.launches == before + 1
    ref = ops_gather.gather_lanes_reference(torch.from_numpy(planes).to(dev), idx, groups_per_plane)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(out, ops_gather.gather_lanes(rows.contiguous(), idx, groups_per_plane))
    assert (out[0, :, :3] == 0).all() and (out[-1, :, -1] == 0).all()


def test_gather_lanes_refuses_other_layouts_with_no_launch(dev):
    from balancedgroupsoftmax_torch.ops import gather as ops_gather

    planes, idx = lane_gather_case(9, 2, 3, 8, 40)
    idx = torch.from_numpy(idx).to(dev)
    rows = rows_on(dev, planes)
    before = cuda.GATHER_LANES.launches
    interleaved = torch.stack(list(rows), 2).permute(2, 0, 1)  # (P, R, N) with strides (1, N P, P)
    for bad in (rows[:, :, :30], torch.from_numpy(planes).to(dev)[:, :, :30], interleaved, rows.double()):
        assert bad.dtype is torch.float64 or ops_gather.table_layout(bad) is None
        with pytest.raises(ValueError):
            ops_gather.gather_lanes(bad, idx, 3)
    assert cuda.GATHER_LANES.launches == before


def test_launches_go_on_the_current_stream(dev):
    """The raw stream every launch is queued on is PyTorch's current one, on
    the default stream and inside `torch.cuda.stream`."""
    assert cuda.current_stream() == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert cuda.current_stream() == side.cuda_stream != torch.cuda.default_stream().cuda_stream
        from balancedgroupsoftmax_torch.ops import gather as ops_gather

        planes, idx = (torch.from_numpy(a).to(dev) for a in lane_gather_case(5))
        out = ops_gather.gather_lanes(planes, idx, 8)
    side.synchronize()
    assert torch.equal(out, ops_gather.gather_lanes_reference(planes, idx, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_matches_plain(dev, dtype):
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(f).to(dev, dtype) for f in pyramid(rng)]
    rois = torch.from_numpy(rois_all_levels(rng)).to(dev)
    out = ops_roi.multilevel_roi_align(feats, rois, STRIDES)
    ref = ops_roi.multilevel_roi_align_reference(feats, rois, STRIDES).float()
    limit = 1e-5 if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
    assert out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= limit


@pytest.mark.parametrize("dtype,out_size", [(torch.float32, 7), (torch.bfloat16, 7), (torch.float32, 14)])
def test_roi_align_backward_matches_plain(dev, dtype, out_size):
    rng = np.random.RandomState(1)
    feats = [torch.from_numpy(f).to(dev, dtype).requires_grad_() for f in pyramid(rng)]
    rois = torch.from_numpy(rois_all_levels(rng)).to(dev)
    grad = torch.from_numpy(rng.randn(*rois.shape[:2], out_size, out_size, 16).astype(np.float32)).to(dev, dtype)
    before = cuda.ROI_ALIGN_BACKWARD.launches
    ops_roi.multilevel_roi_align(feats, rois, STRIDES, out_size).backward(grad)
    assert cuda.ROI_ALIGN_BACKWARD.launches == before + 1
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    ref = ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, STRIDES, out_size, dtype=dtype)
    for f, r in zip(feats, ref):
        r = r.float()
        limit = (1e-5 if dtype == torch.float32 else 2.0**-7) * r.abs().max().item()
        assert f.grad.dtype == dtype and f.grad.shape == r.shape
        assert (f.grad.float() - r).abs().max().item() <= limit


ROI_EDGES = ["s14", "one_level", "c12", "outside", "zero_area", "r0"]


def roi_edge_case(name, seed):
    """(feats as numpy, rois, strides, out_size) of one of K2's edge cases:
    S = 14, a one-level stride-8 pyramid, C = 12 (no multiple of a 16-byte
    piece, so pieces are read channel by channel), rois wholly outside the
    image, zero-area rois (x2 = x1 - 1, y2 = y1 - 1) and R = 0."""
    rng = np.random.RandomState(seed)
    strides = (8,) if name == "one_level" else STRIDES
    feats = [rng.randn(2, -(-IMAGE[0] // s), -(-IMAGE[1] // s), 12 if name == "c12" else 16).astype(np.float32)
             for s in strides]
    rois = rois_all_levels(rng)
    if name == "outside":  # right of or below the image, or above and left of it
        far = np.where(rng.rand(*rois.shape[:2], 1) < 0.5, 2000.0, -2000.0).astype(np.float32)
        rois = rois + far
    elif name == "zero_area":
        rois[..., 2:] = rois[..., :2] - 1
    elif name == "r0":
        rois = rois[:, :0]
    return feats, rois, strides, 14 if name == "s14" else 7


def boundary_rois(finest_scale=56):
    """(1, R, 4) rois whose sqrt(area) / finest_scale + 1e-6 lies within a
    few f32 steps of 2, 4 and 8 (sqrt(area) near 112, 224 and 448), where
    map_roi_levels' rounding decides the level: squares and rectangles of
    five aspect ratios, one side swept step by step, some at fractional
    corners."""
    rng = np.random.RandomState(7)
    rois = []
    for k in (1, 2, 3):
        side = np.float32(finest_scale * (2.0**k - 1e-6))
        for ratio in (1.0, 2.0, 0.5, 1.5, 0.75):
            w = np.float32(side * ratio)
            h0 = np.float32(np.float64(side) ** 2 / np.float64(w))
            hs = (np.array([h0]).view(np.int32) + np.arange(-40, 41, dtype=np.int32)).view(np.float32)
            x1 = np.float32(rng.uniform(0, 50)) if ratio != 1.0 else np.float32(0)
            y1 = np.float32(rng.uniform(0, 50)) if ratio != 1.0 else np.float32(0)
            for h in hs:
                rois.append([x1, y1, x1 + w - 1, y1 + h - 1])
    return np.asarray(rois, np.float32)[None]


def test_boundary_rois_straddle_the_level_boundaries():
    levels = ops_roi.map_roi_levels(torch.from_numpy(boundary_rois()), 4)
    assert set(levels.unique().tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ROI_EDGES)
def test_roi_align_edges_match_plain(dev, dtype, case):
    feats, rois, strides, out_size = roi_edge_case(case, ROI_EDGES.index(case))
    feats = [torch.from_numpy(f).to(dev, dtype) for f in feats]
    rois = torch.from_numpy(rois).to(dev)
    out = ops_roi.multilevel_roi_align(feats, rois, strides, out_size)
    ref = ops_roi.multilevel_roi_align_reference(feats, rois, strides, out_size).float()
    assert out.dtype == dtype and out.shape == ref.shape
    if case == "outside":
        assert ref.abs().max().item() == 0
    if ref.numel():
        limit = 1e-5 if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
        assert (out.float() - ref).abs().max().item() <= limit


@pytest.mark.parametrize("dtype,case", [
    (torch.float32, "c12"), (torch.bfloat16, "c12"), (torch.bfloat16, "s14"), (torch.bfloat16, "one_level"),
    (torch.float32, "outside"), (torch.bfloat16, "zero_area"), (torch.float32, "r0"),
])
def test_roi_align_backward_edges_match_plain(dev, dtype, case):
    feats, rois, strides, out_size = roi_edge_case(case, 10 + ROI_EDGES.index(case))
    feats = [torch.from_numpy(f).to(dev, dtype).requires_grad_() for f in feats]
    rois = torch.from_numpy(rois).to(dev)
    c = feats[0].shape[-1]
    grad = torch.from_numpy(np.random.RandomState(5).randn(*rois.shape[:2], out_size, out_size, c)
                            .astype(np.float32)).to(dev, dtype)
    before = cuda.ROI_ALIGN_BACKWARD.launches
    ops_roi.multilevel_roi_align(feats, rois, strides, out_size).backward(grad)
    assert cuda.ROI_ALIGN_BACKWARD.launches == before + 1
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    ref = ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, out_size, dtype=dtype)
    top = max(r.float().abs().max().item() for r in ref)
    if case in ("outside", "r0"):
        assert top == 0
    for f, r in zip(feats, ref):
        assert f.grad.dtype == dtype and f.grad.shape == r.shape
        limit = (1e-5 if dtype == torch.float32 else 2.0**-7) * r.float().abs().max().item()
        assert (f.grad.float() - r.float()).abs().max().item() <= limit


def test_roi_align_routes_as_map_roi_levels_at_the_boundaries(dev):
    """K2's levels, routed inside the launch, equal map_roi_levels' on the
    card at rois within a few f32 steps of each level boundary, for a
    four-level and a one-level pyramid."""
    rois = torch.from_numpy(boundary_rois()).to(dev)
    for strides in (STRIDES, (8,)):
        feats = [torch.zeros(1, 512 // s, 512 // s, 8, device=dev) for s in strides]
        _, levels = ops_roi.roi_align_forward(feats, rois, strides, return_levels=True)
        want = ops_roi.map_roi_levels(rois, len(strides))
        assert levels.dtype == torch.int32
        assert torch.equal(levels, want), f"{(levels != want).sum().item()} rois routed otherwise"
    assert set(want.unique().tolist()) == {0}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    boxes = torch.zeros(2, 8, 4, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        ops_nms.nms_keep_batched(boxes, torch.ones(2, 8, dtype=torch.bool, device=dev), 0.5)
    feats = [torch.zeros(1, 8, 8, 4, device=dev).permute(0, 2, 1, 3)]  # not contiguous
    with pytest.raises(ValueError):
        ops_roi.multilevel_roi_align(feats, torch.zeros(1, 2, 4, device=dev), (4,))
    with pytest.raises(ValueError):
        ops_nms.nms_keep_tiled(boxes, torch.ones(2, 8, dtype=torch.bool, device=dev), 0.5)
    with pytest.raises(ValueError):  # a gradient of the wrong shape
        ops_roi.roi_align_backward(torch.zeros(1, 2, 7, 7, 5, device=dev), torch.zeros(1, 3, 4, device=dev), [(8, 8)], (4,))
    with pytest.raises(ValueError):  # levels of another dtype than K2's int32
        ops_roi.roi_align_backward(torch.zeros(1, 3, 7, 7, 8, device=dev), torch.zeros(1, 3, 4, device=dev), [(8, 8)],
                                   (4,), levels=torch.zeros(1, 3, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # a sample_num the kernels are not built for
        ops_roi.multilevel_roi_align([torch.zeros(1, 8, 8, 8, device=dev)], torch.zeros(1, 2, 4, device=dev), (4,), 7, 5)
    with pytest.raises(ValueError):  # (G, K, 4) boxes where K5 takes (G, 4, K) planes
        ops_nms.nms_keep_batched_coords(torch.zeros(2, 8, 4, device=dev), torch.ones(2, 8, dtype=torch.bool, device=dev), 0.5)
    from balancedgroupsoftmax_torch.ops import gather as ops_gather

    with pytest.raises(ValueError):  # int64 indices
        ops_gather.gather_lanes(torch.zeros(1, 4, 8, device=dev), torch.zeros(2, 3, dtype=torch.int64, device=dev), 2)


DEFORM_HW = (23, 37)
DEFORM_CASES = [  # window, stride, groups, c_in, c_out, modulated; at DEFORM_HW
    (4, 2, 64, 512, 512, False),  # the X101's first c3 block: groups of 8
    (4, 1, 64, 1024, 1024, False),  # c4: groups of 16
    (4, 1, 64, 2048, 2048, False),  # c5: groups of 32
    (0, 1, 8, 128, 128, False),  # no clamp
    (0, 2, 4, 32, 24, True),  # v2, output groups narrower than input ones
    (4, 1, 1, 16, 16, True),
]
DEFORM_SHAPES = [  # window, stride, groups, c_in, c_out, hw
    (4, 1, 16, 64, 192, (23, 37)),  # c_g = 4, o_g = 12: a k16 step spans four taps, o_g padded to 16
    (4, 1, 64, 2048, 2048, (13, 21)),  # c5-like: 13 x 21 positions leave a ragged last tile both ways
]
WINDOW_EDGE = (4, 2, 64, 512, 512, (23, 37))  # window, stride, groups, c_in, c_out, hw


def _deform_matches_plain(dev, dtype, x, off, weight, mask, stride, groups, window):
    x, weight = (torch.from_numpy(a).to(dev, dtype) for a in (x, weight))
    off = torch.from_numpy(off).to(dev)
    mask = None if mask is None else torch.from_numpy(mask).to(dev)
    before = cuda.DEFORM_CONV.launches
    out = ops_dcn.deform_conv2d(x, off, weight, mask, stride, 1, groups, window)
    assert cuda.DEFORM_CONV.launches == before + 1
    ref = ops_dcn.deform_conv2d_reference(x, off, weight, mask, stride, 1, groups, window).float()
    top = ref.abs().max().item()
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= (1e-5 if dtype == torch.float32 else 2.0**-7) * top


def window_edge_offsets(off, window, seed):
    """Offsets at the shift window's edge: a third exactly +-D, a third just
    beyond (+-(D + 0.5)), the rest as they were; and at the border rows and
    columns, offsets of D and D + 0.5 pointing out of the image, so that the
    staged window's edges and its zero fill are read."""
    rng = np.random.RandomState(seed)
    off = off.copy()
    sign = np.where(rng.rand(*off.shape) < 0.5, -1.0, 1.0)
    pick = rng.rand(*off.shape)
    off[pick < 1 / 3] = (sign * window)[pick < 1 / 3]
    beyond = (pick >= 1 / 3) & (pick < 2 / 3)
    off[beyond] = (sign * (window + 0.5))[beyond]
    off[:, 0, :, 0::2] = -window  # first row: dy up to the window's top edge
    off[:, -1, :, 0::2] = window + 0.5  # last row: dy beyond the bottom edge
    off[:, :, 0, 1::2] = -(window + 0.5)  # first column: dx beyond the left edge
    off[:, :, -1, 1::2] = window  # last column: dx at the right edge
    return off.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,stride,groups,c_in,c_out,modulated", DEFORM_CASES)
def test_deform_conv_matches_plain(dev, dtype, window, stride, groups, c_in, c_out, modulated):
    x, off, weight, mask = deform_case(c_in + stride, c_in, c_out, groups, stride, window, modulated, hw=DEFORM_HW)
    _deform_matches_plain(dev, dtype, x, off, weight, mask if modulated else None, stride, groups, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,stride,groups,c_in,c_out,hw", DEFORM_SHAPES)
def test_deform_conv_narrow_groups_and_ragged_tiles_match_plain(dev, dtype, window, stride, groups, c_in, c_out, hw):
    x, off, weight, _ = deform_case(c_in + groups, c_in, c_out, groups, stride, window, False, hw=hw)
    _deform_matches_plain(dev, dtype, x, off, weight, None, stride, groups, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv_offsets_at_and_beyond_the_window_match_plain(dev, dtype, modulated):
    window, stride, groups, c_in, c_out, hw = WINDOW_EDGE
    x, off, weight, mask = deform_case(41, c_in, c_out, groups, stride, window, modulated, hw=hw)
    off = window_edge_offsets(off, window, 42)
    _deform_matches_plain(dev, dtype, x, off, weight, mask if modulated else None, stride, groups, window)


def test_deform_conv_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 8, 8, 16, device=dev)
    off = torch.zeros(1, 8, 8, 18, device=dev)
    w = torch.zeros(16, 4, 3, 3, device=dev)
    with pytest.raises(ValueError):  # weight in another dtype than x
        ops_dcn.deform_conv2d(x, off, w.bfloat16(), None, 1, 1, 4, 4)
    with pytest.raises(ValueError):  # offsets of another shape than the output's
        ops_dcn.deform_conv2d(x, off[:, :4], w, None, 1, 1, 4, 4)
    with pytest.raises(ValueError):  # x not contiguous
        ops_dcn.deform_conv2d(x.transpose(1, 2), off, w, None, 1, 1, 4, 4)
    with pytest.raises(ValueError):  # groups that do not split the channels
        ops_dcn.deform_conv2d(x, off, w, None, 1, 1, 3, 4)
    with pytest.raises(ValueError):  # bf16 groups of 2 channels: not 8-byte pieces
        ops_dcn.deform_conv2d(x.bfloat16(), off, torch.zeros(16, 2, 3, 3, device=dev).bfloat16(), None, 1, 1, 8, 4)


# (H, W, C, groups, stride) of the input of the six distinct deformable layers
# of HTC X101-64x4d DCN c3-c5 at 800 x 1344 (tests/test_torch_deform_conv.py
# htc_dcn_layers holds all 30; D = 4, C_out = C)
DCN_LAYER_SHAPES = [
    (200, 336, 512, 64, 2), (100, 168, 512, 64, 1), (100, 168, 1024, 64, 2),
    (50, 84, 1024, 64, 1), (50, 84, 2048, 64, 2), (25, 42, 2048, 64, 1),
]


def grad_limit(dtype, ref):
    """f32: 1e-5 of the largest |value|; bf16: one bf16 step of it."""
    return (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.float().abs().max().item()


def deform_backward_matches_plain(dev, dtype, x, off, weight, mask, stride, groups, window, seed=0):
    """K7b against its plain version on one set of inputs: each gradient in
    its dtype and within `grad_limit`, one launch."""
    x, weight = (torch.from_numpy(a).to(dev, dtype) for a in (x, weight))
    off = torch.from_numpy(off).to(dev)
    mask = None if mask is None else torch.from_numpy(mask).to(dev)
    b, h, w, _ = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    gout = torch.randn(b, ho, wo, weight.shape[0], generator=torch.Generator().manual_seed(seed)).to(dev, dtype)
    before = cuda.DEFORM_CONV_BACKWARD.launches
    got = ops_dcn.deform_conv2d_backward(gout, x, off, weight, mask, stride, 1, groups, window)
    assert cuda.DEFORM_CONV_BACKWARD.launches == before + 1
    want = ops_dcn.deform_conv2d_backward_reference(gout, x, off, weight, mask, stride, 1, groups, window)
    for name, g, r, like in zip(("dx", "d_offsets", "d_weight", "d_mask"), got, want, (x, off, weight, mask)):
        if like is None:
            assert g is None and r is None
            continue
        assert g.dtype == like.dtype and g.shape == like.shape, name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= grad_limit(dtype, r), (name, err, grad_limit(dtype, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", DCN_LAYER_SHAPES, ids=lambda t: f"{t[0]}x{t[1]}x{t[2]}-s{t[4]}")
def test_deform_conv_backward_matches_plain_at_the_x101_layers(dev, dtype, layer):
    h, w, c, groups, stride = layer
    x, off, weight, _ = deform_case(c + stride, c, c, groups, stride, 4, False, hw=(h, w))
    deform_backward_matches_plain(dev, dtype, x, off, weight, None, stride, groups, 4, seed=c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,stride,groups,c_in,c_out,modulated", DEFORM_CASES)
def test_deform_conv_backward_matches_plain(dev, dtype, window, stride, groups, c_in, c_out, modulated):
    x, off, weight, mask = deform_case(c_in + stride, c_in, c_out, groups, stride, window, modulated, hw=DEFORM_HW)
    deform_backward_matches_plain(dev, dtype, x, off, weight, mask if modulated else None, stride, groups, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,stride,groups,c_in,c_out,hw", DEFORM_SHAPES)
def test_deform_conv_backward_narrow_groups_and_ragged_tiles_match_plain(dev, dtype, window, stride, groups, c_in,
                                                                         c_out, hw):
    x, off, weight, _ = deform_case(c_in + groups, c_in, c_out, groups, stride, window, False, hw=hw)
    deform_backward_matches_plain(dev, dtype, x, off, weight, None, stride, groups, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv_backward_offsets_at_and_beyond_the_window_match_plain(dev, dtype, modulated):
    """Offsets of exactly +-D (the clamp's slope 1/2, the top of JAX's shift
    range), beyond it (no gradient), at the border and off the image."""
    window, stride, groups, c_in, c_out, hw = WINDOW_EDGE
    x, off, weight, mask = deform_case(43, c_in, c_out, groups, stride, window, modulated, hw=hw)
    off = window_edge_offsets(off, window, 44)
    off[:, 1, 1, :2] = [-30.0, 25.0]
    deform_backward_matches_plain(dev, dtype, x, off, weight, mask if modulated else None, stride, groups, window)


def tile_edge_offsets(ho, wo, th, tw, window, seed):
    """(1, ho, wo, 18) offsets that put K7b's corners on its staged window's
    outermost pixels: -D at each tile's first row (first column), so that
    tap 0 samples the window's first row (column) at full weight; D - 1/4
    and D in turns at each tile's last row (column) and at the output's
    last, so that the last tap reaches the window's last rows (columns);
    random within +-D elsewhere."""
    rng = np.random.RandomState(seed)
    off = rng.uniform(-window, window, (1, ho, wo, 18)).astype(np.float32)
    last = np.array([window - 0.25, window], np.float32)
    i, j = np.arange(ho), np.arange(wo)
    off[:, i % th == 0, :, 0::2] = -window
    rows = (i % th == th - 1) | (i == ho - 1)
    off[:, rows, :, 0::2] = last[np.arange(rows.sum()) % 2][:, None, None]
    off[:, :, j % tw == 0, 1::2] = -window
    cols = (j % tw == tw - 1) | (j == wo - 1)
    off[:, :, cols, 1::2] = last[np.arange(cols.sum()) % 2][None, :, None]
    return off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_backward_corners_on_the_window_edges_match_plain(dev, dtype, stride):
    """Corners on the outermost pixels of each tile's staged window, at the
    image's border too, with a ragged last tile both ways: the dx gather's
    halo and its flush, which skips pixels outside the image."""
    window, groups, c = 4, 16, 128
    x, _, weight, mask = deform_case(51 + stride, c, c, groups, stride, window, True, hw=(19, 29))
    ho, wo = (19 - 1) // stride + 1, (29 - 1) // stride + 1
    plan = ops_dcn.backward_plan(2, ho, wo, c, groups, c, 3, 3, stride, window)
    assert ho % plan.th and wo % plan.tw, plan  # a ragged last tile both ways
    off = np.concatenate([tile_edge_offsets(ho, wo, plan.th, plan.tw, window, 52 + k) for k in range(2)])
    deform_backward_matches_plain(dev, dtype, x, off, weight, mask, stride, groups, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [4, 0])
def test_deform_conv_backward_walking_several_tiles_a_block_matches_plain(dev, dtype, window):
    """A plan whose blocks walk several tiles each: the weight gradient's
    sums stay in registers across the walk, and each tile's copies go out
    while the last one is worked on."""
    groups, c = 8, 64
    x, off, weight, mask = deform_case(61, c, c, groups, 1, window, True, hw=(47, 61))
    plan = ops_dcn.backward_plan(2, 47, 61, c, groups, c, 3, 3, 1, window)
    assert plan.tiles_per_block > 1, plan
    deform_backward_matches_plain(dev, dtype, x, off, weight, mask, 1, groups, window)


def test_deform_conv_function_has_a_gradient_on_the_card(dev, exact_f32):
    """Through `DeformConv`, K7's output has a grad_fn, and the backward
    launches K7b once and gives every input and parameter the gradient the
    CPU's plain versions give (the offset conv in full f32: in TF32 its
    offsets, and so the gradients, move by about 1e-3)."""
    torch.manual_seed(0)
    layer = ops_dcn.DeformConv(64, 64, stride=1, modulated=True, groups=8, shift_window=4)
    with torch.no_grad():
        layer.conv_offset.weight.normal_(0.0, 0.05)
        layer.conv_offset.bias.normal_(0.0, 1.0)
    x = torch.randn(2, 64, 13, 21).contiguous(memory_format=torch.channels_last)
    gout = torch.randn(2, 64, 13, 21)
    grads = {}
    for where in ("cpu", dev):
        mod = copy.deepcopy(layer).to(where)
        xi = x.to(where).detach().requires_grad_()
        before = cuda.DEFORM_CONV_BACKWARD.launches
        out = mod(xi)
        assert out.grad_fn is not None
        (out * gout.to(where)).sum().backward()
        assert cuda.DEFORM_CONV_BACKWARD.launches == before + (where is dev)
        grads[str(where)] = [t.detach().cpu() for t in [xi.grad] + [p.grad for p in mod.parameters()]]
    for g, r in zip(grads[str(dev)], grads["cpu"]):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def test_deform_conv_backward_computes_only_what_is_asked(dev):
    x, off, weight, mask = deform_case(5, 64, 64, 8, 1, 4, True, hw=DEFORM_HW)
    T = lambda a: torch.from_numpy(a).to(dev)
    gout = torch.ones(2, *DEFORM_HW, 64, device=dev)
    got = ops_dcn.deform_conv2d_backward(gout, T(x), T(off), T(weight), T(mask), 1, 1, 8, 4,
                                         needs=(False, False, True, False))
    assert got[0] is None and got[1] is None and got[3] is None
    want = ops_dcn.deform_conv2d_backward_reference(gout, T(x), T(off), T(weight), T(mask), 1, 1, 8, 4)[2]
    assert (got[2] - want).abs().max().item() <= grad_limit(torch.float32, want)


def test_deform_conv_backward_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 8, 8, 16, device=dev)
    off = torch.zeros(1, 8, 8, 18, device=dev)
    g = torch.zeros(1, 8, 8, 16, device=dev)
    before = cuda.DEFORM_CONV_BACKWARD.launches
    with pytest.raises(ValueError):  # groups of 2 channels: not the kernel's groups of 4
        ops_dcn.deform_conv2d_backward(g, x, off, torch.zeros(16, 2, 3, 3, device=dev), None, 1, 1, 8, 4)
    with pytest.raises(ValueError):  # the output's gradient in another dtype than x
        ops_dcn.deform_conv2d_backward(g.bfloat16(), x, off, torch.zeros(16, 4, 3, 3, device=dev), None, 1, 1, 4, 4)
    with pytest.raises(ValueError):  # one group of 1024 channels: no weight block fits
        ops_dcn.deform_conv2d_backward(torch.zeros(1, 8, 8, 1024, device=dev), torch.zeros(1, 8, 8, 1024, device=dev),
                                       off, torch.zeros(1024, 1024, 3, 3, device=dev), None, 1, 1, 1, 4)
    assert cuda.DEFORM_CONV_BACKWARD.launches == before


def fused_block_case(seed, cin, cm, cout, downsample, b=2, hw=(13, 37)):
    """A row-padded NHWC input (B, H + 2, W, Cin) with +-1e9 in its halo rows
    and BN-folded weights of one bottleneck (w1, b1, w2, b2, w3, b3, wd, bd in
    the JAX layout; wd and bd None without a downsample), scaled so that each
    product keeps unit variance."""
    rng = np.random.RandomState(seed)
    h, w = hw
    x = rng.randn(b, h + 2, w, cin).astype(np.float32)
    x[:, 0], x[:, -1] = 1e9, -1e9

    def weight(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def bias(c):
        return (rng.randn(1, c) * 0.1).astype(np.float32)

    p = [weight(cin, cm, fan_in=cin), bias(cm), weight(9, cm, cm, fan_in=9 * cm), bias(cm),
         weight(cm, cout, fan_in=cm), bias(cout)]
    p += [weight(cin, cout, fan_in=cin), bias(cout)] if downsample else [None, None]
    return x, p


# the R50's stride-1 block widths: (cin, cm, cout, downsample)
R50_WIDTHS = {
    "layer1.0": (64, 64, 256, True),
    "layer1": (256, 64, 256, False),
    "layer2": (512, 128, 512, False),
    "layer3": (1024, 256, 1024, False),
    "layer4": (2048, 512, 2048, False),
}


def _fused_params(p, dev):
    from balancedgroupsoftmax_torch.ops.fused_block import FusedBlockParams

    return FusedBlockParams(*(None if t is None else torch.from_numpy(t).to(dev) for t in p))


def _fused_limit(dtype, ref, blocks=1):
    return (1e-5 if dtype == torch.float32 else 2 * 2.0**-7 * blocks) * ref.float().abs().max().item()


@pytest.fixture
def exact_f32():
    """The plain versions' f32 products in full f32, not TF32."""
    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", list(R50_WIDTHS))
def test_fused_bottleneck_matches_plain(dev, exact_f32, dtype, width):
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    x, p = fused_block_case(len(width), *R50_WIDTHS[width])
    x, p = torch.from_numpy(x).to(dev, dtype), _fused_params(p, dev)
    before = cuda.FUSED_BOTTLENECK.launches
    out = ops_fb.fused_bottleneck(x, p)
    assert cuda.FUSED_BOTTLENECK.launches == before + 1
    ref = ops_fb.unpad_rows(ops_fb.fused_bottleneck_reference(x, p))
    out = ops_fb.unpad_rows(out)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("run", ["layer1", "layer3", "layer4"])
def test_fused_layer_matches_plain(dev, exact_f32, dtype, run):
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    widths = {"layer1": ["layer1.0", "layer1", "layer1"], "layer3": ["layer3"] * 3, "layer4": ["layer4"] * 2}[run]
    hw = {"layer1": (19, 35), "layer3": (11, 21), "layer4": (7, 18)}[run]
    blocks = [_fused_params(fused_block_case(40 + i, *R50_WIDTHS[wd], hw=hw)[1], dev) for i, wd in enumerate(widths)]
    x = fused_block_case(50, *R50_WIDTHS[widths[0]], hw=hw)[0][:, 1:-1]
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)
    before = cuda.FUSED_LAYER.launches
    out = ops_fb.fused_layer(x, blocks)
    assert cuda.FUSED_LAYER.launches == before + 1  # one launch for the whole run
    ref = ops_fb.fused_layer_reference(x, blocks)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(dtype, ref, len(blocks))
    chain = ops_fb.pad_rows(x)
    for p in blocks:
        chain = ops_fb.fused_bottleneck(chain, p)
    assert torch.equal(out, ops_fb.unpad_rows(chain))  # K9 runs K8's tile body, so bit for bit


# each route forced at the R50's widths (the halo route where it fits shared
# memory), at ragged sizes: H and W not multiples of a tile, W < 16, one image
FUSED_ROUTES = [(route, width, dtype) for route in ("halo", "phase") for width in R50_WIDTHS
                for dtype in (torch.float32, torch.bfloat16)
                if route == "phase" or width.startswith(("layer1", "layer2")) or
                (width == "layer3" and dtype == torch.bfloat16)]
FUSED_RAGGED = {"13x37": (2, (13, 37)), "5x7-one-image": (1, (5, 7)), "31x61": (1, (31, 61))}


def _forced_plan(route, b, hw, width, dtype):
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    cin, cm, cout, _ = R50_WIDTHS[width]
    return ops_fb.fused_plan(b, *hw, cin, cm, cout, dtype, route=route)


@pytest.mark.parametrize("size", list(FUSED_RAGGED))
@pytest.mark.parametrize("route,width,dtype", FUSED_ROUTES)
def test_fused_route_matches_plain(dev, exact_f32, route, width, dtype, size):
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    b, hw = FUSED_RAGGED[size]
    x, p = fused_block_case(len(width) + b, *R50_WIDTHS[width], b=b, hw=hw)
    x, p = torch.from_numpy(x).to(dev, dtype), _fused_params(p, dev)
    plan = _forced_plan(route, b, hw, width, dtype)
    before = cuda.FUSED_BOTTLENECK.launches
    out = ops_fb.unpad_rows(ops_fb.fused_bottleneck(x, p, plan))
    assert cuda.FUSED_BOTTLENECK.launches == before + 1
    ref = ops_fb.unpad_rows(ops_fb.fused_bottleneck_reference(x, p))
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["halo", "phase"])
def test_fused_layer_route_equals_the_k8_chain(dev, exact_f32, route, dtype):
    """layer1's run (a downsample at stride 1, then two identities) with every
    block forced onto one route: K9 equals the K8 chain bit for bit and the
    plain chain within its limit."""
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    widths, b, hw = ["layer1.0", "layer1", "layer1"], 1, (19, 45)
    blocks = [_fused_params(fused_block_case(60 + i, *R50_WIDTHS[wd], b=b, hw=hw)[1], dev)
              for i, wd in enumerate(widths)]
    plans = [_forced_plan(route, b, hw, wd, dtype) for wd in widths]
    x = fused_block_case(70, *R50_WIDTHS[widths[0]], b=b, hw=hw)[0][:, 1:-1]
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)
    before = cuda.FUSED_LAYER.launches
    out = ops_fb.fused_layer(x, blocks, plans)
    assert cuda.FUSED_LAYER.launches == before + 1
    ref = ops_fb.fused_layer_reference(x, blocks)
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(dtype, ref, len(blocks))
    chain = ops_fb.pad_rows(x)
    for p, plan in zip(blocks, plans):
        chain = ops_fb.fused_bottleneck(chain, p, plan)
    assert torch.equal(out, ops_fb.unpad_rows(chain))


def test_fused_refuses_a_plan_that_does_not_fit(dev):
    """The plan refuses the halo route at layer4's widths before any launch;
    a plan the kernel does not take (odd tile rows) is refused at launch,
    with no launch counted."""
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    with pytest.raises(ValueError):
        _forced_plan("halo", 1, (6, 8), "layer4", torch.bfloat16)
    before = cuda.FUSED_BOTTLENECK.launches
    bad = _forced_plan("halo", 1, (6, 8), "layer1", torch.bfloat16)._replace(rows=3)
    x, p = fused_block_case(4, *R50_WIDTHS["layer1"], b=1, hw=(6, 8))
    with pytest.raises(RuntimeError):
        ops_fb.fused_bottleneck(torch.from_numpy(x).to(dev, torch.bfloat16), _fused_params(p, dev), bad)
    assert cuda.FUSED_BOTTLENECK.launches == before


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    x, p = fused_block_case(0, 64, 16, 64, False, hw=(6, 8))
    x, p = torch.from_numpy(x).to(dev), _fused_params(p, dev)
    with pytest.raises(ValueError):  # x not contiguous
        ops_fb.fused_bottleneck(x.transpose(1, 2).contiguous().transpose(1, 2), p)
    with pytest.raises(ValueError):  # a weight on the CPU
        ops_fb.fused_bottleneck(x, p._replace(w2=p.w2.cpu()))
    with pytest.raises(ValueError):  # a dtype the kernels do not take
        ops_fb.fused_layer(x[:, 1:-1].contiguous().double(), [p])
    with pytest.raises(ValueError):  # channels the block does not keep without a downsample
        ops_fb.fused_layer(x[:, 1:-1, :, :32].contiguous(), [p])


def tiny_mask_rcnn(take_all=False):
    """A small f32 Mask R-CNN (full-width R50, 9 classes, 64-wide shared FCs,
    two 32-channel mask convs, 10 detections an image at 128 x 128, GS
    head) with seeded weights; with `take_all`, sampling made deterministic
    (every anchor and RoI candidate sampled, the GS others' budget covering
    them all)."""
    import dataclasses

    from balancedgroupsoftmax_torch import config as C
    from balancedgroupsoftmax_torch.gs.partition import make_partition
    from balancedgroupsoftmax_torch.models.detector import build_model

    cfg = C.DetectorConfig(
        bbox_head=C.BBoxHeadConfig(num_classes=9, use_gs=True, fc_out_channels=64, gs=C.GSConfig(num_bins=5)),
        rpn_proposal_train=C.ProposalConfig(nms_pre=128, nms_post=64, max_num=64),
        rpn_proposal_test=C.ProposalConfig(nms_pre=128, nms_post=64, max_num=64),
        rcnn_train=C.RCNNTrainConfig(sampler=C.SamplerConfig(num=32, pos_fraction=0.25)),
        rcnn_test=C.RCNNTestConfig(max_per_img=10),
        mask_head=C.MaskHeadConfig(num_classes=9, conv_out_channels=32, num_convs=2),
    )
    if take_all:
        anchors = 3 * sum((128 // s) ** 2 for s in cfg.anchors.strides)
        every = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
        cfg = dataclasses.replace(
            cfg, rpn_train=every(cfg.rpn_train, anchors), rcnn_train=every(cfg.rcnn_train, 64 + 8),
            bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
        )
    partition = make_partition(np.array([0, 5, 50, 500, 5000, 7, 70, 700, 7000]))
    return cfg, partition, build_model(cfg, partition).init_weights(0)


def mask_rcnn_batch(seed=0):
    """Two 128 x 128 images with three gt boxes each and their mask crops
    (seeded ellipses)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, 8, 4), np.float32)
    labels = np.zeros((2, 8), np.int64)
    valid = np.zeros((2, 8), bool)
    for i in range(2):
        for j in range(3):
            x1, y1 = rng.uniform(0, 60, 2)
            w, h = rng.uniform(20, 50, 2)
            boxes[i, j] = [x1, y1, min(x1 + w, 127), min(y1 + h, 127)]
            labels[i, j], valid[i, j] = rng.randint(1, 9), True
    yy, xx = np.mgrid[:112, :112] / 112.0
    crops = np.zeros((2, 8, 112, 112), np.float32)
    for i, j in zip(*np.nonzero(valid)):
        cy, cx = rng.uniform(0.3, 0.7, 2)
        ry, rx = rng.uniform(0.2, 0.5, 2)
        crops[i, j] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return dict(
        images=torch.from_numpy(rng.randn(2, 128, 128, 3).astype(np.float32)), gt_boxes=torch.from_numpy(boxes),
        gt_labels=torch.from_numpy(labels), gt_mask=torch.from_numpy(valid),
        img_shapes=torch.tensor([[128.0, 128.0]] * 2), gt_mask_crops=torch.from_numpy(crops),
    )


def test_mask_rcnn_predict_with_masks_on_the_card_equals_the_cpu(dev, exact_f32):
    """Detections with the same label within 1e-2 px and scores within 1e-4
    (convolutions sum in other orders), their masks within 1e-3."""
    _, _, cpu_model = tiny_mask_rcnn()
    cpu_model.eval()
    card_model = copy.deepcopy(cpu_model).to(dev)
    images = mask_rcnn_batch()["images"]
    shapes, sf = torch.tensor([[128.0, 128.0]] * 2), torch.tensor([1.0, 0.5])
    before = cuda.ROI_ALIGN.launches
    g, gm = card_model.predict_with_masks(images.to(dev), shapes.to(dev), sf.to(dev))
    assert cuda.ROI_ALIGN.launches == before + 2
    g, gm = [t.cpu() for t in g], gm.cpu()
    c, cm = cpu_model.predict_with_masks(images, shapes, sf)
    assert gm.shape == cm.shape == (2, 10, 28, 28)
    assert (g[1] - c[1]).abs().max().item() <= 1e-4
    matched = 0
    for b in range(2):
        for i in torch.nonzero(g[3][b]).flatten().tolist():
            same = c[3][b] & (c[2][b] == g[2][b, i]) & ((c[0][b] - g[0][b, i]).abs().amax(-1) <= 1e-2)
            if bool(same.any()):
                matched += 1
                j = int(torch.nonzero(same)[0])
                assert (gm[b, i] - cm[b, j]).abs().max().item() <= 1e-3
    assert matched >= 0.95 * int(g[3].sum()) > 0


def test_mask_rcnn_training_step_on_the_card_equals_the_cpu(dev, exact_f32, monkeypatch):
    """One f32 selectp=0 step, sampling deterministic: the loss dicts within
    1e-3 relative, every gradient within 1e-2 of its norm (chip_smoke.py's
    GRAD_NORM_LIMIT), and K2b at S = 14, as the mask branch called it, equal
    to its plain version (f32: 1e-5 of the largest value)."""
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    _, _, cpu_model = tiny_mask_rcnn(take_all=True)
    card_model = copy.deepcopy(cpu_model)
    batch = mask_rcnn_batch()
    calls = []
    backward = ops_roi.roi_align_backward
    monkeypatch.setattr(ops_roi, "roi_align_backward", lambda *a, **k: calls.append((a, k)) or backward(*a, **k))
    out, grads = {}, {}
    for name, model, device in (("card", card_model.to(dev), dev), ("cpu", cpu_model, torch.device("cpu"))):
        step = make_train_step(create_train_state(model, TrainConfig(selectp=0)))
        out[name] = {k: v.item() for k, v in step(batch, torch.Generator(device=device).manual_seed(0)).items()}
        grads[name] = {n: p.grad.double().cpu() for n, p in model.named_parameters() if p.grad is not None}
    assert sorted(out["card"]) == sorted(out["cpu"]) and "loss_mask" in out["cpu"]
    for k, v in out["cpu"].items():
        assert abs(out["card"][k] - v) <= 1e-3 * max(abs(v), 1e-6), k
    assert sorted(grads["card"]) == sorted(grads["cpu"])
    for n, w in grads["cpu"].items():
        assert (grads["card"][n] - w).norm() <= 1e-2 * w.norm().clamp(min=1e-30), n
    (grad, rois, shapes, strides, size), kw = next((a[:5], k) for a, k in calls if a[0].is_cuda and a[4] == 14)
    out = backward(grad, rois, shapes, strides, size, dtype=kw["dtype"], levels=kw["levels"])
    ref = ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, size, dtype=kw["dtype"])
    for o, r in zip(out, ref):
        assert (o - r).abs().max().item() <= 1e-5 * max(r.abs().max().item() for r in ref)


def crowded_rows(seed, g, n, spread=120):
    """(G, N, 4) boxes crowded into a few clusters, scores, ~10% invalid."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(40, 40 + spread, (g, n, 2))
    wh = rng.uniform(20, 60, (g, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    return boxes, rng.rand(g, n).astype(np.float32), rng.rand(g, n) > 0.1


@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
def test_soft_nms_on_the_card_equals_the_cpu(dev, method):
    """Soft-NMS is plain PyTorch on the card too (JAX runs it as XLA): the
    same selections and validity, scores within 1e-6; it launches no kernel
    of the port."""
    boxes, scores, valid = (torch.from_numpy(x) for x in crowded_rows(1, 40, 300))
    before = {k.symbol: k.launches for k in cuda.KERNELS}
    g = [t.cpu() for t in ops_nms.soft_nms(boxes.to(dev), scores.to(dev), valid.to(dev), 0.5, method, max_out=300)]
    assert {k.symbol: k.launches for k in cuda.KERNELS} == before
    c = ops_nms.soft_nms(boxes, scores, valid, 0.5, method, max_out=300)
    assert torch.equal(g[2], c[2]) and torch.equal(g[0], c[0])
    assert (g[1] - c[1]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("agnostic", [False, True])
def test_soft_multiclass_nms_on_the_card_equals_the_cpu(dev, agnostic):
    from balancedgroupsoftmax_torch import kernels

    rng = np.random.RandomState(2)
    b, n, c = 2, 200, 41
    boxes = crowded_rows(3, b, n * c)[0].reshape(b, n, c * 4)
    boxes = boxes[..., :4].copy() if agnostic else boxes
    logits = rng.randn(b, n, c).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores.astype(np.float32)), torch.from_numpy(rng.rand(b, n) > 0.1))
    kw = dict(candidates_per_class=100, nms_type="soft_nms")
    g = [t.cpu() for t in kernels.batched_multiclass_nms(*(t.to(dev) for t in args), 0.0, 0.5, 30, **kw)]
    cc = kernels.batched_multiclass_nms(*args, 0.0, 0.5, 30, **kw)
    assert torch.equal(g[3], cc[3]) and torch.equal(g[2], cc[2]) and torch.equal(g[0], cc[0]) and g[3].any()
    assert (g[1] - cc[1]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("views", [2, 4])
def test_tta_merges_on_the_card_equal_the_cpu(dev, views):
    """The proposal merge (`ops/nms.py nms`, K1 once on V x 1000-box rows)
    and the detection-level merge (`eval/aug.py merge_aug_detections`, K1
    once on the batch's (1 + V) x 300 label-offset rows at labels near 1230)
    equal their CPU results."""
    from balancedgroupsoftmax_torch.eval.aug import merge_aug_detections

    boxes, valid = tie_rows(views, 2, views * 1000, 0.7)
    scores = np.random.RandomState(views).choice(np.linspace(0.1, 0.9, 50), (2, views * 1000)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (boxes, scores, valid)]
    before = cuda.NMS_KEEP.launches
    g = [t.cpu() for t in ops_nms.nms(*(t.to(dev) for t in args), 0.7, 1000)]
    assert cuda.NMS_KEEP.launches == before + 1
    for gt, ct in zip(g, ops_nms.nms(*args, 0.7, 1000)):
        assert torch.equal(gt, ct)

    n = (1 + views) * 300
    boxes, valid = tie_rows(views + 10, 2, n, 0.5)
    labels = np.random.RandomState(views).randint(1220, 1230, (2, n)).astype(np.int32)
    scores = np.random.RandomState(views + 1).rand(2, n).astype(np.float32)
    before = cuda.NMS_KEEP.launches
    g = merge_aug_detections(boxes, scores, labels, valid, dev)
    assert cuda.NMS_KEEP.launches == before + 1
    for gk, ck in zip(g, merge_aug_detections(boxes, scores, labels, valid, torch.device("cpu"))):
        np.testing.assert_array_equal(gk, ck)
