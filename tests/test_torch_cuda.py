"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc and skip without them. On the H100, where
JAX is not installed, run them without tests/conftest.py (which imports JAX):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`. Keep masks
and gathered candidates (K3, K6) must be equal; RoIAlign does the plain version's f32
operations in its order, so f32 agrees to 1e-5 and bf16 to one bf16 step
(2^-7 relative to the largest value). The deformable conv (K7) samples with
the plain version's f32 operations in its order but contracts in another, so
f32 agrees to 1e-5 of the largest |output| and bf16 to one bf16 step of it. Its gradient (K2b) sums with atomics,
in an order that changes from run to run, so f32 agrees to 1e-5 relative to
the largest value and bf16 to one bf16 step.

This file imports nothing of JAX, so it also holds the numpy-built inputs
that the port's CPU tests share.
"""

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


def gathered_case(seed, g=6, k=40, n=100, thr=0.5):
    """Coordinate planes (G, 4, N), distinct candidate indices (G, K) and
    validity for the gathered NMS."""
    rng = np.random.RandomState(seed)
    boxes, _ = tie_rows(seed, g, n, thr, spread=120)
    planes = np.ascontiguousarray(boxes.transpose(0, 2, 1))
    idx = np.stack([rng.permutation(n)[:k] for _ in range(g)]).astype(np.int32)
    valid = rng.rand(g, k) > 0.15
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


@pytest.mark.parametrize("k", [60, 1000])
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
    with pytest.raises(ValueError):  # (G, K, 4) boxes where K5 takes (G, 4, K) planes
        ops_nms.nms_keep_batched_coords(torch.zeros(2, 8, 4, device=dev), torch.ones(2, 8, dtype=torch.bool, device=dev), 0.5)
    from balancedgroupsoftmax_torch.ops import gather as ops_gather

    with pytest.raises(ValueError):  # int64 indices
        ops_gather.gather_lanes(torch.zeros(1, 4, 8, device=dev), torch.zeros(2, 3, dtype=torch.int64, device=dev), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "window,stride,groups,c_in,c_out,modulated",
    [
        (4, 2, 64, 512, 512, False),  # the X101's first c3 block: groups of 8
        (4, 1, 64, 1024, 1024, False),  # c4: groups of 16
        (4, 1, 64, 2048, 2048, False),  # c5: groups of 32
        (0, 1, 8, 128, 128, False),  # no clamp
        (0, 2, 4, 32, 24, True),  # v2, output groups narrower than input ones
        (4, 1, 1, 16, 16, True),
    ],
)
def test_deform_conv_matches_plain(dev, dtype, window, stride, groups, c_in, c_out, modulated):
    x, off, weight, mask = deform_case(c_in + stride, c_in, c_out, groups, stride, window, modulated, hw=(23, 37))
    x, weight = (torch.from_numpy(a).to(dev, dtype) for a in (x, weight))
    off = torch.from_numpy(off).to(dev)
    mask = torch.from_numpy(mask).to(dev) if modulated else None
    before = cuda.DEFORM_CONV.launches
    out = ops_dcn.deform_conv2d(x, off, weight, mask, stride, 1, groups, window)
    assert cuda.DEFORM_CONV.launches == before + 1
    ref = ops_dcn.deform_conv2d_reference(x, off, weight, mask, stride, 1, groups, window).float()
    top = ref.abs().max().item()
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= (1e-5 if dtype == torch.float32 else 2.0**-7) * top


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
