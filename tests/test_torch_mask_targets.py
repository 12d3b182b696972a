"""The port's mask targets and mask losses against the JAX package, on the
CPU: `rasterize_gt_masks` equal to JAX's bit for bit on polygon and RLE
segmentations (flipped too, as the train CLI flips them); `mask_targets`
equal to JAX's `mask_target_single` exactly, on rois that are the gt boxes
(every sample then sits halfway between crop pixels, where a rasterised
rectangle's edge gives exactly 0.5), jittered and random; the port's copy of
the RLE helpers equal to JAX's; `semantic_seg_loss` and `mask_head_loss`
within 1e-6, with their gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models.mask_head import mask_head_loss as jax_mask_head_loss
from balancedgroupsoftmax_tpu.models.semantic_head import semantic_seg_loss as jax_semantic_seg_loss
from balancedgroupsoftmax_tpu.ops.mask import mask_target_single as jax_mask_target_single
from balancedgroupsoftmax_tpu.ops.mask import rasterize_gt_masks as jax_rasterize_gt_masks
from balancedgroupsoftmax_tpu.utils import rle as jax_rle
from balancedgroupsoftmax_torch.models.mask_head import mask_head_loss
from balancedgroupsoftmax_torch.models.semantic_head import semantic_seg_loss
from balancedgroupsoftmax_torch.ops.mask import GT_MASK_CROP, mask_targets, rasterize_gt_masks
from balancedgroupsoftmax_torch.utils import rle


def segmentations(seed, n=6, h=90, w=120):
    """Boxes (N, 4) and segmentations: integer and fractional rectangles,
    a triangle, a two-polygon field, and RLE (compressed and counts)."""
    rng = np.random.RandomState(seed)
    segs, boxes = [], []
    for i in range(n):
        x1, y1 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
        bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
        if i % 3 == 0:
            x1, y1, bw, bh = (float(np.round(v)) for v in (x1, y1, bw, bh))
        x2, y2 = x1 + bw, y1 + bh
        kind = i % 4
        if kind in (0, 1):
            seg = [[x1, y1, x2, y1, x2, y2, x1, y2]]
        elif kind == 2:
            seg = [[x1, y2, (x1 + x2) / 2, y1, x2, y2], [x1, y1, x1 + 4, y1, x1 + 4, y1 + 4, x1, y1 + 4]]
        else:
            m = np.zeros((h, w), np.uint8)
            m[int(y1) : int(y2), int(x1) : int(x2)] = 1
            m[int(y1) : int(y1 + bh / 2), int(x1) : int(x1 + bw / 3)] = 0
            seg = jax_rle.encode_mask(m)
            if i % 2:
                seg = dict(seg, counts=jax_rle.decode_counts(seg["counts"]))
        segs.append(seg)
        boxes.append([x1, y1, x2 - 1, y2 - 1])
    segs[-1] = None  # a gt with no segmentation: an empty crop
    return segs, np.asarray(boxes, np.float32), h, w


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("flip", [False, True])
def test_rasterize_gt_masks_equals_jax(seed, flip):
    segs, boxes, h, w = segmentations(seed)
    want = jax_rasterize_gt_masks(segs, boxes, h, w, capacity=8)
    got = rasterize_gt_masks(segs, boxes, h, w, capacity=8)
    if flip:
        want, got = want[:, :, ::-1], got[:, :, ::-1]
    assert got.shape == (8, GT_MASK_CROP, GT_MASK_CROP) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[5:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_copy_equals_jax(seed):
    segs, _, h, w = segmentations(seed)
    for seg in segs[:-1]:
        np.testing.assert_array_equal(rle.segmentation_to_mask(seg, h, w), jax_rle.segmentation_to_mask(seg, h, w))
    s = jax_rle.encode_mask(rle.segmentation_to_mask(segs[0], h, w))["counts"]
    assert rle.decode_counts(s) == jax_rle.decode_counts(s)


def target_case(seed, b=2, s=40, g=6):
    segs, boxes, h, w = segmentations(seed, n=g)
    rng = np.random.RandomState(seed + 10)
    crops = np.stack([jax_rasterize_gt_masks(segs, boxes, h, w, capacity=g) for _ in range(b)])
    crops[1] = crops[1][:, :, ::-1]
    gt = np.stack([boxes * 1.5, boxes * 0.75]).astype(np.float32)  # network scale
    inds = rng.randint(0, g, (b, s)).astype(np.int32)
    rois = np.take_along_axis(gt, inds[..., None].astype(np.int64), 1).copy()
    jitter = slice(s // 3, 2 * s // 3)
    rois[:, jitter] += rng.randn(b, s // 3, 4).astype(np.float32) * 3
    rois[:, 2 * s // 3 :] = rng.uniform(0, 100, (b, s - 2 * s // 3, 4)).astype(np.float32)
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2] + 1)
    rois[0, -1] = [-20, -30, -5, -10]  # off the gt crop: no target
    pos = rng.rand(b, s) < 0.8
    return rois, gt, inds, crops.astype(np.float32), pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_targets_equal_jax_exactly(seed):
    rois, gt, inds, crops, pos = target_case(seed)
    want = jax.jit(jax.vmap(lambda r, g, i, c, p: jax_mask_target_single(r, g, i, c, p, 28)))(rois, gt, inds, crops, pos)
    T = torch.from_numpy
    got = mask_targets(T(rois), T(gt), T(inds), T(crops), T(pos), 28)
    assert got.shape == (2, 40, 28, 28) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.mean() < 1 and not got[~T(pos)].any()


def test_semantic_seg_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 12, 9, 11).astype(np.float32)
    labels = rng.randint(0, 12, (2, 9, 11)).astype(np.int32)
    labels[rng.rand(2, 9, 11) < 0.3] = 255
    f = lambda x: jax_semantic_seg_loss(jnp.transpose(x, (0, 2, 3, 1)), labels, 255, 0.2)
    want, gwant = jax.value_and_grad(f)(logits)
    x = torch.from_numpy(logits).requires_grad_()
    got = semantic_seg_loss(x, torch.from_numpy(labels), 255, 0.2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), rtol=0, atol=1e-6 * np.abs(gwant).max())
    none = semantic_seg_loss(x, torch.full((2, 9, 11), 255), 255, 0.2)
    assert none.item() == 0.0  # every pixel ignored: no loss, no division by zero


@pytest.mark.parametrize("mode", ["preselected", "dense", "class_agnostic"])
def test_mask_head_loss_matches_jax(mode):
    rng = np.random.RandomState(1)
    n, m, k = 10, 28, 8
    labels = rng.randint(0, k + 1, n).astype(np.int32)
    pos = (labels > 0) & (rng.rand(n) < 0.9)
    targets = (rng.rand(n, m, m) < 0.4).astype(np.float32)
    shape = {"preselected": (n, m, m), "dense": (n, m, m, k), "class_agnostic": (n, m, m, 1)}[mode]
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    kw = dict(class_agnostic=mode == "class_agnostic", preselected=mode == "preselected")
    want, gwant = jax.value_and_grad(lambda x: jax_mask_head_loss(x, targets, labels, pos, **kw))(logits)
    port_logits = logits if mode == "preselected" else np.moveaxis(logits, -1, 1)  # the port's NCHW
    x = torch.from_numpy(np.ascontiguousarray(port_logits)).requires_grad_()
    got = mask_head_loss(x, torch.from_numpy(targets), torch.from_numpy(labels), torch.from_numpy(pos), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    gport = x.grad.numpy() if mode == "preselected" else np.moveaxis(x.grad.numpy(), 1, -1)
    np.testing.assert_allclose(gport, np.asarray(gwant), rtol=0, atol=1e-6 * np.abs(gwant).max())
