#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each timed, any failure ending the run with a non-zero exit:
1. build the CUDA kernels of balancedgroupsoftmax_torch/csrc with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, and time both: K1-K3 at inference's, K4 (the
   training RPN's NMS) and K2b (the RoIAlign gradient) at training's, K5 and
   K6 (the class-agnostic multiclass NMS) on inputs with exact ties and
   out-of-range indices at the cascade's shapes;
3. run BAGS Faster R-CNN R50-FPN (gs_faster_rcnn_r50_fpn_lvis: 1231 classes,
   800 x 1344, bf16, batch 2, seeded random weights and synthetic partition)
   through `init_detector` and `predict`, check that K1-K3 were launched and
   that the detections are well formed, and profile one `predict` (device
   time by kernel, idle share);
4. run the same model in f32 on a small image on the card and on the CPU
   (the plain versions) and compare the detections;
5. train the same model (bf16 compute, f32 parameters, batch 2 at 800 x
   1344, 20 synthetic gt boxes an image through the training pipeline)
   through `create_train_state` and `make_train_step`: a warm-up step and
   timed steps of full training (selectp=0), checking that the losses are
   finite, that K4 and K2b were launched and that the parameters moved;
   profile one step; then one BAGS phase-2 step (selectp=1), which must
   move fc_cls alone;
6. take one small f32 training step on the card and on the CPU from the
   same weights and batch, sampling made deterministic by the
   configuration, and compare the loss dicts;
7-10. the same four phases for BAGS Cascade R-CNN R50-FPN
   (cascade_rcnn_r50_fpn_lvis with GS heads, built through `build_model`):
   `predict` must launch K1, K2 (once a stage), K6 and K5 and not K3; K5
   and K6 are held to their plain versions again, and timed, on the inputs
   that predict gave them; the BAGS phase-2 step (selectp=3) must move the
   three stages' fc_cls alone;
11. serve BAGS HTC X101-64x4d with deformable conv c3-c5
   (htc_x101_64x4d_fpn_lvis(use_gs=True, dcn=True): 1231 classes, D = 4,
   bf16, 800 x 1344, batch 2, offset convs given seeded non-zero weights)
   through `build_model` and `predict_with_masks`, which must launch K7 30
   times, K2 8 times, K1, K6 and K5 once and K3 never a call; check the
   detections and that the masks are probabilities; profile one call; then
   hold K7 against its plain version, and time it, on the inputs that one
   call gave each of the 30 deformable layers;
12. run a reduced HTC-DCN (depth 50, the same widths) in f32 on a small
   image on the card and on the CPU and compare detections and masks.

Phase 2 also holds K7 against its plain version on edge cases: the clamp,
the border bands, D = 0, stride 2 and v2 with a mask, in f32 and bf16.

It prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# published H100 SXM peaks (NVIDIA data sheet), against which bounds are stated
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
# f32 operations of one IoU-above-threshold test (ops/boxes.py order)
IOU_OPS = 17
# f32 operations of one RoIAlign sample: 4 weights, 4 products, 3 adds, 1 add to the bin sum
SAMPLE_OPS = 12
# f32 operations of one deformable-conv sample and channel: the blend's 4 products and 3 adds
DCN_SAMPLE_OPS = 7

MAIN_BATCH = 2
MAX_PER_IMG = 300  # rcnn_test: the class cap of the multiclass NMS
MAIN_SIZE = (800, 1344)
TIMED_PREDICTS = 3
TIMED_STEPS = 3
TRAIN_ROIS = 512  # rcnn_train sampler num: RoIs per image in training
TRAIN_GTS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def valid_pairs(valid) -> int:
    n = valid.sum(dim=1).double()
    return int((n * (n - 1) / 2).sum().item())


def tie_boxes(gen, g: int, k: int, thr: float, device):
    """(G, K, 4) integer-cornered boxes with validity, holding exact duplicates
    (slot 7m + 1 repeats 7m) and pairs exactly at the threshold: slot 7m + 2 is
    [x, y, x + 9, y + 9] and 7m + 3 is [x, y, x + 9, y + 10 thr - 1], whose
    IoU 10 thr / 10 equals thr in f32 and so must not suppress."""
    import torch

    xy = torch.randint(0, 400, (g, k, 2), generator=gen).float()
    wh = torch.randint(4, 120, (g, k, 2), generator=gen).float()
    boxes = torch.cat([xy, xy + wh], dim=-1)
    m = (k - 4) // 7 + 1  # slots 7m + 3 that exist
    boxes[:, 1::7][:, :m] = boxes[:, 0::7][:, :m]
    corner = boxes[:, 2::7][:, :m, :2]
    boxes[:, 2::7][:, :m] = torch.cat([corner, corner + 9], dim=-1)
    boxes[:, 3::7][:, :m] = torch.cat([corner, corner + torch.tensor([9.0, round(10 * thr) - 1])], dim=-1)
    valid = torch.rand(g, k, generator=gen) > 0.1
    return boxes.to(device), valid.to(device)


def check_k1(torch, ops_nms, dev):
    g, k = 5 * MAIN_BATCH, 1000
    boxes, valid = tie_boxes(torch.Generator().manual_seed(1), g, k, 0.7, dev)
    keep = ops_nms.nms_keep_batched(boxes, valid, 0.7)
    ref = ops_nms.nms_keep_reference(boxes, valid, 0.7)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref):
        raise AssertionError(f"K1 keep differs from the plain version in {(keep != ref).sum().item()} slots")
    nbytes = boxes.numel() * 4 + valid.numel() * 2
    b_ms, b_by = bound(nbytes, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:304",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_batched(boxes, valid, 0.7), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_reference(boxes, valid, 0.7), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} kept={int(keep.sum())}",
    )


def check_k5_ties(torch, ops_nms, dev) -> None:
    """K5 at the cascade's shape (2 images x 300 classes, 300 candidates) on
    rows with duplicates, exact-threshold pairs and invalid slots."""
    g, k = MAX_PER_IMG * MAIN_BATCH, 300
    for thr in (0.5, 0.7):
        boxes, valid = tie_boxes(torch.Generator().manual_seed(10), g, k, thr, dev)
        coords = boxes.transpose(1, 2).contiguous()
        keep = ops_nms.nms_keep_batched_coords(coords, valid, thr)
        ref = ops_nms.nms_keep_reference(boxes, valid, thr)
        torch.cuda.synchronize()
        if not torch.equal(keep, ref):
            raise AssertionError(f"K5 keep at thr {thr} differs in {(keep != ref).sum().item()} slots")
        log(f"  K5 ties thr={thr}: keep equal to the plain version ({int(keep.sum())} kept of {int(valid.sum())})")


def check_k6_ties(torch, ops_gather, dev) -> None:
    """K6 at the cascade's shape: two (4, 1000) planes of f32 values that
    bf16 cannot hold, 300 groups each, some indices outside [0, N)."""
    gen = torch.Generator().manual_seed(11)
    n, k = 1000, 300
    planes = (torch.rand(MAIN_BATCH, 4, n, generator=gen) * 1333 + 2.0**-13).to(dev)
    idx = torch.randint(-5, n + 5, (MAIN_BATCH * MAX_PER_IMG, k), generator=gen, dtype=torch.int32).to(dev)
    out = ops_gather.gather_lanes(planes, idx, MAX_PER_IMG)
    ref = ops_gather.gather_lanes_reference(planes, idx, MAX_PER_IMG)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K6 is not bit-equal to the plain gather")
    log(f"  K6: bit-equal to the plain version ({int(((idx < 0) | (idx >= n)).sum())} indices outside the plane)")


def check_k5(torch, ops_nms, coords, valid, thr):
    """K5 on the inputs the cascade's predict gave it."""
    keep = ops_nms.nms_keep_batched_coords(coords, valid, thr)
    ref = ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, thr)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref):
        raise AssertionError(f"K5 keep on the path's data differs in {(keep != ref).sum().item()} slots")
    g, k = valid.shape
    nbytes = coords.numel() * 4 + valid.numel() * 2
    b_ms, b_by = bound(nbytes, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep_batched_coords",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:316",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_batched_coords(coords, valid, thr), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, thr), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} valid={int(valid.sum())} pairs={valid_pairs(valid)} kept={int(keep.sum())}",
    )


def check_k6(torch, ops_gather, planes, idx, groups_per_plane):
    """K6 on the inputs the cascade's predict gave it; `torch.gather` on the
    plane expanded over its groups computes the same function."""
    out = ops_gather.gather_lanes(planes, idx, groups_per_plane)
    ref = ops_gather.gather_lanes_reference(planes, idx, groups_per_plane)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K6 on the path's data is not bit-equal to the plain gather")
    p, r, n = planes.shape
    g, k = idx.shape
    src = planes[:, None].expand(p, groups_per_plane, r, n)
    index = idx.long().view(p, groups_per_plane, 1, k).expand(p, groups_per_plane, r, k)
    lib = torch.gather(src, 3, index).reshape(g, r, k)
    if not torch.equal(lib, out):
        raise AssertionError("torch.gather disagrees with K6")
    nbytes = out.numel() * 4 + idx.numel() * 4 + planes.numel() * 4
    b_ms, b_by = bound(nbytes, 0)
    return dict(
        name="gather_lanes",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/gather.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/gather.py:59",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_gather.gather_lanes(planes, idx, groups_per_plane), 50),
        plain_ms=cuda_time_ms(lambda: ops_gather.gather_lanes_reference(planes, idx, groups_per_plane), 10),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=cuda_time_ms(lambda: torch.gather(src, 3, index), 50),
        shape=f"P={p} R={r} N={n} G={g} K={k}",
    )


def pyramid(torch, dtype, dev, gen):
    h, w = MAIN_SIZE
    return [
        torch.randn(MAIN_BATCH, -(-h // s), -(-w // s), 256, generator=gen).to(dev, dtype)
        for s in (4, 8, 16, 32)
    ]


def main_rois(torch, dev, gen, r=1000):
    """Proposal-like rois over all four levels (side 8 to 800 pixels)."""
    h, w = MAIN_SIZE
    side = torch.exp(torch.empty(MAIN_BATCH, r, 2).uniform_(2.0, 6.7, generator=gen))
    x1 = torch.rand(MAIN_BATCH, r, generator=gen) * (w - 1)
    y1 = torch.rand(MAIN_BATCH, r, generator=gen) * (h - 1)
    rois = torch.stack(
        [x1, y1, (x1 + side[..., 0]).clamp(max=w - 1), (y1 + side[..., 1]).clamp(max=h - 1)], -1
    )
    return rois.to(dev)


def check_k2(torch, ops_roi, dev):
    gen = torch.Generator().manual_seed(2)
    rois = main_rois(torch, dev, gen)
    strides = (4, 8, 16, 32)
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, None)):
        feats = pyramid(torch, dtype, dev, gen)
        out = ops_roi.multilevel_roi_align(feats, rois, strides)
        ref = ops_roi.multilevel_roi_align_reference(feats, rois, strides)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # f32: the same operations in the same order, so equal up to 1e-5
        # (|x| <= ~5); bf16: should an f32 sum differ in its last bit, it may
        # round to the neighbouring bf16 value, one bf16 step (2^-7 relative)
        limit = tol if tol is not None else 2.0**-7 * ref.float().abs().max().item()
        log(f"  K2 {dtype}: max |kernel - plain| = {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"K2 {dtype}: max abs err {err} above {limit}")
        results[dtype] = (feats, err)
    feats, err = results[torch.bfloat16]
    lvl_shapes = [(f.shape[1], f.shape[2]) for f in feats]
    index, _, valid = ops_roi.sample_points(lvl_shapes, rois, strides)
    touched = torch.unique(index[:, valid]).numel()
    out_elems = rois.shape[0] * rois.shape[1] * 49 * 256
    nbytes = touched * 256 * 2 + rois.numel() * 4 + out_elems * 2
    b_ms, b_by = bound(nbytes, out_elems * 4 * SAMPLE_OPS)
    return dict(
        name="roi_align_forward",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/roi_align.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/roi_align.py:511",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ops_roi.multilevel_roi_align(feats, rois, strides), 20),
        plain_ms=cuda_time_ms(lambda: ops_roi.multilevel_roi_align_reference(feats, rois, strides), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"B={MAIN_BATCH} R=1000 S=7 C=256 bf16, f32 err {results[torch.float32][1]:.3e}",
    )


def check_k3(torch, ops_nms, dev):
    g, k, n = 300 * MAIN_BATCH, 300, 1000
    gen = torch.Generator().manual_seed(3)
    boxes, _ = tie_boxes(gen, g, n, 0.5, "cpu")
    planes = boxes.permute(0, 2, 1).contiguous().to(dev)
    idx = torch.argsort(torch.rand(g, n, generator=gen), dim=1)[:, :k].to(torch.int32).to(dev)
    valid = (torch.rand(g, k, generator=gen) > 0.1).to(dev)
    keep, cand = ops_nms.nms_keep_gathered(planes, idx, valid, 0.5)
    ref_keep, ref_cand = ops_nms.nms_keep_gathered_reference(planes, idx, valid, 0.5)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref_keep):
        raise AssertionError(f"K3 keep differs in {(keep != ref_keep).sum().item()} slots")
    if not torch.equal(cand.view(torch.int32), ref_cand.view(torch.int32)):
        raise AssertionError("K3 candidates are not bit-equal to the plain gather")
    nbytes = g * k * 4 * 4 + idx.numel() * 4 + valid.numel() * 2 + cand.numel() * 4
    b_ms, b_by = bound(nbytes, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep_gathered",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:371",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_gathered(planes, idx, valid, 0.5), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_gathered_reference(planes, idx, valid, 0.5), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} N={n} kept={int(keep.sum())}",
    )


def check_k4(torch, ops_nms, dev):
    """K4 at the training RPN's shape (5 levels x 2 images, 2000 boxes a
    row) and at a K that is no multiple of 64."""
    g, k = 5 * MAIN_BATCH, 2000
    gen = torch.Generator().manual_seed(6)
    for kk in (k, 1337):
        boxes, valid = tie_boxes(gen, g, kk, 0.7, dev)
        keep = ops_nms.nms_keep_tiled(boxes, valid, 0.7)
        ref = ops_nms.nms_keep_reference(boxes, valid, 0.7)
        torch.cuda.synchronize()
        if not torch.equal(keep, ref):
            raise AssertionError(f"K4 keep at K={kk} differs in {(keep != ref).sum().item()} slots")
        log(f"  K4 K={kk}: keep equal to the plain version ({int(keep.sum())} kept of {int(valid.sum())})")
    boxes, valid = tie_boxes(gen, g, k, 0.7, dev)
    nbytes = boxes.numel() * 4 + valid.numel() * 2
    b_ms, b_by = bound(nbytes, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep_tiled",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:213",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_tiled(boxes, valid, 0.7), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_reference(boxes, valid, 0.7), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k}",
    )


def check_k2b(torch, ops_roi, dev):
    """K2b at the training head's shape: 512 rois an image on the 800 x 1344
    pyramid, C=256, 7 x 7, sample_num 2."""
    gen = torch.Generator().manual_seed(7)
    rois = main_rois(torch, dev, gen, TRAIN_ROIS)
    strides = (4, 8, 16, 32)
    h, w = MAIN_SIZE
    shapes = [(-(-h // s), -(-w // s)) for s in strides]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        grad = torch.randn(MAIN_BATCH, TRAIN_ROIS, 7, 7, 256, generator=gen).to(dev, dtype)
        out = ops_roi.roi_align_backward(grad, rois, shapes, strides, dtype=dtype)
        ref = ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, dtype=dtype)
        torch.cuda.synchronize()
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        top = max(r.float().abs().max().item() for r in ref)
        # atomics sum in another order than index_add_: f32 within 1e-5 of
        # the largest value, bf16 within one bf16 step (2^-7) of it
        limit = (1e-5 if dtype == torch.float32 else 2.0**-7) * top
        log(f"  K2b {dtype}: max |kernel - plain| = {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"K2b {dtype}: max abs err {err} above {limit}")
        results[dtype] = (grad, err)
    grad, err = results[torch.bfloat16]
    pyramid_elems = MAIN_BATCH * sum(a * b for a, b in shapes) * 256
    nbytes = grad.numel() * 2 + rois.numel() * 4 + pyramid_elems * 2
    b_ms, b_by = bound(nbytes, grad.numel() * 4 * SAMPLE_OPS)
    return dict(
        name="roi_align_backward",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/roi_align.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/roi_align.py:569",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ops_roi.roi_align_backward(grad, rois, shapes, strides, dtype=torch.bfloat16), 20),
        plain_ms=cuda_time_ms(
            lambda: ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, dtype=torch.bfloat16), 3
        ),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"B={MAIN_BATCH} R={TRAIN_ROIS} S=7 C=256 bf16, f32 err {results[torch.float32][1]:.3e}",
    )


def check_detections(torch, det, num_classes: int, size) -> None:
    b, m = det.scores.shape
    if det.boxes.shape != (b, m, 4) or det.labels.shape != (b, m) or det.valid.shape != (b, m):
        raise AssertionError(f"detection shapes {[tuple(t.shape) for t in det]}")
    if not bool(det.valid.any()):
        raise AssertionError("no valid detection")
    s = det.scores[det.valid]
    bx = det.boxes[det.valid]
    lab = det.labels[det.valid]
    if not (torch.isfinite(s).all() and ((s >= 0) & (s <= 1)).all()):
        raise AssertionError("scores not finite probabilities")
    if not (torch.isfinite(bx).all() and (bx >= 0).all() and (bx[:, 0::2] <= size[1]).all() and (bx[:, 1::2] <= size[0]).all()):
        raise AssertionError("boxes outside the image")
    if not ((lab >= 0) & (lab < num_classes - 1)).all():
        raise AssertionError("labels outside the foreground classes")
    if not (det.scores[:, :-1] >= det.scores[:, 1:]).all():
        raise AssertionError("detections not in score order")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def run_predicts(torch, model, per_predict: dict, call=None):
    """A first `predict` (or `call`, e.g. `predict_with_masks`) and
    TIMED_PREDICTS timed ones at the main shape, with the kernels' counts set
    to 0 just before and read just after; each kernel of `per_predict` must
    have launched that many times a predict (None: at least once). Returns
    the counts and the inputs."""
    from balancedgroupsoftmax_torch import cuda

    call = call or model.predict
    dev = next(model.parameters()).device
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(MAIN_BATCH, *MAIN_SIZE, 3, generator=gen).to(dev)
    img_shapes = torch.tensor([MAIN_SIZE] * MAIN_BATCH, dtype=torch.float32, device=dev)
    scale_factors = torch.ones(MAIN_BATCH, device=dev)

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call(images, img_shapes, scale_factors)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_PREDICTS):
        out = call(images, img_shapes, scale_factors)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED_PREDICTS * 1e3
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"  first predict {first_s:.2f} s; then {ms:.3f} ms per batch of {MAIN_BATCH}, "
        f"{MAIN_BATCH / ms * 1e3:.2f} images/s, peak memory {peak:.2f} GiB ({card_line()})")
    log(f"  launches over {TIMED_PREDICTS + 1} predicts: {launches}")
    for sym, each in per_predict.items():
        ok = launches[sym] > 0 if each is None else launches[sym] == each * (TIMED_PREDICTS + 1)
        if not ok:
            raise AssertionError(f"{sym} launched {launches[sym]} times, not {each} a predict")
    det, masks = out if isinstance(out, tuple) and len(out) == 2 else (out, None)
    check_detections(torch, det, model.cfg.bbox_head.num_classes, MAIN_SIZE)
    log(f"  detections: {int(det.valid.sum())} valid, top score {det.scores[0, 0].item():.6f}")
    if masks is not None:
        size = model.cfg.mask_head.mask_size
        if masks.shape != (*det.scores.shape, size, size):
            raise AssertionError(f"masks of shape {tuple(masks.shape)}")
        m = masks[det.valid].float()
        if not (torch.isfinite(m).all() and (m >= 0).all() and (m <= 1).all()):
            raise AssertionError("masks are not finite probabilities")
        log(f"  masks {tuple(masks.shape)} {masks.dtype}: in [{m.min().item():.4f}, {m.max().item():.4f}], "
            f"mean {m.mean().item():.4f}")
    return launches, (images, img_shapes, scale_factors)


def run_main_path(torch, bgs, dev):
    t0 = time.perf_counter()
    detector = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0)
    model = detector.model
    log(f"  model built on the card in {time.perf_counter() - t0:.1f} s")
    launches, inputs = run_predicts(
        torch, model, {"bags_nms_keep": None, "bags_roi_align_forward": None, "bags_nms_keep_gathered": None}
    )
    profile_device(torch, "predict", lambda: model.predict(*inputs))
    return launches, model


def cascade_model(torch, dev):
    """gs_cascade_rcnn_r50 (1231 classes, GS heads in three stages) in bf16
    on the card, through `build_model`, with seeded weights."""
    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model

    cfg = zoo.cascade_rcnn_r50_fpn_lvis(use_gs=True)
    model = build_model(cfg, synthetic_partition(cfg.bbox_head.num_classes), torch.bfloat16)
    return model.init_weights(0).to(dev).eval()


def run_cascade_path(torch, dev):
    """Cascade predicts at the main shape: K1 once, K2 once a stage, K6 and
    K5 once, K3 never. Then K5 and K6 against their plain versions on the
    inputs one more predict gave them."""
    from balancedgroupsoftmax_torch import kernels
    from balancedgroupsoftmax_torch.ops import gather as ops_gather
    from balancedgroupsoftmax_torch.ops import nms as ops_nms

    t0 = time.perf_counter()
    model = cascade_model(torch, dev)
    log(f"  cascade built on the card in {time.perf_counter() - t0:.1f} s")
    stages = len(model.bbox_heads)
    launches, inputs = run_predicts(
        torch, model,
        {"bags_nms_keep": 1, "bags_roi_align_forward": stages, "bags_gather_lanes": 1,
         "bags_nms_keep_coords": 1, "bags_nms_keep_gathered": 0},
    )
    profile_device(torch, "cascade predict", lambda: model.predict(*inputs))

    # record what the class-agnostic multiclass NMS hands K6 and K5
    seen = {}
    wrapped = {}
    for name in ("gather_lanes", "nms_keep_batched_coords"):
        fn = getattr(kernels, name)

        def record(*args, _name=name, _fn=fn, **kw):
            seen[_name] = (args, kw)
            return _fn(*args, **kw)

        wrapped[name] = fn
        setattr(kernels, name, record)
    try:
        model.predict(*inputs)
    finally:
        for name, fn in wrapped.items():
            setattr(kernels, name, fn)
    (planes, idx), kw6 = seen["gather_lanes"]
    (coords, valid, thr), _ = seen["nms_keep_batched_coords"]
    rows = [
        check_k5(torch, ops_nms, coords, valid, thr),
        check_k6(torch, ops_gather, planes, idx, kw6["groups_per_plane"]),
    ]
    return launches, model, rows


def profile_device(torch, label: str, fn, top: int = 12) -> dict:
    """Device time of one call of `fn` by kernel, from torch.profiler: where
    the time goes, the share of the wall time the device is idle, and the
    port's own kernels wherever they rank. Returns {kernel: (ms, count)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    self_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    rows = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and self_us(e) > 0),
        key=self_us, reverse=True,
    )
    if not rows:
        log(f"  profiled {label}: wall {wall_ms:.3f} ms; the profiler recorded no device time (not measured)")
        return {}
    busy_ms = sum(self_us(e) for e in rows) / 1e3
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, profiler on)")
    for e in rows[:top]:
        log(f"    {self_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    for e in rows[top:]:
        if any(k in e.key for k in ("nms_", "roi_align", "gather_lanes", "deform_conv")):
            log(f"    {self_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]} (rank {rows.index(e) + 1})")
    return {e.key: (self_us(e) / 1e3, e.count) for e in rows}


def compare_small(torch, model) -> None:
    """The main path's model in f32 on a 256 x 384 image: the card (kernels)
    against the CPU (plain versions). Convolutions sum in other orders on the
    two, so near-tied scores may swap places; the check asks that the score
    lists agree to 1e-4 and that 95% of the card's detections are found on
    the CPU with the same label and boxes within 1e-2 pixels."""
    from balancedgroupsoftmax_torch.models.detector import build_model

    dev = next(model.parameters()).device
    cpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    gpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    gen = torch.Generator().manual_seed(5)
    images = torch.randn(1, 256, 384, 3, generator=gen)
    shapes = torch.tensor([[256.0, 384.0]])
    sf = torch.ones(1)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = gpu_model.predict(images.to(dev), shapes.to(dev), sf.to(dev))
        g = [t.cpu() for t in g]
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    c = cpu_model.predict(images, shapes, sf)
    score_err = (g[1] - c[1]).abs().max().item()
    gb, gl, gv = g[0][0], g[2][0], g[3][0]
    cb, cl, cv = c[0][0], c[2][0], c[3][0]
    matched = 0
    for i in torch.nonzero(gv).flatten().tolist():
        same = cv & (cl == gl[i]) & ((cb - gb[i]).abs().amax(dim=-1) <= 1e-2)
        matched += bool(same.any())
    total = int(gv.sum())
    log(f"  small input, card vs CPU: max score diff {score_err:.3e}, "
        f"{matched}/{total} detections matched")
    if not (score_err <= 1e-4 and total > 0 and matched >= 0.95 * total):
        raise AssertionError("card and CPU detections disagree")


def gt_labels(rng, partition, n: int):
    """`n` labels in 1..1230, each from a random one of the four foreground
    bins, so every bin of the GS loss has foreground."""
    import numpy as np

    bins = rng.randint(1, partition.num_bins, n)
    return np.array([rng.choice(np.flatnonzero(partition.label2bin == b)) for b in bins], np.int32)


def train_batch(seed: int, partition, size=(427, 640)):
    """A batch through the training pipeline: random images of `size`
    resized into the landscape bucket, TRAIN_GTS random gt boxes an image,
    random flips."""
    import numpy as np

    from balancedgroupsoftmax_torch.data.pipeline import collate, preprocess_image

    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(MAIN_BATCH):
        img = rng.randint(0, 255, (*size, 3), np.uint8)
        xy = rng.uniform(0, 0.8, (TRAIN_GTS, 2)) * size[::-1]
        wh = rng.uniform(0.05, 0.4, (TRAIN_GTS, 2)) * size[::-1]
        boxes = np.concatenate([xy, np.minimum(xy + wh, np.array(size[::-1]) - 1)], 1).astype(np.float32)
        labels = gt_labels(rng, partition, TRAIN_GTS)
        samples.append(preprocess_image(img, boxes, labels, train=True, rng=rng))
    return collate(samples)


def run_train_path(torch, model, phase2):
    """Full training steps of `model` (bf16, on the card) at 800 x 1344,
    batch 2, then one BAGS phase-2 step with the TrainConfig `phase2`, which
    must move the fc_cls tensors alone. Each step launches K4 once, and K2
    and K2b once a stage."""
    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    dev = next(model.parameters()).device
    stages = model.cfg.cascade.num_stages if model.cfg.cascade else 1
    batch = train_batch(8, model.partition)
    if tuple(batch["images"].shape[1:3]) != MAIN_SIZE or int(batch["gt_mask"].sum()) != MAIN_BATCH * TRAIN_GTS:
        raise AssertionError(f"training batch {batch['images'].shape}, {int(batch['gt_mask'].sum())} gts")
    # loading the batch is set-up: the timed steps start from the card
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    state = create_train_state(model, TrainConfig(selectp=0))
    step = make_train_step(state)
    gen = torch.Generator(device=dev).manual_seed(0)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = step(batch, gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ms = sum(step_ms) / TIMED_STEPS
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"  first step {first_s:.2f} s; then {ms:.3f} ms per step of {MAIN_BATCH} images "
        f"(steps {', '.join(f'{t:.3f}' for t in step_ms)} ms), {MAIN_BATCH / ms * 1e3:.2f} images/s, "
        f"peak memory {peak:.2f} GiB ({card_line()})")
    log(f"  launches over {TIMED_STEPS + 1} steps: {launches}")
    log("  losses: " + ", ".join(f"{k} {v.item():.5f}" for k, v in metrics.items()))
    steps = TIMED_STEPS + 1
    for sym, each in (("bags_nms_keep_tiled", 1), ("bags_roi_align_forward", stages), ("bags_roi_align_backward", stages)):
        if launches[sym] != each * steps:
            raise AssertionError(f"{sym} launched {launches[sym]} times in {steps} steps, not {each} a step")
    if not all(torch.isfinite(v).item() for v in metrics.values()):
        raise AssertionError(f"a loss is not finite: {metrics}")
    moved = {n for n, p in named.items() if not torch.equal(p.detach(), before[n])}
    trainable = {n for n, p in named.items() if p.requires_grad}
    if moved - trainable or not all(any(n.startswith(m) for n in moved) for m in ("backbone", "neck", "rpn_head", "bbox_head")):
        raise AssertionError(f"selectp=0 moved {len(moved)} tensors of {len(trainable)} trainable")
    log(f"  selectp=0 moved {len(moved)} of {len(trainable)} trainable tensors, no frozen one")
    profile_device(torch, "train step", lambda: step(batch, gen))

    state = create_train_state(model, phase2)
    before = {n: p.detach().clone() for n, p in named.items()}
    step1 = make_train_step(state)
    t0 = time.perf_counter()
    metrics = step1(batch, gen)
    torch.cuda.synchronize()
    moved = sorted(n for n, p in named.items() if not torch.equal(p.detach(), before[n]))
    if moved != sorted(n for n in named if "fc_cls" in n):
        raise AssertionError(f"selectp={phase2.selectp} moved {moved}")
    log(f"  selectp={phase2.selectp} step {(time.perf_counter() - t0) * 1e3:.3f} ms moved only {moved}, "
        f"loss {metrics['loss'].item():.5f}")
    return launches


def compare_small_train(torch, model) -> None:
    """One f32 training step of the main path's model, 1231 classes, on two
    256 x 384 images, on the card (kernels, K4 included: the RPN still takes
    2000 boxes a level) and on the CPU (plain versions), from the same
    weights. Sampling is made deterministic by the configuration, as in
    tests/test_torch_train_step.py: every anchor and every RoI candidate is
    sampled and the GS others' budget covers them all. The loss dicts must
    agree to 1e-3 relative: convolutions sum in other orders (TF32 off), and
    a proposal whose IoU with another lies within rounding of the NMS
    threshold may be kept on one side only, which moves an averaged loss by
    about one part in the 216 RoIs."""
    import dataclasses

    import numpy as np

    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    dev = next(model.parameters()).device
    cfg = model.cfg
    stages = model.cfg.cascade.num_stages if model.cfg.cascade else 1
    num_anchors = 3 * sum(-(-256 // s) * -(-384 // s) for s in cfg.anchors.strides)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    cfg = dataclasses.replace(
        cfg,
        rpn_train=take_all(cfg.rpn_train, num_anchors),
        rpn_proposal_train=dataclasses.replace(cfg.rpn_proposal_train, nms_post=100, max_num=100),
        # the 100 proposals and the 8 gt boxes, which each later stage adds again
        rcnn_train=take_all(cfg.rcnn_train, 100 + 8 * stages),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )
    weights = {k: v.float().cpu() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(9)
    xy = torch.rand(MAIN_BATCH, 8, 2, generator=gen) * torch.tensor([300.0, 200.0])
    wh = 16 + torch.rand(MAIN_BATCH, 8, 2, generator=gen) * 120
    rng = np.random.RandomState(9)
    batch = dict(
        images=torch.randn(MAIN_BATCH, 256, 384, 3, generator=gen),
        gt_boxes=torch.cat([xy, torch.minimum(xy + wh, torch.tensor([383.0, 255.0]))], -1).floor(),
        gt_labels=torch.from_numpy(np.stack([gt_labels(rng, model.partition, 8) for _ in range(MAIN_BATCH)])),
        gt_mask=torch.ones(MAIN_BATCH, 8, dtype=torch.bool),
        img_shapes=torch.tensor([[256.0, 384.0]] * MAIN_BATCH),
    )

    out = {}
    allow = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = build_model(cfg, model.partition, torch.float32)
            m.load_state_dict(weights)
            m.to(device)
            step = make_train_step(create_train_state(m, TrainConfig(selectp=0)))
            out[name] = {k: v.item() for k, v in step(batch, torch.Generator(device=device).manual_seed(0)).items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    worst = max(abs(out["card"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-6) for k in out["cpu"])
    log(f"  small f32 train step, card vs CPU: max relative loss difference {worst:.3e} over {sorted(out['cpu'])}")
    if not (sorted(out["card"]) == sorted(out["cpu"]) and worst <= 1e-3):
        raise AssertionError(f"card and CPU losses disagree: {out}")


def dcn_bound(torch, x, offsets, weight, mask, out) -> tuple[float, str]:
    """K7's least time: the bytes it must move (x, offsets, mask and weight
    read once, out written once) at HBM rate, against the bilinear sampling
    (DCN_SAMPLE_OPS f32 operations a sample and channel, on the CUDA cores)
    plus the grouped contraction (2 operations a multiply-add, at the tensor
    cores' dense rate for bf16 inputs, the CUDA cores' for f32)."""
    b, ho, wo, c_out = out.shape
    _, c_g, kh, kw = weight.shape
    taps = kh * kw
    nbytes = sum(t.numel() * t.element_size() for t in (x, offsets, weight, out) + ((mask,) if mask is not None else ()))
    sample_ops = b * ho * wo * taps * x.shape[-1] * DCN_SAMPLE_OPS
    mac_ops = 2 * b * ho * wo * c_out * taps * c_g
    t_ops = sample_ops / F32_FLOP_PER_S + mac_ops / (BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else F32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def k7_err(torch, ops_dcn, args) -> tuple[float, float]:
    """K7 against its plain version on the same inputs: (max |kernel - plain|,
    its limit). The samples are the same f32 operations in the same order;
    the contraction sums in another order, so f32 agrees within 1e-5 of the
    largest |output| and bf16 within one bf16 step (2^-7) of it."""
    out = ops_dcn.deform_conv2d(*args)
    ref = ops_dcn.deform_conv2d_reference(*args).float()
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    limit = (1e-5 if args[0].dtype == torch.float32 else 2.0**-7) * ref.abs().max().item()
    if not (out.dtype == args[0].dtype and out.shape == ref.shape and err <= limit):
        raise AssertionError(f"K7 {args[0].dtype} {tuple(args[0].shape)}: max abs err {err} above {limit}")
    return err, limit


def dcn_case(torch, gen, b, h, w, c_in, c_out, groups, stride, modulated, scale, dev, dtype):
    """K7 inputs with offsets of std `scale` cells, a quarter of them whole
    numbers, and samples placed in the (-1, 0) and (H - 1, H) border bands."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(b, h, w, c_in, generator=gen)
    off = torch.randn(b, ho, wo, 18, generator=gen) * scale
    whole = torch.rand(off.shape, generator=gen) < 0.25
    off[whole] = off[whole].round()
    off[:, 0, :, 0] = 0.5  # tap (0, 0) of the first row samples at y = -0.5
    off[:, :, 0, 1] = 0.25  # ... and of the first column at x = -0.75
    off[:, -1, :, 16] = h - 0.5 - ((ho - 1) * stride + 1)  # tap (2, 2) of the last row at y = H - 0.5
    off[:, :, -1, 17] = w - 0.5 - ((wo - 1) * stride + 1)
    weight = torch.randn(c_out, c_in // groups, 3, 3, generator=gen) / (9 * c_in / groups) ** 0.5
    mask = torch.rand(b, ho, wo, 9, generator=gen).to(dev) if modulated else None
    return x.to(dev, dtype), off.to(dev), weight.to(dev, dtype), mask


def check_k7_edges(torch, ops_dcn, dev) -> None:
    """K7 against its plain version on edge cases, in f32 and bf16: the
    clamp (offsets of std 3 cells at D = 4), the border bands, D = 0, stride
    2, and v2 with a mask and output groups narrower than the input ones."""
    from balancedgroupsoftmax_torch import cuda

    gen = torch.Generator().manual_seed(13)
    cases = [
        ("clamp D=4 c3 groups", dict(h=40, w=56, c_in=512, c_out=512, groups=64, stride=1, modulated=False, scale=3.0), 4),
        ("D=0 stride 2 c4 groups", dict(h=41, w=57, c_in=1024, c_out=1024, groups=64, stride=2, modulated=False, scale=2.5), 0),
        ("D=0 c5 groups", dict(h=13, w=21, c_in=2048, c_out=2048, groups=64, stride=1, modulated=False, scale=2.0), 0),
        ("v2 mask D=4", dict(h=33, w=27, c_in=256, c_out=192, groups=8, stride=1, modulated=True, scale=2.5), 4),
        ("v2 mask D=0 stride 2", dict(h=33, w=27, c_in=64, c_out=64, groups=1, stride=2, modulated=True, scale=2.5), 0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, kw, window in cases:
            stride = kw["stride"]
            x, off, weight, mask = dcn_case(torch, gen, 2, kw["h"], kw["w"], kw["c_in"], kw["c_out"], kw["groups"],
                                            stride, kw["modulated"], kw["scale"], dev, dtype)
            before = cuda.DEFORM_CONV.launches
            err, limit = k7_err(torch, ops_dcn, (x, off, weight, mask, stride, 1, kw["groups"], window))
            if cuda.DEFORM_CONV.launches != before + 1:
                raise AssertionError(f"K7 {label}: the wrapper did not launch the kernel")
            log(f"  K7 {label} {str(dtype)[6:]}: max |kernel - plain| = {err:.3e} (limit {limit:.3e}), "
                f"{(off.abs() > 4).float().mean().item():.3f} of offsets beyond +-4")


def spread_offsets(torch, model, images, target: float = 2.0) -> None:
    """Seeded, non-zero weights for every `conv_offset` (the JAX initialiser
    zeroes them, which would make K7 a plain grouped conv), scaled so that
    each layer's offsets have a standard deviation of `target` cells on
    `images`: mostly fractional, spread over a few cells, about 5% beyond
    +-4. One backbone pass: a hook before each offset conv draws its weights,
    measures what they give and rescales them before the layer runs."""
    from balancedgroupsoftmax_torch.ops.deform_conv import DeformConv

    gen = torch.Generator().manual_seed(12)

    def calibrate(mod, inputs):
        x = inputs[0]
        mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen))
        mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.5)
        std = mod._conv_forward(x, mod.weight.to(x.dtype), None).float().std().item()
        mod.weight.mul_(target / std)

    hooks = [m.conv_offset.register_forward_pre_hook(calibrate) for m in model.modules() if isinstance(m, DeformConv)]
    try:
        with torch.no_grad():
            model.extract_feats(images)
    finally:
        for h in hooks:
            h.remove()


def capture_dcn(torch, fn) -> list:
    """The arguments of every K7 call that `fn()` makes, in order."""
    from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn

    seen = []
    wrapped = ops_dcn.deform_conv2d

    def record(*args):
        seen.append(args)
        return wrapped(*args)

    ops_dcn.deform_conv2d = record
    try:
        fn()
    finally:
        ops_dcn.deform_conv2d = wrapped
    return seen


def check_k7_path(torch, ops_dcn, layers: list):
    """K7 on the inputs that one HTC predict gave each of its 30 deformable
    layers: held against its plain version in bf16 (the path's dtype) at
    every layer, and in f32 at a stride-2 c3, a middle c4 and a c5 layer;
    timed by CUDA events at every layer (the sum is K7's time a predict),
    with the plain version beside it and its bound; the profiler's device
    time at the three named layers. Prints the offsets' spread at one layer
    of each stage."""
    names = [f"c3.{i}" for i in range(4)] + [f"c4.{i}" for i in range(23)] + [f"c5.{i}" for i in range(3)]
    if len(layers) != len(names):
        raise AssertionError(f"predict made {len(layers)} K7 calls, not {len(names)}")
    shown = {"c3.0": "stride-2 c3", "c4.11": "middle c4", "c5.1": "c5"}
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, by={"bytes": 0, "operations": 0})
    worst = 0.0
    for name, args in zip(names, layers):
        x, off, weight, mask, stride, pad, groups, window = args
        err, _ = k7_err(torch, ops_dcn, args)
        worst = max(worst, err)
        ms = cuda_time_ms(lambda: ops_dcn.deform_conv2d(*args), 10)
        plain_ms = cuda_time_ms(lambda: ops_dcn.deform_conv2d_reference(*args), 1)
        out = ops_dcn.deform_conv2d(*args)
        b_ms, b_by = dcn_bound(torch, x, off, weight, mask, out)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        total["by"][b_by] += 1
        if name in shown:
            f32 = (x.float(), off, weight.float(), mask, stride, pad, groups, window)
            err32, lim32 = k7_err(torch, ops_dcn, f32)
            prof = profile_device(torch, f"K7 x10 at {name}", lambda: [ops_dcn.deform_conv2d(*args) for _ in range(10)], top=3)
            k7 = [v for k, v in prof.items() if "deform_conv" in k]
            dev_ms = sum(v[0] for v in k7) / max(sum(v[1] for v in k7), 1)  # per launch the profiler kept
            d = off.abs()
            log(f"  K7 {shown[name]} ({name}): x {tuple(x.shape)} -> {tuple(out.shape)}, groups {groups}, "
                f"stride {stride}: {ms:.4f} ms by events, {dev_ms:.4f} ms device, plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.5f} ms ({b_by}); bf16 err {err:.3e}, f32 err {err32:.3e} (limit {lim32:.3e}); "
                f"offsets: std {off.std().item():.3f}, median |d| {d.median().item():.3f}, "
                f"{(d > window).float().mean().item():.4f} beyond +-{window}")
    log(f"  K7 over the 30 layers of one predict: {total['ms']:.4f} ms by events, plain {total['plain_ms']:.3f} ms, "
        f"bound {total['bound_ms']:.5f} ms ({total['by']['bytes']} layers bound by bytes, "
        f"{total['by']['operations']} by operations), max bf16 err {worst:.3e}")
    return dict(
        name="deform_conv_forward",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/deform_conv.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/deform_conv.py:501",
        max_abs_err=worst,
        ms=total["ms"],
        plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by="bytes" if total["by"]["bytes"] >= total["by"]["operations"] else "operations",
        library_ms=None,
        shape="the 30 deformable layers of one HTC X101 predict, bf16, summed",
    )


def htc_model(torch, dev, cfg=None):
    """gs HTC X101-64x4d DCN c3-c5 (D = 4, 1231 classes) in bf16 on the
    card, through `build_model`, with seeded weights."""
    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model

    cfg = cfg or zoo.htc_x101_64x4d_fpn_lvis(use_gs=True, dcn=True)
    model = build_model(cfg, synthetic_partition(cfg.bbox_head.num_classes), torch.bfloat16)
    return model.init_weights(0).to(dev).eval()


def run_htc_path(torch, dev):
    """HTC-DCN serving at the main shape: `predict_with_masks`, with K7 30
    times, K2 8 times (three stages and the masks, each over the FPN and the
    semantic feature), K1, K6 and K5 once and K3 never a call. Then K7
    against its plain version, and timed, on the inputs one more predict gave
    each deformable layer."""
    from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn

    t0 = time.perf_counter()
    model = htc_model(torch, dev)
    gen = torch.Generator().manual_seed(4)
    spread_offsets(torch, model, torch.randn(MAIN_BATCH, *MAIN_SIZE, 3, generator=gen).to(dev))
    log(f"  HTC X101-DCN built on the card, offsets spread, in {time.perf_counter() - t0:.1f} s")
    launches, inputs = run_predicts(
        torch, model,
        {"bags_deform_conv_forward": 30, "bags_roi_align_forward": 8, "bags_nms_keep": 1,
         "bags_gather_lanes": 1, "bags_nms_keep_coords": 1, "bags_nms_keep_gathered": 0},
        call=model.predict_with_masks,
    )
    prof = profile_device(torch, "HTC predict_with_masks", lambda: model.predict_with_masks(*inputs), top=15)
    k7 = [v for k, v in prof.items() if "deform_conv" in k]
    if k7:
        log(f"  K7 in the profiled predict: {sum(v[0] for v in k7):.4f} ms device over {sum(v[1] for v in k7)} launches")
    layers = capture_dcn(torch, lambda: model.predict_with_masks(*inputs))
    row = check_k7_path(torch, ops_dcn, layers)
    del layers
    return launches, model, row


def compare_small_htc(torch, model) -> None:
    """HTC-DCN in f32 on a 256 x 384 image, on a reduced ResNeXt (depth 50,
    the X101's widths, 64 groups, deformable c3-c5 at D = 4, offsets spread
    as on the main path): the card (kernels) against the CPU (plain
    versions), as `compare_small` does for the detections; for the
    detections found alike, the masks must agree within 1e-3."""
    import dataclasses

    from balancedgroupsoftmax_torch.models.detector import build_model

    dev = next(model.parameters()).device
    cfg = dataclasses.replace(model.cfg, backbone=dataclasses.replace(model.cfg.backbone, depth=50))
    gen = torch.Generator().manual_seed(5)
    images = torch.randn(1, 256, 384, 3, generator=gen)
    shapes = torch.tensor([[256.0, 384.0]])
    sf = torch.ones(1)
    cpu_model = build_model(cfg, model.partition, torch.float32).init_weights(0).eval()
    spread_offsets(torch, cpu_model, images)
    gpu_model = build_model(cfg, model.partition, torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g, gm = gpu_model.predict_with_masks(images.to(dev), shapes.to(dev), sf.to(dev))
        g, gm = [t.cpu() for t in g], gm.cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    c, cm = cpu_model.predict_with_masks(images, shapes, sf)
    score_err = (g[1] - c[1]).abs().max().item()
    gb, gl, gv = g[0][0], g[2][0], g[3][0]
    cb, cl, cv = c[0][0], c[2][0], c[3][0]
    matched, mask_err = 0, 0.0
    for i in torch.nonzero(gv).flatten().tolist():
        same = cv & (cl == gl[i]) & ((cb - gb[i]).abs().amax(dim=-1) <= 1e-2)
        if bool(same.any()):
            matched += 1
            j = int(torch.nonzero(same)[0])
            mask_err = max(mask_err, (gm[0, i] - cm[0, j]).abs().max().item())
    total = int(gv.sum())
    log(f"  small HTC-DCN input, card vs CPU: max score diff {score_err:.3e}, {matched}/{total} detections "
        f"matched, max mask diff over them {mask_err:.3e}")
    if not (score_err <= 1e-4 and total > 0 and matched >= 0.95 * total and mask_err <= 1e-3):
        raise AssertionError("card and CPU detections or masks disagree")


def log_row(r: dict) -> None:
    lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
    log(f"  {r['name']} ({r['shape']}): max err {r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}){lib}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from balancedgroupsoftmax_torch import apis as bgs
        from balancedgroupsoftmax_torch import cuda
        from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn
        from balancedgroupsoftmax_torch.ops import gather as ops_gather
        from balancedgroupsoftmax_torch.ops import nms as ops_nms
        from balancedgroupsoftmax_torch.ops import roi_align as ops_roi
        from balancedgroupsoftmax_torch.zoo import TRAIN_CONFIGS
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _, build_s = cuda.build()
    cuda.library()
    log(f"phase build: nvcc {build_s:.1f} s, wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = [
        check_k1(torch, ops_nms, dev),
        check_k2(torch, ops_roi, dev),
        check_k3(torch, ops_nms, dev),
        check_k4(torch, ops_nms, dev),
        check_k2b(torch, ops_roi, dev),
    ]
    check_k5_ties(torch, ops_nms, dev)
    check_k6_ties(torch, ops_gather, dev)
    check_k7_edges(torch, ops_dcn, dev)
    for r in rows:
        log_row(r)
    log(f"phase kernels vs plain: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, model = run_main_path(torch, bgs, dev)
    log(f"phase main path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small(torch, model)
    log(f"phase small-input card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del model

    t0 = time.perf_counter()
    train_model = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0).model
    train_launches = run_train_path(torch, train_model, TRAIN_CONFIGS["gs_faster_rcnn_r50_fpn_lvis"])
    log(f"phase training path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_train(torch, train_model)
    log(f"phase small training step card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del train_model

    t0 = time.perf_counter()
    cascade_launches, cascade, cascade_rows = run_cascade_path(torch, dev)
    for r in cascade_rows:
        log_row(r)
    rows += cascade_rows
    log(f"phase cascade serving: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small(torch, cascade)
    log(f"phase small cascade predict card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_train_path(torch, cascade, TRAIN_CONFIGS["gs_cascade_rcnn_r50_fpn_lvis"])
    log(f"phase cascade training: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_train(torch, cascade)
    log(f"phase small cascade training step card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del cascade

    t0 = time.perf_counter()
    htc_launches, htc, htc_row = run_htc_path(torch, dev)
    log_row(htc_row)
    rows.append(htc_row)
    log(f"phase HTC-DCN serving: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_htc(torch, htc)
    log(f"phase small HTC-DCN predict_with_masks card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del htc

    # each kernel's launches on the path that runs it: the Faster R-CNN
    # predicts for K1-K3, its selectp=0 training steps for K4 and K2b, the
    # cascade's predicts for K5 and K6, the HTC's for K7
    symbols = {
        "nms_keep": (launches, "bags_nms_keep"),
        "roi_align_forward": (launches, "bags_roi_align_forward"),
        "nms_keep_gathered": (launches, "bags_nms_keep_gathered"),
        "nms_keep_tiled": (train_launches, "bags_nms_keep_tiled"),
        "roi_align_backward": (train_launches, "bags_roi_align_backward"),
        "nms_keep_batched_coords": (cascade_launches, "bags_nms_keep_coords"),
        "gather_lanes": (cascade_launches, "bags_gather_lanes"),
        "deform_conv_forward": (htc_launches, "bags_deform_conv_forward"),
    }
    for r in rows:
        counts, sym = symbols[r["name"]]
        r["launches"] = counts[sym]
        del r["shape"]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
