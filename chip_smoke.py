#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each timed, any failure ending the run with a non-zero exit:
1. build the CUDA kernels of balancedgroupsoftmax_torch/csrc with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, and time both: K1-K3 at inference's, K4 (the
   training RPN's NMS) and K2b (the RoIAlign gradient) at training's;
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
   configuration, and compare the loss dicts.

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
# f32 operations of one IoU-above-threshold test (ops/boxes.py order)
IOU_OPS = 17
# f32 operations of one RoIAlign sample: 4 weights, 4 products, 3 adds, 1 add to the bin sum
SAMPLE_OPS = 12

MAIN_BATCH = 2
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


def run_main_path(torch, bgs, dev):
    from balancedgroupsoftmax_torch import cuda

    t0 = time.perf_counter()
    detector = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0)
    model = detector.model
    log(f"  model built on the card in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(MAIN_BATCH, *MAIN_SIZE, 3, generator=gen).to(dev)
    img_shapes = torch.tensor([MAIN_SIZE] * MAIN_BATCH, dtype=torch.float32, device=dev)
    scale_factors = torch.ones(MAIN_BATCH, device=dev)

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    det = model.predict(images, img_shapes, scale_factors)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_PREDICTS):
        det = model.predict(images, img_shapes, scale_factors)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED_PREDICTS * 1e3
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"  first predict {first_s:.2f} s; then {ms:.3f} ms per batch of {MAIN_BATCH}, "
        f"{MAIN_BATCH / ms * 1e3:.2f} images/s, peak memory {peak:.2f} GiB ({card_line()})")
    log(f"  launches over {TIMED_PREDICTS + 1} predicts: {launches}")
    for sym in ("bags_nms_keep", "bags_roi_align_forward", "bags_nms_keep_gathered"):
        if launches[sym] == 0:
            raise AssertionError(f"{sym} was not launched on the predict path")
    check_detections(torch, det, model.cfg.bbox_head.num_classes, MAIN_SIZE)
    log(f"  detections: {int(det.valid.sum())} valid, top score {det.scores[0, 0].item():.6f}")
    profile_device(torch, "predict", lambda: model.predict(images, img_shapes, scale_factors))
    return launches, model


def profile_device(torch, label: str, fn, top: int = 12) -> None:
    """Device time of one call of `fn` by kernel, from torch.profiler: where
    the time goes, the share of the wall time the device is idle, and the
    port's own kernels wherever they rank."""
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
        return
    busy_ms = sum(self_us(e) for e in rows) / 1e3
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}, profiler on)")
    for e in rows[:top]:
        log(f"    {self_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    for e in rows[top:]:
        if "nms_" in e.key or "roi_align" in e.key:
            log(f"    {self_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]} (rank {rows.index(e) + 1})")


def compare_small(torch, model) -> None:
    """The main path's model in f32 on a 256 x 384 image: the card (kernels)
    against the CPU (plain versions). Convolutions sum in other orders on the
    two, so near-tied scores may swap places; the check asks that the score
    lists agree to 1e-4 and that 95% of the card's detections are found on
    the CPU with the same label and boxes within 1e-2 pixels."""
    from balancedgroupsoftmax_torch.models.detector import build_detector

    dev = next(model.parameters()).device
    cpu_model = build_detector(model.cfg, model.partition, torch.float32).eval()
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    gpu_model = build_detector(model.cfg, model.partition, torch.float32).eval()
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


def run_train_path(torch, bgs, dev):
    """Full training steps of gs_faster_rcnn_r50 at 800 x 1344, batch 2."""
    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
    from balancedgroupsoftmax_torch.zoo import TRAIN_CONFIGS

    model = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0).model
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
    for sym in ("bags_nms_keep_tiled", "bags_roi_align_forward", "bags_roi_align_backward"):
        if launches[sym] == 0:
            raise AssertionError(f"{sym} was not launched on the training path")
    if not all(torch.isfinite(v).item() for v in metrics.values()):
        raise AssertionError(f"a loss is not finite: {metrics}")
    moved = {n for n, p in named.items() if not torch.equal(p.detach(), before[n])}
    trainable = {n for n, p in named.items() if p.requires_grad}
    if moved - trainable or not all(any(n.startswith(m) for n in moved) for m in ("backbone", "neck", "rpn_head", "bbox_head")):
        raise AssertionError(f"selectp=0 moved {len(moved)} tensors of {len(trainable)} trainable")
    log(f"  selectp=0 moved {len(moved)} of {len(trainable)} trainable tensors, no frozen one")
    profile_device(torch, "train step", lambda: step(batch, gen))

    state = create_train_state(model, TRAIN_CONFIGS["gs_faster_rcnn_r50_fpn_lvis"])  # selectp=1
    before = {n: p.detach().clone() for n, p in named.items()}
    step1 = make_train_step(state)
    t0 = time.perf_counter()
    metrics = step1(batch, gen)
    torch.cuda.synchronize()
    moved = sorted(n for n, p in named.items() if not torch.equal(p.detach(), before[n]))
    if moved != ["bbox_head.fc_cls.bias", "bbox_head.fc_cls.weight"]:
        raise AssertionError(f"selectp=1 moved {moved}")
    log(f"  selectp=1 step {(time.perf_counter() - t0) * 1e3:.3f} ms moved only {moved}, "
        f"loss {metrics['loss'].item():.5f}")
    return launches, model


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
    from balancedgroupsoftmax_torch.models.detector import build_detector
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    dev = next(model.parameters()).device
    cfg = model.cfg
    num_anchors = 3 * sum(-(-256 // s) * -(-384 // s) for s in cfg.anchors.strides)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    cfg = dataclasses.replace(
        cfg,
        rpn_train=take_all(cfg.rpn_train, num_anchors),
        rpn_proposal_train=dataclasses.replace(cfg.rpn_proposal_train, nms_post=100, max_num=100),
        rcnn_train=take_all(cfg.rcnn_train, 100 + 8),
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
        for device in (dev, torch.device("cpu")):
            m = build_detector(cfg, model.partition, torch.float32)
            m.load_state_dict(weights)
            m.to(device)
            step = make_train_step(create_train_state(m, TrainConfig(selectp=0)))
            out[device.type] = {k: v.item() for k, v in step(batch, torch.Generator(device=device).manual_seed(0)).items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    worst = max(abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-6) for k in out["cpu"])
    log(f"  small f32 train step, card vs CPU: max relative loss difference {worst:.3e} over {sorted(out['cpu'])}")
    if not (sorted(out["cuda"]) == sorted(out["cpu"]) and worst <= 1e-3):
        raise AssertionError(f"card and CPU losses disagree: {out}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from balancedgroupsoftmax_torch import apis as bgs
        from balancedgroupsoftmax_torch import cuda
        from balancedgroupsoftmax_torch.ops import nms as ops_nms
        from balancedgroupsoftmax_torch.ops import roi_align as ops_roi
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
    for r in rows:
        log(f"  {r['name']} ({r['shape']}): max err {r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    log(f"phase kernels vs plain: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, model = run_main_path(torch, bgs, dev)
    log(f"phase main path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small(torch, model)
    log(f"phase small-input card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del model

    t0 = time.perf_counter()
    train_launches, train_model = run_train_path(torch, bgs, dev)
    log(f"phase training path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_train(torch, train_model)
    log(f"phase small training step card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    # each kernel's launches on the path that runs it: predict for K1-K3,
    # the selectp=0 training steps for K4 and K2b
    symbols = {
        "nms_keep": (launches, "bags_nms_keep"),
        "roi_align_forward": (launches, "bags_roi_align_forward"),
        "nms_keep_gathered": (launches, "bags_nms_keep_gathered"),
        "nms_keep_tiled": (train_launches, "bags_nms_keep_tiled"),
        "roi_align_backward": (train_launches, "bags_roi_align_backward"),
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
