#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each timed, any failure ending the run with a non-zero exit:
1. build the CUDA kernels of balancedgroupsoftmax_torch/csrc with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, and time both: K2 at inference's, K2b (the
   RoIAlign gradient) at training's, K1 (the test-time RPN's NMS) on inputs
   with exact ties at K = 1 to 1280 and K3 (the class-specific multiclass
   NMS) on gathered ones with indices outside the plane at K = 1 to 1344
   (K = 1345 refused), each also timed at its path's shape, K4 (the
   training RPN's NMS) on inputs with exact ties at K = 1 to 4097 (timed at
   the training RPN's shape), K5 and K6 (the class-agnostic multiclass NMS)
   on inputs with exact ties and out-of-range indices at the cascade's
   shapes, K6 in both layouts it takes (the boxes' own rows, seen through
   `transpose(1, 2)`, and contiguous planes);
3. run BAGS Faster R-CNN R50-FPN (gs_faster_rcnn_r50_fpn_lvis: 1231 classes,
   800 x 1344, bf16, batch 2, seeded random weights and synthetic partition)
   through `init_detector` and `predict`, check that K1-K3 were launched and
   that the detections are well formed, and profile one `predict` (device
   time by kernel, idle share); hold K1 and K3 bit for bit against their
   plain versions, and time them, on what one more `predict` handed them;
4. run the same model in f32 on a small image on the card and on the CPU
   (the plain versions) and compare the detections;
5. train the same model (bf16 compute, f32 parameters, batch 2 at 800 x
   1344, 20 synthetic gt boxes an image through the training pipeline)
   through `create_train_state` and `make_train_step`: a warm-up step and
   timed steps of full training (selectp=0), checking that the losses are
   finite, that K4 and K2b were launched and that the parameters moved;
   hold K4 against its plain version, and time it, on the boxes and
   validity the first step handed it; profile one step; then two BAGS
   phase-2 steps (selectp=1), a first and a timed one, which must move
   fc_cls alone;
6. take one small f32 training step on the card and on the CPU from the
   same weights and batch, sampling made deterministic by the
   configuration, and compare the loss dicts;
7-10. the same four phases for BAGS Cascade R-CNN R50-FPN
   (cascade_rcnn_r50_fpn_lvis with GS heads, built through `build_model`):
   `predict` must launch K1, K2 (once a stage), K6 and K5 and not K3; K1,
   K5 and K6 are held to their plain versions again, and timed, on the
   inputs that predict gave them (K6 on the decoded boxes' rows as predict
   hands them and on the same data as contiguous planes, in turns with
   `torch.gather`, with the device times of each from the profiler and the
   host's cost of K6's launch path part by part, beside the plainer ways to
   do each part); the device kernels a predict are counted as it runs and
   with a transpose copy put back before K6 (one more); the BAGS phase-2
   step (selectp=3) must move the three stages' fc_cls alone;
11. serve BAGS HTC X101-64x4d with deformable conv c3-c5
   (htc_x101_64x4d_fpn_lvis(use_gs=True, dcn=True): 1231 classes, D = 4,
   bf16, 800 x 1344, batch 2, offset convs given seeded non-zero weights)
   through `build_model` and `predict_with_masks`, which must launch K7 30
   times, K2 8 times, K1, K6 and K5 once and K3 never a call; check the
   detections and that the masks are probabilities; profile one call; then
   hold K7 against its plain version, and time it, on the inputs that one
   call gave each of the 30 deformable layers, K1 on its RPN's boxes, K5
   and K6 (in both layouts) on the candidates one call gave them; count the
   device kernels a call as for the cascade;
12. run a reduced HTC-DCN (depth 50, the same widths) in f32 on a small
   image on the card and on the CPU and compare detections and masks;
12b. train the same HTC-DCN (`run_htc_train_path`: bf16 compute, f32
   parameters, batch 2 at 800 x 1344, 20 gt boxes with random polygon masks
   an image, rasterised into crops as the train CLI does): a warm-up step and
   timed steps of full training (selectp=0), each launching K7 and K7b 30
   times, K2 and K2b 12 times and K4 once, moving every deformable layer's
   weight and offset conv; a profiled step; then a selectp=3 step (only
   fc_cls moves) and a selectp=4 step (only the bbox and mask heads), neither
   launching K7b or K2b; hold K7b against its plain version, and time it, at
   the first layer of each of the six shapes of the 30 (bf16, and f32 at two),
   and K2/K2b on the semantic pyramid at S = 14; then one small f32 HTC-DCN
   step (depth 50) on the card and on the CPU, the loss dicts and gradients
   compared;
12c. serve BAGS Mask R-CNN R50-FPN (gs_mask_rcnn_r50: 1231 classes, bf16,
   800 x 1344, batch 2, seeded weights, synthetic partition) through
   `init_detector` and `predict_with_masks`, which must launch K1 once, K2
   twice (S = 7 over the proposals, S = 14 over the 300 detections an
   image) and K3 once a call, with well-formed detections and (2, 300, 28,
   28) masks in [0, 1]; profile one call; hold K2 at S = 14 against its
   plain version, and time it, on the detections one call pooled; compare a
   small f32 predict_with_masks card vs CPU (detections and masks); train
   mask_rcnn_r50 (bf16 compute, f32 parameters, batch 2 at 800 x 1344, 20 gt
   boxes with random polygon masks an image, rasterised into crops as the
   train CLI does): a warm-up step and timed selectp=0 steps, each launching
   K4 once and K2 and K2b twice, "loss_mask" finite and the mask head
   moving, then two selectp=1 steps (only fc_cls moves) and two selectp=4
   steps (only the bbox and mask heads move, no K2b), each a first and a
   timed one, of gs_mask_rcnn_r50
   warm-started from its weights; hold K2b at S = 14 against its plain
   version, and time it, on the mask branch's gradient and rois; then one
   small f32 Mask R-CNN step on the card and on the CPU, the loss dicts and
   gradients compared;
12d. the detector variants (`run_variant_path`), each the zoo's config at
   1231 classes, bf16, 800 x 1344, batch 2, seeded weights, through
   `build_model`: Grid R-CNN `predict` (K1, K3 once; K2 twice, S = 7 and
   S = 14 on the 300 detections an image; `grid_to_boxes` card vs CPU on
   its heatmaps and on tied ones), Double-Head R-CNN `predict` (K2 twice at
   S = 7, the second on the rois inflated 1.3x), Mask-Scoring R-CNN
   `predict_with_masks` (K2 at 7 and 14; finite mask scores) and Fast R-CNN
   `predict` on 1000 seeded proposals an image (no K1, K2 once, K3 once),
   each profiled; selectp=0 steps (K4 once, none for Fast R-CNN, which
   trains through `loss` on 2000 seeded proposals; K2 and K2b as K2
   serves; "loss_grid" and "loss_mask_iou" positive), Mask-Scoring's
   selectp=4 steps (its MaskIoU head frozen); K2 and K2b held to their plain
   versions and timed on the grid's S = 14 and the Double-Head's inflated
   rois (the "/grid" and "/double-head" rows); each variant's small f32
   predict and step card vs CPU;
13. drive the BAGS two-phase recipe through the CLIs' `main(argv)` at full
   width (`run_flow`): an LVIS-shaped fixture of 8 JPEGs in both buckets
   with 1230 classes, the partition, phase 1 (K4, K2 and K2b once a step),
   phase 2 warm-started from it (only fc_cls fresh, only fc_cls moves), a
   resume (at the saved step, with the optimizer's state), the test CLI
   with and without --tau 0.5 (K1, K2 and K3 once a batch; the records
   finite and inside their images) and the eval CLI (the same table); then
   a mask_rcnn_r50 train-CLI step with the gt crops and the test CLI on its
   checkpoint (segm records, each a mask of its image, and a finite segm
   table; K1 and K3 once and K2 twice a batch), and the same for
   mask_scoring_rcnn_r50 (two steps; records with a finite "segm_score",
   the segm table ranked by it); K1-K4
   and K2 are held to their plain versions on the CLIs' inputs, and the
   train CLI's images/s from JPEG files and the test CLIs' time splits (the
   masks' paste and encode among them) are printed;
14. the BAGS ablation (`run_ablation`): a long-tailed fixture from
   `tools.make_longtail` (120 train images and the injected tail ones, 24
   val, 320 x 320, 48 classes) and its 4-bin partition, then
   `tools.run_longtail_ablation.main` on the card (2 epochs, batch 8,
   bf16), which calls the train and test CLIs' `main(argv)` in this
   process, each row's launches counted (a training step K4, K2 and, but
   at selectp 1, K2b once; a test batch K1 and K3 once and K2 once, twice
   for tnorm-select): all seven rows in [0, 100], RFS upsampling some
   image, the GS checkpoint differing from the baseline's in fc_cls alone;
   K4, K2 and K2b held to their plain versions on the baseline's last
   training step, and K1, K2 and K3 on tnorm-select's last batch (the
   "/ablation-train" and "/tnorm-select" rows of the kernels line); then
   `test_lvis_tnorm --taus 0.0 1.0` on the flow's fixture and final
   checkpoint (K2 once an (800, 1344) image; the per-bin counts sum to those
   images' boxes, at most 64 an image).

After phase 4, "test-time augmentation" runs the test CLI's `predict_aug`
on the same model at full width, four views a batch (the base, x1.25 in
its 1024 x 1696 bucket, each flipped): `--aug-rescore` (K1 5, K2 4, K3 1 a
batch) and the detection-level flow (K1 5, K2 4, K3 4), K1 held to its
plain version, and timed, on each merge's rows (4 x 1000 proposals, 4 x
300 label-offset detections an image) and on tie boxes at those lengths
(the "nms_keep/tta-*" rows); both flows in f32 on small images card vs CPU;
then "soft-NMS predict" (rcnn_test.nms_type "soft_nms": K1 and K2 once, no
K3; timed beside the hard-NMS predict in turns, and the multiclass NMS
alone both ways with its device kernels). After phase 6, "loss baselines":
Faster R-CNN R50 steps with the focal head at selectp 0 and 1 and the
re-weight and GS-reweight heads at selectp 1 (K4 and K2 once, K2b once at
selectp 0), each also as a small f32 step card vs CPU, losses and
gradients. After phase 10, "GS Cascade X101-64x4d": predicts (K1, K2 three
times, K6, K5), a profiled one, K1 and K5 held and K6 bit-equal on its
inputs, then the selectp 0 and selectp 3 steps with their peak memory. After
phase 12, "HTC-DCN test-time augmentation": `--aug-rescore` over the base
and its flip, then `predict_masks` on the merged boxes (K7 150, K1 3, K2 14,
K6 and K5 once a batch).

Between the Faster R-CNN and the cascade phases, "fused bottlenecks (K8,
K9)": a seeded R50 (FrozenBN scales and variances in [0.5, 2]) runs once in
bf16 at 800 x 1344, batch 2, and the input and output of each of its four
runs of stride-1 blocks (3, 3, 5, 2 blocks) are captured; one pass over the
runs launches `fused_layer` (K9) once a run and `fused_bottleneck` (K8) once
a block with the plans `fused_plan` computes (the halo route for layer1,
the phase route for layer2-4), and must count K9 4 and K8 13 launches;
each K8 output is held to its plain version on the same input,
each K9 output to the K8 chain (bit for bit), to the plain chain and to the
captured module output, again in f32 at 256 x 384 with the computed plans and
with the halo route wherever it fits; K8 (per block) and K9 (per run) are
timed on parameters cast once beside their bounds, the plain versions, the
unfused module chain and the folded cuDNN chain. As in the JAX package,
neither kernel is wired into `predict`.

Phase 2 also holds K7 against its plain version on edge cases: the clamp,
the border bands, D = 0, stride 2, v2 with a mask, groups of 4 channels with
12 outputs, offsets at and beyond +-D at the border, and a c5-like layer
with ragged last tiles, in f32 and bf16. It holds and times K2 at HTC's two
other shapes (the mask pooling, 300 rois an image at 14 x 14, and the
semantic pooling over one stride-8 level), holds K2 and K2b on edge cases
(S = 14, one level, C = 12, rois outside the image, zero-area rois, R = 0)
in f32 and bf16, checks that the levels K2 routes by inside its launch equal
map_roi_levels' at rois on the level boundaries, and times K2b beside its
f32 buffer's memset and cast alone and beside four per-level casts. The
HTC phase reports K2's device time over its 8 launches and how many device
kernels map_roi_levels launches a call.

It prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
HOST_CALLS = 3000  # calls a part of K6's launch path is timed over


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


def interleaved_ms(fns, iters: int, reps: int) -> list:
    """`cuda_time_ms` of each of `fns`, taken `reps` times in turns (a, b, a,
    b, ...), the median of each: for calls whose time the host's cost of a
    launch sets, which moves from one moment to the next on a shared host."""
    import statistics

    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            t.append(cuda_time_ms(fn, iters))
    return [statistics.median(t) for t in times]


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


RPN_ROWS = 5 * MAIN_BATCH  # the test-time RPN's rows: five FPN levels an image
K1_EDGES = (1, 63, 64, 65, 819, 1000, 1280)  # 819: the stride-64 level's anchors at 800 x 1344


def check_k1_ties(torch, ops_nms, dev) -> None:
    """K1 on tie boxes at the test-time RPN's G = 10, at K of one box,
    around one 64-box chunk, the stride-64 level's 819, the RPN's 1000 and
    1280, the longest row `batched_nms_topk` sends it; then timed at K = 1000
    (the shape earlier runs timed it at). Its row in the kernels line comes
    from the Faster predict's own inputs (`check_k1`)."""
    from balancedgroupsoftmax_torch import cuda

    gen = torch.Generator().manual_seed(1)
    for kk in K1_EDGES:
        boxes, valid = tie_boxes(gen, RPN_ROWS, kk, 0.7, dev)
        before = cuda.NMS_KEEP.launches
        keep = ops_nms.nms_keep_batched(boxes, valid, 0.7)
        ref = ops_nms.nms_keep_reference(boxes, valid, 0.7)
        torch.cuda.synchronize()
        if cuda.NMS_KEEP.launches != before + 1:
            raise AssertionError(f"K1 at K={kk} did not count one launch")
        if not torch.equal(keep, ref):
            raise AssertionError(f"K1 keep at K={kk} differs from the plain version in {(keep != ref).sum().item()} slots")
        log(f"  K1 ties K={kk}: keep equal to the plain version ({int(keep.sum())} kept of {int(valid.sum())})")
    boxes, valid = tie_boxes(torch.Generator().manual_seed(1), RPN_ROWS, 1000, 0.7, dev)
    b_ms, _ = bound(boxes.numel() * 4 + valid.numel() * 2, valid_pairs(valid) * IOU_OPS)
    log(f"  K1 ties G={RPN_ROWS} K=1000: kernel {cuda_time_ms(lambda: ops_nms.nms_keep_batched(boxes, valid, 0.7), 50):.4f}"
        f" ms, bound {b_ms:.5f} ms")


def check_k1(torch, ops_nms, boxes, valid, thr, path="Faster predict"):
    """K1 on the boxes and validity the `path` handed the RPN's NMS."""
    keep = ops_nms.nms_keep_batched(boxes, valid, thr)
    ref = ops_nms.nms_keep_reference(boxes, valid, thr)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref):
        raise AssertionError(f"K1 keep on the {path}'s data differs in {(keep != ref).sum().item()} slots")
    g, k = valid.shape
    b_ms, b_by = bound(boxes.numel() * 4 + valid.numel() * 2, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:304",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_batched(boxes, valid, thr), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_reference(boxes, valid, thr), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} valid={int(valid.sum())} pairs={valid_pairs(valid)} kept={int(keep.sum())}",
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
    """K6 at the cascade's shape: two images of 1000 boxes of f32 values
    that bf16 cannot hold, 300 groups each, some indices outside [0, N), in
    both layouts (the (2, 1000, 4) rows seen as (2, 4, 1000), and planes)."""
    gen = torch.Generator().manual_seed(11)
    n, k = 1000, 300
    boxes = (torch.rand(MAIN_BATCH, n, 4, generator=gen) * 1333 + 2.0**-13).to(dev)
    idx = torch.randint(-5, n + 5, (MAIN_BATCH * MAX_PER_IMG, k), generator=gen, dtype=torch.int32).to(dev)
    k6_matches(torch, ops_gather, boxes.transpose(1, 2), idx, MAX_PER_IMG, "tie inputs")
    log(f"  K6: bit-equal to the plain version in both layouts ({int(((idx < 0) | (idx >= n)).sum())} indices "
        f"outside the table)")


def k6_matches(torch, ops_gather, rows, idx, groups_per_plane, label):
    """K6 on the (P, R, N) transposed view of a path's box rows and on the
    same data as contiguous planes: both must be bit-equal to the plain
    version and each must count one launch. Returns the planes."""
    from balancedgroupsoftmax_torch import cuda

    if ops_gather.table_layout(rows) != ops_gather.ROWS or rows.is_contiguous():
        raise AssertionError(f"K6 on the {label} was not handed the boxes' own rows (strides {rows.stride()})")
    planes = rows.contiguous()
    ref = ops_gather.gather_lanes_reference(planes, idx, groups_per_plane)
    for layout, table in (("rows", rows), ("planes", planes)):
        before = cuda.GATHER_LANES.launches
        out = ops_gather.gather_lanes(table, idx, groups_per_plane)
        torch.cuda.synchronize()
        if cuda.GATHER_LANES.launches != before + 1:
            raise AssertionError(f"K6 on the {label} as {layout} did not count one launch")
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K6 on the {label} as {layout} is not bit-equal to the plain gather")
    return planes


def check_k5(torch, ops_nms, coords, valid, thr, path="cascade"):
    """K5 on the inputs the cascade's (or HTC's) predict gave it."""
    keep = ops_nms.nms_keep_batched_coords(coords, valid, thr)
    ref = ops_nms.nms_keep_reference(coords.transpose(1, 2), valid, thr)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref):
        raise AssertionError(f"K5 keep on the {path}'s data differs in {(keep != ref).sum().item()} slots")
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


def check_k6(torch, ops_gather, rows, idx, groups_per_plane):
    """K6 on the inputs the cascade's predict gave it (the decoded boxes'
    rows, seen as (P, 4, N)) and on the same data as contiguous planes;
    `torch.gather` on the rows expanded over their groups computes the same
    function. The row is the path's layout; the planes are timed beside it."""
    planes = k6_matches(torch, ops_gather, rows, idx, groups_per_plane, "cascade's candidates")
    out = ops_gather.gather_lanes(rows, idx, groups_per_plane)
    p, r, n = rows.shape
    g, k = idx.shape
    src = rows[:, None].expand(p, groups_per_plane, r, n)
    index = idx.long().view(p, groups_per_plane, 1, k).expand(p, groups_per_plane, r, k)
    lib = torch.gather(src, 3, index).reshape(g, r, k)
    if not torch.equal(lib, out):
        raise AssertionError("torch.gather disagrees with K6")
    nbytes = out.numel() * 4 + idx.numel() * 4 + rows.numel() * 4
    b_ms, b_by = bound(nbytes, 0)
    k6_host_split(torch, ops_gather, rows, planes, idx, groups_per_plane)
    kernel_fn = lambda: ops_gather.gather_lanes(rows, idx, groups_per_plane)
    planes_fn = lambda: ops_gather.gather_lanes(planes, idx, groups_per_plane)
    library_fn = lambda: torch.gather(src, 3, index)
    dev_k6 = device_ms_per_launch(torch, kernel_fn, "gather_lanes")
    dev_planes = device_ms_per_launch(torch, planes_fn, "gather_lanes")
    dev_lib = device_ms_per_launch(torch, library_fn, "")
    log(f"  K6 device time {dev_k6:.5f} ms a launch on the rows, {dev_planes:.5f} ms on planes, torch.gather's "
        f"{dev_lib:.5f} ms (profiler, 50 calls each; {card_line()})")
    ms, planes_ms, library_ms = interleaved_ms([kernel_fn, planes_fn, library_fn], 300, 7)
    log(f"  K6 {ms:.5f} ms a call by events on the rows, {planes_ms:.5f} ms on planes, torch.gather "
        f"{library_ms:.5f} ms (medians of 7 turns of 300 calls)")
    return dict(
        name="gather_lanes",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/gather.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/gather.py:59",
        max_abs_err=0.0,
        ms=ms,
        plain_ms=cuda_time_ms(lambda: ops_gather.gather_lanes_reference(rows, idx, groups_per_plane), 10),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=library_ms,
        shape=f"P={p} R={r} N={n} G={g} K={k}",
    )


def host_us(torch, fn, calls: int = HOST_CALLS, batch: int = 200) -> float:
    """Host time of one call of `fn`, in microseconds: perf_counter around
    batches of `batch` calls, the card drained before each batch so that a
    full launch queue never holds the host back."""
    fn()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e6


def k6_host_split(torch, ops_gather, rows, planes, idx, groups_per_plane) -> dict:
    """The host cost of one K6 launch, part by part, at the cascade's shape:
    each part of the wrapper's launch path beside a plainer way to do it
    (checks through `tuple(shape)` and `device.type`, `torch.empty`, a Stream
    object for the current stream, the symbol looked up at every launch, a
    ctypes call converting ten arguments in place of the launch module's
    call), the layout test on the rows, the whole wrapper on the rows and on
    planes, and one `torch.gather` call."""
    import ctypes

    from balancedgroupsoftmax_torch import cuda

    p, r, n = planes.shape
    g, k = idx.shape

    def check_plain(t, dtype, shape):
        if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise AssertionError("refused")

    out = planes.new_empty((g, r, k))
    kernel = cuda.GATHER_LANES
    launch = kernel.bind()
    ctypes_fn = getattr(ctypes.CDLL(str(cuda.build()[0])), kernel.symbol)
    ctypes_fn.argtypes = cuda.SIGNATURES[kernel.symbol]
    ctypes_fn.restype = ctypes.c_int
    stream = cuda.current_stream()
    args = (planes.data_ptr(), idx.data_ptr(), out.data_ptr(), g, r, k, n, groups_per_plane, ops_gather.PLANES,
            stream)
    src = planes[:, None].expand(p, groups_per_plane, r, n)
    index = idx.long().view(p, groups_per_plane, 1, k).expand(p, groups_per_plane, r, k)
    parts = {
        "checks x2 (tuple(shape), device.type)": lambda: (check_plain(planes, torch.float32, (p, r, n)),
                                                       check_plain(idx, torch.int32, (g, k))),
        "checks x2": lambda: (cuda.check(planes, torch.float32, (p, r, n), "planes"),
                              cuda.check(idx, torch.int32, (g, k), "idx")),
        "torch.empty(g, r, k, dtype, device)": lambda: torch.empty(g, r, k, dtype=torch.float32, device=planes.device),
        "new_empty(g, r, k)": lambda: planes.new_empty(g, r, k),
        "stream (current_stream().cuda_stream)": lambda: torch.cuda.current_stream().cuda_stream,
        "stream (raw)": cuda.current_stream,
        "symbol lookup (getattr(library(), ...))": lambda: getattr(cuda.library(), kernel.symbol),
        "data_ptr x3": lambda: (planes.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "ctypes call of 10 converted arguments and launch": lambda: ctypes_fn(*args),
        "_bags_launch.launch call and launch": lambda: launch(kernel.address, kernel.kinds, *args),
        "table_layout (rows)": lambda: ops_gather.table_layout(rows),
        "whole wrapper (rows)": lambda: ops_gather.gather_lanes(rows, idx, groups_per_plane),
        "whole wrapper (planes)": lambda: ops_gather.gather_lanes(planes, idx, groups_per_plane),
        "torch.gather": lambda: torch.gather(src, 3, index),
    }
    split = {name: host_us(torch, f) for name, f in parts.items()}
    log(f"  K6 host cost a call (us, perf_counter over {HOST_CALLS} calls, {card_line()}): "
        + ", ".join(f"{name} {us:.3f}" for name, us in split.items()))
    return split


def device_ms_per_launch(torch, fn, pattern: str, calls: int = 50) -> float:
    """Device time of one launch of the kernels whose name holds `pattern`
    (any CUDA kernel for ""), from the profiler over `calls` calls of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    self_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and self_us(e) > 0 and pattern in e.key]
    count = sum(e.count for e in rows)
    return float("nan") if not count else sum(self_us(e) for e in rows) / count / 1e3


def pyramid(torch, dtype, dev, gen):
    h, w = MAIN_SIZE
    return [
        torch.randn(MAIN_BATCH, -(-h // s), -(-w // s), 256, generator=gen).to(dev, dtype)
        for s in (4, 8, 16, 32)
    ]


def main_rois(torch, dev, gen, r=1000, size=MAIN_SIZE, batch=MAIN_BATCH):
    """Proposal-like rois over all four levels (side 8 to 800 pixels) in
    images of `size`."""
    h, w = size
    side = torch.exp(torch.empty(batch, r, 2).uniform_(2.0, 6.7, generator=gen))
    x1 = torch.rand(batch, r, generator=gen) * (w - 1)
    y1 = torch.rand(batch, r, generator=gen) * (h - 1)
    rois = torch.stack(
        [x1, y1, (x1 + side[..., 0]).clamp(max=w - 1), (y1 + side[..., 1]).clamp(max=h - 1)], -1
    )
    return rois.to(dev)


def k2_bound(torch, ops_roi, feats, rois, strides, out_size) -> tuple[float, str]:
    """K2's least time: the pixels its samples touch, the rois and its output,
    each moved once, against SAMPLE_OPS a sample and channel."""
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    index, _, valid = ops_roi.sample_points(shapes, rois, strides, out_size)
    touched = torch.unique(index[:, valid]).numel()
    c, size = feats[0].shape[-1], feats[0].element_size()
    out_elems = rois.shape[0] * rois.shape[1] * out_size * out_size * c
    return bound(touched * c * size + rois.numel() * 4 + out_elems * size, out_elems * 4 * SAMPLE_OPS)


def k2_matches(torch, ops_roi, feats, rois, strides, out_size, label) -> float:
    """K2 against its plain version on the same inputs: f32 equal up to 1e-5
    (the same operations in the same order, |x| <= ~5), bf16 within one bf16
    step (2^-7 relative) of the largest value, should an f32 sum differ in
    its last bit. Returns the largest difference."""
    out = ops_roi.multilevel_roi_align(feats, rois, strides, out_size)
    ref = ops_roi.multilevel_roi_align_reference(feats, rois, strides, out_size)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"K2 {label}: {out.dtype} {tuple(out.shape)}, plain {ref.dtype} {tuple(ref.shape)}")
    if not ref.numel():
        log(f"  K2 {label}: empty output, as the plain version's")
        return 0.0
    err = (out.float() - ref.float()).abs().max().item()
    limit = 1e-5 if feats[0].dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    log(f"  K2 {label}: max |kernel - plain| = {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"K2 {label}: max abs err {err} above {limit}")
    return err


def k2_row(torch, ops_roi, feats, rois, strides, out_size, name, label):
    """K2 held to its plain version on `feats` and `rois`, and timed: a
    kernels-line row named `name`."""
    err = k2_matches(torch, ops_roi, feats, rois, strides, out_size, label)
    b_ms, b_by = k2_bound(torch, ops_roi, feats, rois, strides, out_size)
    return dict(
        name=name,
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/roi_align.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/roi_align.py:511",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ops_roi.multilevel_roi_align(feats, rois, strides, out_size), 20),
        plain_ms=cuda_time_ms(lambda: ops_roi.multilevel_roi_align_reference(feats, rois, strides, out_size), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"B={rois.shape[0]} R={rois.shape[1]} S={out_size} C={feats[0].shape[-1]} {feats[0].dtype}",
    )


def roi_edges(torch, dev, gen, c=256):
    """K2's and K2b's edge cases on a 256 x 384 image, batch 2: name ->
    (features (f32) per level, rois, strides, out_size). S = 14; a one-level
    stride-8 pyramid; C = 12 (no multiple of a 16-byte piece); rois wholly
    outside the image; zero-area rois (x2 = x1 - 1, y2 = y1 - 1); R = 0."""
    h, w = 256, 384
    side = torch.exp(torch.empty(MAIN_BATCH, 200, 2).uniform_(2.0, 6.5, generator=gen))
    xy = torch.rand(MAIN_BATCH, 200, 2, generator=gen) * torch.tensor([w, h])
    rois = torch.cat([xy, xy + side], -1)
    far = torch.where(torch.rand(MAIN_BATCH, 200, 1, generator=gen) < 0.5, 2000.0, -2000.0)
    level = lambda s, ch: torch.randn(MAIN_BATCH, -(-h // s), -(-w // s), ch, generator=gen)
    fpn = [level(s, c) for s in (4, 8, 16, 32)]
    cases = {
        "S=14": (fpn, rois, (4, 8, 16, 32), 14),
        "one level": ([level(8, c)], rois, (8,), 7),
        "C=12": ([level(s, 12) for s in (4, 8, 16, 32)], rois, (4, 8, 16, 32), 7),
        "outside": (fpn, rois + far, (4, 8, 16, 32), 7),
        "zero area": (fpn, torch.cat([xy, xy - 1], -1), (4, 8, 16, 32), 7),
        "R=0": (fpn, rois[:, :0], (4, 8, 16, 32), 7),
    }
    return {k: ([f.to(dev) for f in fs], r.contiguous().to(dev), st, s) for k, (fs, r, st, s) in cases.items()}


def boundary_rois(torch, finest_scale=56):
    """(1, R, 4) rois whose sqrt(area) / finest_scale + 1e-6 lies within a
    few f32 steps of 2, 4 and 8, where map_roi_levels' rounding decides the
    level: squares and rectangles of five aspect ratios, one side swept step
    by step (tests/test_torch_cuda.py builds the same)."""
    import numpy as np

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
            rois += [[x1, y1, x1 + w - 1, y1 + hh - 1] for hh in hs]
    return torch.from_numpy(np.asarray(rois, np.float32)[None])


def check_k2_levels(torch, ops_roi, dev) -> None:
    """K2 routes each roi inside the launch: its levels must equal
    map_roi_levels' on the card at the level boundaries, four levels and one."""
    rois = boundary_rois(torch).to(dev)
    for strides in ((4, 8, 16, 32), (8,)):
        feats = [torch.zeros(1, 512 // s, 512 // s, 8, device=dev) for s in strides]
        _, levels = ops_roi.roi_align_forward(feats, rois, strides, return_levels=True)
        want = ops_roi.map_roi_levels(rois, len(strides))
        torch.cuda.synchronize()
        if not torch.equal(levels, want):
            raise AssertionError(f"K2 routes {(levels != want).sum().item()} of {want.numel()} boundary rois otherwise")
        log(f"  K2 levels at {want.numel()} boundary rois, {len(strides)} level(s): equal to map_roi_levels "
            f"(levels {sorted(want.unique().tolist())})")


def check_k2(torch, ops_roi, dev):
    """K2 at Faster R-CNN's shape (the kernels line's row), then at HTC's
    two other shapes -- the mask pooling (300 rois an image at 14 x 14 over
    the FPN) and the semantic pooling (1000 rois at 7 x 7 over a one-level
    stride-8 pyramid) -- each held to its plain version and timed, then the
    edge cases in f32 and bf16 and the levels at the boundaries."""
    gen = torch.Generator().manual_seed(2)
    rois = main_rois(torch, dev, gen)
    strides = (4, 8, 16, 32)
    f32_err = k2_matches(torch, ops_roi, pyramid(torch, torch.float32, dev, gen), rois, strides, 7, f"{torch.float32}")
    feats = pyramid(torch, torch.bfloat16, dev, gen)
    row = k2_row(torch, ops_roi, feats, rois, strides, 7, "roi_align_forward", f"{torch.bfloat16}")
    row["shape"] += f", f32 err {f32_err:.3e}"

    h, w = MAIN_SIZE
    semantic = [torch.randn(MAIN_BATCH, -(-h // 8), -(-w // 8), 256, generator=gen).to(dev, torch.bfloat16)]
    htc = {
        "HTC mask pooling B=2 R=300 S=14 C=256 bf16": (feats, main_rois(torch, dev, gen, 300), strides, 14),
        "HTC semantic pooling B=2 R=1000 S=7 C=256 bf16, one stride-8 level": (semantic, rois, (8,), 7),
    }
    for label, (fs, rs, st, size) in htc.items():
        e = k2_matches(torch, ops_roi, fs, rs, st, size, label)
        ms = cuda_time_ms(lambda: ops_roi.multilevel_roi_align(fs, rs, st, size), 20)
        plain = cuda_time_ms(lambda: ops_roi.multilevel_roi_align_reference(fs, rs, st, size), 3)
        bms, bby = k2_bound(torch, ops_roi, fs, rs, st, size)
        log(f"  K2 {label}: max err {e:.3e}, kernel {ms:.4f} ms, plain {plain:.3f} ms, "
            f"bound {bms:.5f} ms ({bby})")
    for label, (fs, rs, st, size) in roi_edges(torch, dev, gen).items():
        for dtype in (torch.float32, torch.bfloat16):
            k2_matches(torch, ops_roi, [f.to(dtype) for f in fs], rs, st, size, f"{label} {dtype}")
    check_k2_levels(torch, ops_roi, dev)
    return row


K3_EDGES = (1, 64, 65, 300, 1280, 1344)  # 1344: the most K5's walk holds; 1345 is refused
K3_PLANE = 1000  # N: the test-time RCNN's rois an image, the candidates' plane


def gathered_ties(gen, g: int, k: int, thr: float, dev):
    """K3's inputs at G rows of K: (G, 4, N) planes of tie boxes, N = max(1000,
    K), and (G, K) indices -- even rows the first K slots in order (so
    duplicates and exact-threshold pairs meet as neighbours), odd rows a
    random K of the N -- with about 5% of the slots sent outside [0, N), to
    -1, -7, N and N + 3, valid or not; about 10% of slots invalid, and the
    first row all invalid."""
    import torch

    n = max(K3_PLANE, k)
    boxes, _ = tie_boxes(gen, g, n, thr, "cpu")
    planes = boxes.transpose(1, 2).contiguous()
    idx = torch.argsort(torch.rand(g, n, generator=gen), dim=1)[:, :k]
    idx[0::2] = torch.arange(k)
    outside = torch.rand(g, k, generator=gen) < 0.05
    far = torch.tensor([-1, -7, n, n + 3])[torch.randint(0, 4, (g, k), generator=gen)]
    idx = torch.where(outside, far, idx).to(torch.int32)
    valid = torch.rand(g, k, generator=gen) > 0.1
    valid[0] = False
    return planes.to(dev), idx.to(dev), valid.to(dev)


def k3_matches(torch, ops_nms, planes, idx, valid, thr, label):
    """K3 bit for bit against its plain version, keep and the candidates;
    returns the keep mask."""
    keep, cand = ops_nms.nms_keep_gathered(planes, idx, valid, thr)
    ref_keep, ref_cand = ops_nms.nms_keep_gathered_reference(planes, idx, valid, thr)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref_keep):
        raise AssertionError(f"K3 keep {label} differs in {(keep != ref_keep).sum().item()} slots")
    if not torch.equal(cand.view(torch.int32), ref_cand.view(torch.int32)):
        raise AssertionError(f"K3 candidates {label} are not bit-equal to the plain gather")
    return keep


def check_k3_ties(torch, ops_nms, dev) -> None:
    """K3 on gathered tie boxes at K of one box, around one 64-box chunk, the
    multiclass NMS's 300 (its 600 rows), 1280 and 1344, thresholds 0.5 and
    0.7, with indices outside [0, N) on valid slots and an all-invalid row;
    K = 1345 refused with no launch counted; then timed at the multiclass
    NMS's shape, on distinct indices in range (the inputs earlier runs timed
    it on). Its row in the kernels line comes from the Faster predict's own
    inputs (`check_k3`)."""
    from balancedgroupsoftmax_torch import cuda

    gen = torch.Generator().manual_seed(3)
    for kk in K3_EDGES:
        for thr in (0.5, 0.7):
            planes, idx, valid = gathered_ties(gen, MAX_PER_IMG * MAIN_BATCH if kk == 300 else 7, kk, thr, dev)
            before = cuda.NMS_KEEP_GATHERED.launches
            keep = k3_matches(torch, ops_nms, planes, idx, valid, thr, f"at K={kk} thr={thr}")
            if cuda.NMS_KEEP_GATHERED.launches != before + 1:
                raise AssertionError(f"K3 at K={kk} did not count one launch")
            n = planes.shape[-1]
            log(f"  K3 ties K={kk} thr={thr}: keep and candidates equal to the plain version ({int(keep.sum())} kept "
                f"of {int(valid.sum())}; {int((valid & ((idx < 0) | (idx >= n))).sum())} valid slots outside the plane)")
    planes, idx, valid = gathered_ties(gen, 2, 1345, 0.5, dev)
    before = cuda.NMS_KEEP_GATHERED.launches
    try:
        ops_nms.nms_keep_gathered(planes, idx, valid, 0.5)
    except RuntimeError as e:
        if "bags_nms_keep_gathered" not in str(e):
            raise
    else:
        raise AssertionError("K3 took K = 1345, beyond its walk's shared memory")
    torch.cuda.synchronize()
    if cuda.NMS_KEEP_GATHERED.launches != before:
        raise AssertionError("K3's refusal at K = 1345 counted a launch")
    log("  K3 at K=1345: refused, no launch counted")

    g, k, n = MAX_PER_IMG * MAIN_BATCH, 300, K3_PLANE
    gen = torch.Generator().manual_seed(3)
    boxes, _ = tie_boxes(gen, g, n, 0.5, "cpu")
    planes = boxes.permute(0, 2, 1).contiguous().to(dev)
    idx = torch.argsort(torch.rand(g, n, generator=gen), dim=1)[:, :k].to(torch.int32).to(dev)
    valid = (torch.rand(g, k, generator=gen) > 0.1).to(dev)
    k3_matches(torch, ops_nms, planes, idx, valid, 0.5, "at the timed ties")
    b_ms, _ = k3_bound(planes, idx, valid)
    log(f"  K3 ties G={g} K={k} N={n}: kernel "
        f"{cuda_time_ms(lambda: ops_nms.nms_keep_gathered(planes, idx, valid, 0.5), 50):.4f} ms, bound {b_ms:.5f} ms")


def k3_bound(planes, idx, valid) -> tuple[float, str]:
    """The gathered coordinates, the indices, valid and keep, and cand, each
    moved once; 17 operations an IoU test over the valid pairs."""
    g, k = valid.shape
    return bound(g * k * 4 * 4 + idx.numel() * 4 + valid.numel() * 2 + g * 4 * k * 4, valid_pairs(valid) * IOU_OPS)


def check_k3(torch, ops_nms, planes, idx, valid, thr, path="Faster predict"):
    """K3 on what the `path`'s multiclass NMS handed it."""
    keep = k3_matches(torch, ops_nms, planes, idx, valid, thr, f"on the {path}'s data")
    g, k = valid.shape
    b_ms, b_by = k3_bound(planes, idx, valid)
    return dict(
        name="nms_keep_gathered",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:371",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_gathered(planes, idx, valid, thr), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_gathered_reference(planes, idx, valid, thr), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} N={planes.shape[-1]} valid={int(valid.sum())} pairs={valid_pairs(valid)} "
              f"kept={int(keep.sum())}",
    )


def check_k4_ties(torch, ops_nms, dev) -> None:
    """K4 on tie boxes at the training RPN's shape (5 levels x 2 images, 2000
    boxes a row), at K of one box, around one 64-box chunk, no multiple of
    64 and past 4096; then timed at the training RPN's shape (the number
    earlier runs reported). Its row in the kernels line comes from the
    training step's own inputs (`check_k4`)."""
    g = 5 * MAIN_BATCH
    gen = torch.Generator().manual_seed(6)
    for kk in (2000, 1337, 1, 64, 65, 4097):
        boxes, valid = tie_boxes(gen, g if kk <= 2000 else 3, kk, 0.7, dev)
        keep = ops_nms.nms_keep_tiled(boxes, valid, 0.7)
        ref = ops_nms.nms_keep_reference(boxes, valid, 0.7)
        torch.cuda.synchronize()
        if not torch.equal(keep, ref):
            raise AssertionError(f"K4 keep at K={kk} differs in {(keep != ref).sum().item()} slots")
        log(f"  K4 ties K={kk}: keep equal to the plain version ({int(keep.sum())} kept of {int(valid.sum())})")
    boxes, valid = tie_boxes(gen, g, 2000, 0.7, dev)
    b_ms, _ = bound(boxes.numel() * 4 + valid.numel() * 2, valid_pairs(valid) * IOU_OPS)
    log(f"  K4 ties G={g} K=2000: kernel {cuda_time_ms(lambda: ops_nms.nms_keep_tiled(boxes, valid, 0.7), 50):.4f} ms, "
        f"bound {b_ms:.5f} ms")


def check_k4(torch, ops_nms, boxes, valid, thr):
    """K4 on the inputs one selectp=0 training step gave it."""
    keep = ops_nms.nms_keep_tiled(boxes, valid, thr)
    ref = ops_nms.nms_keep_reference(boxes, valid, thr)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref):
        raise AssertionError(f"K4 keep on the training step's data differs in {(keep != ref).sum().item()} slots")
    g, k = valid.shape
    b_ms, b_by = bound(boxes.numel() * 4 + valid.numel() * 2, valid_pairs(valid) * IOU_OPS)
    return dict(
        name="nms_keep_tiled",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/nms.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/nms.py:213",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops_nms.nms_keep_tiled(boxes, valid, thr), 50),
        plain_ms=cuda_time_ms(lambda: ops_nms.nms_keep_reference(boxes, valid, thr), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"G={g} K={k} valid={int(valid.sum())} pairs={valid_pairs(valid)} kept={int(keep.sum())}",
    )


def k2b_matches(torch, ops_roi, grad, rois, shapes, strides, out_size, dtype, label, levels=None) -> float:
    """K2b against its plain version: atomics sum in another order than
    index_add_, so f32 within 1e-5 of the largest value, bf16 within one bf16
    step (2^-7) of it. Returns the largest difference."""
    out = ops_roi.roi_align_backward(grad, rois, shapes, strides, out_size, dtype=dtype, levels=levels)
    ref = ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, out_size, dtype=dtype)
    torch.cuda.synchronize()
    if any(o.shape != r.shape or o.dtype != r.dtype for o, r in zip(out, ref)):
        raise AssertionError(f"K2b {label}: levels of other shapes or dtypes than the plain version's")
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
    top = max(r.float().abs().max().item() for r in ref)
    limit = (1e-5 if dtype == torch.float32 else 2.0**-7) * top
    log(f"  K2b {label}: max |kernel - plain| = {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"K2b {label}: max abs err {err} above {limit}")
    return err


def check_k2b(torch, ops_roi, dev):
    """K2b at the training head's shape: 512 rois an image on the 800 x 1344
    pyramid, C=256, 7 x 7, sample_num 2, with the levels K2 routed by (the
    training path hands K2b the forward's). Timed beside the same scatter
    with its f32 gradient cast by four per-level `.to` (one launch a level) and
    beside the f32 buffer's memset and cast alone (R = 0). Then the edge
    cases."""
    gen = torch.Generator().manual_seed(7)
    rois = main_rois(torch, dev, gen, TRAIN_ROIS)
    strides = (4, 8, 16, 32)
    h, w = MAIN_SIZE
    shapes = [(-(-h // s), -(-w // s)) for s in strides]
    feats = [torch.zeros(MAIN_BATCH, a, b, 8, device=dev) for a, b in shapes]
    _, levels = ops_roi.roi_align_forward(feats, rois, strides, return_levels=True)
    del feats
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        grad = torch.randn(MAIN_BATCH, TRAIN_ROIS, 7, 7, 256, generator=gen).to(dev, dtype)
        results[dtype] = (grad, k2b_matches(torch, ops_roi, grad, rois, shapes, strides, 7, dtype, f"{dtype}", levels))
    grad, err = results[torch.bfloat16]
    pyramid_elems = MAIN_BATCH * sum(a * b for a, b in shapes) * 256
    nbytes = grad.numel() * 2 + rois.numel() * 4 + pyramid_elems * 2
    b_ms, b_by = bound(nbytes, grad.numel() * 4 * SAMPLE_OPS)
    bf16 = torch.bfloat16
    fused, four_casts, buffer_only = interleaved_ms([
        lambda: ops_roi.roi_align_backward(grad, rois, shapes, strides, dtype=bf16, levels=levels),
        lambda: [g.to(bf16) for g in ops_roi.roi_align_backward(grad, rois, shapes, strides, levels=levels)],
        lambda: ops_roi.roi_align_backward(grad[:, :0], rois[:, :0], shapes, strides, dtype=bf16, levels=levels[:, :0]),
    ], 20, 3)
    floor = bound(pyramid_elems * (4 + 4 + 2), 0)[0]
    log(f"  K2b bf16, medians of 3 turns of 20 calls ({card_line()}): one cast pass {fused:.4f} ms, "
        f"four per-level casts {four_casts:.4f} ms; the f32 buffer's memset and cast alone (R = 0) "
        f"{buffer_only:.4f} ms, their floor {floor:.4f} ms at 3.35 TB/s")
    for label, (fs, rs, st, size) in roi_edges(torch, dev, gen).items():
        lshapes = [(f.shape[1], f.shape[2]) for f in fs]
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(*rs.shape[:2], size, size, fs[0].shape[-1], generator=gen).to(dev, dtype)
            k2b_matches(torch, ops_roi, g, rs, lshapes, st, size, dtype, f"{label} {dtype}")
    return dict(
        name="roi_align_backward",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/roi_align.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/roi_align.py:569",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ops_roi.roi_align_backward(grad, rois, shapes, strides, dtype=bf16, levels=levels), 20),
        plain_ms=cuda_time_ms(
            lambda: ops_roi.multilevel_roi_align_backward_reference(grad, rois, shapes, strides, dtype=bf16), 3
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
    # (dets, masks), Mask-Scoring R-CNN's (dets, masks, mask scores), or dets
    det, masks, *mask_scores = out if isinstance(out, tuple) and len(out) in (2, 3) else (out, None)
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
    if mask_scores:
        ms = mask_scores[0][det.valid]
        if mask_scores[0].shape != det.scores.shape or not torch.isfinite(ms).all() or torch.equal(ms, det.scores[det.valid]):
            raise AssertionError("mask scores not finite, of another shape, or the detection scores unchanged")
        log(f"  mask scores (score x predicted mask IoU): in [{ms.min().item():.6f}, {ms.max().item():.6f}]")
    return launches, (images, img_shapes, scale_factors)


def run_main_path(torch, bgs, dev):
    """Faster R-CNN predicts at the main shape (K1, K2 and K3 at least once
    each), a profiled one, then K1 and K3 held to their plain versions, and
    timed, on what one more predict handed them."""
    from balancedgroupsoftmax_torch.ops import nms as ops_nms

    t0 = time.perf_counter()
    detector = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0)
    model = detector.model
    log(f"  model built on the card in {time.perf_counter() - t0:.1f} s")
    launches, inputs = run_predicts(
        torch, model, {"bags_nms_keep": None, "bags_roi_align_forward": None, "bags_nms_keep_gathered": None}
    )
    profile_device(torch, "predict", lambda: model.predict(*inputs))
    seen = capture_calls(("nms_keep_batched", "nms_keep_gathered"), lambda: model.predict(*inputs))
    (boxes, valid, thr), _ = seen["nms_keep_batched"]
    (planes, idx, cand_valid, cls_thr), _ = seen["nms_keep_gathered"]
    rows = [check_k1(torch, ops_nms, boxes, valid, thr), check_k3(torch, ops_nms, planes, idx, cand_valid, cls_thr)]
    return launches, model, rows


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
    K5 once, K3 never. Then K1, K5 and K6 against their plain versions on
    the inputs one more predict gave them."""
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
    prof = profile_device(torch, "cascade predict", lambda: model.predict(*inputs))
    log(f"  device kernels in the profiled predict: {sum(v[1] for v in prof.values())}")
    kernels_without_and_with_the_copy(torch, "cascade predict", lambda: model.predict(*inputs))

    # record what the RPN's NMS hands K1 and the class-agnostic multiclass NMS K6 and K5
    seen = capture_calls(("nms_keep_batched", "gather_lanes", "nms_keep_batched_coords"),
                         lambda: model.predict(*inputs))
    k1 = check_k1(torch, ops_nms, *seen["nms_keep_batched"][0], path="cascade predict")
    log(f"  K1 on the cascade's RPN boxes ({k1['shape']}): equal to the plain version, kernel {k1['ms']:.4f} ms")
    (boxes, idx), kw6 = seen["gather_lanes"]
    (coords, valid, thr), _ = seen["nms_keep_batched_coords"]
    rows = [
        check_k5(torch, ops_nms, coords, valid, thr),
        check_k6(torch, ops_gather, boxes, idx, kw6["groups_per_plane"]),
    ]
    return launches, model, rows


def capture_calls(names, fn, module=None) -> dict:
    """Run `fn` with the kernel wrappers `names` of `kernels.py` (or of
    `module`) recording what they are handed: {name: (args, kwargs)} of
    each one's last call. The wrappers still run (and count their
    launches)."""
    from balancedgroupsoftmax_torch import kernels

    module = module or kernels
    seen, wrapped = {}, {}
    for name in names:
        fn_k = getattr(module, name)

        def record(*args, _name=name, _fn=fn_k, **kw):
            seen[_name] = (args, kw)
            return _fn(*args, **kw)

        wrapped[name] = fn_k
        setattr(module, name, record)
    try:
        fn()
    finally:
        for name, fn_k in wrapped.items():
            setattr(module, name, fn_k)
    return seen


def capture_path(names, fn) -> dict:
    """`capture_calls` of the kernel wrappers `names` and of the detector's
    RoIAlign around `fn()`, whose result is under "out"."""
    from balancedgroupsoftmax_torch.models import detector

    seen = {}
    roi = lambda: seen.update(out=fn())
    seen.update(capture_calls(names, lambda: seen.update(capture_calls(("batched_multilevel_roi_align",), roi, detector))))
    return seen


def kernels_per_call(torch, fn, calls: int = 3) -> int:
    """The device kernels one call of `fn` launches, from the profiler: the
    most common count over `calls` profiled calls. A profiled HTC call now
    and then comes back some 90 kernel events short (2562 against 2653-2654
    at the same inputs on an H100), so one count is not enough."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA))
    if len(set(counts)) > 1:
        log(f"  profiled kernel counts differ between calls: {counts}")
    return max(counts, key=counts.count)


def kernels_without_and_with_the_copy(torch, label: str, fn) -> tuple[int, int]:
    """The device kernels one call of `fn` launches as it runs, and with the
    transpose copy put back before K6 (its table made contiguous planes, as
    the multiclass NMS made them before K6 read the boxes' rows where they
    lie). The copy must be the one kernel between them."""
    from balancedgroupsoftmax_torch import kernels

    now = kernels_per_call(torch, fn)
    gather = kernels.gather_lanes
    kernels.gather_lanes = lambda table, idx, **kw: gather(table.contiguous(), idx, **kw)
    try:
        copied = kernels_per_call(torch, fn)
    finally:
        kernels.gather_lanes = gather
    log(f"  device kernels a {label}: {now}; with a transpose copy before K6: {copied} (profiler)")
    if copied != now + 1:
        raise AssertionError(f"the {label} does not run one kernel fewer without the copy ({now}, {copied})")
    return now, copied


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


def compare_small(torch, model, proposals=None) -> None:
    """The main path's model in f32 on a 256 x 384 image: the card (kernels)
    against the CPU (plain versions). Convolutions sum in other orders on the
    two, so near-tied scores may swap places; the check asks that the score
    lists agree to 1e-4 and that 95% of the card's detections are found on
    the CPU with the same label and boxes within 1e-2 pixels. Fast R-CNN
    takes `proposals` (1, P, 4)."""
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
    given = lambda d: {} if proposals is None else dict(proposals=proposals.to(d))
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = gpu_model.predict(images.to(dev), shapes.to(dev), sf.to(dev), **given(dev))
        g = [t.cpu() for t in g]
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    detections_agree(torch, g, cpu_model.predict(images, shapes, sf, **given("cpu")), "small input")


def detections_agree(torch, g, c, label: str) -> None:
    """The card's detections `g` (on the CPU) against the CPU's `c`, image by
    image: the score lists within 1e-4, and 95% of the card's detections
    found on the CPU with the same label and boxes within 1e-2 pixels."""
    score_err = (g[1] - c[1]).abs().max().item()
    matched = 0
    for b in range(len(g[3])):
        gb, gl, gv = g[0][b], g[2][b], g[3][b]
        cb, cl, cv = c[0][b], c[2][b], c[3][b]
        for i in torch.nonzero(gv).flatten().tolist():
            same = cv & (cl == gl[i]) & ((cb - gb[i]).abs().amax(dim=-1) <= 1e-2)
            matched += bool(same.any())
    total = int(g[3].sum())
    log(f"  {label}, card vs CPU: max score diff {score_err:.3e}, {matched}/{total} detections matched")
    if not (score_err <= 1e-4 and total > 0 and matched >= 0.95 * total):
        raise AssertionError(f"card and CPU detections disagree ({label})")


def gt_labels(rng, partition, n: int):
    """`n` labels in 1..1230, each from a random one of the four foreground
    bins, so every bin of the GS loss has foreground."""
    import numpy as np

    bins = rng.randint(1, partition.num_bins, n)
    return np.array([rng.choice(np.flatnonzero(partition.label2bin == b)) for b in bins], np.int32)


def polygon_in(rng, box, corners: int = 10) -> list:
    """A random star-shaped polygon inside `box` (x1, y1, x2, y2): `corners`
    points around its centre at radii of 0.5 to 1 of the box's half sides."""
    import numpy as np

    cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    a = np.sort(rng.uniform(0, 2 * np.pi, corners))
    r = rng.uniform(0.5, 1.0, corners)
    xs = cx + np.cos(a) * r * (box[2] - box[0]) / 2
    ys = cy + np.sin(a) * r * (box[3] - box[1]) / 2
    return [float(v) for xy in zip(xs, ys) for v in xy]


def train_batch(seed: int, partition, size=(427, 640), masks: bool = False):
    """A batch through the training pipeline: random images of `size`
    resized into the landscape bucket, TRAIN_GTS random gt boxes an image,
    random flips. With `masks`, each gt also gets a random polygon, and the
    batch its crops as the train CLI makes them: rasterised at the original
    size (`rasterize_gt_masks`), flipped with the image."""
    import numpy as np

    from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig, collate, preprocess_image
    from balancedgroupsoftmax_torch.ops.mask import rasterize_gt_masks

    rng = np.random.RandomState(seed)
    samples, crops = [], []
    for _ in range(MAIN_BATCH):
        img = rng.randint(0, 255, (*size, 3), np.uint8)
        xy = rng.uniform(0, 0.8, (TRAIN_GTS, 2)) * size[::-1]
        wh = rng.uniform(0.05, 0.4, (TRAIN_GTS, 2)) * size[::-1]
        boxes = np.concatenate([xy, np.minimum(xy + wh, np.array(size[::-1]) - 1)], 1).astype(np.float32)
        labels = gt_labels(rng, partition, TRAIN_GTS)
        samples.append(preprocess_image(img, boxes, labels, train=True, rng=rng))
        if masks:
            segs = [[polygon_in(rng, b)] for b in boxes]
            c = rasterize_gt_masks(segs, boxes, size[0], size[1], PipelineConfig().max_gt_boxes)
            crops.append(c[:, :, ::-1] if samples[-1]["flipped"] else c)
    batch = collate(samples)
    if masks:
        batch["gt_mask_crops"] = np.ascontiguousarray(np.stack(crops))
    return batch


def train_step_for(torch, model, cfg, proposals=None):
    """`make_train_step`'s step for `model` at the TrainConfig `cfg`; with
    `proposals` (B, P, 4), Fast R-CNN's: the same step on `model.loss` with
    them, as the JAX package trains Fast R-CNN (its train step passes no
    proposals)."""
    from balancedgroupsoftmax_torch.parallel.train import BATCH_KEYS, create_train_state, make_train_step

    state = create_train_state(model, cfg)
    if proposals is None:
        return make_train_step(state)
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    dev = next(model.parameters()).device

    def step(batch, gen):
        state.optimizer.zero_grad(set_to_none=True)
        losses = model.loss(*(torch.as_tensor(batch[k], device=dev) for k in BATCH_KEYS),
                            proposals=proposals.to(dev), generator=gen)
        total = sum(v for k, v in losses.items() if "loss" in k)
        total.backward()
        torch.nn.utils.clip_grad_norm_(params, state.grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        return {**{k: v.detach() for k, v in losses.items()}, "loss": total.detach()}

    return step


def run_train_path(torch, model, phase2, phase2_model=None, pools=None, heads=(), losses=(), proposals=None) -> dict:
    """Full training steps of `model` (bf16, on the card) at 800 x 1344,
    batch 2, then BAGS phase-2 steps with the TrainConfig `phase2` of
    `phase2_model` (`model` by default), a first and a timed one, which must
    move the fc_cls tensors alone (none with `phase2` None). Each step
    launches K4 once (none with Fast R-CNN's `proposals`), and K2 and K2b
    `pools` times (by default once a stage and once more for a mask head). With a mask head the batch holds gt mask crops
    (`train_batch(masks=True)`), "loss_mask" must be finite, the mask head
    must move, and two selectp=4 steps of `phase2_model` must move the bbox
    and mask heads alone and launch no K2b. The modules `heads` must move
    too, and the `losses` be positive. Returns the launches of the
    selectp=0 steps, what the first of them handed K4 (boxes, valid,
    iou_thr; None without an RPN) and K2b at S = 14 ((args, kwargs), or
    None), every K2b call of that step, the mean ms of the timed steps and
    the peak GiB."""
    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.ops import roi_align as ops_roi

    dev = next(model.parameters()).device
    stages = model.cfg.cascade.num_stages if model.cfg.cascade else 1
    masks = model.mask_head is not None
    pools = stages + masks if pools is None else pools
    batch = train_batch(8, model.partition or synthetic_partition(model.cfg.bbox_head.num_classes), masks=masks)
    if tuple(batch["images"].shape[1:3]) != MAIN_SIZE or int(batch["gt_mask"].sum()) != MAIN_BATCH * TRAIN_GTS:
        raise AssertionError(f"training batch {batch['images'].shape}, {int(batch['gt_mask'].sum())} gts")
    # loading the batch is set-up: the timed steps start from the card
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = train_step_for(torch, model, TrainConfig(selectp=0), proposals)
    gen = torch.Generator(device=dev).manual_seed(0)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the first step also records what the RPN's NMS hands K4, and what K2b is handed
    out, k2b = [], []
    first = lambda: out.append(step(batch, gen))
    seen = capture_calls(("nms_keep_tiled",), lambda: k2b.extend(record_calls(ops_roi, "roi_align_backward", first)))
    metrics, k4_inputs = out[0], seen["nms_keep_tiled"][0] if "nms_keep_tiled" in seen else None
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
    k4 = 0 if proposals is not None else 1
    for sym, each in (("bags_nms_keep_tiled", k4), ("bags_roi_align_forward", pools), ("bags_roi_align_backward", pools)):
        if launches[sym] != each * steps:
            raise AssertionError(f"{sym} launched {launches[sym]} times in {steps} steps, not {each} a step")
    if not all(torch.isfinite(v).item() for v in metrics.values()) or masks != ("loss_mask" in metrics):
        raise AssertionError(f"a loss is not finite, or loss_mask is amiss: {metrics}")
    if not all(k in metrics and metrics[k].item() > 0 for k in losses):
        raise AssertionError(f"the losses {losses} are not all there and positive: {metrics}")
    moved = {n for n, p in named.items() if not torch.equal(p.detach(), before[n])}
    trainable = {n for n, p in named.items() if p.requires_grad}
    heads = ("backbone", "neck", "bbox_head") + (("rpn_head",) if k4 else ()) + (("mask_head.",) if masks else ()) + heads
    if moved - trainable or not all(any(n.startswith(m) for n in moved) for m in heads):
        raise AssertionError(f"selectp=0 moved {len(moved)} tensors of {len(trainable)} trainable")
    log(f"  selectp=0 moved {len(moved)} of {len(trainable)} trainable tensors, no frozen one"
        + (", the mask head's among them" if masks else ""))
    profile_device(torch, "train step", lambda: step(batch, gen))
    del step

    phase_model = phase2_model or model
    named = dict(phase_model.named_parameters())
    phases = [] if phase2 is None else [(phase2, sorted(n for n in named if "fc_cls" in n))]
    if masks:
        phases.append((TrainConfig(selectp=4), sorted(n for n in named if n.startswith(("bbox_head.", "mask_head.")))))
    for cfg, expect in phases:
        phase = train_step_for(torch, phase_model, cfg, proposals)
        before = {n: p.detach().clone() for n, p in named.items()}
        for k in cuda.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        # a first step, then a timed one
        took = []
        for _ in range(2):
            t0 = time.perf_counter()
            m = phase(batch, gen)
            torch.cuda.synchronize()
            took.append((time.perf_counter() - t0) * 1e3)
        moved = sorted(n for n, p in named.items() if not torch.equal(p.detach(), before[n]))
        if moved != expect or not torch.isfinite(m["loss"]):
            raise AssertionError(f"selectp={cfg.selectp} moved {moved}, loss {m['loss'].item()}")
        if cuda.ROI_ALIGN_BACKWARD.launches:
            raise AssertionError(f"selectp={cfg.selectp} launched K2b {cuda.ROI_ALIGN_BACKWARD.launches} times")
        what = f"only {moved}" if cfg.selectp != 4 else f"{len(moved)} tensors, the bbox and mask heads'"
        log(f"  selectp={cfg.selectp}: first step {took[0]:.3f} ms, then {took[1]:.3f} ms; two steps moved {what}, "
            f"K2b not launched, loss {m['loss'].item():.5f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del phase
    k2b_14 = [c for c in k2b if c[0][4] == 14]
    return dict(launches=launches, k4_inputs=k4_inputs, k2b=k2b_14[0] if k2b_14 else None, k2b_calls=k2b, ms=ms,
                peak=peak)


def run_mask_rcnn_path(torch, bgs, ops_roi, dev):
    """GS Mask R-CNN serving at the main shape: `predict_with_masks`, with
    K1 once, K2 twice (S = 7 over the proposals, then S = 14 over the 300
    detections an image) and K3 once a call; a profiled call; then K2 at
    S = 14 held to its plain version, and timed, on the detections one more
    call pooled (the "/mask-rcnn" row). Returns the model and that row."""
    from balancedgroupsoftmax_torch.models import detector

    t0 = time.perf_counter()
    model = bgs.init_detector("gs_mask_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0).model
    log(f"  model built on the card in {time.perf_counter() - t0:.1f} s")
    launches, inputs = run_predicts(
        torch, model, {"bags_nms_keep": 1, "bags_roi_align_forward": 2, "bags_nms_keep_gathered": 1},
        call=model.predict_with_masks,
    )
    profile_device(torch, "Mask R-CNN predict_with_masks", lambda: model.predict_with_masks(*inputs))
    calls = record_calls(detector, "batched_multilevel_roi_align", lambda: model.predict_with_masks(*inputs))
    (feats, rois, strides, out_size), _ = calls[-1][0][:4], calls[-1][1]
    if [c[0][3] for c in calls] != [7, 14] or tuple(rois.shape) != (MAIN_BATCH, MAX_PER_IMG, 4):
        raise AssertionError(f"Mask R-CNN's K2 calls: sizes {[c[0][3] for c in calls]}, mask rois {tuple(rois.shape)}")
    row = k2_row(torch, ops_roi, feats, rois, strides, out_size, "roi_align_forward/mask-rcnn",
                 f"on Mask R-CNN's {MAX_PER_IMG} detections an image, S = 14")
    row["launches"] = launches["bags_roi_align_forward"]
    return model, row


def run_mask_rcnn_train(torch, bgs, ops_roi, dev) -> dict:
    """Mask R-CNN training at the main shape through `run_train_path`:
    mask_rcnn_r50's selectp=0 steps (K4 once, K2 and K2b twice a step), then
    a selectp=1 and a selectp=4 step of gs_mask_rcnn_r50 warm-started from
    its weights (all but fc_cls copied, as the BAGS recipe's phase 2); K2b
    at S = 14 held to its plain version, and timed, on the gradient and rois
    of the first step's mask branch (the "/mask-rcnn" row). Returns
    `run_train_path`'s numbers and the row."""
    from balancedgroupsoftmax_torch.utils.checkpoint import warm_start
    from balancedgroupsoftmax_torch.zoo import TRAIN_CONFIGS

    model = bgs.init_detector("mask_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0).model
    gs = bgs.init_detector("gs_mask_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=1).model
    _, fresh = warm_start(gs, model.state_dict())
    if sorted(fresh) != ["bbox_head.fc_cls.bias", "bbox_head.fc_cls.weight"]:
        raise AssertionError(f"the GS Mask R-CNN's warm start left fresh {fresh}")
    trained = run_train_path(torch, model, TRAIN_CONFIGS["gs_mask_rcnn_r50_fpn_lvis"], phase2_model=gs)
    del gs, trained["k4_inputs"]
    if trained["k2b"] is None:
        raise AssertionError("no K2b call at S = 14 in the Mask R-CNN step")
    args, kw = trained.pop("k2b")
    grad, rois, shapes, strides, size = args[:5]
    trained["row"] = k2b_row(torch, ops_roi, grad, rois, shapes, strides, size, kw["dtype"], kw["levels"],
                             "roi_align_backward/mask-rcnn", f"on the mask branch's {tuple(rois.shape[:2])} rois, S = 14")
    trained["row"]["launches"] = trained["launches"]["bags_roi_align_backward"]
    return trained


def compare_small_train(torch, model, selectp: int = 0, proposals=None) -> None:
    """One f32 training step of the main path's model, 1231 classes, on two
    256 x 384 images, on the card (kernels, K4 included: the RPN still takes
    2000 boxes a level) and on the CPU (plain versions), from the same
    weights. Sampling is made deterministic by the configuration, as in
    tests/test_torch_train_step.py: every anchor and every RoI candidate is
    sampled, the GS others' budget covers them all and Grid R-CNN's
    positives are not jittered. The loss dicts must agree to 1e-3 relative:
    convolutions sum in other orders (TF32 off), and
    a proposal whose IoU with another lies within rounding of the NMS
    threshold may be kept on one side only, which moves an averaged loss by
    about one part in the 216 RoIs. The step trains at `selectp` with the
    model's class weights; every trained parameter's gradient must agree to
    GRAD_NORM_LIMIT in the relative norm, as `compare_small_mask_train`'s.
    Fast R-CNN takes `proposals` (2, 100, 4), the count the sampler takes."""
    import dataclasses

    import numpy as np

    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model

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
        # the grid's jitter too: the card's generator draws other numbers than the CPU's
        variant=cfg.variant and dataclasses.replace(cfg.variant, grid_jitter=0.0),
    )
    weights = {k: v.float().cpu() for k, v in model.state_dict().items()}
    partition = model.partition or synthetic_partition(cfg.bbox_head.num_classes)  # the labels' bins
    gen = torch.Generator().manual_seed(9)
    xy = torch.rand(MAIN_BATCH, 8, 2, generator=gen) * torch.tensor([300.0, 200.0])
    wh = 16 + torch.rand(MAIN_BATCH, 8, 2, generator=gen) * 120
    rng = np.random.RandomState(9)
    batch = dict(
        images=torch.randn(MAIN_BATCH, 256, 384, 3, generator=gen),
        gt_boxes=torch.cat([xy, torch.minimum(xy + wh, torch.tensor([383.0, 255.0]))], -1).floor(),
        gt_labels=torch.from_numpy(np.stack([gt_labels(rng, partition, 8) for _ in range(MAIN_BATCH)])),
        gt_mask=torch.ones(MAIN_BATCH, 8, dtype=torch.bool),
        img_shapes=torch.tensor([[256.0, 384.0]] * MAIN_BATCH),
    )

    class_weights = None if model.class_weights is None else model.class_weights.cpu()
    out, grad = {}, {}
    allow = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = build_model(cfg, model.partition, torch.float32, class_weights=class_weights)
            m.load_state_dict(weights)
            m.to(device)
            step = train_step_for(torch, m, TrainConfig(selectp=selectp), proposals)
            out[name] = {k: v.item() for k, v in step(batch, torch.Generator(device=device).manual_seed(0)).items()}
            grad[name] = {n: p.grad.double().cpu() for n, p in m.named_parameters() if p.grad is not None}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    worst = max(abs(out["card"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-6) for k in out["cpu"])
    log(f"  small f32 train step (selectp={selectp}), card vs CPU: max relative loss difference {worst:.3e} "
        f"over {sorted(out['cpu'])}")
    if not (sorted(out["card"]) == sorted(out["cpu"]) and worst <= 1e-3):
        raise AssertionError(f"card and CPU losses disagree: {out}")
    if sorted(grad["card"]) != sorted(grad["cpu"]) or not grad["cpu"]:
        raise AssertionError("the card and the CPU step trained different parameters")
    norm, peak = grad_differences(grad["card"], grad["cpu"])
    far = max(norm, key=norm.get)
    log(f"  gradients, card vs CPU: relative norm worst {norm[far]:.3e} ({far}) over {len(norm)} tensors; "
        f"largest elementwise difference {max(peak.values()):.3e} of its tensor's largest")
    if norm[far] > GRAD_NORM_LIMIT:
        raise AssertionError(f"card and CPU gradients disagree: {sorted(norm.items(), key=lambda kv: -kv[1])[:5]}")


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


def dcn_case(torch, gen, b, h, w, c_in, c_out, groups, stride, modulated, scale, dev, dtype, at_window=0):
    """K7 inputs with offsets of std `scale` cells, a quarter of them whole
    numbers, and samples placed in the (-1, 0) and (H - 1, H) border bands.
    With `at_window` D > 0 instead: a third of the offsets exactly +-D, a
    third just beyond (+-(D + 0.5)), and at the border rows and columns
    offsets of D and D + 0.5 pointing out of the image, so that the staged
    window's edges and its zero fill are read."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(b, h, w, c_in, generator=gen)
    off = torch.randn(b, ho, wo, 18, generator=gen) * scale
    whole = torch.rand(off.shape, generator=gen) < 0.25
    off[whole] = off[whole].round()
    if at_window:
        d = float(at_window)
        sign = torch.where(torch.rand(off.shape, generator=gen) < 0.5, -1.0, 1.0)
        pick = torch.rand(off.shape, generator=gen)
        off = torch.where(pick < 1 / 3, sign * d, torch.where(pick < 2 / 3, sign * (d + 0.5), off))
        off[:, 0, :, 0::2] = -d
        off[:, -1, :, 0::2] = d + 0.5
        off[:, :, 0, 1::2] = -(d + 0.5)
        off[:, :, -1, 1::2] = d
    else:
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
    2, v2 with a mask and output groups narrower than the input ones, groups
    of 4 channels with 12 outputs (a k16 step over four taps, o_g padded),
    offsets at and beyond +-D at the border (stride 2), and a c5-like layer
    whose 13 x 21 positions leave a ragged last tile."""
    from balancedgroupsoftmax_torch import cuda

    gen = torch.Generator().manual_seed(13)
    cases = [
        ("clamp D=4 c3 groups", dict(h=40, w=56, c_in=512, c_out=512, groups=64, stride=1, modulated=False, scale=3.0), 4),
        ("D=0 stride 2 c4 groups", dict(h=41, w=57, c_in=1024, c_out=1024, groups=64, stride=2, modulated=False, scale=2.5), 0),
        ("D=0 c5 groups", dict(h=13, w=21, c_in=2048, c_out=2048, groups=64, stride=1, modulated=False, scale=2.0), 0),
        ("v2 mask D=4", dict(h=33, w=27, c_in=256, c_out=192, groups=8, stride=1, modulated=True, scale=2.5), 4),
        ("v2 mask D=0 stride 2", dict(h=33, w=27, c_in=64, c_out=64, groups=1, stride=2, modulated=True, scale=2.5), 0),
        ("c_g 4 o_g 12 D=4", dict(h=33, w=27, c_in=64, c_out=192, groups=16, stride=1, modulated=False, scale=2.5), 4),
        ("offsets at +-D and beyond, border, stride 2", dict(h=41, w=57, c_in=512, c_out=512, groups=64, stride=2,
                                                             modulated=False, scale=2.0, at_window=4), 4),
        ("ragged c5 tiles D=4", dict(h=13, w=21, c_in=2048, c_out=2048, groups=64, stride=1, modulated=False, scale=2.0), 4),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, kw, window in cases:
            stride = kw["stride"]
            x, off, weight, mask = dcn_case(torch, gen, 2, kw["h"], kw["w"], kw["c_in"], kw["c_out"], kw["groups"],
                                            stride, kw["modulated"], kw["scale"], dev, dtype, kw.get("at_window", 0))
            before = cuda.DEFORM_CONV.launches
            err, limit = k7_err(torch, ops_dcn, (x, off, weight, mask, stride, 1, kw["groups"], window))
            if cuda.DEFORM_CONV.launches != before + 1:
                raise AssertionError(f"K7 {label}: the wrapper did not launch the kernel")
            log(f"  K7 {label} {str(dtype)[6:]}: max |kernel - plain| = {err:.3e} (limit {limit:.3e}), "
                f"{(off.abs() > 4).float().mean().item():.3f} of offsets beyond +-4, "
                f"{(off.abs() == 4).float().mean().item():.3f} at +-4")


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


def record_calls(module, name: str, fn) -> list:
    """The (args, kwargs) of every call of `module.name` that `fn()` makes,
    in order; the function still runs (and counts its launches)."""
    seen = []
    wrapped = getattr(module, name)

    def record(*args, **kw):
        seen.append((args, kw))
        return wrapped(*args, **kw)

    setattr(module, name, record)
    try:
        fn()
    finally:
        setattr(module, name, wrapped)
    return seen


def capture_dcn(torch, fn) -> list:
    """The arguments of every K7 call that `fn()` makes, in order."""
    from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn

    return [args for args, _ in record_calls(ops_dcn, "deform_conv2d", fn)]


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


FUSED_SMALL = (256, 384)  # the f32 check's image
FUSED_MODULE_TOL = {"bfloat16": 2.0**-4, "float32": 1e-4}


def fused_backbone(torch, dev):
    """The port's ResNet-50 on the card with seeded convolutions (std
    1/sqrt(fan_in)) and FrozenBatchNorms whose scales and variances lie in
    [0.5, 2] and whose shifts and means are N(0, 0.2): at init the fold would
    only multiply by 1/sqrt(1 + eps). Parameters in f32; it computes in the
    dtype of its input, as the detector's backbone does."""
    from balancedgroupsoftmax_torch.models.resnet import FrozenBatchNorm, ResNet

    gen = torch.Generator().manual_seed(14)
    net = ResNet(depth=50)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / m.weight[0].numel() ** 0.5)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 2.0, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
    return net.to(dev).eval()


def capture_runs(torch, net, runs, size, dtype):
    """One backbone pass on a seeded (2, 3, *size) image in `dtype`: the NCHW
    input of each stride-1 run's first block and the output of its last."""
    gen = torch.Generator().manual_seed(15)
    dev = next(net.parameters()).device
    images = torch.randn(MAIN_BATCH, 3, *size, generator=gen).to(dev, dtype)
    seen, hooks = {}, []
    for i, run in enumerate(runs):
        hooks.append(run[0].register_forward_pre_hook(lambda m, a, i=i: seen.__setitem__((i, 0), a[0])))
        hooks.append(run[-1].register_forward_hook(lambda m, a, o, i=i: seen.__setitem__((i, 1), o)))
    try:
        with torch.no_grad():
            net(images.contiguous(memory_format=torch.channels_last))
    finally:
        for h in hooks:
            h.remove()
    return [(seen[(i, 0)], seen[(i, 1)]) for i in range(len(runs))]


def fused_bound(torch, x, blocks, out) -> tuple[float, str]:
    """The least time of blocks chained on x (NHWC): x read once, out written
    once and the weights read once, at HBM rate, against 2 operations a
    multiply-add of the four products at the tensor cores' dense bf16 rate
    (the CUDA cores' for f32)."""
    b, h, w, _ = x.shape
    es = x.element_size()
    wbytes = sum(t.numel() * (es if i % 2 == 0 else 4) for p in blocks for i, t in enumerate(p) if t is not None)
    macs = b * h * w * sum(p.w1.numel() + p.w2.numel() + p.w3.numel() + (p.wd.numel() if p.wd is not None else 0)
                           for p in blocks)
    t_bytes = (x.numel() * es + out.numel() * es + wbytes) / HBM_BYTES_PER_S
    t_ops = 2 * macs / (BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else F32_FLOP_PER_S)
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def fused_pass(torch, ops_fb, xs, folded, plans=None):
    """The fused path over the four runs: `fused_layer` once a run (K9) and
    `fused_bottleneck` block by block (K8), with `plans` (per run, per block)
    or the computed ones. Returns the K9 outputs and, per run, the row-padded
    inputs and outputs of each K8 call."""
    k9, k8 = [], []
    for i, (x, ps) in enumerate(zip(xs, folded)):
        run_plans = None if plans is None else plans[i]
        k9.append(ops_fb.fused_layer(x, ps, run_plans))
        chain = [ops_fb.pad_rows(x)]
        for s, p in enumerate(ps):
            chain.append(ops_fb.fused_bottleneck(chain[-1], p, None if run_plans is None else run_plans[s]))
        k8.append(chain)
    return k9, k8


def check_fused_runs(torch, ops_fb, caps, folded, k9, k8, dtype) -> dict:
    """Each K8 output against `fused_bottleneck_reference` on the same input:
    the same roundings with sums in another order. In f32 they agree within
    1e-5 of the largest |output|. In bf16 within two bf16 steps (2 x 2^-7) of
    it: y3 is rounded, then y3 + identity is rounded again, so a y3 that
    rounds one step apart can land two steps apart. Each K9 output must
    equal the K8 chain's bit for bit (the same tile body, and each output's
    sums run in one order whatever the tiling), and is held to the plain
    chain within those steps once a block in bf16 (1e-5 in f32): a block's output that rounds
    apart reaches the next block's output unchanged through the identity.
    Both against the module chain's output: the fold rounds once a
    convolution where the modules round after the convolution, the BN's
    multiply and add and the residual add, with BN scales up to 2 / sqrt(0.5)
    between them; in bf16 the two differ by about 1% of the largest output,
    so they are held to FUSED_MODULE_TOL of it (f32: the reassociated BN
    scale, 1e-4). Returns the worst errors: K9's and K8's against the plain
    versions, absolute ("abs9", "abs8") and relative to the largest |output|
    ("rel9", "rel8"), and the fused path's relative to the modules' largest
    |output| ("mod")."""
    step = 1e-5 if dtype == torch.float32 else 2 * 2.0**-7
    tol = FUSED_MODULE_TOL[str(dtype)[6:]]
    w = dict(abs9=0.0, rel9=0.0, abs8=0.0, rel8=0.0, mod=0.0)
    for i, ((_, mod_out), ps, out9, chain) in enumerate(zip(caps, folded, k9, k8)):
        for s, p in enumerate(ps):
            r = ops_fb.unpad_rows(ops_fb.fused_bottleneck_reference(chain[s], p)).float()
            e = (ops_fb.unpad_rows(chain[s + 1]).float() - r).abs().max().item()
            if not e <= step * r.abs().max().item():
                raise AssertionError(f"K8 run {i} block {s} {dtype}: max abs err {e} above {step} of {r.abs().max().item()}")
            w["abs8"], w["rel8"] = max(w["abs8"], e), max(w["rel8"], e / r.abs().max().item())
        if not torch.equal(out9, ops_fb.unpad_rows(chain[-1])):
            raise AssertionError(f"K9 run {i} {dtype} is not bit-equal to the K8 chain")
        ref = ops_fb.fused_layer_reference(ops_fb.unpad_rows(chain[0]), ps).float()
        err = (out9.float() - ref).abs().max().item()
        limit = (len(ps) if dtype == torch.bfloat16 else 1) * step * ref.abs().max().item()
        if not err <= limit:
            raise AssertionError(f"K9 run {i} {dtype}: max abs err {err} above {limit}")
        w["abs9"], w["rel9"] = max(w["abs9"], err), max(w["rel9"], err / ref.abs().max().item())
        want = mod_out.permute(0, 2, 3, 1).float()
        top = want.abs().max().item()
        e = (out9.float() - want).abs().max().item()
        if not (torch.isfinite(out9).all() and e <= tol * top):
            raise AssertionError(f"run {i} {dtype} against the modules: {e} above {tol} of {top}")
        w["mod"] = max(w["mod"], e / top)
    return w


def kernel_params(torch, ops_fb, p):
    """`p` as the kernels take it, cast once: weights in bf16, biases f32, so
    that a timed launch casts nothing."""
    return ops_fb.FusedBlockParams(*(None if t is None else t.to(torch.bfloat16 if i % 2 == 0 else torch.float32)
                                     for i, t in enumerate(p)))


def folded_chain(torch, p):
    """The folded cuDNN chain of one block: `F.conv2d` on the folded bf16
    weights with their biases, relu and the residual add, channels-last NCHW
    bf16. A timing yardstick only (its biases round to bf16)."""
    import torch.nn.functional as F

    def conv(w):  # (Cin, Cout) or (9, Cm, Cm) -> (Cout, Cin, kh, kw)
        w = w.to(torch.bfloat16)
        if w.dim() == 3:
            return w.reshape(3, 3, *w.shape[1:]).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return w.t()[:, :, None, None].contiguous(memory_format=torch.channels_last)

    w1, w2, w3 = conv(p.w1), conv(p.w2), conv(p.w3)
    b1, b2, b3 = (t.reshape(-1).to(torch.bfloat16) for t in (p.b1, p.b2, p.b3))
    wd = None if p.wd is None else conv(p.wd)
    bd = None if p.bd is None else p.bd.reshape(-1).to(torch.bfloat16)

    def block(x):
        y = F.relu(F.conv2d(x, w1, b1))
        y = F.relu(F.conv2d(y, w2, b2, padding=1))
        y = F.conv2d(y, w3, b3)
        return F.relu(y + (x if wd is None else F.conv2d(x, wd, bd)))

    return block


def halo_where_it_fits(ops_fb, xs, folded, dtype):
    """Per run and block, the halo plan where one fits, else the computed plan."""
    plans = []
    for x, ps in zip(xs, folded):
        b, h, w, cin = x.shape
        run = []
        for p in ps:
            args = (b, h, w, cin, p.w1.shape[1], p.w3.shape[1], dtype)
            try:
                run.append(ops_fb.fused_plan(*args, route="halo"))
            except ValueError:
                run.append(ops_fb.fused_plan(*args))
            cin = p.w3.shape[1]
        plans.append(run)
    return plans


def run_fused_path(torch, dev):
    """K8 and K9 over the 13 stride-1 bottlenecks of the R50 at 800 x 1344,
    batch 2, bf16, with the computed plans (halo route for layer1, phase
    route for layer2-4): one pass launches K9 4 times
    and K8 13 times; each run is held to the plain versions and the module
    chain, then the same in f32 at FUSED_SMALL with the computed plans (the
    phase route) and with the halo route wherever it fits; K8 and K9 timed
    per block and run on parameters cast once, beside their bounds, the plain
    versions, the module chain and the folded cuDNN chain."""
    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.ops import fused_block as ops_fb

    t0 = time.perf_counter()
    net = fused_backbone(torch, dev)
    runs = ops_fb.stride1_runs(net)
    folded = [[ops_fb.fold_bottleneck(b) for b in run] for run in runs]
    caps = capture_runs(torch, net, runs, MAIN_SIZE, torch.bfloat16)
    xs = [x.permute(0, 2, 3, 1).contiguous() for x, _ in caps]
    log(f"  R50 built, runs of {[len(r) for r in runs]} blocks captured at {MAIN_SIZE}, "
        f"inputs {[tuple(x.shape) for x in xs]}, in {time.perf_counter() - t0:.1f} s")

    for k in cuda.KERNELS:
        k.launches = 0
    k9, k8 = fused_pass(torch, ops_fb, xs, folded)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in cuda.KERNELS}
    log(f"  launches over one pass: {launches}")
    if launches["bags_fused_layer"] != 4 or launches["bags_fused_bottleneck"] != 13:
        raise AssertionError("a backbone pass must launch K9 4 times and K8 13 times")
    bf16 = check_fused_runs(torch, ops_fb, caps, folded, k9, k8, torch.bfloat16)
    log(f"  bf16: K8 within {bf16['rel8']:.3e} (abs {bf16['abs8']:.3e}) of the plain version's largest |output| "
        f"a block; K9 bit-equal to the K8 chain, within {bf16['rel9']:.3e} (abs {bf16['abs9']:.3e}) of the plain "
        f"chain's; fused within {bf16['mod']:.3e} of the modules' (limit {FUSED_MODULE_TOL['bfloat16']})")
    del k8

    t9 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, by={"bytes": 0.0, "operations": 0.0})
    t8 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, by={"bytes": 0.0, "operations": 0.0})
    module_ms = folded_ms = 0.0
    routes = set()
    for i, ((x_nchw, _), x, ps, run, out) in enumerate(zip(caps, xs, folded, runs, k9)):
        kps = [kernel_params(torch, ops_fb, p) for p in ps]
        plans = ops_fb.run_plans(*x.shape, kps, x.dtype, ops_fb._sm_count(dev.index or 0))
        routes |= {pl.route for pl in plans}
        ms = cuda_time_ms(lambda: ops_fb.fused_layer(x, kps), 5)
        plain = cuda_time_ms(lambda: ops_fb.fused_layer_reference(x, ps), 2)
        b_ms, b_by = fused_bound(torch, x, ps, out)
        t9["ms"] += ms
        t9["plain_ms"] += plain
        t9["bound_ms"] += b_ms
        t9["by"][b_by] += b_ms

        def modules(x_nchw=x_nchw, run=run):
            with torch.no_grad():
                y = x_nchw
                for blk in run:
                    y = blk(y)
            return y

        chain = [folded_chain(torch, p) for p in ps]

        def folded_run(x_nchw=x_nchw, chain=chain):
            with torch.no_grad():
                y = x_nchw
                for blk in chain:
                    y = blk(y)
            return y

        mod = cuda_time_ms(modules, 5)
        fold = cuda_time_ms(folded_run, 5)
        module_ms += mod
        folded_ms += fold
        xp = ops_fb.pad_rows(x)
        per_block = []
        for p, kp, plan in zip(ps, kps, plans):
            out_p = ops_fb.fused_bottleneck(xp, kp)
            bms = cuda_time_ms(lambda: ops_fb.fused_bottleneck(xp, kp), 5)
            t8["ms"] += bms
            t8["plain_ms"] += cuda_time_ms(lambda: ops_fb.fused_bottleneck_reference(xp, p), 2)
            bb_ms, bb_by = fused_bound(torch, ops_fb.unpad_rows(xp), [p], ops_fb.unpad_rows(out_p))
            t8["bound_ms"] += bb_ms
            t8["by"][bb_by] += bb_ms
            per_block.append(f"{bms:.4f} (bound {bb_ms:.4f} {bb_by[0]})")
            xp = out_p
        log(f"  run {i} x {tuple(x.shape)} -> {tuple(out.shape)}, {len(ps)} blocks, route "
            f"{'/'.join(sorted({f'{pl.route} {pl.rows}' for pl in plans}))}: K9 {ms:.4f} ms "
            f"(bound {b_ms:.4f}, {b_by}), K8 blocks {', '.join(per_block)} ms, plain {plain:.3f} ms, "
            f"module chain {mod:.4f} ms, folded cuDNN chain {fold:.4f} ms")
    if routes != {"halo", "phase"}:
        raise AssertionError(f"the bf16 pass must take both routes, took {routes}")
    log(f"  a backbone pass: K9 {t9['ms']:.4f} ms (plain {t9['plain_ms']:.3f}, bound {t9['bound_ms']:.4f}), "
        f"K8 {t8['ms']:.4f} ms (plain {t8['plain_ms']:.3f}, bound {t8['bound_ms']:.4f}), "
        f"module chain {module_ms:.4f} ms, folded cuDNN chain {folded_ms:.4f} ms ({card_line()})")
    kxs = [[kernel_params(torch, ops_fb, p) for p in ps] for ps in folded]
    profile_device(torch, "K9 over the four runs", lambda: [ops_fb.fused_layer(x, ps) for x, ps in zip(xs, kxs)],
                   top=6)

    def k8_pass():
        for x, ps in zip(xs, kxs):
            y = ops_fb.pad_rows(x)
            for p in ps:
                y = ops_fb.fused_bottleneck(y, p)

    profile_device(torch, "K8 over the 13 blocks", k8_pass, top=6)
    del caps, xs, k9, kxs

    # f32 at a reduced size, TF32 off for the modules' convolutions and the plain versions' products
    allow = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {}
    try:
        caps = capture_runs(torch, net, runs, FUSED_SMALL, torch.float32)
        xs = [x.permute(0, 2, 3, 1).contiguous() for x, _ in caps]
        for label, plans in (("computed", None), ("halo where it fits", halo_where_it_fits(ops_fb, xs, folded,
                                                                                          torch.float32))):
            k9, k8 = fused_pass(torch, ops_fb, xs, folded, plans)
            f32[label] = check_fused_runs(torch, ops_fb, caps, folded, k9, k8, torch.float32)
            taken = plans or [ops_fb.run_plans(*x.shape, ps, torch.float32, ops_fb._sm_count(dev.index or 0))
                              for x, ps in zip(xs, folded)]
            log(f"  f32 at {FUSED_SMALL}, plans {label} ({[[f'{p.route} {p.rows}' for p in r] for r in taken]}): "
                f"K8 within {f32[label]['rel8']:.3e} a block, K9 within {f32[label]['rel9']:.3e} a run of the "
                f"plain versions' largest |output|; fused within {f32[label]['mod']:.3e} of the modules' "
                f"(limit {FUSED_MODULE_TOL['float32']})")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow

    def row(name, t, err):
        return dict(
            name=name,
            route="cuda",
            source="balancedgroupsoftmax_torch/csrc/fused_block.cu",
            replaces=f"balancedgroupsoftmax_tpu/pallas/fused_block.py:{234 if name == 'fused_bottleneck' else 448}",
            max_abs_err=err,
            ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=max(t["by"], key=t["by"].get),
            library_ms=None,
            module_chain_ms=module_ms,
            folded_chain_ms=folded_ms,
            shape=f"the R50's 13 stride-1 blocks at {MAIN_SIZE}, batch {MAIN_BATCH}, bf16, summed; "
                  f"module chain {module_ms:.4f} ms, folded cuDNN chain {folded_ms:.4f} ms",
        )

    return launches, [row("fused_bottleneck", t8, bf16["abs8"]), row("fused_layer", t9, bf16["abs9"])]


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
    each deformable layer, and K1, K5 and K6 on what one more predict gave them."""
    from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn
    from balancedgroupsoftmax_torch.ops import gather as ops_gather
    from balancedgroupsoftmax_torch.ops import nms as ops_nms
    from balancedgroupsoftmax_torch.ops import roi_align as ops_roi

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
    for name, pattern in (("K7", "deform_conv"), ("K2", "roi_align_forward")):
        rows = [v for k, v in prof.items() if pattern in k]
        if rows:
            log(f"  {name} in the profiled predict: {sum(v[0] for v in rows):.4f} ms device over "
                f"{sum(v[1] for v in rows)} launches")
    if prof:
        # K2 routes inside its launch: what map_roi_levels would add before each K2 call
        rois = main_rois(torch, dev, gen, 300)
        routing = kernels_per_call(torch, lambda: ops_roi.map_roi_levels(rois, 4))
        log(f"  device kernels in the profiled predict: {sum(v[1] for v in prof.values())}; "
            f"map_roi_levels alone launches {routing}, {8 * routing} over 8 K2 calls")
    kernels_without_and_with_the_copy(torch, "HTC predict_with_masks", lambda: model.predict_with_masks(*inputs))
    layers = capture_dcn(torch, lambda: model.predict_with_masks(*inputs))
    row = check_k7_path(torch, ops_dcn, layers)
    del layers
    seen = capture_calls(("nms_keep_batched", "gather_lanes", "nms_keep_batched_coords"),
                         lambda: model.predict_with_masks(*inputs))
    k1 = check_k1(torch, ops_nms, *seen["nms_keep_batched"][0], path="HTC")
    log(f"  K1 on HTC's RPN boxes ({k1['shape']}): equal to the plain version, kernel {k1['ms']:.4f} ms")
    (coords, valid, thr), _ = seen["nms_keep_batched_coords"]
    k5 = check_k5(torch, ops_nms, coords, valid, thr, path="HTC")
    log(f"  K5 on HTC's candidates ({k5['shape']}): equal to the plain version, kernel {k5['ms']:.4f} ms, "
        f"bound {k5['bound_ms']:.5f} ms")
    (rows, idx), kw6 = seen["gather_lanes"]
    planes = k6_matches(torch, ops_gather, rows, idx, kw6["groups_per_plane"], "HTC's candidates")
    k6_ms = [cuda_time_ms(lambda t=t: ops_gather.gather_lanes(t, idx, kw6["groups_per_plane"]), 300)
             for t in (rows, planes)]
    log(f"  K6 on HTC's candidates (P={rows.shape[0]} N={rows.shape[2]} G={idx.shape[0]} K={idx.shape[1]}): "
        f"bit-equal to the plain version in both layouts, {k6_ms[0]:.5f} ms a call on the rows, "
        f"{k6_ms[1]:.5f} on planes")
    return launches, model, row


def small_image(torch):
    """The seeded 256 x 384 image (batch 1) and its shape and scale of the
    small card-vs-CPU predicts."""
    gen = torch.Generator().manual_seed(5)
    return torch.randn(1, 256, 384, 3, generator=gen), torch.tensor([[256.0, 384.0]]), torch.ones(1)


def compare_masks_card_cpu(torch, cpu_model, gpu_model, label: str) -> None:
    """`predict_with_masks` of two f32 copies of a model on `small_image`:
    the card's (kernels) against the CPU's (plain versions), as
    `compare_small` does for the detections; for the detections found
    alike, the masks (and Mask-Scoring R-CNN's mask scores) must agree
    within 1e-3."""
    dev = next(gpu_model.parameters()).device
    images, shapes, sf = small_image(torch)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g, gm, *gs = gpu_model.predict_with_masks(images.to(dev), shapes.to(dev), sf.to(dev))
        g, gm, gs = [t.cpu() for t in g], gm.cpu(), [t.cpu() for t in gs]
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    c, cm, *cs = cpu_model.predict_with_masks(images, shapes, sf)
    score_err = (g[1] - c[1]).abs().max().item()
    gb, gl, gv = g[0][0], g[2][0], g[3][0]
    cb, cl, cv = c[0][0], c[2][0], c[3][0]
    matched, mask_err, ms_err = 0, 0.0, 0.0
    for i in torch.nonzero(gv).flatten().tolist():
        same = cv & (cl == gl[i]) & ((cb - gb[i]).abs().amax(dim=-1) <= 1e-2)
        if bool(same.any()):
            matched += 1
            j = int(torch.nonzero(same)[0])
            mask_err = max(mask_err, (gm[0, i] - cm[0, j]).abs().max().item())
            if gs:
                ms_err = max(ms_err, abs(gs[0][0, i].item() - cs[0][0, j].item()))
    total = int(gv.sum())
    log(f"  small {label} input, card vs CPU: max score diff {score_err:.3e}, {matched}/{total} detections "
        f"matched, max mask diff over them {mask_err:.3e}" + (f", max mask-score diff {ms_err:.3e}" if gs else ""))
    if not (score_err <= 1e-4 and total > 0 and matched >= 0.95 * total and mask_err <= 1e-3 and ms_err <= 1e-3):
        raise AssertionError("card and CPU detections, masks or mask scores disagree")


def compare_small_htc(torch, model) -> None:
    """HTC-DCN in f32 on `small_image`, on a reduced ResNeXt (depth 50, the
    X101's widths, 64 groups, deformable c3-c5 at D = 4, offsets spread as
    on the main path): `compare_masks_card_cpu`."""
    import dataclasses

    from balancedgroupsoftmax_torch.models.detector import build_model

    dev = next(model.parameters()).device
    cfg = dataclasses.replace(model.cfg, backbone=dataclasses.replace(model.cfg.backbone, depth=50))
    cpu_model = build_model(cfg, model.partition, torch.float32).init_weights(0).eval()
    spread_offsets(torch, cpu_model, small_image(torch)[0])
    gpu_model = build_model(cfg, model.partition, torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    compare_masks_card_cpu(torch, cpu_model, gpu_model.to(dev), "HTC-DCN")


def compare_small_mask_rcnn(torch, model) -> None:
    """The serving Mask R-CNN's weights in f32 on `small_image`:
    `compare_masks_card_cpu`."""
    from balancedgroupsoftmax_torch.models.detector import build_model

    dev = next(model.parameters()).device
    cpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    gpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    compare_masks_card_cpu(torch, cpu_model, gpu_model.to(dev), "Mask R-CNN")


VARIANT_LABELS = {"grid": "Grid R-CNN", "double_head": "Double-Head R-CNN", "mask_scoring": "Mask-Scoring R-CNN",
                  "fast": "Fast R-CNN"}
VARIANT_PROPOSALS = (1000, 2000)  # Fast R-CNN's seeded proposals an image: serving, training (the RPN's counts)


def variant_model(torch, dev, kind: str):
    """The zoo's `{kind}_rcnn_r50_fpn` at LVIS's 1231 classes (as the CLIs
    build it for LVIS), in bf16 on the card, through `build_model`, with
    seeded weights."""
    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.models.detector import build_model

    cfg = getattr(zoo, f"{kind}_rcnn_r50_fpn")(num_classes=1231)
    return build_model(cfg, dtype=torch.bfloat16).init_weights(0).to(dev).eval()


def check_grid_decode(torch, dev, heat, rois) -> None:
    """`grid_to_boxes` on the card against the CPU: on the bf16 heatmaps
    (N, 9, 56, 56) and boxes a Grid R-CNN predict decoded, and on seeded bf16
    heatmaps of three values, whose maxima tie. The argmax cells must be the
    same (both take the first maximum, as jnp.argmax) and the boxes within
    1e-3 px: the card fuses the cell-to-image multiply-add, a few f32 ulps
    at 1344 px, while a cell apart they would differ by a 56th of the box."""
    from balancedgroupsoftmax_torch.models.grid_head import grid_to_boxes

    gen = torch.Generator().manual_seed(12)
    ties = torch.randint(0, 3, heat.shape, generator=gen).to(torch.bfloat16)
    cells = lambda h: h.reshape(*h.shape[:2], -1).argmax(-1).cpu()
    for name, h in (("the predict's heatmaps", heat), ("tied heatmaps", ties)):
        got = grid_to_boxes(h.to(dev), rois.to(dev)).cpu()
        want = grid_to_boxes(h.cpu(), rois.cpu())
        err = (got - want).abs().max().item()
        same = torch.equal(cells(h.to(dev)), cells(h.cpu()))
        log(f"  grid_to_boxes card vs CPU on {name} {tuple(h.shape)} {h.dtype}: the same argmax cells {same}, "
            f"max box difference {err:.3e} px")
        if not (same and err <= 1e-3):
            raise AssertionError(f"grid_to_boxes differs on the card ({name})")


def run_variant_path(torch, ops_roi, dev, kind: str):
    """One detector variant at full width on the card: its serving call
    (`predict`, Mask-Scoring's `predict_with_masks`, Fast R-CNN's `predict`
    on 1000 seeded proposals an image) through `run_predicts` (K1 once, K2
    twice: S = 7, then S = 14 on the detections for the grid and Mask-Scoring
    or on the 1.3x inflated rois for the Double-Head; K3 once; Fast R-CNN no
    K1 and K2 once) and a profiled call; K2 held to its plain version on
    what the last pooling of one more call was handed (timed as a kernels-line
    row for the grid's S = 14 and the Double-Head's inflated rois); then
    selectp=0 training steps through `run_train_path` (K4 once, none for
    Fast R-CNN, which trains through `loss` on 2000 seeded proposals an
    image; K2 and K2b as many times as K2 serves, the grid's S = 14 on the
    jittered positives among them; "loss_grid" and "loss_mask_iou" positive;
    the grid and MaskIoU heads moved; Mask-Scoring's selectp=4 steps leave
    the MaskIoU head frozen), K2b held to its plain version on the grid's S =
    14 and the Double-Head's inflated rois (rows too). Then the small f32
    predict and training step card vs CPU. Returns the rows."""
    from balancedgroupsoftmax_torch.models import detector, variants
    from balancedgroupsoftmax_torch.models.variants import _scale_rois

    label = VARIANT_LABELS[kind]
    t0 = time.perf_counter()
    model = variant_model(torch, dev, kind)
    log(f"  {label} (1231 classes, bf16) built on the card in {time.perf_counter() - t0:.1f} s")
    fast = kind == "fast"
    serve_props, train_props = (main_rois(torch, dev, torch.Generator().manual_seed(6 + i), r)
                                for i, r in enumerate(VARIANT_PROPOSALS))
    call = {"fast": lambda im, sh, sf: model.predict(im, sh, sf, proposals=serve_props),
            "mask_scoring": model.predict_with_masks}.get(kind, model.predict)
    pools = 1 if fast else 2
    launches, inputs = run_predicts(
        torch, model, {"bags_nms_keep": 0 if fast else 1, "bags_roi_align_forward": pools, "bags_nms_keep_gathered": 1},
        call=call,
    )
    profile_device(torch, f"{label} serving", lambda: call(*inputs))
    calls = record_calls(detector, "batched_multilevel_roi_align", lambda: call(*inputs))
    sizes = [c[0][3] for c in calls]
    want = {"grid": [7, 14], "mask_scoring": [7, 14], "double_head": [7, 7], "fast": [7]}[kind]
    (feats, rois, strides, out_size) = calls[-1][0][:4]
    if sizes != want or (kind != "double_head" and not fast and tuple(rois.shape) != (MAIN_BATCH, MAX_PER_IMG, 4)):
        raise AssertionError(f"{label}'s K2 calls: sizes {sizes}, last rois {tuple(rois.shape)}")
    if kind == "double_head" and not torch.equal(rois, _scale_rois(calls[0][0][1], 1.3)):
        raise AssertionError("the Double-Head's second pooling is not of the inflated rois")
    rows = []
    if kind == "grid":
        check_grid_decode(torch, dev, *record_calls(variants, "grid_to_boxes", lambda: call(*inputs))[0][0])
    if kind in ("grid", "double_head"):
        what = (f"on Grid R-CNN's {MAX_PER_IMG} detections an image, S = 14" if kind == "grid"
                else f"on the Double-Head's {rois.shape[1]} proposals an image inflated 1.3x, S = 7")
        row = k2_row(torch, ops_roi, feats, rois, strides, out_size, f"roi_align_forward/{kind.replace('_', '-')}", what)
        row["launches"] = launches["bags_roi_align_forward"]
        rows.append(row)
    else:
        k2_matches(torch, ops_roi, feats, rois, strides, out_size, f"on {label}'s last pooling")

    extra = {"grid": (("grid_head.",), ("loss_grid",)), "mask_scoring": (("mask_iou_head.",), ("loss_mask_iou",)),
             "double_head": (("bbox_head.res0_",), ()), "fast": ((), ())}[kind]
    trained = run_train_path(torch, model, None, pools=pools, heads=extra[0], losses=extra[1],
                             proposals=train_props if fast else None)
    k2b = trained["k2b_calls"]
    pick = None
    if kind == "grid":
        pick = trained["k2b"]
    elif kind == "double_head":
        (a, b) = k2b
        pick = b if torch.equal(b[0][1], _scale_rois(a[0][1], 1.3)) else a
        if not torch.equal(pick[0][1], _scale_rois((a if pick is b else b)[0][1], 1.3)):
            raise AssertionError("no K2b call of the Double-Head's step was on the inflated rois")
    if pick is not None:
        args, kw = pick
        grad, r, shapes, strides, size = args[:5]
        what = (f"on the grid branch's {tuple(r.shape[:2])} jittered positives, S = 14" if kind == "grid"
                else f"on the Double-Head's {tuple(r.shape[:2])} inflated rois, S = 7")
        row = k2b_row(torch, ops_roi, grad, r, shapes, strides, size, kw["dtype"], kw["levels"],
                      f"roi_align_backward/{kind.replace('_', '-')}", what)
        row["launches"] = trained["launches"]["bags_roi_align_backward"]
        rows.append(row)
    del trained, k2b, pick, calls, feats, rois

    t0 = time.perf_counter()
    if kind == "mask_scoring":
        compare_small_mask_rcnn(torch, model)
        compare_small_mask_train(torch, model, label)
    else:
        gen = torch.Generator().manual_seed(8)
        small = lambda b, r: main_rois(torch, torch.device("cpu"), gen, r, (256, 384), b) if fast else None
        compare_small(torch, model, proposals=small(1, 300))
        compare_small_train(torch, model, proposals=small(MAIN_BATCH, 100))
    log(f"  small f32 {label} predict and train step, card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    return rows


# f32 operations K7b does a sample and channel beyond the contractions: the
# sample's blend (7, for the weight's and the mask's gradients), grad_s times
# each of the four corners summed over the channels (four multiply-adds, 8:
# the derivatives in the two fractions follow from those sums once a
# (position, tap)) and the four corners' shares of dx added up (four
# multiply-adds, 8)
DCN_GRAD_SAMPLE_OPS = 23
HTC_DCN_SHAPES = 6  # distinct (input, stride) among the X101's 30 deformable layers


def dcn_grad_bound(torch, args, grads) -> tuple[float, str]:
    """K7b's least time: its inputs (x, offsets, weight, mask, grad_out) read
    once and its gradients written once at HBM rate, against its operations:
    the two grouped contractions (grad_col and the weight's gradient, 2 *
    taps * c_g * C_out each a position, at the tensor cores' dense rate for
    bf16 inputs, the CUDA cores' for f32) and DCN_GRAD_SAMPLE_OPS f32
    operations a sample and channel on the CUDA cores."""
    grad_out, x, off, weight, mask = args[:5]
    b, ho, wo, c_out = grad_out.shape
    _, c_g, kh, kw = weight.shape
    tensors = [t for t in (grad_out, x, off, weight, mask) + tuple(grads) if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n, taps = b * ho * wo, kh * kw
    mac_ops = 2 * 2 * n * c_out * taps * c_g
    sample_ops = n * taps * x.shape[-1] * DCN_GRAD_SAMPLE_OPS
    t_ops = sample_ops / F32_FLOP_PER_S + mac_ops / (BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else F32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def k7b_err(torch, ops_dcn, args) -> tuple[float, float, tuple]:
    """K7b against its plain version on the same inputs: each gradient in its
    dtype, f32 within 1e-5 of its largest |value| and bf16 within one bf16
    step (2^-7) of it (the sums' order differs, and dx's atomics change it
    from run to run). Returns the largest difference relative to its
    gradient's largest |value|, the largest absolute difference, and K7b's
    gradients."""
    got = ops_dcn.deform_conv2d_backward(*args)
    want = ops_dcn.deform_conv2d_backward_reference(*args)
    torch.cuda.synchronize()
    scale = 1e-5 if args[1].dtype == torch.float32 else 2.0**-7
    worst = worst_abs = 0.0
    for name, g, r, like in zip(("dx", "d_offsets", "d_weight", "d_mask"), got, want, args[1:5]):
        if like is None or r is None:
            continue
        top = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        if not (g.dtype == like.dtype and g.shape == like.shape and err <= scale * top):
            raise AssertionError(f"K7b {name} {args[1].dtype} {tuple(args[1].shape)}: max abs err {err} above "
                                 f"{scale * top}")
        worst = max(worst, err / max(top, 1e-30))
        worst_abs = max(worst_abs, err)
    return worst, worst_abs, got


def check_k7b_path(torch, ops_dcn, calls: list, layers: int):
    """K7b on what one selectp=0 HTC-DCN step handed it: at the first layer
    of each of the six distinct shapes of its `layers`, held against its plain
    version in bf16 (the path's dtype) and, at c3's stride-2 layer and at
    c5, in f32; timed by CUDA events beside the plain version and its bound.
    A step's K7b time is each shape's time times its count of layers."""
    if len(calls) != layers:
        raise AssertionError(f"a training step made {len(calls)} K7b calls, not {layers}")
    shapes = {}
    for args, kw in calls:
        key = (tuple(args[1].shape), args[5])
        shapes.setdefault(key, [args, kw, 0])[2] += 1
    if len(shapes) != HTC_DCN_SHAPES:
        raise AssertionError(f"{len(shapes)} distinct K7b shapes, not {HTC_DCN_SHAPES}")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, by={"bytes": 0, "operations": 0})
    worst = 0.0
    for (xshape, stride), (args, kw, count) in shapes.items():
        args = args[:9]  # grad_out, x, offsets, weight, mask, stride, padding, groups, D; all gradients
        err, err_abs, grads = k7b_err(torch, ops_dcn, args)
        worst = max(worst, err_abs)
        ms = cuda_time_ms(lambda: ops_dcn.deform_conv2d_backward(*args), 5)
        plain_ms = cuda_time_ms(lambda: ops_dcn.deform_conv2d_backward_reference(*args), 1)
        b_ms, b_by = dcn_grad_bound(torch, args, grads)
        total["ms"] += ms * count
        total["plain_ms"] += plain_ms * count
        total["bound_ms"] += b_ms * count
        total["by"][b_by] += count
        f32 = ""
        if xshape[-1] == 2048 and stride == 1 or xshape[-1] == 512 and stride == 2:
            err32, _, _ = k7b_err(torch, ops_dcn, (args[0].float(), args[1].float(), args[2], args[3].float(), *args[4:]))
            f32 = f", f32 err {err32:.3e} of the largest"
        log(f"  K7b at x {xshape} stride {stride} (x{count} a step): {ms:.4f} ms by events, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}); bf16 err {err:.3e} of the largest ({err_abs:.3e} absolute){f32}")
        del grads
    log(f"  K7b over the {layers} layers of one step: {total['ms']:.4f} ms by events, plain {total['plain_ms']:.3f} ms, "
        f"bound {total['bound_ms']:.5f} ms ({total['by']['bytes']} layers bound by bytes, "
        f"{total['by']['operations']} by operations)")
    return dict(
        name="deform_conv_backward",
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/deform_conv.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/deform_conv.py:544",
        max_abs_err=worst,
        ms=total["ms"],
        plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by="bytes" if total["by"]["bytes"] >= total["by"]["operations"] else "operations",
        library_ms=None,
        shape=f"the {layers} deformable layers of one HTC training step, bf16, summed",
    )


def check_semantic_pooling(torch, ops_roi, forwards: list, backwards: list) -> None:
    """K2 and K2b on HTC's semantic pyramid (one stride-8 level) at S = 14,
    as a training step handed them, against their plain versions."""
    fwd = [(a, kw) for a, kw in forwards if len(a[0]) == 1 and a[3] == 14]
    bwd = [(a, kw) for a, kw in backwards if len(a[2]) == 1 and a[4] == 14]
    if not (fwd and bwd):
        raise AssertionError(f"no semantic pooling at S = 14 among {len(forwards)} K2 and {len(backwards)} K2b calls")
    (feats, rois, strides, out_size), _ = fwd[0][0][:4], fwd[0][1]
    k2_matches(torch, ops_roi, [f.detach() for f in feats], rois, strides, out_size,
               f"HTC training, semantic pyramid {tuple(feats[0].shape)}, S = 14")
    args, kw = bwd[0]
    grad, rois, shapes, strides, out_size = args[:5]
    k2b_matches(torch, ops_roi, grad, rois, shapes, strides, out_size, kw["dtype"],
                f"HTC training, semantic pyramid {tuple(shapes)}, S = 14", kw.get("levels"))


def run_htc_train_path(torch, model):
    """Training of the HTC-DCN `model` (bf16, f32 parameters, offsets
    spread) at 800 x 1344, batch 2, 20 gt boxes with polygon masks an image:
    a warm-up step and TIMED_STEPS timed steps of full training (selectp=0),
    each launching K7 and K7b 30 times, K2 and K2b 12 times (three stages'
    bbox and mask poolings, over the FPN and the semantic feature) and K4
    once, moving every deformable layer's weight and offset conv; a profiled
    step; then a BAGS phase-2 step (selectp=3, only fc_cls moves) and a
    selectp=4 step (only the bbox and mask heads), neither launching K7b or
    K2b. K7b and the semantic K2/K2b are held to their plain versions on
    what the first step handed them. Returns the selectp=0 launches and
    K7b's kernels-line row."""
    from balancedgroupsoftmax_torch import cuda
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.ops import deform_conv as ops_dcn
    from balancedgroupsoftmax_torch.ops import roi_align as ops_roi
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step
    from balancedgroupsoftmax_torch.zoo import TRAIN_CONFIGS

    dev = next(model.parameters()).device
    n_dcn = sum(isinstance(m, ops_dcn.DeformConv) for m in model.modules())  # 30 in the X101
    n_pool = 4 * model.cfg.cascade.num_stages  # bbox and mask, each over the FPN and the semantic feature
    batch = train_batch(8, model.partition, masks=True)
    if tuple(batch["images"].shape[1:3]) != MAIN_SIZE or int(batch["gt_mask"].sum()) != MAIN_BATCH * TRAIN_GTS:
        raise AssertionError(f"training batch {batch['images'].shape}, {int(batch['gt_mask'].sum())} gts")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    named = dict(model.named_parameters())
    step = make_train_step(create_train_state(model, TrainConfig(selectp=0)))
    gen = torch.Generator(device=dev).manual_seed(0)
    before = {n: p.detach().clone() for n, p in named.items()}

    for k in cuda.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = []
    k2f, k2b = [], []
    first = lambda: out.append(step(batch, gen))
    with_k2b = lambda: k2b.extend(record_calls(ops_roi, "roi_align_backward", first))
    with_k2 = lambda: k2f.extend(record_calls(ops_roi, "roi_align_forward", with_k2b))
    k7b = record_calls(ops_dcn, "deform_conv2d_backward", with_k2)
    metrics = out[0]
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
    for sym, each in (("bags_deform_conv_forward", n_dcn), ("bags_deform_conv_backward", n_dcn),
                      ("bags_roi_align_forward", n_pool), ("bags_roi_align_backward", n_pool),
                      ("bags_nms_keep_tiled", 1)):
        if launches[sym] != each * steps:
            raise AssertionError(f"{sym} launched {launches[sym]} times in {steps} steps, not {each} a step")
    if not all(torch.isfinite(v).item() for v in metrics.values()) or "s2.loss_mask" not in metrics:
        raise AssertionError(f"a loss is missing or not finite: {metrics}")
    moved = {n for n, p in named.items() if not torch.equal(p.detach(), before[n])}
    trainable = {n for n, p in named.items() if p.requires_grad}
    dcn = {n for n in named if ".conv2." in n and n.startswith("backbone.layer") and n.endswith("weight")
           and ("conv_offset" in n or n.replace(".weight", ".conv_offset.weight") in named)}
    if len(dcn) != 2 * n_dcn or not dcn <= moved or moved - trainable or not all(
            any(n.startswith(m) for n in moved) for m in ("backbone", "neck", "semantic_head", "bbox_heads", "mask_heads")):
        raise AssertionError(f"selectp=0 moved {len(moved)} tensors of {len(trainable)} trainable, "
                             f"{len(dcn & moved)} of the {len(dcn)} deformable weights and offset convs")
    log(f"  selectp=0 moved {len(moved)} of {len(trainable)} trainable tensors, every deformable layer's weight and "
        f"offset conv among them, no frozen one")
    profile_device(torch, "HTC-DCN train step", lambda: step(batch, gen), top=15)
    del step

    for cfg, expect in ((TRAIN_CONFIGS["gs_htc_x101_64x4d_fpn_lvis"], lambda n: "fc_cls" in n),
                        (TrainConfig(selectp=4), lambda n: n.startswith(("bbox_heads", "mask_heads")))):
        phase = make_train_step(create_train_state(model, cfg))
        before = {n: p.detach().clone() for n, p in named.items()}
        for k in cuda.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        m = phase(batch, gen)
        torch.cuda.synchronize()
        took = (time.perf_counter() - t0) * 1e3
        moved = sorted(n for n, p in named.items() if not torch.equal(p.detach(), before[n]))
        if not moved or any(not expect(n) for n in moved) or (cfg.selectp == 4 and {n.split(".")[0] for n in moved}
                                                               != {"bbox_heads", "mask_heads"}):
            raise AssertionError(f"selectp={cfg.selectp} moved {moved}")
        if cuda.DEFORM_CONV_BACKWARD.launches or cuda.ROI_ALIGN_BACKWARD.launches or not torch.isfinite(m["loss"]):
            raise AssertionError(f"selectp={cfg.selectp}: K7b {cuda.DEFORM_CONV_BACKWARD.launches}, "
                                 f"K2b {cuda.ROI_ALIGN_BACKWARD.launches} launches, loss {m['loss'].item()}")
        log(f"  selectp={cfg.selectp} step {took:.3f} ms moved {len(moved)} tensors, all "
            f"{'fc_cls' if cfg.selectp == 3 else 'bbox or mask head'}; K7b and K2b not launched; "
            f"loss {m['loss'].item():.5f}")
        del phase

    check_semantic_pooling(torch, ops_roi, k2f, k2b)
    del k2f, k2b, batch
    row = check_k7b_path(torch, ops_dcn, k7b, n_dcn)
    return launches, row, ms, peak


# The card's and the CPU's f32 gradients of the small HTC-DCN step may part by
# this much in the relative norm of a tensor. The function's derivative jumps
# where a sample's position crosses a whole cell or a ReLU's input crosses 0,
# and f32 rounding moves a few of the step's ~10^6 samples and activations
# across: on this case the CPU's own f32 gradient parts from its f64 one by
# up to 2.4e-3 (`tests/f64_witness.py`), so any two f32 orders of summation
# may part by about that. A wrong K7b gradient (a lost corner, group or
# atomic) parts by O(1); K7b is held to 1e-5 of its plain version at the six
# X101 layer shapes on their own.
GRAD_NORM_LIMIT = 1e-2


def small_mask_train_case(torch, model):
    """The reduced model that `compare_small_mask_train` steps, from the
    main HTC-DCN's or Mask R-CNN's configuration (depth 50): (its
    configuration, a batch of two 256 x 384 images with eight
    polygon-masked gt boxes each, seeded f32 weights, an HTC's offset convs
    spread as on the main path)."""
    import dataclasses

    import numpy as np

    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.ops.mask import rasterize_gt_masks

    cfg = model.cfg
    num_anchors = 3 * sum(-(-256 // s) * -(-384 // s) for s in cfg.anchors.strides)
    take_all = lambda sc, num: dataclasses.replace(sc, sampler=dataclasses.replace(sc.sampler, num=num, pos_fraction=1.0))
    # HTC adds the 8 gt boxes again in each later stage and each mask resampling
    samplings = 6 if cfg.htc else 1
    cfg = dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, depth=50),
        rpn_train=take_all(cfg.rpn_train, num_anchors),
        rpn_proposal_train=dataclasses.replace(cfg.rpn_proposal_train, nms_post=100, max_num=100),
        rcnn_train=take_all(cfg.rcnn_train, 100 + 8 * samplings),
        bbox_head=dataclasses.replace(cfg.bbox_head, gs=dataclasses.replace(cfg.bbox_head.gs, others_sample_ratio=1e4)),
    )
    gen = torch.Generator().manual_seed(11)
    rng = np.random.RandomState(11)
    xy = torch.rand(MAIN_BATCH, 8, 2, generator=gen) * torch.tensor([300.0, 200.0])
    wh = 16 + torch.rand(MAIN_BATCH, 8, 2, generator=gen) * 120
    boxes = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([383.0, 255.0]))], -1).floor()
    crops = np.stack([rasterize_gt_masks([[polygon_in(rng, b)] for b in bs.numpy()], bs.numpy(), 256, 384, 8)
                      for bs in boxes])
    partition = model.partition or synthetic_partition(cfg.bbox_head.num_classes)
    batch = dict(
        images=torch.randn(MAIN_BATCH, 256, 384, 3, generator=gen),
        gt_boxes=boxes,
        gt_labels=torch.from_numpy(np.stack([gt_labels(rng, partition, 8) for _ in range(MAIN_BATCH)])),
        gt_mask=torch.ones(MAIN_BATCH, 8, dtype=torch.bool),
        img_shapes=torch.tensor([[256.0, 384.0]] * MAIN_BATCH),
        gt_mask_crops=torch.from_numpy(crops),
    )
    cpu_model = build_model(cfg, model.partition, torch.float32).init_weights(0)
    if cfg.htc:
        spread_offsets(torch, cpu_model, batch["images"])
    return cfg, batch, cpu_model.state_dict()


def compare_small_mask_train(torch, model, label: str) -> None:
    """One f32 training step of the reduced `small_mask_train_case` model
    (for HTC-DCN depth 50 with the X101's widths, 64 groups, deformable
    c3-c5 at D = 4, offsets spread as on the main path) on two 256 x 384
    images with polygon masks, on the card (kernels, K7b among them for
    HTC) and on the CPU (plain versions), from the same weights; sampling
    made deterministic by the configuration (every anchor and RoI candidate
    sampled, also for the interleaved mask targets, the GS others' budget
    covering them all). The loss dicts must agree to 1e-3 relative, as
    `compare_small_train`'s, and every trained parameter's gradient
    (clipped, as the step leaves it) to GRAD_NORM_LIMIT in the relative norm
    |card - cpu| / |cpu|: the mask head's, and the deformable layers'
    weights and offset convs, whose gradient K7b gives on the card, among
    them. The largest elementwise difference is printed beside it."""
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    dev = next(model.parameters()).device
    cfg, batch, weights = small_mask_train_case(torch, model)
    n_dcn = 13 if cfg.htc else 0  # deformable c3-c5 of depth 50
    mask_loss = "s2.loss_mask" if cfg.htc else "loss_mask"
    out, grads = {}, {}
    allow = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = build_model(cfg, model.partition, torch.float32)
            m.load_state_dict(weights)
            m.to(device)
            before = cuda_launches()
            step = make_train_step(create_train_state(m, TrainConfig(selectp=0)))
            out[name] = {k: v.item() for k, v in step(batch, torch.Generator(device=device).manual_seed(0)).items()}
            grads[name] = {n: p.grad.double().cpu() for n, p in m.named_parameters() if p.grad is not None}
            if name == "card" and cuda_launches()["bags_deform_conv_backward"] - before["bags_deform_conv_backward"] != n_dcn:
                raise AssertionError(f"the small {label} step did not launch K7b once a deformable layer")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    worst = max(abs(out["card"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-6) for k in out["cpu"])
    log(f"  small f32 {label} train step, card vs CPU: max relative loss difference {worst:.3e} over "
        f"{len(out['cpu'])} losses")
    if not (sorted(out["card"]) == sorted(out["cpu"]) and worst <= 1e-3 and mask_loss in out["cpu"]):
        raise AssertionError(f"card and CPU losses disagree: {out}")
    if sorted(grads["card"]) != sorted(grads["cpu"]):
        raise AssertionError("the card and the CPU step trained different parameters")
    norm, peak = grad_differences(grads["card"], grads["cpu"])
    dcn = [n for n in norm if n.endswith(("conv2.weight", "conv2.conv_offset.weight", "conv2.conv_offset.bias"))
           and n.rsplit("conv2.", 1)[0] + "conv2.conv_offset.weight" in norm]
    heads = [n for n in norm if n.startswith(("mask_head.", "mask_heads."))]
    far = max(norm, key=norm.get)
    log(f"  gradients, card vs CPU: relative norm worst {norm[far]:.3e} ({far}) over {len(norm)} tensors, "
        f"{max(norm[n] for n in heads):.3e} over the {len(heads)} mask-head tensors"
        + (f", {max(norm[n] for n in dcn):.3e} over the {len(dcn)} deformable weights and offset convs" if dcn else "")
        + f"; largest elementwise difference {max(peak.values()):.3e} of its tensor's largest "
        f"({max(peak, key=peak.get)})")
    # each layer's offset conv weight and bias, and its weight (no bias); the
    # limit is GRAD_NORM_LIMIT's
    if len(dcn) != 3 * n_dcn or not heads or norm[far] > GRAD_NORM_LIMIT:
        raise AssertionError(f"card and CPU gradients disagree: {sorted(norm.items(), key=lambda kv: -kv[1])[:5]}")


def grad_differences(got: dict, want: dict) -> tuple[dict, dict]:
    """Per tensor name: |got - want| / |want| in the 2-norm, and the largest
    elementwise |got - want| over the largest |want|."""
    norm = {n: ((got[n] - w).norm() / w.norm().clamp(min=1e-30)).item() for n, w in want.items()}
    peak = {n: ((got[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item() for n, w in want.items()}
    return norm, peak


def cuda_launches() -> dict:
    from balancedgroupsoftmax_torch import cuda

    return {k.symbol: k.launches for k in cuda.KERNELS}


FLOW_PHASE1_STEPS = 4
FLOW_PHASE2_STEPS = 2
FLOW_BATCH = 2


def run_cli(fn, argv) -> tuple:
    """`fn(argv)` (a CLI's main) with its standard output captured and shown
    indented: (what it returned, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    | {line}")
    return out, text


def counted(torch, fn):
    """`fn()` with every kernel's count set to 0 just before and read just
    after: (what it returned, {symbol: launches})."""
    from balancedgroupsoftmax_torch import cuda

    for k in cuda.KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.symbol: k.launches for k in cuda.KERNELS}


def expect_launches(launches: dict, each: dict, calls: int, what: str) -> None:
    for sym, n in each.items():
        if launches[sym] != n * calls:
            raise AssertionError(f"{sym} launched {launches[sym]} times in {calls} {what}, not {n} each")


def check_records(records, ann: str) -> None:
    """Finite boxes inside their images, scores in [0, 1], known classes."""
    import json
    import math

    with open(ann) as f:
        gt = json.load(f)
    sizes = {i["id"]: (i["width"], i["height"]) for i in gt["images"]}
    cats = {c["id"] for c in gt["categories"]}
    if not records or {r["image_id"] for r in records} != set(sizes):
        raise AssertionError(f"{len(records)} records, not covering the {len(sizes)} images")
    for r in records:
        x, y, w, h = r["bbox"]
        iw, ih = sizes[r["image_id"]]
        if not all(math.isfinite(v) for v in (x, y, w, h, r["score"])):
            raise AssertionError(f"a record is not finite: {r}")
        # xywh with mmdet's +1: the box's last pixel is x + w - 1 (a box
        # clipped at the border can have w, h a rounding under 1)
        if not (x >= 0 and y >= 0 and w > 0 and h > 0 and x + w - 1 <= iw + 1e-3 and y + h - 1 <= ih + 1e-3):
            raise AssertionError(f"a record outside its {iw} x {ih} image: {r}")
        if not (0 <= r["score"] <= 1 and r["category_id"] in cats):
            raise AssertionError(f"a record's score or class is wrong: {r}")


def check_segmentations(records, ann: str) -> None:
    """Every record's "segmentation" decodes to a mask of its image's size;
    some masks are not empty."""
    import json

    from balancedgroupsoftmax_torch.utils.rle import decode_rle

    with open(ann) as f:
        sizes = {i["id"]: (i["height"], i["width"]) for i in json.load(f)["images"]}
    areas = []
    for r in records:
        m = decode_rle(r["segmentation"])
        if m.shape != sizes[r["image_id"]] or r["segmentation"]["size"] != list(m.shape):
            raise AssertionError(f"a mask of {m.shape} on a {sizes[r['image_id']]} image: {r['segmentation']['size']}")
        areas.append(int(m.sum()))
    if not any(areas):
        raise AssertionError("every pasted mask is empty")


def run_mask_scoring_flow(torch, root: str, ann: str, common: list, train_args: list, n_batches: int) -> dict:
    """Two mask_scoring_rcnn_r50 train-CLI steps (K4 once, K2 and K2b twice
    a step; "loss_mask" and "loss_mask_iou" positive), then the test CLI on its
    checkpoint (K1 and K3 once, K2 twice a batch): its records' masks and
    finite "segm_score", and the segm table the evaluator's of the records
    ranked by their mask scores. Returns the test CLI's times."""
    import math
    import os

    from balancedgroupsoftmax_torch.eval.lvis_eval import LvisEvaluator
    from balancedgroupsoftmax_torch.tools import test_lvis, train

    (rs, _), launches = counted(torch, lambda: run_cli(train.main, [
        "--model", "mask_scoring_rcnn_r50", *train_args, "--selectp", "0", "--work-dir", os.path.join(root, "ws"),
        "--max-steps", "2"]))
    expect_launches(launches, {"bags_nms_keep_tiled": 1, "bags_roi_align_forward": 2, "bags_roi_align_backward": 2},
                    2, "Mask-Scoring R-CNN steps")
    if not all(math.isfinite(rs["log"][-1][k]) and rs["log"][-1][k] > 0 for k in ("loss_mask", "loss_mask_iou")):
        raise AssertionError(f"the Mask-Scoring R-CNN step's mask losses: {rs['log'][-1]}")
    (sout, stext), launches = counted(torch, lambda: run_cli(test_lvis.main, [
        "--model", "mask_scoring_rcnn_r50", *common, "--checkpoint", rs["checkpoint"]]))
    del rs
    expect_launches(launches, {"bags_nms_keep": 1, "bags_roi_align_forward": 2, "bags_nms_keep_gathered": 1},
                    n_batches, "Mask-Scoring R-CNN test batches")
    records = sout["records"]
    check_records(records, ann)
    check_segmentations(records, ann)
    if not all(math.isfinite(r["segm_score"]) for r in records) or all(r["segm_score"] == r["score"] for r in records):
        raise AssertionError("the Mask-Scoring records' segm_score is missing, not finite or the score")
    with open(ann) as f:
        ranked = LvisEvaluator(json.load(f), [dict({k: v for k, v in r.items() if k != "segm_score"},
                                                   score=r["segm_score"]) for r in records], iou_type="segm").run()
    segm = sout["segm_evaluator"]
    if "segm results:" not in stext or segm.results != ranked:
        raise AssertionError("the test CLI's segm table is not ranked by the mask scores")
    t = dict(sout["times"], images=len({r["image_id"] for r in records}))
    log(f"  Mask-Scoring R-CNN test CLI: {len(records)} records with masks and segm_score, launches {launches}; "
        f"predict {t['predict']:.3f} s, masks {t['masks']:.3f} s over {t['images']} images; the segm table ranked by "
        f"the mask scores, segm AP {segm.results['AP']:.6f} ({card_line()})")
    return t


def run_flow(torch, ops_nms, ops_roi, preloaded_ms: float, root: str) -> dict:
    """The BAGS two-phase recipe through the CLIs' `main(argv)` on the card,
    gs_faster_rcnn_r50_fpn_lvis at full width (1230 classes, bf16,
    800 x 1344 and 1344 x 800, batch 2), on an LVIS-shaped fixture of 8 JPEGs
    (`tools.mini_lvis` "full": both buckets, 20 boxes an image, the
    federated fields filled in): the partition; phase 1 (selectp=0, K4, K2
    and K2b once a step); phase 2 warm-started from it (only fc_cls fresh,
    only fc_cls moves); a resume (restarts at the saved step with the
    optimizer's state); the test CLI with and without --tau 0.5 (K1, K2 and
    K3 once a batch; records finite and inside their images); the eval CLI,
    whose table must equal the test CLI's; then one mask_rcnn_r50 train-CLI
    step with the gt crops (K4 once, K2 and K2b twice) and the test CLI on
    its checkpoint (K1 and K3 once and K2 twice a batch; every record's
    segmentation a mask of its image, the segm table finite, the masks'
    paste-and-encode seconds printed). K1-K4 and K2 are held to their
    plain versions again on what the CLIs handed them (the portrait bucket
    too). Then the same two for mask_scoring_rcnn_r50
    (`run_mask_scoring_flow`). The fixture, partition and checkpoints stay in
    `root`. Returns the flow's numbers."""
    import math
    import os

    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.parallel.train import TrainState
    from balancedgroupsoftmax_torch.tools import eval_lvis, gs_partition, mini_lvis, test_lvis, train
    from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint

    numbers = {}
    ann, imgs = mini_lvis.write_full_fixture(os.path.join(root, "lvis"))
    part_path = os.path.join(root, "part.npz")
    part, _ = run_cli(gs_partition.main, ["--ann", ann, "--out", part_path])
    if part.num_logits != 1236 or sorted(set(part.label2bin[1:].tolist())) != [1, 2, 3, 4]:
        raise AssertionError(f"partition: {part.num_logits} logits, bins {part.bin_sizes}")
    common = ["--ann", ann, "--img-prefix", imgs, "--dtype", "bfloat16", "--batch-size", str(FLOW_BATCH)]
    train_args = [*common, "--log-interval", "1", "--warmup-iters", "500"]

    # phase 1, recording what the last step handed K4 and K2
    t0 = time.perf_counter()
    seen, launches = counted(torch, lambda: capture_path(("nms_keep_tiled",), lambda: run_cli(train.main, [
        "--model", "faster_rcnn_r50", *train_args, "--selectp", "0", "--work-dir", os.path.join(root, "w1"),
        "--max-steps", str(FLOW_PHASE1_STEPS)])))
    r1 = seen["out"][0]
    log(f"  phase 1: {FLOW_PHASE1_STEPS} steps, wall {time.perf_counter() - t0:.1f} s; launches {launches}")
    expect_launches(launches, {"bags_nms_keep_tiled": 1, "bags_roi_align_forward": 1, "bags_roi_align_backward": 1},
                    FLOW_PHASE1_STEPS, "phase-1 steps")
    boxes, valid, thr = seen["nms_keep_tiled"][0]
    if not torch.equal(ops_nms.nms_keep_tiled(boxes, valid, thr), ops_nms.nms_keep_reference(boxes, valid, thr)):
        raise AssertionError("K4 differs from its plain version on the train CLI's boxes")
    feats, rois, strides, out_size = seen["batched_multilevel_roi_align"][0][:4]
    k2_matches(torch, ops_roi, [f.detach() for f in feats], rois, strides, out_size, "on the train CLI's step")
    steady = r1["log"][1:]
    numbers["train_images_per_s"] = sum(l["imgs_per_sec"] for l in steady) / len(steady)
    numbers["train_data_wait_s"] = sum(l["data_wait_s"] for l in steady) / len(steady)
    log(f"  train CLI from JPEG files: {numbers['train_images_per_s']:.3f} images/s over steps 2-"
        f"{FLOW_PHASE1_STEPS} (data wait {numbers['train_data_wait_s'] * 1e3:.3f} ms a step); the preloaded "
        f"batch above {FLOW_BATCH / preloaded_ms * 1e3:.3f} images/s ({card_line()})")
    losses = r1["log"][-1]
    if not all(math.isfinite(v) for k, v in losses.items() if "loss" in k):
        raise AssertionError(f"phase 1 loss not finite: {losses}")

    # phase 2: the GS head warm-started from phase 1, only fc_cls trains
    (r2, _), launches = counted(torch, lambda: run_cli(train.main, [
        "--model", "gs_faster_rcnn_r50", *train_args, "--partition", part_path, "--selectp", "1",
        "--load-from", r1["checkpoint"], "--work-dir", os.path.join(root, "w2"),
        "--max-steps", str(FLOW_PHASE2_STEPS)]))
    fc_cls = ["bbox_head.fc_cls.weight", "bbox_head.fc_cls.bias"]
    if sorted(r2["fresh"]) != sorted(fc_cls):
        raise AssertionError(f"phase 2 warm start left fresh {r2['fresh']}")
    c1 = restore_checkpoint(r1["checkpoint"])["model"]
    c2 = restore_checkpoint(r2["checkpoint"])["model"]
    init = build_model(zoo.gs_faster_rcnn_r50_fpn_lvis(), partition=part).init_weights(0).state_dict()
    moved = sorted(n for n, t in c2.items() if not torch.equal(t, c1[n] if n not in fc_cls else init[n]))
    if moved != sorted(fc_cls):
        raise AssertionError(f"phase 2 moved {moved}")
    log(f"  phase 2: fresh {r2['fresh']}, moved only {moved}; launches {launches}")

    # resume phase 2 from its checkpoint: step 2, the optimizer's state restored
    ckpt2 = restore_checkpoint(r2["checkpoint"])
    restored = []
    load = TrainState.load_state_dict

    def load_and_compare(self, state):
        load(self, state)
        mine = self.optimizer.state_dict()["state"]
        saved = ckpt2["train"]["optimizer"]["state"]
        restored.append(len(saved) > 0 and all(
            torch.equal(mine[i]["momentum_buffer"].cpu(), saved[i]["momentum_buffer"]) for i in saved)
            and self.generator.device.type == "cuda"
            and torch.equal(self.generator.get_state(), ckpt2["train"]["generator"]))

    TrainState.load_state_dict = load_and_compare
    try:
        r3, _ = run_cli(train.main, [
            "--model", "gs_faster_rcnn_r50", *train_args, "--partition", part_path, "--selectp", "1",
            "--resume-from", r2["checkpoint"], "--work-dir", os.path.join(root, "w3"),
            "--max-steps", str(FLOW_PHASE2_STEPS + 1)])
    finally:
        TrainState.load_state_dict = load
    if restored != [True] or r3["start_step"] != FLOW_PHASE2_STEPS or r3["state"].step != FLOW_PHASE2_STEPS + 1:
        raise AssertionError(f"resume: restored {restored}, from step {r3['start_step']} to {r3['state'].step}")
    log(f"  resume: restarted at step {r3['start_step']} with the momentum of {FLOW_PHASE2_STEPS} steps and "
        f"the card's generator state, ended at {r3['state'].step}")
    del r1, r2, c1, c2, init, ckpt2

    # test, plain and tau-normalised, recording what the last batch (portrait) handed K1, K2 and K3
    n_batches = 4
    test_args = ["--model", "gs_faster_rcnn_r50", *common, "--partition", part_path, "--checkpoint", r3["checkpoint"]]
    numbers["checkpoint"] = r3["checkpoint"]
    del r3
    res = os.path.join(root, "results.json")
    seen, launches = counted(torch, lambda: capture_path(
        ("nms_keep_batched", "nms_keep_gathered"), lambda: run_cli(test_lvis.main, [*test_args, "--out", res])))
    out, text = seen["out"]
    expect_launches(launches, {"bags_nms_keep": 1, "bags_roi_align_forward": 1, "bags_nms_keep_gathered": 1},
                    n_batches, "test batches")
    boxes, valid, thr = seen["nms_keep_batched"][0]
    if not torch.equal(ops_nms.nms_keep_batched(boxes, valid, thr), ops_nms.nms_keep_reference(boxes, valid, thr)):
        raise AssertionError("K1 differs from its plain version on the test CLI's boxes")
    k3_matches(torch, ops_nms, *seen["nms_keep_gathered"][0][:4], "on the test CLI's portrait batch")
    feats, rois, strides, out_size = seen["batched_multilevel_roi_align"][0][:4]
    if feats[0].shape[1] <= feats[0].shape[2]:
        raise AssertionError(f"the test CLI's last batch is not portrait: {tuple(feats[0].shape)}")
    k2_matches(torch, ops_roi, feats, rois, strides, out_size, "on the test CLI's portrait batch")
    check_records(out["records"], ann)
    t = out["times"]
    numbers["test"] = dict(t, images=8)
    log(f"  test CLI: {len(out['records'])} records, launches {launches}; preprocess {t['preprocess']:.3f} s, "
        f"predict {t['predict']:.3f} s, records {t['records']:.3f} s, evaluate {t['evaluate']:.3f} s over 8 images "
        f"(first batch of each bucket included; {card_line()})")
    (tau_out, _), launches = counted(torch, lambda: run_cli(test_lvis.main, [*test_args, "--tau", "0.5", "--no-eval"]))
    expect_launches(launches, {"bags_nms_keep": 1, "bags_roi_align_forward": 1, "bags_nms_keep_gathered": 1},
                    n_batches, "tau test batches")
    check_records(tau_out["records"], ann)
    numbers["test_tau"] = dict(tau_out["times"], images=8)
    if tau_out["records"] == out["records"]:
        raise AssertionError("--tau 0.5 changed no record")

    ev, eval_text = run_cli(eval_lvis.main, ["--ann", ann, "--result", res])
    table = text[text.index("bbox results:"):]
    if eval_text.strip() != table.strip() or ev.results != out["evaluator"].results:
        raise AssertionError("the eval CLI's table differs from the test CLI's")
    log(f"  eval CLI: the same table as the test CLI's (AP {ev.results['AP']:.6f})")

    # Mask R-CNN: one train-CLI step with the gt crops, then the test CLI with masks on its checkpoint
    (rm, _), launches = counted(torch, lambda: run_cli(train.main, [
        "--model", "mask_rcnn_r50", *train_args, "--selectp", "0", "--work-dir", os.path.join(root, "wm"),
        "--max-steps", "1"]))
    expect_launches(launches, {"bags_nms_keep_tiled": 1, "bags_roi_align_forward": 2, "bags_roi_align_backward": 2},
                    1, "Mask R-CNN steps")
    if not (math.isfinite(rm["log"][-1]["loss_mask"]) and rm["log"][-1]["loss_mask"] > 0):
        raise AssertionError(f"the Mask R-CNN step's loss_mask: {rm['log'][-1]}")
    (mout, mtext), launches = counted(torch, lambda: run_cli(test_lvis.main, [
        "--model", "mask_rcnn_r50", *common, "--checkpoint", rm["checkpoint"]]))
    del rm
    expect_launches(launches, {"bags_nms_keep": 1, "bags_roi_align_forward": 2, "bags_nms_keep_gathered": 1},
                    n_batches, "Mask R-CNN test batches")
    check_records(mout["records"], ann)
    check_segmentations(mout["records"], ann)
    segm = mout["segm_evaluator"]
    if "segm results:" not in mtext or not all(math.isfinite(v) for v in segm.results.values()):
        raise AssertionError(f"the test CLI's segm table: {segm and segm.results}")
    t = mout["times"]
    numbers["test_masks"] = dict(t, images=8)
    log(f"  Mask R-CNN test CLI: {len(mout['records'])} records with masks, launches {launches}; preprocess "
        f"{t['preprocess']:.3f} s, predict {t['predict']:.3f} s, records {t['records']:.3f} s, masks {t['masks']:.3f} s "
        f"({t['masks'] / 8 * 1e3:.1f} ms an image), evaluate {t['evaluate']:.3f} s over 8 images; segm AP "
        f"{segm.results['AP']:.6f} ({card_line()})")
    del mout

    numbers["test_mask_scoring"] = run_mask_scoring_flow(torch, root, ann, common, train_args, n_batches)
    return numbers


ABLATION_ROWS = ("baseline", "tau=0.5", "tau=0.7", "tau=1.0", "tnorm-select=1.0", "gs (BAGS)", "rfs")
ABLATION_TRAIN_IMAGES = 120  # with the injected tail images, 132: a class in over 100 images, so APf is defined
ABLATION_VAL_IMAGES = 24
ABLATION_BATCH = 8
ABLATION_EPOCHS = 2
TNORM_TAUS = ("0.0", "1.0")
TNORM_MAX_ROIS = 64


def k2b_row(torch, ops_roi, grad, rois, shapes, strides, out_size, dtype, levels, name, label):
    """K2b held to its plain version on `grad` and `rois`, and timed: a
    kernels-line row named `name`."""
    err = k2b_matches(torch, ops_roi, grad, rois, shapes, strides, out_size, dtype, label, levels)
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    out_bytes = b * sum(h * w for h, w in shapes) * c * torch.empty((), dtype=dtype).element_size()
    b_ms, b_by = bound(grad.numel() * grad.element_size() + rois.numel() * 4 + out_bytes, grad.numel() * 4 * SAMPLE_OPS)
    return dict(
        name=name,
        route="cuda",
        source="balancedgroupsoftmax_torch/csrc/roi_align.cu",
        replaces="balancedgroupsoftmax_tpu/pallas/roi_align.py:569",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: ops_roi.roi_align_backward(grad, rois, shapes, strides, out_size, dtype=dtype,
                                                           levels=levels), 20),
        plain_ms=cuda_time_ms(lambda: ops_roi.multilevel_roi_align_backward_reference(
            grad, rois, shapes, strides, out_size, dtype=dtype), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"B={b} R={r} S={out_size} C={c} {grad.dtype}",
    )


def capture_with_backward(ops_roi, names, fn) -> dict:
    """`capture_path(names, fn)`, and what K2b (`ops_roi.roi_align_backward`)
    was last handed under "roi_align_backward"."""
    seen = {}
    seen.update(capture_calls(("roi_align_backward",), lambda: seen.update(capture_path(names, fn)), ops_roi))
    return seen


def run_ablation(torch, ops_nms, ops_roi, flow_root: str, flow_checkpoint: str) -> list:
    """The BAGS ablation matrix on the card: a long-tailed fixture
    (`tools.make_longtail`, 48 classes, seed 0) and its partition, then
    `tools.run_longtail_ablation.main` at 2 epochs, batch 8, bf16, 320 x 320,
    with each CLI it runs called through its `main(argv)` in this process
    and its launches counted: a training row launches K4 and K2 once a step
    and K2b once a step but at selectp 1 (the gs row), a test row K1 and K3
    once a batch and K2 once a batch, twice for tnorm-select, and nothing
    else. The baseline's training is held to the plain versions of K4, K2
    and K2b on its last step's inputs, and tnorm-select to those of K1, K2
    and K3 on its last batch's (the "/ablation-train" and "/tnorm-select"
    rows of the kernels line, each with its row's launches). Every one of
    the seven rows must be in ablation.json with values in [0, 100], the
    RFS row must upsample some image, and the GS checkpoint must differ from
    the baseline's in fc_cls alone. Then `test_lvis_tnorm --taus 0.0 1.0`
    on `run_flow`'s fixture and checkpoint (K2 once an image of the
    (800, 1344) bucket, whose boxes, at most 64 an image, the per-bin counts
    must sum to). Returns the kernels-line rows."""
    import importlib
    import math
    import os
    import re

    from balancedgroupsoftmax_torch.tools import gs_partition, make_longtail, run_longtail_ablation, test_lvis_tnorm
    from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint

    batches = -(-ABLATION_VAL_IMAGES // ABLATION_BATCH)
    rows, texts, walls = [], {}, {}

    def run_here(name, argv):
        """`tools.<name>.main(argv)` with its launches counted; returns what it printed."""
        tag = os.path.basename(argv[argv.index("--work-dir" if name == "train" else "--out") + 1])
        log(f"  + tools.{name} {tag}")
        main_fn = importlib.import_module(f"balancedgroupsoftmax_torch.tools.{name}").main
        t0 = time.perf_counter()
        seen, launches = counted(torch, lambda: capture_with_backward(
            ops_roi, ("nms_keep_tiled", "nms_keep_batched", "nms_keep_gathered"), lambda: run_cli(main_fn, argv)))
        walls[tag] = time.perf_counter() - t0
        _, texts[tag] = seen.pop("out")
        if name == "train":
            steps = int(run_longtail_ablation.TRAINED.search(texts[tag])[1])
            want = {"bags_nms_keep_tiled": steps, "bags_roi_align_forward": steps,
                    "bags_roi_align_backward": 0 if tag == "gs" else steps, "bags_nms_keep": 0,
                    "bags_nms_keep_gathered": 0}
        else:
            want = {"bags_nms_keep": batches, "bags_roi_align_forward": batches * (2 if "--tau-select" in argv else 1),
                    "bags_nms_keep_gathered": batches, "bags_nms_keep_tiled": 0, "bags_roi_align_backward": 0}
        wrong = {s: (launches[s], n) for s, n in want.items() if launches[s] != n}
        if wrong:
            raise AssertionError(f"tools.{name} {tag}: launches (counted, expected) {wrong}")
        log(f"    launches {launches}; wall {walls[tag]:.1f} s")
        if tag == "baseline":
            feats, rois, strides, out_size = seen["batched_multilevel_roi_align"][0][:4]
            (grad, rois_b, shapes, strides_b, size_b), kw = seen["roi_align_backward"][0][:5], seen["roi_align_backward"][1]
            new = [
                (check_k4(torch, ops_nms, *seen["nms_keep_tiled"][0]), "bags_nms_keep_tiled"),
                (k2_row(torch, ops_roi, [f.detach() for f in feats], rois, strides, out_size, "roi_align_forward",
                        "on the baseline's last training step"), "bags_roi_align_forward"),
                (k2b_row(torch, ops_roi, grad, rois_b, shapes, strides_b, size_b, kw["dtype"], kw["levels"],
                         "roi_align_backward", "on the baseline's last training step"), "bags_roi_align_backward"),
            ]
            suffix = "/ablation-train"
        elif "--tau-select" in argv:
            new = [
                (check_k1(torch, ops_nms, *seen["nms_keep_batched"][0], path="tau-select batch"), "bags_nms_keep"),
                (k2_row(torch, ops_roi, *seen["batched_multilevel_roi_align"][0][:4], "roi_align_forward",
                        "on the tau-select batch's second rescore"), "bags_roi_align_forward"),
                (check_k3(torch, ops_nms, *seen["nms_keep_gathered"][0][:4], path="tau-select batch"),
                 "bags_nms_keep_gathered"),
            ]
            suffix = "/tnorm-select"
        else:
            new = []
        for r, sym in new:
            r["name"] += suffix
            r["launches"] = launches[sym]
            rows.append(r)
        return texts[tag]

    with tempfile.TemporaryDirectory() as root:
        data, work = os.path.join(root, "synlt"), os.path.join(root, "ablation")
        run_cli(make_longtail.main, ["--out", data, "--train-images", str(ABLATION_TRAIN_IMAGES),
                                     "--val-images", str(ABLATION_VAL_IMAGES), "--seed", "0"])
        part, _ = run_cli(gs_partition.main, ["--ann", os.path.join(data, "train.json"), "--out",
                                              os.path.join(data, "part.npz"), "--num-classes", "49",
                                              "--thresholds", "8", "40", "200"])
        if min(part.bin_sizes[1:]) < 2:  # a bin's slice is its classes and "others"
            raise AssertionError(f"a GS bin of the fixture is empty: {part.bin_sizes}")

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        table = run_longtail_ablation.main(["--data", data, "--work-dir", work, "--epochs", str(ABLATION_EPOCHS),
                                            "--batch-size", str(ABLATION_BATCH), "--dtype", "bfloat16"], run_here)
        wall = time.perf_counter() - t0
        if tuple(table) != ABLATION_ROWS or not all(
                math.isfinite(v) and 0 <= v <= 100 for row in table.values() for v in row.values()):
            raise AssertionError(f"ablation.json: {table}")
        with open(os.path.join(work, "ablation.json")) as f:
            if json.load(f) != table:
                raise AssertionError("ablation.json differs from the rows run_longtail_ablation returned")
        upsampled = re.search(r"RFS t=\S+: (\d+)/(\d+) images upsampled", texts["rfs"])
        if upsampled is None or int(upsampled[1]) < 1:
            raise AssertionError("the rfs row upsampled no image")
        base = restore_checkpoint(os.path.join(work, "baseline", f"ckpt_epoch_{ABLATION_EPOCHS}.pt"))["model"]
        gs = restore_checkpoint(os.path.join(work, "gs", f"ckpt_epoch_{ABLATION_EPOCHS}.pt"))["model"]
        fc_cls = {"bbox_head.fc_cls.weight", "bbox_head.fc_cls.bias"}
        differ = sorted(n for n in gs if gs[n].shape != base[n].shape or not torch.equal(gs[n], base[n]))
        if gs.keys() != base.keys() or set(differ) != fc_cls or gs["bbox_head.fc_cls.bias"].shape != (49 + 5,):
            raise AssertionError(f"the gs checkpoint differs from the baseline's in {differ}")
        with open(os.path.join(work, "train_times.json")) as f:
            times = json.load(f)
        del base, gs
    log(f"  ablation: wall {wall:.1f} s, of which the CLIs {sum(walls.values()):.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in walls.items())}; the kernel checks and the evaluator the rest); "
        f"{upsampled[1]}/{upsampled[2]} images upsampled by RFS; gs differs from the baseline in {differ} alone; "
        f"train {json.dumps(times)}")
    log(f"  ablation table ({ABLATION_EPOCHS} epochs, {ABLATION_TRAIN_IMAGES} + injected train images): "
        f"{json.dumps(table)}")
    # the per-bin accuracy of ground-truth rois on run_flow's fixture
    t0 = time.perf_counter()
    ann = os.path.join(flow_root, "lvis", "ann.json")
    with open(ann) as f:
        gt = json.load(f)
    landscape = {i["id"] for i in gt["images"] if i["width"] >= i["height"]}
    boxes = sum(min(sum(a["image_id"] == i for a in gt["annotations"]), TNORM_MAX_ROIS) for i in landscape)
    seen, launches = counted(torch, lambda: capture_path((), lambda: run_cli(test_lvis_tnorm.main, [
        "--model", "gs_faster_rcnn_r50", "--ann", ann, "--img-prefix", os.path.join(flow_root, "lvis", "images"),
        "--checkpoint", flow_checkpoint, "--partition", os.path.join(flow_root, "part.npz"),
        "--taus", *TNORM_TAUS])))
    lines, _ = seen["out"]
    expect_launches(launches, {"bags_roi_align_forward": 1}, len(TNORM_TAUS) * len(landscape), "tnorm images")
    if [sum(l["counts"]) for l in lines] != [boxes] * len(TNORM_TAUS):
        raise AssertionError(f"tnorm counted {[l['counts'] for l in lines]}, not {boxes} boxes a tau")
    k2_matches(torch, ops_roi, *seen["batched_multilevel_roi_align"][0][:4], "on test_lvis_tnorm's last image")
    log(f"  test_lvis_tnorm: {len(landscape)} images of the (800, 1344) bucket, {boxes} boxes a tau, K2 "
        f"{launches['bags_roi_align_forward']} launches; wall {time.perf_counter() - t0:.1f} s")
    return rows


TTA_RAW = (600, 800)  # (h, w): 800 x 1067 in the 800 x 1344 bucket; at x1.25, 1000 x 1333 in 1024 x 1696
TTA_SCALE = 1.25


def tta_batch(seed: int, size=None, pcfg=None) -> dict:
    """MAIN_BATCH random RGB images of `size` (TTA_RAW) through the test
    pipeline, as the test CLI batches them for test-time augmentation (with
    "raw")."""
    import numpy as np

    from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig, preprocess_image
    from balancedgroupsoftmax_torch.tools.test_lvis import stack_batch

    rng = np.random.RandomState(seed)
    raws = [rng.randint(0, 255, (*(size or TTA_RAW), 3), np.uint8) for _ in range(MAIN_BATCH)]
    batch = stack_batch([preprocess_image(r, cfg=pcfg or PipelineConfig()) for r in raws])
    batch["raw"] = raws
    return batch


def timed_calls(torch, fn, each: dict, what: str):
    """A first call of `fn`, then TIMED_PREDICTS timed ones with the kernels'
    counts set to 0 just before and read just after; each kernel of `each`
    must have launched that many times a call. Returns (the last result, ms
    a call, first call s, launches, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, launches = counted(torch, lambda: [fn() for _ in range(TIMED_PREDICTS)][-1])
    ms = (time.perf_counter() - t0) / TIMED_PREDICTS * 1e3
    expect_launches(launches, each, TIMED_PREDICTS, what)
    return out, ms, first_s, launches, torch.cuda.max_memory_allocated() / 2**30


def exact_class_merge(boxes, scores, labels, valid, iou_thr: float = 0.5, max_out: int = 300) -> list:
    """The detection-level merge without JAX's f32 label offsets: each
    image's valid detections by descending score (ties by index), greedy NMS
    at `iou_thr` within each class on f64 boxes, the top `max_out` kept."""
    import numpy as np

    kept = []
    for bi in range(len(boxes)):
        idx = np.where(valid[bi])[0]
        order = idx[np.argsort(-scores[bi][idx], kind="stable")]
        b, lab = boxes[bi][order].astype(np.float64), labels[bi][order]
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        wh = np.clip(np.minimum(b[:, None, 2:], b[None, :, 2:]) - np.maximum(b[:, None, :2], b[None, :, :2]) + 1, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        sup = (inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-6) > iou_thr) & (lab[:, None] == lab[None, :])
        keep = np.ones(len(order), bool)
        for i in range(len(order)):
            if keep[i]:
                keep[i + 1:] &= ~sup[i, i + 1:]
        kept.append(order[keep][:max_out])
    return kept


def run_tta_path(torch, model):
    """Test-time augmentation of GS Faster R-CNN through the test CLI's
    `predict_aug` at full width, four views a batch (the base, x1.25, each
    flipped): `--aug-rescore` (K1 once a view and once for the proposal
    merge, K2 once a view, K3 once) and the detection-level flow (a predict
    a view, K1 once more for the merge of all views' detections). K1 is held
    to its plain version, and timed, on each merge's rows as the flow handed
    them, and on tie boxes at those row lengths; the detection-level merge's
    kept detections are counted against an exact per-class merge (JAX's f32
    label offsets, ROADMAP C). Returns the two K1 rows."""
    from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig
    from balancedgroupsoftmax_torch.ops import nms as ops_nms
    from balancedgroupsoftmax_torch.tools import test_lvis

    pcfg = PipelineConfig()
    batch = tta_batch(6)
    views = 4
    rows = []
    for name, aug, each, merge_k in (
        ("aug-rescore", test_lvis.Aug(True, (TTA_SCALE,), True),
         {"bags_nms_keep": views + 1, "bags_roi_align_forward": views, "bags_nms_keep_gathered": 1}, views * 1000),
        ("detection-level", test_lvis.Aug(True, (TTA_SCALE,)),
         {"bags_nms_keep": views + 1, "bags_roi_align_forward": views, "bags_nms_keep_gathered": views}, views * 300),
    ):
        fn = lambda aug=aug: test_lvis.predict_aug(model, batch, pcfg, aug)
        dets, ms, first_s, launches, peak = timed_calls(torch, fn, each, f"{name} batches")
        check_detections(torch, dets, model.cfg.bbox_head.num_classes, TTA_RAW)
        log(f"  {name}, {views} views (base, x{TTA_SCALE}, each flipped): first batch {first_s:.2f} s, then {ms:.3f} ms "
            f"a batch of {MAIN_BATCH}, {MAIN_BATCH / ms * 1e3:.2f} images/s, peak memory {peak:.2f} GiB "
            f"({card_line()}); {int(dets.valid.sum())} detections; launches over {TIMED_PREDICTS} batches {launches}")
        profile_device(torch, f"{name} batch", fn)
        seen = capture_calls(("nms_keep_batched",), fn, module=ops_nms)
        boxes, valid, thr = seen["nms_keep_batched"][0]
        if boxes.shape[1] != merge_k:
            raise AssertionError(f"the {name} merge took rows of {boxes.shape[1]} boxes, not {merge_k}")
        row = check_k1(torch, ops_nms, boxes, valid, thr, path=f"{name} merge")
        row.update(name=f"nms_keep/tta-{name}", launches=launches["bags_nms_keep"])
        log(f"  K1 on the {name} merge's rows ({row['shape']}): equal to the plain version, kernel {row['ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms, plain {row['plain_ms']:.3f} ms")
        rows.append(row)
        gen = torch.Generator().manual_seed(merge_k)
        tb, tv = tie_boxes(gen, MAIN_BATCH, merge_k, thr, boxes.device)
        if not torch.equal(ops_nms.nms_keep_batched(tb, tv, thr), ops_nms.nms_keep_reference(tb, tv, thr)):
            raise AssertionError(f"K1 on tie boxes at K={merge_k} differs from the plain version")
        log(f"  K1 ties G={MAIN_BATCH} K={merge_k}: keep equal to the plain version")
        if not aug.rescore:
            # JAX's f32 label offsets (ROADMAP C): the merge's kept detections against an exact per-class merge
            merged = capture_calls(("merge_aug_detections",), fn, module=test_lvis)["merge_aug_detections"][0]
            got = test_lvis.merge_aug_detections(*merged)
            exact = exact_class_merge(*merged[:4])
            moved = sum(len(set(g.tolist()) ^ set(e.tolist())) for g, e in zip(got, exact))
            log(f"  the f32 label offsets move {moved} of {sum(len(g) for g in got)} merged detections against an "
                f"exact per-class merge (labels up to {int(merged[2].max())})")
    return rows


def compare_small_tta(torch, model) -> None:
    """Both flows of `run_tta_path` on f32 copies of the model, two 192 x
    256 images at a scale of (384, 256) and x1.25, each flipped: the card
    (kernels) against the CPU (plain versions), by `detections_agree`."""
    from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.tools import test_lvis

    dev = next(model.parameters()).device
    cpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    gpu_model = build_model(model.cfg, model.partition, torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev)
    pcfg = PipelineConfig(scale=(384, 256))
    batch = tta_batch(9, (192, 256), pcfg)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, aug in (("aug-rescore", test_lvis.Aug(True, (TTA_SCALE,), True)),
                          ("detection-level", test_lvis.Aug(True, (TTA_SCALE,)))):
            g = [t.cpu() for t in test_lvis.predict_aug(gpu_model, batch, pcfg, aug)]
            detections_agree(torch, g, test_lvis.predict_aug(cpu_model, batch, pcfg, aug), f"small f32 {name}")
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def run_soft_nms_path(torch, model) -> None:
    """`predict` with rcnn_test.nms_type "soft_nms": K1 and K2 once a call
    and no K3 (soft-NMS is plain PyTorch, as JAX runs it as XLA), well-formed
    detections; its time beside the hard-NMS predict's, in turns, and the
    multiclass NMS alone both ways on the inputs one predict gave it, with
    the device kernels of the soft one; a profiled soft-NMS predict."""
    import dataclasses

    from balancedgroupsoftmax_torch import kernels
    from balancedgroupsoftmax_torch.models import detector

    hard = model.cfg
    soft = dataclasses.replace(hard, rcnn_test=dataclasses.replace(hard.rcnn_test, nms_type="soft_nms"))
    gen = torch.Generator().manual_seed(4)
    dev = next(model.parameters()).device
    inputs = (torch.randn(MAIN_BATCH, *MAIN_SIZE, 3, generator=gen).to(dev),
              torch.tensor([MAIN_SIZE] * MAIN_BATCH, dtype=torch.float32, device=dev), torch.ones(MAIN_BATCH, device=dev))
    try:
        model.cfg = soft
        dets, ms, first_s, launches, peak = timed_calls(
            torch, lambda: model.predict(*inputs),
            {"bags_nms_keep": 1, "bags_roi_align_forward": 1, "bags_nms_keep_gathered": 0}, "soft-NMS predicts")
        check_detections(torch, dets, hard.bbox_head.num_classes, MAIN_SIZE)
        seen = capture_calls(("batched_multiclass_nms",), lambda: model.predict(*inputs), module=detector)
        args, kw = seen["batched_multiclass_nms"]
        soft_nms_call = lambda: kernels.batched_multiclass_nms(*args, **kw)
        launched = kernels_per_call(torch, soft_nms_call)
        profile_device(torch, "soft-NMS predict", lambda: model.predict(*inputs), top=6)
    finally:
        model.cfg = hard

    def predict_as(cfg):
        model.cfg = cfg
        try:
            model.predict(*inputs)
        finally:
            model.cfg = hard

    hard_ms, soft_ms = interleaved_ms([lambda: predict_as(hard), lambda: predict_as(soft)], 2, 3)
    hard_nms = lambda: kernels.batched_multiclass_nms(*args, **dict(kw, nms_type="nms"))
    nms_ms = interleaved_ms([hard_nms, soft_nms_call], 3, 3)
    log(f"  soft-NMS predict: first {first_s:.2f} s, then {ms:.3f} ms a batch of {MAIN_BATCH}, peak memory {peak:.2f} "
        f"GiB; {int(dets.valid.sum())} detections, top score {dets.scores[0, 0].item():.6f}; launches over "
        f"{TIMED_PREDICTS} predicts {launches} ({card_line()})")
    log(f"  in turns: hard-NMS predict {hard_ms:.3f} ms, soft-NMS predict {soft_ms:.3f} ms; the multiclass NMS alone: "
        f"hard (K3) {nms_ms[0]:.3f} ms, soft {nms_ms[1]:.3f} ms, {launched} device kernels (profiler) over "
        f"{args[1].shape[0]} x {args[5]} rows (the class cap) of {kw['candidates_per_class']} candidates")


def run_cascade_x101_path(torch, dev, phase2) -> dict:
    """BAGS Cascade X101-64x4d (cascade_rcnn_x101_64x4d_fpn_lvis(use_gs=True):
    1231 classes, bf16, seeded weights) through `build_model`: predicts at
    the main shape (K1 once, K2 once a stage, K6 and K5 once, K3 never), a
    profiled one, K1, K5 and K6 held to their plain versions on what one
    more predict gave them; then `run_train_path` (selectp 0, then the
    phase-2 recipe `phase2`, selectp 3). Returns the predicts' launches."""
    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.ops import gather as ops_gather
    from balancedgroupsoftmax_torch.ops import nms as ops_nms

    t0 = time.perf_counter()
    cfg = zoo.cascade_rcnn_x101_64x4d_fpn_lvis(use_gs=True)
    model = build_model(cfg, synthetic_partition(cfg.bbox_head.num_classes), torch.bfloat16).init_weights(0).to(dev).eval()
    log(f"  Cascade X101-64x4d built on the card in {time.perf_counter() - t0:.1f} s")
    stages = len(model.bbox_heads)
    launches, inputs = run_predicts(
        torch, model,
        {"bags_nms_keep": 1, "bags_roi_align_forward": stages, "bags_gather_lanes": 1,
         "bags_nms_keep_coords": 1, "bags_nms_keep_gathered": 0},
    )
    profile_device(torch, "Cascade X101 predict", lambda: model.predict(*inputs))
    seen = capture_calls(("nms_keep_batched", "gather_lanes", "nms_keep_batched_coords"), lambda: model.predict(*inputs))
    k1 = check_k1(torch, ops_nms, *seen["nms_keep_batched"][0], path="Cascade X101")
    (coords, valid, thr), _ = seen["nms_keep_batched_coords"]
    k5 = check_k5(torch, ops_nms, coords, valid, thr, path="Cascade X101")
    (rows, idx), kw6 = seen["gather_lanes"]
    k6_matches(torch, ops_gather, rows, idx, kw6["groups_per_plane"], "Cascade X101's candidates")
    log(f"  Cascade X101: K1 ({k1['shape']}) and K5 ({k5['shape']}) equal to their plain versions, K6 bit-equal; "
        f"K1 {k1['ms']:.4f} ms, K5 {k5['ms']:.4f} ms")
    run_train_path(torch, model, phase2)
    return launches


LOSS_BASELINES = (  # (label, zoo constructor, GS head, selectp)
    ("focal", "faster_rcnn_r50_fpn_focal_lvis", False, 0),
    ("focal", "faster_rcnn_r50_fpn_focal_lvis", False, 1),
    ("re-weight", "faster_rcnn_r50_fpn_reweight_lvis", False, 1),
    ("GS-reweight", "gs_faster_rcnn_r50_fpn_lvis", True, 1),
)


def run_loss_baselines(torch, dev) -> None:
    """The long-tail loss baselines on Faster R-CNN R50 (bf16, batch 2 at 800
    x 1344, 20 gt boxes an image): a first and a timed step each of the
    focal head at selectp 0 and 1, the re-weight head and GS-reweight at
    selectp 1, the class weights `class_weights_from_counts` of seeded
    long-tailed counts; K4 and K2 once a step, K2b once at selectp 0 and
    never at 1, where fc_cls alone moves; then each one's small f32 step on
    the card against the CPU, losses and gradients."""
    import dataclasses

    import numpy as np

    from balancedgroupsoftmax_torch import zoo
    from balancedgroupsoftmax_torch.config import TrainConfig
    from balancedgroupsoftmax_torch.gs.partition import class_weights_from_counts, synthetic_partition
    from balancedgroupsoftmax_torch.models.detector import build_model
    from balancedgroupsoftmax_torch.parallel.train import create_train_state, make_train_step

    counts = (10 ** np.random.RandomState(3).uniform(0, 4, 1231)).astype(np.int64)
    weights = class_weights_from_counts(counts)
    partition = synthetic_partition(1231)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(8, partition).items()}
    for label, name, use_gs, selectp in LOSS_BASELINES:
        cfg = getattr(zoo, name)()
        if use_gs:
            cfg = dataclasses.replace(cfg, bbox_head=dataclasses.replace(cfg.bbox_head, loss_cls_type="reweight"))
        model = build_model(cfg, partition if use_gs else None, torch.bfloat16, class_weights=weights)
        model = model.init_weights(0).to(dev)
        named = dict(model.named_parameters())
        before = {n: p.detach().clone() for n, p in named.items()}
        step = make_train_step(create_train_state(model, TrainConfig(selectp=selectp)))
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        took = []

        def two_steps():  # a first step, then a timed one
            for _ in range(2):
                t0 = time.perf_counter()
                out = step(batch, gen)
                torch.cuda.synchronize()
                took.append((time.perf_counter() - t0) * 1e3)
            return out

        metrics, launches = counted(torch, two_steps)
        expect_launches(launches, {"bags_nms_keep_tiled": 1, "bags_roi_align_forward": 1,
                                   "bags_roi_align_backward": int(selectp == 0)}, 2, f"{label} steps")
        moved = sorted(n for n, p in named.items() if not torch.equal(p.detach(), before[n]))
        if not all(torch.isfinite(v).item() for v in metrics.values()):
            raise AssertionError(f"{label}: a loss is not finite: {metrics}")
        if selectp == 1 and moved != ["bbox_head.fc_cls.bias", "bbox_head.fc_cls.weight"]:
            raise AssertionError(f"{label} selectp=1 moved {moved}")
        if selectp == 0 and not any(n.startswith("backbone.") for n in moved):
            raise AssertionError(f"{label} selectp=0 did not move the backbone")
        cls = {k: round(v.item(), 5) for k, v in metrics.items() if k.startswith("loss_cls")}
        log(f"  {label} selectp={selectp}: first step {took[0]:.3f} ms, then {took[1]:.3f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card_line()}); {len(moved)} tensors moved; {cls}")
        compare_small_train(torch, model, selectp=selectp)
        del step, model


def run_htc_tta(torch, model) -> None:
    """`--aug-rescore` over the base view and its flip on the serving
    HTC-DCN, then `predict_masks` on the merged boxes (JAX
    tools/test_lvis.py:579-585): each view's backbone twice (its proposals,
    then its rescore) and once more for the masks, so K7 30 x 5 times a
    batch, K1 3 times (two views and the merge), K2 6 a view (three stages
    over the FPN and the semantic feature) and 2 for the masks, K6 and K5
    once, K3 never; finite detections and masks in [0, 1]."""
    from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig
    from balancedgroupsoftmax_torch.tools import test_lvis

    pcfg = PipelineConfig()
    batch = tta_batch(7)
    dev = next(model.parameters()).device
    images, sfs = (torch.from_numpy(batch[k]).to(dev) for k in ("image", "scale_factor"))
    aug = test_lvis.Aug(flip=True, rescore=True)

    def call():
        dets = test_lvis.predict_aug(model, batch, pcfg, aug)
        return dets, model.predict_masks(images, dets.boxes, dets.labels, sfs)

    views = 2
    (dets, masks), ms, first_s, launches, peak = timed_calls(
        torch, call,
        {"bags_deform_conv_forward": 30 * (2 * views + 1), "bags_nms_keep": views + 1,
         "bags_roi_align_forward": 6 * views + 2, "bags_gather_lanes": 1, "bags_nms_keep_coords": 1,
         "bags_nms_keep_gathered": 0},
        "HTC-DCN aug-rescore batches",
    )
    check_detections(torch, dets, model.cfg.bbox_head.num_classes, TTA_RAW)
    m = masks[dets.valid].float()
    if masks.shape[:2] != dets.scores.shape or not (torch.isfinite(m).all() and (m >= 0).all() and (m <= 1).all()):
        raise AssertionError("HTC-DCN TTA masks are not finite probabilities of each detection")
    log(f"  HTC-DCN aug-rescore, base and flip, masks on the merged boxes: first batch {first_s:.2f} s, then "
        f"{ms:.3f} ms a batch of {MAIN_BATCH}, peak memory {peak:.2f} GiB ({card_line()}); "
        f"{int(dets.valid.sum())} detections; launches over {TIMED_PREDICTS} batches {launches}")



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
        check_k2(torch, ops_roi, dev),
        check_k2b(torch, ops_roi, dev),
    ]
    check_k1_ties(torch, ops_nms, dev)
    check_k3_ties(torch, ops_nms, dev)
    check_k4_ties(torch, ops_nms, dev)
    check_k5_ties(torch, ops_nms, dev)
    check_k6_ties(torch, ops_gather, dev)
    check_k7_edges(torch, ops_dcn, dev)
    for r in rows:
        log_row(r)
    log(f"phase kernels vs plain: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, model, main_rows = run_main_path(torch, bgs, dev)
    for r in main_rows:
        log_row(r)
    rows += main_rows
    log(f"phase main path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small(torch, model)
    log(f"phase small-input card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tta_rows = run_tta_path(torch, model)
    rows += tta_rows
    log(f"phase test-time augmentation (GS Faster R-CNN): wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_tta(torch, model)
    log(f"phase small test-time augmentation card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_soft_nms_path(torch, model)
    log(f"phase soft-NMS predict: wall {time.perf_counter() - t0:.1f} s")
    del model

    t0 = time.perf_counter()
    train_model = bgs.init_detector("gs_faster_rcnn_r50", dtype=torch.bfloat16, device=dev, seed=0).model
    trained = run_train_path(torch, train_model, TRAIN_CONFIGS["gs_faster_rcnn_r50_fpn_lvis"])
    train_launches, train_ms = trained["launches"], trained["ms"]
    k4_row = check_k4(torch, ops_nms, *trained.pop("k4_inputs"))
    log_row(k4_row)
    rows.append(k4_row)
    log(f"phase training path: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_train(torch, train_model)
    log(f"phase small training step card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del train_model

    t0 = time.perf_counter()
    run_loss_baselines(torch, dev)
    log(f"phase loss baselines (focal, re-weight, GS-reweight): wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fused_launches, fused_rows = run_fused_path(torch, dev)
    for r in fused_rows:
        log_row(r)
    rows += fused_rows
    log(f"phase fused bottlenecks (K8, K9): wall {time.perf_counter() - t0:.1f} s")

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
    run_cascade_x101_path(torch, dev, TRAIN_CONFIGS["gs_cascade_rcnn_x101_64x4d_fpn_lvis"])
    log(f"phase GS Cascade X101-64x4d serving and training: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    htc_launches, htc, htc_row = run_htc_path(torch, dev)
    log_row(htc_row)
    rows.append(htc_row)
    log(f"phase HTC-DCN serving: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_htc(torch, htc)
    log(f"phase small HTC-DCN predict_with_masks card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_htc_tta(torch, htc)
    log(f"phase HTC-DCN test-time augmentation with masks: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    htc_train_launches, k7b_row, _, _ = run_htc_train_path(torch, htc)
    log_row(k7b_row)
    rows.append(k7b_row)
    log(f"phase HTC-DCN training: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_mask_train(torch, htc, "HTC-DCN")
    log(f"phase small HTC-DCN train step card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del htc

    t0 = time.perf_counter()
    mask_rcnn, k2_mask_row = run_mask_rcnn_path(torch, bgs, ops_roi, dev)
    log_row(k2_mask_row)
    rows.append(k2_mask_row)
    log(f"phase Mask R-CNN serving: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_mask_rcnn(torch, mask_rcnn)
    log(f"phase small Mask R-CNN predict_with_masks card vs CPU: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    k2b_mask_row = run_mask_rcnn_train(torch, bgs, ops_roi, dev)["row"]
    log_row(k2b_mask_row)
    rows.append(k2b_mask_row)
    log(f"phase Mask R-CNN training: wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compare_small_mask_train(torch, mask_rcnn, "Mask R-CNN")
    log(f"phase small Mask R-CNN train step card vs CPU: wall {time.perf_counter() - t0:.1f} s")
    del mask_rcnn

    for kind in ("grid", "double_head", "mask_scoring", "fast"):
        t0 = time.perf_counter()
        variant_rows = run_variant_path(torch, ops_roi, dev, kind)
        for r in variant_rows:
            log_row(r)
        rows += variant_rows
        log(f"phase {VARIANT_LABELS[kind]} serving and training: wall {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as flow_root:
        t0 = time.perf_counter()
        flow = run_flow(torch, ops_nms, ops_roi, train_ms, flow_root)
        flow_checkpoint = flow.pop("checkpoint")
        log(f"  flow numbers: {json.dumps(flow)}")
        log(f"phase BAGS recipe through the CLIs: wall {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        ablation_rows = run_ablation(torch, ops_nms, ops_roi, flow_root, flow_checkpoint)
        for r in ablation_rows:
            log_row(r)
        rows += ablation_rows
        log(f"phase BAGS ablation: wall {time.perf_counter() - t0:.1f} s")

    # each kernel's launches on the path that runs it: the Faster R-CNN
    # predicts for K1-K3, its selectp=0 training steps for K4 and K2b, the
    # cascade's predicts for K5 and K6, the HTC's for K7, its selectp=0
    # training steps for K7b, one pass of the
    # R50's stride-1 runs for K8 and K9; the "/mask-rcnn", "/grid" and
    # "/double-head" rows carry their models' predicts' and selectp=0
    # steps' counts, the "/ablation-train"
    # and "/tnorm-select" rows their ablation rows' counts, the "/tta-*"
    # rows the K1 launches of their flows' timed batches
    symbols = {
        "nms_keep": (launches, "bags_nms_keep"),
        "roi_align_forward": (launches, "bags_roi_align_forward"),
        "nms_keep_gathered": (launches, "bags_nms_keep_gathered"),
        "nms_keep_tiled": (train_launches, "bags_nms_keep_tiled"),
        "roi_align_backward": (train_launches, "bags_roi_align_backward"),
        "nms_keep_batched_coords": (cascade_launches, "bags_nms_keep_coords"),
        "gather_lanes": (cascade_launches, "bags_gather_lanes"),
        "deform_conv_forward": (htc_launches, "bags_deform_conv_forward"),
        "deform_conv_backward": (htc_train_launches, "bags_deform_conv_backward"),
        "fused_bottleneck": (fused_launches, "bags_fused_bottleneck"),
        "fused_layer": (fused_launches, "bags_fused_layer"),
    }
    for r in rows:
        if "launches" not in r:  # the Mask R-CNN, ablation and TTA rows carry their own counts
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
