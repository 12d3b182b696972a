"""Run a detector over an LVIS annotation file's images, write the result
records and score them with the federated evaluator (JAX tools/test_lvis.py
:27-688, its plain path).

    python -m balancedgroupsoftmax_torch.tools.test_lvis --model gs_faster_rcnn_r50 \
        --ann ANN --img-prefix IMAGES --partition PART.npz \
        --checkpoint WORK/ckpt_epoch_12.pt --out results.json [--tau 0.5]

Images are preprocessed in order and batched per bucket; a bucket's last
batch is filled up by repeating its last image, whose detections are
dropped. `--tau` tau-normalises the classifier first (`apis.tau_norm`).
`--tau-select TAU` runs tau-norm-select (JAX :192-256): a copy of the
classifier, tau-normalised with TAU but for its background row, rescores the
same proposals, and takes a RoI's score row where its class has fewer than
`--tail-threshold` training instances (`models/dual_head.py`). A model with
a mask head (Mask R-CNN, HTC) serves with `predict_with_masks`, one backbone
pass, or, behind `--tau-select`, runs `predict_masks` on the final boxes
(JAX :576-607); each valid detection's mask is pasted at the original size
and RLE-encoded into its record's "segmentation". It prints the time split
into preprocessing, prediction (with the copies to and from the card),
records, masks (paste and encode) and evaluation, then the evaluator's bbox
table and, for a mask model, its segm table. It runs on the card unless
`--device cpu` is given.

Not ported here: test-time augmentation (`--flip-aug`, `--aug-scales`,
`--aug-rescore`, ROADMAP A5) and `--distributed` (A6).
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..apis import MODELS, resolve_device, tau_norm
from ..data.lvis import LvisDataset
from ..data.pipeline import PipelineConfig, preprocess_image_file
from ..eval.lvis_eval import LvisEvaluator
from ..eval.results import add_segmentations, detections_to_records, write_results_json
from ..gs.partition import load_partition
from ..models.detector import Detections, FasterRCNN, build_model
from ..models.dual_head import tail_class_mask_from_counts, update_scores_with_reweight
from ..utils.checkpoint import restore_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="faster_rcnn_r50", choices=sorted(MODELS))
    p.add_argument("--ann", required=True)
    p.add_argument("--img-prefix", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--partition", default=None)
    p.add_argument("--out", default=None, help="write the result records here (json)")
    p.add_argument("--tau", type=float, default=None, help="tau-normalise fc_cls rows by 1 / ||w||^tau")
    p.add_argument("--tau-select", type=float, default=None,
                   help="tau-norm-select: score with fc_cls and a copy tau-normalised by this tau (background row "
                        "kept), and take a RoI's row from the copy where its class is a tail class")
    p.add_argument("--tail-threshold", type=int, default=100,
                   help="tau-select's tail classes: fewer training instances than this (instance_count)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32", help="compute dtype")
    p.add_argument("--scale", type=int, nargs=2, default=None, metavar=("LONG", "SHORT"),
                   help="keep-ratio resize target (1333 800); the one the checkpoint was trained at")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--limit", type=int, default=None, help="only the first N images")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def bucket_batches(
    ds: LvisDataset, pcfg: PipelineConfig, batch_size: int, n: int, times: Dict[str, float]
) -> Iterator[Tuple[List[int], Dict[str, np.ndarray]]]:
    """The first `n` images, preprocessed in order and grouped by bucket:
    yields (indices, batch) as each bucket fills a batch, then each bucket's
    rest, filled up by repeating its last sample (`indices` names only the
    real ones). Adds the preprocessing time to times["preprocess"]."""
    pending: Dict[tuple, list] = {b: [] for b in sorted(set(pcfg.buckets()))}

    def flush(bucket):
        buf = pending[bucket]
        samples = [s for _, s in buf] + [buf[-1][1]] * (batch_size - len(buf))
        pending[bucket] = []
        batch = {k: np.stack([s[k] for s in samples]) for k in ("image", "img_shape", "scale_factor")}
        return [i for i, _ in buf], batch

    for idx in range(n):
        t0 = time.perf_counter()
        s = preprocess_image_file(ds.image_path(idx), cfg=pcfg)
        times["preprocess"] += time.perf_counter() - t0
        pending[s["bucket"]].append((idx, s))
        if len(pending[s["bucket"]]) == batch_size:
            yield flush(s["bucket"])
    for bucket in list(pending):
        if pending[bucket]:
            yield flush(bucket)


@torch.inference_mode()
def predict_tau_select(
    model: FasterRCNN, back_cls: torch.nn.Linear, tail_mask: torch.Tensor,
    images: torch.Tensor, img_shapes: torch.Tensor, scale_factors: torch.Tensor,
) -> Detections:
    """One batch of tau-norm-select: `propose` (K1), `rescore` with the
    model's fc_cls and again with `back_cls` (K2 each), each image's rows
    chosen by `update_scores_with_reweight`, the boxes rescaled, then the
    multiclass NMS (K3)."""
    proposals = model.propose(images, img_shapes)
    boxes, scores_main = model.rescore(images, proposals.boxes, img_shapes)
    main_cls, model.bbox_head.fc_cls = model.bbox_head.fc_cls, back_cls
    try:
        _, scores_back = model.rescore(images, proposals.boxes, img_shapes)
    finally:
        model.bbox_head.fc_cls = main_cls
    scores = update_scores_with_reweight(scores_main, scores_back, tail_mask)
    return model._multiclass_nms(boxes / scale_factors.float()[:, None, None], scores, proposals.valid)


def infer_dataset(
    model, ds: LvisDataset, pcfg: PipelineConfig, batch_size: int, limit: Optional[int] = None,
    predict: Optional[Callable[..., Detections]] = None,
) -> Tuple[List[dict], Dict[str, float]]:
    """`predict` (`model.predict` by default) over the dataset's first
    `limit` images (all by default) on the model's device -> (result
    records, seconds spent in "preprocess", "predict" and "records"). A
    model with a mask head serves with `predict_with_masks` (or runs
    `predict_masks` on what `predict` found), its records carry their
    "segmentation", and the seconds pasting and encoding them are under
    "masks"."""
    device = next(model.parameters()).device
    with_masks = model.cfg.mask_head is not None
    n = min(len(ds), limit or len(ds))
    times = dict(preprocess=0.0, predict=0.0, records=0.0, **(dict(masks=0.0) if with_masks else {}))
    records: List[dict] = []
    for idxs, batch in bucket_batches(ds, pcfg, batch_size, n, times):
        t0 = time.perf_counter()
        images, shapes, sfs = (torch.from_numpy(batch[k]).to(device) for k in ("image", "img_shape", "scale_factor"))
        masks = None
        if with_masks and predict is None:
            dets, masks = model.predict_with_masks(images, shapes, sfs)
        else:
            dets = (predict or model.predict)(images, shapes, sfs)
            if with_masks:
                masks = model.predict_masks(images, dets.boxes, dets.labels, sfs)
        boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
        if masks is not None:
            masks = masks.float().cpu().numpy()  # cv2 takes f32, not bf16
        times["predict"] += time.perf_counter() - t0
        for bi, idx in enumerate(idxs):
            t1 = time.perf_counter()
            info = ds.img_infos[idx]
            recs = detections_to_records(info["id"], boxes[bi], scores[bi], labels[bi], valid[bi], ds.cat_ids)
            t2 = time.perf_counter()
            times["records"] += t2 - t1
            if masks is not None:
                add_segmentations(recs, masks[bi], boxes[bi], valid[bi], info["height"], info["width"])
                times["masks"] += time.perf_counter() - t2
            records += recs
    return records, times


def evaluate(ann: str, records: List[dict], img_ids=None, iou_type: str = "bbox") -> LvisEvaluator:
    """The evaluator run over `records` (their boxes, or with iou_type "segm"
    their masks); with `img_ids`, over those images' ground truth alone."""
    with open(ann) as f:
        gt = json.load(f)
    if img_ids is not None:
        keep = set(img_ids)
        gt["images"] = [i for i in gt["images"] if i["id"] in keep]
        gt["annotations"] = [a for a in gt["annotations"] if a["image_id"] in keep]
    ev = LvisEvaluator(gt, records, iou_type=iou_type)
    ev.run()
    return ev


def main(argv=None) -> dict:
    """Returns the records, the evaluator (None with --no-eval), the segm
    evaluator (None but for a mask model) and the times in seconds."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    builder, _ = MODELS[args.model]
    ds = LvisDataset(args.ann, args.img_prefix, test_mode=True)
    num_classes = len(ds.cat_ids) + 1
    det_cfg = builder(num_classes=num_classes)
    partition = load_partition(args.partition) if args.partition else None
    if partition is not None and partition.num_classes != num_classes:
        raise ValueError(f"partition has {partition.num_classes} classes, dataset {num_classes}")
    pcfg = PipelineConfig() if args.scale is None else PipelineConfig(scale=tuple(args.scale))

    model = build_model(det_cfg, partition=partition, dtype=getattr(torch, args.dtype))
    model.load_state_dict(restore_checkpoint(args.checkpoint)["model"])
    if args.tau is not None:
        tau_norm(model.bbox_head.fc_cls, args.tau)
    model.to(device).eval()
    predict = None
    if args.tau_select is not None:
        if not hasattr(model, "bbox_head"):
            raise SystemExit(f"--tau-select needs a Faster R-CNN model, not {args.model}")
        # tau_norm works in place: the copy alone is normalised
        back_cls = copy.deepcopy(model.bbox_head.fc_cls)
        tau_norm(back_cls, args.tau_select, skip_bg=True)
        tail = tail_class_mask_from_counts(ds.instance_counts(), args.tail_threshold)
        print(f"tau-select tau={args.tau_select}: {int(tail.sum())}/{num_classes - 1} tail classes "
              f"(< {args.tail_threshold} instances)")
        tail_mask = torch.from_numpy(tail).to(device)
        predict = functools.partial(predict_tau_select, model, back_cls, tail_mask)

    n = min(len(ds), args.limit or len(ds))
    t0 = time.perf_counter()
    records, times = infer_dataset(model, ds, pcfg, args.batch_size, n, predict)
    wall = time.perf_counter() - t0
    masks = f", masks {times['masks']:.3f} s" if "masks" in times else ""
    print(f"inference done: {n} images in {wall:.3f} s ({n / wall:.3f} img/s): preprocess "
          f"{times['preprocess']:.3f} s, predict {times['predict']:.3f} s, records {times['records']:.3f} s{masks}")
    if args.out:
        write_results_json(records, args.out)
        print(f"wrote {len(records)} detections to {args.out}")
    ev = ev_segm = None
    if not args.no_eval:
        img_ids = [ds.img_infos[i]["id"] for i in range(n)] if args.limit else None
        t0 = time.perf_counter()
        ev = evaluate(args.ann, records, img_ids)
        if det_cfg.mask_head is not None:
            ev_segm = evaluate(args.ann, records, img_ids, "segm")
        times["evaluate"] = time.perf_counter() - t0
        print(f"evaluate {times['evaluate']:.3f} s")
        print("bbox results:")
        ev.print_results()
        if ev_segm is not None:
            print("segm results:")
            ev_segm.print_results()
    return dict(records=records, evaluator=ev, segm_evaluator=ev_segm, times=times)


if __name__ == "__main__":
    main()
