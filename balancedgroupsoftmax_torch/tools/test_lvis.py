"""Run a detector over an LVIS annotation file's images, write the result
records and score them with the federated evaluator (JAX tools/test_lvis.py
:27-688, its plain path).

    python -m balancedgroupsoftmax_torch.tools.test_lvis --model gs_faster_rcnn_r50 \
        --ann ANN --img-prefix IMAGES --partition PART.npz \
        --checkpoint WORK/ckpt_epoch_12.pt --out results.json [--tau 0.5]

Images are preprocessed in order and batched per bucket; a bucket's last
batch is filled up by repeating its last image, whose detections are
dropped. `--tau` tau-normalises the classifier first (`apis.tau_norm`). It
prints the time split into preprocessing, prediction (with the copies to
and from the card) and evaluation, then the evaluator's table. It runs on the
card unless `--device cpu` is given.

Not ported here: test-time augmentation (`--flip-aug`, `--aug-scales`,
`--aug-rescore`, ROADMAP A5), `--tau-select` and the dual head (A7),
`--distributed` (A6), and mask results (A4).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..apis import MODELS, resolve_device, tau_norm
from ..data.lvis import LvisDataset
from ..data.pipeline import PipelineConfig, preprocess_image_file
from ..eval.lvis_eval import LvisEvaluator
from ..eval.results import detections_to_records, write_results_json
from ..gs.partition import load_partition
from ..models.detector import build_model
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


def infer_dataset(
    model, ds: LvisDataset, pcfg: PipelineConfig, batch_size: int, limit: Optional[int] = None
) -> Tuple[List[dict], Dict[str, float]]:
    """`model.predict` over the dataset's first `limit` images (all by
    default) on the model's device -> (result records, seconds spent in
    "preprocess", "predict" and "records")."""
    device = next(model.parameters()).device
    n = min(len(ds), limit or len(ds))
    times = dict(preprocess=0.0, predict=0.0, records=0.0)
    records: List[dict] = []
    for idxs, batch in bucket_batches(ds, pcfg, batch_size, n, times):
        t0 = time.perf_counter()
        dets = model.predict(*(torch.from_numpy(batch[k]).to(device) for k in ("image", "img_shape", "scale_factor")))
        boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
        t1 = time.perf_counter()
        for bi, idx in enumerate(idxs):
            records += detections_to_records(
                ds.img_infos[idx]["id"], boxes[bi], scores[bi], labels[bi], valid[bi], ds.cat_ids
            )
        times["predict"] += t1 - t0
        times["records"] += time.perf_counter() - t1
    return records, times


def evaluate(ann: str, records: List[dict], img_ids=None) -> LvisEvaluator:
    """The evaluator run over `records`; with `img_ids`, over those images'
    ground truth alone."""
    with open(ann) as f:
        gt = json.load(f)
    if img_ids is not None:
        keep = set(img_ids)
        gt["images"] = [i for i in gt["images"] if i["id"] in keep]
        gt["annotations"] = [a for a in gt["annotations"] if a["image_id"] in keep]
    ev = LvisEvaluator(gt, records)
    ev.run()
    return ev


def main(argv=None) -> dict:
    """Returns the records, the evaluator (None with --no-eval) and the
    times in seconds."""
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
        tau_norm(model, args.tau)
    model.to(device).eval()

    n = min(len(ds), args.limit or len(ds))
    t0 = time.perf_counter()
    records, times = infer_dataset(model, ds, pcfg, args.batch_size, n)
    wall = time.perf_counter() - t0
    print(f"inference done: {n} images in {wall:.3f} s ({n / wall:.3f} img/s): preprocess "
          f"{times['preprocess']:.3f} s, predict {times['predict']:.3f} s, records {times['records']:.3f} s")
    if args.out:
        write_results_json(records, args.out)
        print(f"wrote {len(records)} detections to {args.out}")
    ev = None
    if not args.no_eval:
        t0 = time.perf_counter()
        ev = evaluate(args.ann, records, [ds.img_infos[i]["id"] for i in range(n)] if args.limit else None)
        times["evaluate"] = time.perf_counter() - t0
        print(f"evaluate {times['evaluate']:.3f} s")
        print("bbox results:")
        ev.print_results()
    return dict(records=records, evaluator=ev, times=times)


if __name__ == "__main__":
    main()
