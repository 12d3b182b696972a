"""Per-bin top-1 accuracy of the classifier on ground-truth RoIs, for each
tau of a tau-norm sweep (JAX tools/test_lvis_tnorm.py; the reference's
accumulate_acc and reweight_cls): the diagnostic the BAGS paper uses to show
the head's imbalance.

    python -m balancedgroupsoftmax_torch.tools.test_lvis_tnorm --model faster_rcnn_r50 \
        --ann ANN --img-prefix IMAGES --checkpoint WORK/ckpt_epoch_12.pt \
        --partition PART.npz --taus 0.0 0.5 1.0

As in the JAX CLI: images at the default scale (1333, 800), only those padded
into the (800, 1344) bucket, at most 64 ground-truth boxes an image, the
first `--limit` (500) images; the GS partition's bins name the groups; one
JSON line a tau. The model is resized to the dataset's class count. It runs
on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np
import torch

from ..apis import MODELS, resolve_device, tau_norm
from ..data.lvis import LvisDataset
from ..data.pipeline import PipelineConfig, preprocess_image_file
from ..gs.head import gs_merge_scores
from ..gs.partition import load_partition
from ..models.detector import FasterRCNN, build_model
from ..utils.checkpoint import restore_checkpoint

BUCKET = (800, 1344)
MAX_ROIS = 64
BIN_NAMES = ("bg/fg", "(0,10)", "[10,100)", "[100,1000)", "[1000,~)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="faster_rcnn_r50", choices=["faster_rcnn_r50", "gs_faster_rcnn_r50"])
    p.add_argument("--ann", required=True)
    p.add_argument("--img-prefix", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--partition", required=True, help="GS partition .npz (the bins)")
    p.add_argument("--taus", type=float, nargs="+", default=[0.0])
    p.add_argument("--limit", type=int, default=500)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


@torch.inference_mode()
def gt_roi_hits(
    model: FasterRCNN, image: np.ndarray, gt_boxes: np.ndarray, gt_labels: np.ndarray, label2bin: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One image's ground-truth boxes (k, 4) classified by the model's head:
    `extract_feats`, RoIAlign over the FPN levels (K2), the bbox head, then
    the GS merge or a softmax; a box is right when its best foreground class
    is its label. Returns per-bin (correct, total), each (num_bins,)."""
    device = next(model.parameters()).device
    feats = model.extract_feats(torch.from_numpy(image[None]).to(device))
    rois = torch.from_numpy(np.ascontiguousarray(gt_boxes, np.float32)[None]).to(device)
    cls_logits, _ = model.bbox_head(model._pool(feats, rois))
    logits = cls_logits[0].float()
    if model.cfg.bbox_head.use_gs:
        scores = gs_merge_scores(logits, model.partition)
    else:
        scores = torch.softmax(logits, dim=-1)
    pred = scores[:, 1:].argmax(-1).cpu().numpy() + 1
    bins, n = label2bin[gt_labels], int(label2bin.max()) + 1
    return (np.bincount(bins, weights=pred == gt_labels, minlength=n).astype(np.int64),
            np.bincount(bins, minlength=n))


def main(argv=None) -> List[dict]:
    """Prints and returns one line a tau: its per-bin accuracy and counts
    (and the correct counts)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    partition = load_partition(args.partition)
    ds = LvisDataset(args.ann, args.img_prefix, test_mode=True)
    det_cfg = MODELS[args.model][0](num_classes=len(ds.cat_ids) + 1)
    model = build_model(det_cfg, partition=partition if det_cfg.bbox_head.use_gs else None)
    base = restore_checkpoint(args.checkpoint)["model"]
    pcfg = PipelineConfig()
    n = min(len(ds), args.limit)
    lines = []
    for tau in args.taus:
        model.load_state_dict(base)
        if tau:
            tau_norm(model.bbox_head.fc_cls, tau)
        model.to(device).eval()
        correct = np.zeros(partition.num_bins, np.int64)
        total = np.zeros(partition.num_bins, np.int64)
        for idx in range(n):
            ann = ds.get_ann_info(idx)
            if len(ann["labels"]) == 0:
                continue
            s = preprocess_image_file(ds.image_path(idx), ann["bboxes"], ann["labels"], pcfg, False)
            if s["bucket"] != BUCKET:
                continue
            k = min(len(ann["labels"]), MAX_ROIS)
            c, t = gt_roi_hits(model, s["image"], s["gt_boxes"][:k], s["gt_labels"][:k], partition.label2bin)
            correct += c
            total += t
        names = BIN_NAMES[: partition.num_bins]
        accs = {names[b]: round(int(correct[b]) / int(total[b]), 4) if total[b] else None
                for b in range(partition.num_bins)}
        print(json.dumps(dict(tau=tau, per_bin_accuracy=accs, counts=total.tolist())), flush=True)
        lines.append(dict(tau=tau, per_bin_accuracy=accs, counts=total.tolist(), correct=correct.tolist()))
    return lines


if __name__ == "__main__":
    main()
