"""Train a detector on an LVIS annotation file: the BAGS two-phase recipe on
one card (JAX tools/train.py :30-476).

    # phase 1: the baseline, everything but the frozen stem and first stage
    python -m balancedgroupsoftmax_torch.tools.train --model faster_rcnn_r50 \
        --ann ANN --img-prefix IMAGES --work-dir WORK1 --selectp 0
    # phase 2: the GS head warm-started from phase 1, only fc_cls trains
    python -m balancedgroupsoftmax_torch.tools.train --model gs_faster_rcnn_r50 \
        --ann ANN --img-prefix IMAGES --partition PART.npz --work-dir WORK2 \
        --load-from WORK1/ckpt_epoch_12.pt --selectp 1
    # either, continued from its last checkpoint
    ... --resume-from WORK2/ckpt_epoch_1.pt

Images are decoded and preprocessed (resize, flip, normalise, pad into their
bucket) by a pool of host threads, one batch ahead of the card. Each step
logs a JSON line to WORK/train_log.jsonl every `--log-interval` steps; a
checkpoint (`utils/checkpoint.py`) is written every `--save-interval` epochs,
at the last epoch and at `--max-steps`. The model is resized to the
dataset's class count. It runs on the card unless `--device cpu` is given.
Sample i of epoch e draws its flip from the seed (seed * 1000003 + e * 131 +
i) % 2^31, as in the JAX CLI, and a resumed run goes on from the batch where
the checkpoint stood, so a resumed run takes the steps an uninterrupted one
would have taken.

`--model` also takes the detector variants `grid_rcnn_r50`,
`mask_scoring_rcnn_r50` and `double_head_rcnn_r50` (Fast R-CNN takes its
proposals as input and trains through `model.loss` alone, as in JAX). The
model is resized to the dataset's classes, every head of it.

For a model with a mask head (Mask R-CNN, Mask-Scoring R-CNN, HTC) each
sample also carries its gt masks, rasterised from the annotation's
segmentations at the original size into box-normalised crops (`ops/mask.py`),
flipped with the image.

Not ported here: `--dataset cityscapes`, `--remat`, `--autosave-steps`,
`--val-ann` and `--distributed` (ROADMAP A6, A10 and the leftovers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import zoo
from ..apis import MODELS, resolve_device
from ..data.lvis import LvisDataset
from ..data.pipeline import DetBatcher, PipelineConfig, collate, preprocess_image_file, repeat_factors
from ..gs.partition import load_partition
from ..models.detector import build_model
from ..ops.mask import rasterize_gt_masks
from ..parallel.train import create_train_state, make_train_step
from ..utils.checkpoint import load_torchvision_resnet, restore_checkpoint, save_checkpoint, warm_start


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="faster_rcnn_r50", choices=sorted(MODELS))
    p.add_argument("--ann", required=True)
    p.add_argument("--img-prefix", required=True)
    p.add_argument("--partition", default=None, help=".npz from tools.gs_partition")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--load-from", default=None, help="warm start: copy every tensor whose name and shape match")
    p.add_argument("--resume-from", default=None, help="continue a run from its checkpoint")
    p.add_argument("--pretrained-backbone", default=None, help="torchvision ResNet .pth")
    p.add_argument("--selectp", type=int, default=None,
                   help="0 all, 1 fc_cls only, 2 bbox head, 3 every cascade stage's fc_cls, 4 bbox and mask heads")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-steps", type=int, nargs="*", default=None, help="epochs at which the lr drops x0.1 (8 11)")
    p.add_argument("--warmup-iters", type=int, default=None, help="linear warmup in steps (500)")
    p.add_argument("--autoscale-lr", action="store_true", help="linear scaling rule: lr *= batch / 16")
    p.add_argument("--use-rfs", action="store_true", help="repeat-factor sampling")
    p.add_argument("--rfs-t", type=float, default=0.001,
                   help="RFS threshold t of max(1, sqrt(t / f_c)); on a small dataset raise it to about "
                        "8 / images, or every factor is 1")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype; parameters stay f32")
    p.add_argument("--scale", type=int, nargs=2, default=None, metavar=("LONG", "SHORT"),
                   help="keep-ratio resize target (1333 800)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--save-interval", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--max-steps", type=int, default=None, help="stop (and save) at this step")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the model, its TrainState, the last checkpoint's path,
    the warm start's copied and fresh names, the step the run started from
    and the logged lines."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)

    builder, train_key = MODELS[args.model]
    print(f"loading dataset {args.ann}")
    ds = LvisDataset(args.ann, args.img_prefix)
    num_classes = len(ds.cat_ids) + 1
    det_cfg = builder()
    if num_classes != det_cfg.bbox_head.num_classes:
        det_cfg = builder(num_classes=num_classes)
        print(f"model resized to dataset: {num_classes} classes (incl. bg)")
    partition = load_partition(args.partition) if args.partition else None
    if partition is not None and partition.num_classes != num_classes:
        raise ValueError(f"partition has {partition.num_classes} classes, dataset {num_classes}")

    overrides = dict(
        selectp=args.selectp, total_epochs=args.epochs, warmup_iters=args.warmup_iters,
        lr_step_epochs=None if args.lr_steps is None else tuple(args.lr_steps), lr=args.lr,
    )
    train_cfg = dataclasses.replace(zoo.TRAIN_CONFIGS[train_key], **{k: v for k, v in overrides.items() if v is not None})
    if args.autoscale_lr:
        train_cfg = dataclasses.replace(train_cfg, lr=train_cfg.lr * args.batch_size / 16.0)
    if train_cfg.selectp != 0 and not (args.load_from or args.resume_from):
        # the gs_* entries default to the phase-2 recipe: from scratch it
        # freezes the backbone and the RPN, and nothing learns
        print(
            f"WARNING: selectp={train_cfg.selectp} trains only the classifier subset (the BAGS phase-2 "
            "recipe) but no warm-start checkpoint was given (--load-from). For full from-scratch "
            "training pass --selectp 0."
        )

    pcfg = PipelineConfig() if args.scale is None else PipelineConfig(scale=tuple(args.scale))
    model = build_model(det_cfg, partition=partition, dtype=getattr(torch, args.dtype)).init_weights(args.seed)
    if args.pretrained_backbone:
        copied, _ = warm_start(model, load_torchvision_resnet(args.pretrained_backbone))
        print(f"backbone warm start: {len(copied)} tensors")
    copied, fresh = [], []
    if args.load_from:
        copied, fresh = warm_start(model, restore_checkpoint(args.load_from)["model"])
        print(f"warm start from {args.load_from}: copied {len(copied)}, fresh {len(fresh)} "
              f"({', '.join(fresh[:4])}{', ...' if len(fresh) > 4 else ''})")
    model.to(device)

    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = create_train_state(model, train_cfg, steps_per_epoch, generator)

    flags = np.array([0 if i["width"] >= i["height"] else 1 for i in ds.img_infos], np.int64)
    repeat = None
    if args.use_rfs:
        repeat = repeat_factors([ds.get_ann_info(i)["labels"] for i in range(len(ds))], len(ds.cat_ids), t=args.rfs_t)
        n_up = int((repeat > 1.0).sum())
        print(f"RFS t={args.rfs_t}: {n_up}/{len(repeat)} images upsampled, max factor {repeat.max():.3f}, "
              f"expected epoch length {repeat.sum():.1f} vs {len(repeat)}")
        if n_up == 0:
            raise SystemExit(
                f"--use-rfs is a no-op: every repeat factor is 1 because t={args.rfs_t} is below the rarest "
                "class frequency (f_c = images-with-class / num_images). Raise --rfs-t (about 8/num_images "
                "on small datasets) or drop --use-rfs; refusing to train a sampler that cannot sample."
            )
    batcher = DetBatcher(flags, args.batch_size, seed=args.seed, repeat=repeat)

    start_epoch, start_batch = 0, 0
    if args.resume_from:
        ckpt = restore_checkpoint(args.resume_from)
        if "train" not in ckpt:
            raise SystemExit(f"{args.resume_from} holds no training state: warm-start from it with --load-from")
        model.load_state_dict(ckpt["model"])
        try:
            state.load_state_dict(ckpt["train"])
        except ValueError as e:
            raise SystemExit(f"refusing to resume from {args.resume_from}: {e}") from None
        start_epoch, start_batch = ckpt["loader"]["epoch"], ckpt["loader"]["batch"]
        if start_batch >= len(batcher.epoch_batches(start_epoch)):
            start_epoch, start_batch = start_epoch + 1, 0
        print(f"resumed from {args.resume_from} at step {state.step} (with optimizer state), "
              f"epoch {start_epoch} batch {start_batch}")
    start_step = state.step
    step_fn = make_train_step(state)

    with_masks = det_cfg.mask_head is not None

    def load_sample(idx, epoch):
        ann = ds.get_ann_info(idx)
        rng = np.random.RandomState((args.seed * 1000003 + epoch * 131 + int(idx)) % (2**31))
        s = preprocess_image_file(ds.image_path(idx), ann["bboxes"], ann["labels"], pcfg, True, rng)
        if with_masks:
            info = ds.img_infos[idx]
            crops = rasterize_gt_masks(ann["masks"], ann["bboxes"], info["height"], info["width"], pcfg.max_gt_boxes)
            s["gt_mask_crops"] = crops[:, :, ::-1].copy() if s["flipped"] else crops
        return s

    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    log, ckpt_path = [], None
    samples_pool = ThreadPoolExecutor(max_workers=4)
    batch_pool = ThreadPoolExecutor(max_workers=1)

    def make_batch(idxs, epoch):
        samples = list(samples_pool.map(lambda i: load_sample(i, epoch), idxs))
        batch = collate(samples)
        if with_masks:
            batch["gt_mask_crops"] = np.stack([s["gt_mask_crops"] for s in samples])
        return batch

    def reached_max() -> bool:
        return bool(args.max_steps) and state.step >= args.max_steps

    t_run = t_log = time.perf_counter()
    data_s = 0.0
    try:
        for epoch in range(start_epoch, train_cfg.total_epochs):
            if reached_max():
                break
            batches = batcher.epoch_batches(epoch)
            done = start_batch if epoch == start_epoch else 0
            pending = batch_pool.submit(make_batch, batches[done], epoch) if done < len(batches) else None
            while pending is not None:
                t0 = time.perf_counter()
                batch = pending.result()
                data_s += time.perf_counter() - t0
                done += 1
                pending = batch_pool.submit(make_batch, batches[done], epoch) if done < len(batches) else None
                metrics = step_fn(batch)
                if state.step % args.log_interval == 0:
                    m = {k: v.item() for k, v in metrics.items()}
                    dt = time.perf_counter() - t_log
                    t_log = time.perf_counter()
                    line = dict(epoch=epoch, step=state.step, imgs_per_sec=args.batch_size * args.log_interval / dt,
                                data_wait_s=data_s, **m)
                    data_s = 0.0
                    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in line.items()}), flush=True)
                    with open(log_path, "a") as f:
                        f.write(json.dumps(line) + "\n")
                    log.append(line)
                if reached_max():
                    if pending is not None:
                        pending.cancel()
                    break
            if (epoch + 1) % args.save_interval and epoch + 1 != train_cfg.total_epochs and not reached_max():
                continue
            ckpt_path = os.path.join(args.work_dir, f"ckpt_epoch_{epoch + 1}.pt")
            save_checkpoint(
                ckpt_path,
                {"model": model.state_dict(), "train": state.state_dict(), "loader": {"epoch": epoch, "batch": done}},
                meta=dict(model=args.model, epoch=epoch + 1, step=state.step, classes=list(ds.class_names),
                          train_cfg=dataclasses.asdict(train_cfg), argv=sys.argv[1:] if argv is None else list(argv)),
            )
            print(f"saved {ckpt_path}")
    finally:
        batch_pool.shutdown(cancel_futures=True)
        samples_pool.shutdown(cancel_futures=True)
    steps = state.step - start_step
    wall = time.perf_counter() - t_run
    print(f"trained {steps} steps in {wall:.3f} s ({steps * args.batch_size / max(wall, 1e-9):.3f} images/s "
          f"from image files, first step included)")
    return dict(model=model, state=state, checkpoint=ckpt_path, copied=copied, fresh=fresh,
                start_step=start_step, log=log)


if __name__ == "__main__":
    main()
