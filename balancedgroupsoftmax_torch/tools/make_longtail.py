"""Write a long-tailed LVIS-format detection fixture (a copy of JAX
tools/make_longtail.py, cv2 and numpy only: the same flags, and at a given
seed the same JSON files and JPEG bytes).

The classes are (hue x shape) pairs that a ResNet learns quickly; train
instance counts follow a power law, so the softmax classifier suppresses the
tail classes, and the val split is balanced, so APr, APc and APf are all
measurable (BAGS_EXPERIMENT.md).

Written to --out:
  images/train_*.jpg, images/val_*.jpg
  train.json, val.json        (LVIS schema: the categories carry the train
                               split's instance_count, image_count and r/c/f
                               frequency by LVIS's <=10 / <=100 image rule)

    python -m balancedgroupsoftmax_torch.tools.make_longtail --out /tmp/synlt --train-images 400
    python -m balancedgroupsoftmax_torch.tools.gs_partition --ann /tmp/synlt/train.json \
        --out /tmp/synlt/part.npz --num-classes 49 --thresholds 8 40 200
"""

import argparse
import json
import os

import cv2
import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--train-images", type=int, default=500)
    p.add_argument("--val-images", type=int, default=120)
    p.add_argument("--size", type=int, default=320, help="square image side")
    p.add_argument("--hues", type=int, default=12)
    p.add_argument("--shapes", type=int, default=4)
    p.add_argument("--alpha", type=float, default=1.6,
                   help="power-law exponent of train class frequencies")
    p.add_argument("--min-obj", type=int, default=2)
    p.add_argument("--max-obj", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def class_color(cls_id, hues):
    """Distinct BGR color per class: hue wheel, full saturation."""
    hue = int(180.0 * ((cls_id - 1) % hues) / hues)
    hsv = np.uint8([[[hue, 230, 220]]])
    return tuple(int(v) for v in cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0, 0])


def draw_object(img, cls_id, x, y, s, hues):
    """Draw one instance of class cls_id in box (x, y, x+s, y+s).

    Shape index = (cls_id-1) // hues: 0 filled square, 1 filled circle,
    2 filled triangle, 3 ring. Same hue + different shape are distinct
    classes, so the head must use geometry as well as color.
    """
    color = class_color(cls_id, hues)
    shape = (cls_id - 1) // hues
    cx, cy, r = x + s // 2, y + s // 2, s // 2
    if shape == 0:
        cv2.rectangle(img, (x, y), (x + s, y + s), color, -1)
    elif shape == 1:
        cv2.circle(img, (cx, cy), r, color, -1)
    elif shape == 2:
        pts = np.array([[cx, y], [x, y + s], [x + s, y + s]])
        cv2.fillPoly(img, [pts], color)
    else:
        cv2.circle(img, (cx, cy), r, color, max(2, s // 5))
    return (x, y, x + s, y + s)


def background(rng, size):
    """Smooth random gradient + noise so images are not trivially flat."""
    lo = rng.randint(20, 90, 3)
    hi = rng.randint(120, 200, 3)
    t = np.linspace(0, 1, size, dtype=np.float32)
    axis = rng.rand() < 0.5
    grad = t[:, None] if axis else t[None, :]
    img = (lo[None, None] * (1 - grad[..., None]) + hi[None, None] * grad[..., None])
    img = np.broadcast_to(img, (size, size, 3)).astype(np.float32).copy()
    img += rng.randn(size, size, 3) * 8
    return np.clip(img, 0, 255).astype(np.uint8)


def place_objects(rng, size, n, min_s=28, max_s=80, max_tries=40):
    """Non-overlapping square slots (IoU kept low for clean assignment)."""
    slots = []
    for _ in range(n):
        for _ in range(max_tries):
            s = int(rng.randint(min_s, max_s + 1))
            x = int(rng.randint(2, size - s - 2))
            y = int(rng.randint(2, size - s - 2))
            ok = True
            for (px, py, ps) in slots:
                ix = max(0, min(x + s, px + ps) - max(x, px))
                iy = max(0, min(y + s, py + ps) - max(y, py))
                if ix * iy > 0.15 * min(s * s, ps * ps):
                    ok = False
                    break
            if ok:
                slots.append((x, y, s))
                break
    return slots


def main(argv=None):
    args = parse_args(argv)
    rng = np.random.RandomState(args.seed)
    num_classes = args.hues * args.shapes
    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)

    # power-law class distribution over a random class order (so hue/shape
    # do not correlate with frequency)
    order = rng.permutation(num_classes) + 1
    probs = (1.0 + np.arange(num_classes)) ** (-args.alpha)
    probs /= probs.sum()
    class_probs = np.zeros(num_classes + 1)
    class_probs[order] = probs

    def gen_split(name, n_images, balanced):
        images, annotations = [], []
        aid = len(annotations) + 1
        inst_count = np.zeros(num_classes + 1, np.int64)
        img_sets = [set() for _ in range(num_classes + 1)]
        balanced_cycle = 0
        for i in range(n_images):
            img = background(rng, args.size)
            n_obj = int(rng.randint(args.min_obj, args.max_obj + 1))
            slots = place_objects(rng, args.size, n_obj)
            fname = f"{name}_{i:06d}.jpg"
            img_id = i + 1
            for (x, y, s) in slots:
                if balanced:
                    nonlocal_cls = (balanced_cycle % num_classes) + 1
                    balanced_cycle += 1
                    cls = int(nonlocal_cls)
                else:
                    cls = int(rng.choice(num_classes + 1, p=class_probs))
                x1, y1, x2, y2 = draw_object(img, cls, x, y, s, args.hues)
                w, h = x2 - x1, y2 - y1
                annotations.append(dict(
                    id=aid, image_id=img_id, category_id=cls,
                    bbox=[float(x1), float(y1), float(w), float(h)],
                    area=float(w * h),
                    segmentation=[[x1, y1, x2, y1, x2, y2, x1, y2]],
                ))
                aid += 1
                inst_count[cls] += 1
                img_sets[cls].add(img_id)
            cv2.imwrite(os.path.join(args.out, "images", fname), img)
            # synthetic images are exhaustively annotated: every absent
            # category is a TRUE negative, so declare it — otherwise the
            # federated evaluator never counts cross-class false
            # positives and the BAGS comparison is too forgiving
            present = {a["category_id"] for a in annotations
                       if a["image_id"] == img_id}
            images.append(dict(
                id=img_id, file_name=fname,
                width=args.size, height=args.size,
                neg_category_ids=sorted(
                    c for c in range(1, num_classes + 1) if c not in present
                ),
                not_exhaustive_category_ids=[],
            ))
        return images, annotations, inst_count, [len(s) for s in img_sets]

    # train split first; the injection loop below guarantees every class
    # at least one instance (gs_partition and the evaluator need nonempty
    # bins)
    tr_images, tr_anns, tr_inst, tr_imgc = gen_split(
        "train", args.train_images, balanced=False
    )
    # guarantee nonzero tail: inject missing classes into fresh images
    missing = [c for c in range(1, num_classes + 1) if tr_inst[c] == 0]
    for j, cls in enumerate(missing):
        i = len(tr_images)
        img = background(rng, args.size)
        slots = place_objects(rng, args.size, 1)
        x, y, s = slots[0]
        x1, y1, x2, y2 = draw_object(img, cls, x, y, s, args.hues)
        fname = f"train_{i:06d}.jpg"
        cv2.imwrite(os.path.join(args.out, "images", fname), img)
        img_id = i + 1
        tr_images.append(dict(
            id=img_id, file_name=fname, width=args.size, height=args.size,
            neg_category_ids=sorted(
                c for c in range(1, num_classes + 1) if c != cls
            ),
            not_exhaustive_category_ids=[],
        ))
        w, h = x2 - x1, y2 - y1
        tr_anns.append(dict(
            id=len(tr_anns) + 1, image_id=img_id, category_id=int(cls),
            bbox=[float(x1), float(y1), float(w), float(h)], area=float(w * h),
            segmentation=[[x1, y1, x2, y1, x2, y2, x1, y2]],
        ))
        tr_inst[cls] += 1
        tr_imgc[cls] += 1

    va_images, va_anns, _, _ = gen_split("val", args.val_images, balanced=True)

    def freq(ic):  # LVIS rule: rare = 1-10 images, common = 11-100, else freq
        return "r" if ic <= 10 else ("c" if ic <= 100 else "f")

    categories = [
        dict(
            id=c,
            name=f"hue{(c - 1) % args.hues}_shape{(c - 1) // args.hues}",
            instance_count=int(tr_inst[c]),
            image_count=int(tr_imgc[c]),
            frequency=freq(tr_imgc[c]),
        )
        for c in range(1, num_classes + 1)
    ]

    for name, images, anns in (
        ("train", tr_images, tr_anns), ("val", va_images, va_anns)
    ):
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(
                dict(images=images, annotations=anns, categories=categories), f
            )

    by_freq = {"r": 0, "c": 0, "f": 0}
    for c in categories:
        by_freq[c["frequency"]] += 1
    print(
        f"wrote {args.out}: {len(tr_images)} train / {len(va_images)} val "
        f"images, {num_classes} classes "
        f"({by_freq['r']} rare, {by_freq['c']} common, {by_freq['f']} frequent), "
        f"train instances min/median/max = "
        f"{tr_inst[1:].min()}/{int(np.median(tr_inst[1:]))}/{tr_inst[1:].max()}"
    )


if __name__ == "__main__":
    main()
