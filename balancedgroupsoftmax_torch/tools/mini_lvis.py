"""Write a small LVIS v0.5-shaped dataset of random JPEGs, for the flows of
the CLIs where no LVIS data is at hand.

    python -m balancedgroupsoftmax_torch.tools.mini_lvis --out DIR [--preset mini|full]

"mini" is the verify fixture of the JAX package's workflow: 8 classes, 6
random 160 x 120 images with 3 boxes each. "full" has LVIS's 1230 classes,
their instance counts spread over 1-10^4 so that every bin of the GS
partition holds classes, and 8 images in both buckets (4 at 640 x 480, 4 at
427 x 640) with 20 boxes each and the federated fields filled in. DIR gets
`ann.json` and `images/`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def frequency(count: int) -> str:
    """The LVIS group of a class by its count: rare, common or frequent."""
    return "r" if count <= 10 else ("c" if count <= 100 else "f")


def write_lvis_fixture(
    root: str,
    num_classes: int = 8,
    image_sizes: Sequence[Tuple[int, int]] = ((120, 160),) * 6,  # (h, w) each
    boxes_per_image: int = 3,
    box_range: Tuple[int, int] = (20, 60),
    instance_counts: Optional[Sequence[int]] = None,
    federated: bool = False,
    seed: int = 0,
) -> Tuple[str, str]:
    """Write `root`/ann.json and `root`/images/*.jpg; returns their paths.
    The defaults give the "mini" fixture, draw for draw. With `federated`
    each image lists as negative the classes (c + image id) % 5 == 0 it does
    not hold, and even images their first class as not exhaustive."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    if instance_counts is None:
        instance_counts = [10 ** (1 + i % 4) for i in range(num_classes)]
    cats = [
        dict(
            id=i + 1, name=f"cls{i + 1}", instance_count=int(n), frequency=frequency(n),
            image_count=int(5 * 10 ** (i % 3)),
        )
        for i, n in enumerate(instance_counts)
    ]
    images, annotations = [], []
    for i, (h, w) in enumerate(image_sizes):
        fname = f"COCO_val2014_{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, fname), rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append(dict(id=i + 1, file_name=fname, width=w, height=h, neg_category_ids=[], not_exhaustive_category_ids=[]))
        for _ in range(boxes_per_image):
            bw, bh = (int(v) for v in rng.randint(*box_range, 2))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            annotations.append(
                dict(
                    id=len(annotations) + 1, image_id=i + 1, category_id=int(rng.randint(1, num_classes + 1)),
                    bbox=[float(x), float(y), float(bw), float(bh)], area=float(bw * bh),
                    segmentation=[[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
                )
            )
    if federated:
        for img in images:
            held = [a["category_id"] for a in annotations if a["image_id"] == img["id"]]
            img["neg_category_ids"] = [c for c in range(1, num_classes + 1) if c not in held and (c + img["id"]) % 5 == 0]
            img["not_exhaustive_category_ids"] = held[:1] if img["id"] % 2 == 0 else []
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=cats), f)
    return ann, img_dir


def write_full_fixture(root: str, seed: int = 0) -> Tuple[str, str]:
    """The "full" preset: 1230 classes at LVIS's widths, both buckets."""
    n = 1230
    counts = [max(1, int(10 ** (4 * ((i * 7) % n) / (n - 1)))) for i in range(n)]
    return write_lvis_fixture(
        root, n, [(480, 640)] * 4 + [(640, 427)] * 4, 20, (32, 200), counts, federated=True, seed=seed
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--preset", choices=["mini", "full"], default="mini")
    args = p.parse_args(argv)
    ann, img_dir = (write_full_fixture if args.preset == "full" else write_lvis_fixture)(args.out)
    print(f"wrote {ann} and {img_dir}")


if __name__ == "__main__":
    main()
