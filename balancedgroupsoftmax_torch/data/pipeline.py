"""Image preprocessing, sampling and batching, in numpy.

A copy of JAX `data/pipeline.py` (`PipelineConfig` :33-54, `rescale_size`
:57, `preprocess_image` :63, `preprocess_image_file` :125, `repeat_factors`
:220, `expand_indices_by_repeat` :244, `DetBatcher` :289-330, `collate`
:374) without multi-scale training: keep-ratio resize to `scale` (1333,
800), in training a random horizontal flip (gt boxes scaled and flipped with
the image), ImageNet normalisation in RGB, zero padding into the landscape or
portrait bucket (the scale's sides rounded up to 32), and gt boxes padded to
`max_gt_boxes` slots with a validity mask. Images are read and decoded by
cv2 (the JAX package's native JPEG loader is not ported). Batches hold
images of one bucket; repeat-factor sampling (RFS, loader/sampler.py:104-117)
repeats the images of rare classes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    scale: Tuple[int, int] = (1333, 800)  # (long, short)
    flip_prob: float = 0.5
    max_gt_boxes: int = 100

    def buckets(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """The (landscape, portrait) pad buckets, (h, w) each."""
        pad = lambda v: -(-v // 32) * 32
        long_side, short_side = pad(max(self.scale)), pad(min(self.scale))
        return (short_side, long_side), (long_side, short_side)


def rescale_size(w: int, h: int, scale: Tuple[int, int]) -> Tuple[int, int, float]:
    """mmcv.imrescale sizing: factor = min(long/max, short/min)."""
    long_side, short_side = max(scale), min(scale)
    f = min(long_side / max(w, h), short_side / min(w, h))
    return int(w * f + 0.5), int(h * f + 0.5), f


def preprocess_image(
    img: np.ndarray,  # (H, W, 3) uint8 RGB
    gt_bboxes: Optional[np.ndarray] = None,  # (N, 4) xyxy at the original scale
    gt_labels: Optional[np.ndarray] = None,  # (N,) 1-based
    cfg: PipelineConfig = PipelineConfig(),
    train: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """One image -> the padded network input, its geometry and padded gts.
    In training, `rng` draws the flip."""
    import cv2

    if gt_bboxes is None:
        gt_bboxes = np.zeros((0, 4), np.float32)
        gt_labels = np.zeros(0, np.int32)
    h0, w0 = img.shape[:2]
    new_w, new_h, _ = rescale_size(w0, h0, cfg.scale)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    w_scale = new_w / w0
    h_scale = new_h / h0
    scale_factor = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
    boxes = gt_bboxes * scale_factor if len(gt_bboxes) else gt_bboxes

    flipped = False
    if train and rng is not None and rng.rand() < cfg.flip_prob:
        resized = resized[:, ::-1]
        flipped = True
        if len(boxes):
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = new_w - boxes[:, 2] - 1
            boxes[:, 2] = new_w - x1 - 1

    norm = (resized.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    land, port = cfg.buckets()
    bucket = land if new_w >= new_h else port
    padded = np.zeros((*bucket, 3), np.float32)
    padded[:new_h, :new_w] = norm

    g = cfg.max_gt_boxes
    out_boxes = np.zeros((g, 4), np.float32)
    out_labels = np.zeros((g,), np.int32)
    out_mask = np.zeros((g,), bool)
    n = min(len(boxes), g)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = gt_labels[:n]
    out_mask[:n] = True
    return dict(
        image=padded,
        gt_boxes=out_boxes,
        gt_labels=out_labels,
        gt_mask=out_mask,
        img_shape=np.array([new_h, new_w], np.float32),
        scale_factor=np.float32(w_scale),
        flipped=flipped,
        bucket=bucket,
    )


def preprocess_image_file(
    path: str,
    gt_bboxes: Optional[np.ndarray] = None,
    gt_labels: Optional[np.ndarray] = None,
    cfg: PipelineConfig = PipelineConfig(),
    train: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """`preprocess_image` of the image file at `path`, decoded by cv2."""
    return preprocess_image(read_rgb(path), gt_bboxes, gt_labels, cfg, train, rng)


def read_rgb(path: str) -> np.ndarray:
    """The image file at `path` as (H, W, 3) uint8 RGB, decoded by cv2."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"cannot decode image file: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def repeat_factors(labels_per_image: Sequence[np.ndarray], num_classes: int, t: float = 0.001) -> np.ndarray:
    """Each image's RFS repeat factor (loader/sampler.py:104-117): with f_c
    the fraction of images holding class c, r_c = max(1, sqrt(t / f_c)), and
    an image's factor is the largest r_c of its classes."""
    num_images = len(labels_per_image)
    img_count = np.zeros(num_classes + 1, np.float64)
    for labels in labels_per_image:
        for c in np.unique(labels):
            img_count[c] += 1
    f = img_count / max(num_images, 1)
    r_c = np.maximum(1.0, np.sqrt(t / np.maximum(f, 1e-12)))
    out = np.ones(num_images)
    for i, labels in enumerate(labels_per_image):
        if len(labels):
            out[i] = r_c[np.unique(labels)].max()
    return out


def expand_indices_by_repeat(repeat: np.ndarray, epoch_seed: int) -> np.ndarray:
    """One epoch's image indices: each factor stochastically rounded."""
    rng = np.random.RandomState(epoch_seed)
    base = np.floor(repeat).astype(np.int64)
    extra = (rng.rand(len(repeat)) < repeat - base).astype(np.int64)
    return np.repeat(np.arange(len(repeat)), base + extra)


class DetBatcher:
    """Epoch-seeded shuffling and bucket batching on one process (the
    static-shape stand-in for GroupSampler, loader/sampler.py:39-76): a batch
    holds images of one bucket, and a bucket's last incomplete batch is
    dropped."""

    def __init__(
        self,
        bucket_flags: np.ndarray,  # (N,) 0 = landscape, 1 = portrait
        batch_size: int,
        seed: int = 0,
        repeat: Optional[np.ndarray] = None,
    ):
        self.bucket_flags = bucket_flags
        self.batch_size = batch_size
        self.seed = seed
        self.repeat = repeat

    def epoch_batches(self, epoch: int) -> List[np.ndarray]:
        rng = np.random.RandomState(self.seed + epoch)
        if self.repeat is not None:
            indices = expand_indices_by_repeat(self.repeat, self.seed + epoch)
            rng.shuffle(indices)
        else:
            indices = rng.permutation(len(self.bucket_flags))

        batches = []
        for flag in (0, 1):
            idx = indices[self.bucket_flags[indices] == flag]
            full = len(idx) // self.batch_size * self.batch_size
            for s in range(0, full, self.batch_size):
                batches.append(idx[s : s + self.batch_size])
        order = rng.permutation(len(batches))
        return [batches[i] for i in order]


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples of one bucket into a batch."""
    return dict(
        images=np.stack([s["image"] for s in samples]),
        gt_boxes=np.stack([s["gt_boxes"] for s in samples]),
        gt_labels=np.stack([s["gt_labels"] for s in samples]),
        gt_mask=np.stack([s["gt_mask"] for s in samples]),
        img_shapes=np.stack([s["img_shape"] for s in samples]),
        scale_factors=np.stack([s["scale_factor"] for s in samples]),
    )
