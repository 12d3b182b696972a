"""Test-time augmentation: mapping views back and merging them (JAX
`eval/aug.py`: `merge_aug_proposals` :23, `merge_aug_bboxes` :50,
`merge_aug_masks` :71, `flip_image_content` :82, `unflip_boxes` :97), and
the detection-level merge of JAX tools/test_lvis.py:553-575
(`merge_aug_detections`).

The proposal merge takes a batch's tensors, (B, P, 4) boxes with (B, 2)
view shapes and (B,) scale factors (JAX's takes one image's); the box
merge also an image's boxes with its (h, w) and scale factor. Proposals are
merged by `ops/nms.py nms`, whose keep mask is K1 on a CUDA tensor; the
detection-level merge runs K1 on the label-offset rows of every image in
one launch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.boxes import bbox_mapping_back
from ..ops.nms import nms, nms_keep


def merge_aug_proposals(
    aug_boxes: Sequence[torch.Tensor],  # per view (B, P, 4) in that view's frame
    aug_scores: Sequence[torch.Tensor],  # per view (B, P)
    aug_valid: Sequence[torch.Tensor],  # per view (B, P) bool
    img_shapes: Sequence[torch.Tensor],  # per view (B, 2) content (h, w)
    scale_factors: Sequence[torch.Tensor],  # per view (B,)
    flips: Sequence[bool],
    nms_thr: float = 0.7,
    max_num: int = 2000,
):
    """Each view's proposals mapped back to the original frame, concatenated
    image by image and merged by NMS, the top `max_num` kept: (boxes,
    scores, valid)."""
    boxes = [bbox_mapping_back(b, sh, sf, fl) for b, sh, sf, fl in zip(aug_boxes, img_shapes, scale_factors, flips)]
    return nms(torch.cat(boxes, dim=1), torch.cat(aug_scores, dim=1), torch.cat(aug_valid, dim=1), nms_thr, max_num)


def merge_aug_bboxes(
    aug_boxes: Sequence[torch.Tensor],  # per view (..., N, 4 or 4C) decoded, in the view's frame
    aug_scores: Sequence[torch.Tensor],  # per view (..., N, C)
    img_shapes: Sequence,
    scale_factors: Sequence,
    flips: Sequence[bool],
):
    """The views' boxes mapped back and averaged, and their scores averaged
    (merge_augs.py:46-80). Every view must have scored the same proposals.
    The sums divide by a tensor, so the card rounds as the CPU does."""
    mapped = [bbox_mapping_back(b, sh, sf, fl) for b, sh, sf, fl in zip(aug_boxes, img_shapes, scale_factors, flips)]
    n = torch.tensor(float(len(mapped)), device=mapped[0].device)
    return sum(mapped) / n, sum(aug_scores) / n


def merge_aug_masks(aug_masks: Sequence[np.ndarray], flips: Sequence[bool]) -> np.ndarray:
    """The views' (N, M, M) mask probabilities averaged in f64, a flipped
    view's masks flipped back first."""
    fixed = [m[..., ::-1] if fl else m for m, fl in zip(aug_masks, flips)]
    return sum(np.asarray(f, np.float64) for f in fixed) / len(fixed)


def flip_image_content(images, shapes):
    """Each image's content region flipped, not the padded canvas (the
    reference flips before it pads): images (B, H, W, 3) and content shapes
    (B, 2), as numpy arrays or tensors; a copy."""
    out = images.clone() if isinstance(images, torch.Tensor) else np.array(images)
    for i in range(len(out)):
        w = int(round(float(shapes[i][1])))
        out[i, :, :w] = out[i, :, :w].flip(1) if isinstance(out, torch.Tensor) else out[i, :, :w][:, ::-1]
    return out


def unflip_boxes(boxes: np.ndarray, new_w: float, sf: float) -> np.ndarray:
    """Boxes of a content-flipped view, already at the original scale, back
    in the original frame: the -1 flip on the content width `new_w` at
    network scale, divided by `sf` (bbox_mapping_back's semantics)."""
    fb = boxes.copy()
    x1 = fb[..., 0].copy()
    fb[..., 0] = (new_w - 1.0) / sf - fb[..., 2]
    fb[..., 2] = (new_w - 1.0) / sf - x1
    return fb


def merge_aug_detections(boxes, scores, labels, valid, device, iou_thr: float = 0.5, max_out: int = 300):
    """The detection-level merge (JAX tools/test_lvis.py:553-575) of views'
    detections at the original scale, concatenated per image: numpy boxes
    (B, N, 4), scores (B, N), labels (B, N), valid (B, N). Each box is
    offset by its label x 1e5 in f64, cast to f32 (as JAX's `jnp.asarray`
    casts it: at 1230 classes the offsets reach 1.23e8, where f32 steps are
    8 px), and one greedy NMS at `iou_thr` over all classes then suppresses
    within a class only: K1 on `device`, every image's row in one launch.
    Returns each image's kept indices, by descending score (ties by index),
    at most `max_out`."""
    shifted = (boxes + labels[..., None].astype(np.float64) * 1e5).astype(np.float32)
    keep = nms_keep(
        torch.from_numpy(shifted).to(device), torch.from_numpy(scores).to(device),
        torch.from_numpy(valid).to(device), iou_thr,
    ).cpu().numpy()
    kept = []
    for bi in range(len(boxes)):
        k = np.where(keep[bi] & valid[bi])[0]
        kept.append(k[np.argsort(-scores[bi][k], kind="stable")][:max_out])
    return kept
