"""Mask results of the PyTorch port against the JAX package: the paste
(`ops/mask.py paste_mask`), the RLE codec's encode half and mask IoU
(`utils/rle.py`), the federated evaluator's segm path
(`eval/lvis_eval.py`), and the test CLI's segm records.

- `paste_mask` equals JAX's bit for bit on seeded boxes, among them boxes
  partly or wholly outside the image, sub-pixel boxes, boxes on the image's
  edges and corners at exact halves (rounded half to even);
- `mask_to_counts` and the compressed strings of `encode_mask` equal JAX's
  on seeded masks, the empty and the full one and masks whose first pixel
  is set among them; their decoded areas equal JAX's `rle_area`, and the
  evaluator's bitmap IoU equals JAX's `mask_iou`;
- the segm evaluator equals JAX's to 1e-12 on every key, federated and
  not, on records that JAX's paste and encode made for the mini fixture
  from masks of three spreads about 0.75 (nearly the box, and sparser);
- `tools.test_lvis.infer_dataset` on a tiny GS Mask R-CNN's JAX-converted
  weights writes JAX's segmentation strings, JAX's being
  `predict_with_masks`, its paste and its encode on the same batches. Where
  a resized mask pixel lies within 1e-5 of the 0.5 threshold (the masks
  agree to 1e-5, tests/test_torch_mask_rcnn.py), the two may part there
  and only there; the test counts such pixels.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.eval.lvis_eval import LvisEvaluator as JLvisEvaluator
from balancedgroupsoftmax_tpu.gs.partition import partition_from_lvis as jpartition_from_lvis
from balancedgroupsoftmax_tpu.models.detector import build_model as jax_build_model
from balancedgroupsoftmax_tpu.ops.mask import paste_mask as jpaste_mask
from balancedgroupsoftmax_tpu.utils import rle as jrle
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import save_flax_checkpoint
from balancedgroupsoftmax_torch.data.lvis import LvisDataset
from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig
from balancedgroupsoftmax_torch.eval.lvis_eval import LvisEvaluator, mask_iou_bitmaps
from balancedgroupsoftmax_torch.eval.results import add_segmentations
from balancedgroupsoftmax_torch.gs.partition import partition_from_lvis
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.ops.mask import paste_mask
from balancedgroupsoftmax_torch.tools import test_lvis
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture
from balancedgroupsoftmax_torch.utils import rle
from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint
from tests.test_lvis_eval_fixture import _synth_detections
from tests.test_torch_detector import to_port
from tests.test_torch_mask_rcnn import mask_config

SIZES = ((120, 160),) * 6 + ((160, 120),) * 2


@pytest.fixture(scope="module")
def lvis(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_lvis_segm")
    ann, img_dir = write_lvis_fixture(str(root), image_sizes=SIZES, federated=True)
    return dict(root=root, ann=ann, img_prefix=img_dir, gt=json.loads(Path(ann).read_text()))


def seeded_boxes(rng, h, w, n=200):
    """xyxy boxes on an h x w image: random ones reaching past every edge,
    sub-pixel ones, ones on the edges, ones wholly outside, and corners at
    exact halves."""
    xy = rng.uniform(-0.3, 1.1, (n, 2)) * [w, h]
    wh = np.exp(rng.uniform(np.log(0.2), np.log(1.5 * max(h, w)), (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[: n // 8, 2:] = boxes[: n // 8, :2] + rng.uniform(0.0, 0.9, (n // 8, 2))  # sub-pixel
    edges = np.array([[0, 0, w - 1, h - 1], [0, 0, w, h], [w - 5, h - 5, w - 1, h - 1], [-3, -2, 4, 5],
                      [w - 0.5, h - 0.5, w + 3, h + 3], [w + 1, 0, w + 9, 9], [0, h + 2, 9, h + 9],
                      [-9, -9, -1, -1], [2.5, 3.5, 10.5, 11.5], [1.5, 0.5, 2.5, 1.5]])
    return np.concatenate([boxes, edges]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paste_mask_equals_jax_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    h, w = (120, 160) if seed != 1 else (97, 61)
    boxes = seeded_boxes(rng, h, w)
    probs = rng.rand(len(boxes), 28, 28).astype(np.float32)
    # bf16 probabilities, cast to f32 as the test CLI casts them
    probs[::3] = torch.from_numpy(probs[::3]).to(torch.bfloat16).float().numpy()
    probs[5] = 0.5  # a mask on the threshold: strictly above it is set
    nonempty = 0
    for m, box in zip(probs, boxes):
        got, want = paste_mask(m, box, h, w), jpaste_mask(m, box, h, w)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want, err_msg=str(box))
        nonempty += bool(got.any())
    assert 0 < nonempty < len(boxes)
    assert not paste_mask(probs[5], boxes[5], h, w).any()


def seeded_masks(rng, h, w):
    masks = [rng.rand(h, w) < p for p in (0.02, 0.3, 0.5, 0.9)]
    blob = np.zeros((h, w), bool)
    blob[h // 4 : 3 * h // 4, w // 5 : 4 * w // 5] = True  # runs longer than 2^10
    corner = blob.copy()
    corner[0, 0] = True  # the first pixel set: the counts start with a 0 run
    return masks + [blob, corner, np.zeros((h, w), bool), np.ones((h, w), bool)]


@pytest.mark.parametrize("shape", [(120, 160), (57, 33), (1, 1), (300, 400)])
def test_rle_encode_area_and_iou_equal_jax(shape):
    rng = np.random.RandomState(shape[0])
    masks = [m.astype(np.uint8) for m in seeded_masks(rng, *shape)]
    encoded = []
    for m in masks:
        assert rle.mask_to_counts(m) == jrle.mask_to_counts(m)
        e = rle.encode_mask(m)
        assert e == jrle.encode_mask(m) and isinstance(e["counts"], str)
        assert rle.encode_counts(rle.mask_to_counts(m)) == jrle.encode_counts(jrle.mask_to_counts(m))
        np.testing.assert_array_equal(rle.decode_rle(e), m)
        assert int(rle.decode_rle(e).sum()) == jrle.rle_area(e) == int(m.sum())
        encoded.append(e)
    flat = np.stack([m.reshape(-1) for m in masks])
    np.testing.assert_array_equal(mask_iou_bitmaps(flat, flat[::-1]), jrle.mask_iou(encoded, encoded[::-1]))
    np.testing.assert_array_equal(mask_iou_bitmaps(flat, flat[:3]), jrle.mask_iou(encoded, encoded[:3]))
    assert mask_iou_bitmaps(flat[:0], flat).shape == (0, len(encoded))


def jax_segm_records(gt, seed, spread=0.3):
    """`_synth_detections`' records with a "segmentation" that JAX's paste
    of a seeded 28 x 28 mask into the record's box and JAX's encode made
    (the gt masks are the boxes' rectangles); the masks' probabilities
    scatter about 0.75 by `spread`, so that most of each box is set and the
    masks of jittered gt boxes score."""
    rng = np.random.RandomState(100 + seed)
    sizes = {i["id"]: (i["height"], i["width"]) for i in gt["images"]}
    dets = _synth_detections(gt, seed)
    for d in dets:
        x, y, w, h = d["bbox"]
        prob = np.clip(0.75 + spread * rng.randn(28, 28), 0, 1)
        d["segmentation"] = jrle.encode_mask(
            jpaste_mask(prob.astype(np.float32), np.array([x, y, x + w - 1, y + h - 1]), *sizes[d["image_id"]]))
    return dets


@pytest.mark.parametrize("federated", [True, False])
@pytest.mark.parametrize("spread", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_segm_evaluator_equals_jax(lvis, seed, spread, federated):
    dets = jax_segm_records(lvis["gt"], seed, spread)
    gt = lambda: json.loads(json.dumps(lvis["gt"]))
    mine = LvisEvaluator(gt(), json.loads(json.dumps(dets)), iou_type="segm", federated=federated).run()
    ref = JLvisEvaluator(gt(), json.loads(json.dumps(dets)), iou_type="segm", federated=federated).run()
    assert list(mine) == list(ref)
    assert ref["AP"] > 0.05
    for key in ref:
        assert mine[key] == pytest.approx(ref[key], abs=1e-12), key


def test_segm_area_precedence_follows_lvis_results(lvis):
    """A record with a box keeps w x h as its area in segm mode, as JAX's
    evaluator gives it."""
    dets = jax_segm_records(lvis["gt"], 0)[:20]
    mine = LvisEvaluator(lvis["gt"], dets, iou_type="segm").dts_by_img_cat
    ref = JLvisEvaluator(lvis["gt"], dets, iou_type="segm").dts_by_img_cat
    assert mine.keys() == ref.keys()
    for key in ref:
        fields = lambda dts: [(d["id"], d["area"], d["bbox"]) for d in dts]
        assert fields(mine[key]) == fields(ref[key])
    d = LvisEvaluator(lvis["gt"], dets[:1], iou_type="segm").dts_by_img_cat
    (only,) = [x for v in d.values() for x in v]
    assert only["area"] == dets[0]["bbox"][2] * dets[0]["bbox"][3]


def test_test_cli_writes_jax_segmentations(lvis, tmp_path):
    """`infer_dataset` on a tiny GS Mask R-CNN's converted weights against
    JAX `predict_with_masks`, paste and encode on the same batches."""
    ann = lvis["ann"]
    jcfg = mask_config(use_gs=True)
    jmodel = jax_build_model(jcfg, partition=jpartition_from_lvis(ann, 9))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3), np.zeros((1, 128, 128, 3))))
    save_flax_checkpoint(variables, str(tmp_path / "jax.pt"))
    model = build_model(to_port(tconfig.DetectorConfig, jcfg), partition=partition_from_lvis(ann, 9))
    model.load_state_dict(restore_checkpoint(str(tmp_path / "jax.pt"))["model"])
    model.eval()
    ds = LvisDataset(ann, lvis["img_prefix"], test_mode=True)
    pcfg = PipelineConfig(scale=(128, 96))
    records, times = test_lvis.infer_dataset(model, ds, pcfg, batch_size=4)
    assert set(times) == {"preprocess", "predict", "records", "masks"}

    predict = jax.jit(lambda v, im, sh, sf: jmodel.apply(v, im, sh, sf, method="predict_with_masks"))
    want, near_pixels, parted = [], 0, 0
    for idxs, batch in test_lvis.bucket_batches(ds, pcfg, 4, len(ds), dict(preprocess=0.0)):
        dets, masks = predict(variables, batch["image"], batch["img_shape"], batch["scale_factor"])
        boxes, valid, masks = np.asarray(dets.boxes), np.asarray(dets.valid), np.asarray(masks, np.float32)
        for bi, idx in enumerate(idxs):
            info = ds.img_infos[idx]
            for i in np.flatnonzero(valid[bi]):
                args = (masks[bi, i], boxes[bi, i], info["height"], info["width"])
                near = jpaste_mask(*args, thr=0.5 - 1e-5) != jpaste_mask(*args, thr=0.5 + 1e-5)
                want.append((jrle.encode_mask(jpaste_mask(*args)), near))
    assert len(records) == len(want) == 8 * 10
    for r, (w, near) in zip(records, want):
        near_pixels += int(near.sum())
        if r["segmentation"] != w:
            parted += 1
            differ = rle.decode_rle(r["segmentation"]) != jrle.decode_rle(w)
            assert not (differ & ~near).any(), "pixels away from the threshold differ"
    print(f"{near_pixels} pasted pixels within 1e-5 of 0.5; {parted} of {len(records)} strings differ")
    assert parted <= near_pixels
    assert sum(bool(rle.decode_rle(r["segmentation"]).any()) for r in records) > len(records) // 2


def test_add_segmentations_encodes_the_valid_slots():
    rng = np.random.RandomState(4)
    masks = rng.rand(6, 28, 28).astype(np.float32)
    boxes = np.array([[10, 10, 50, 40]] * 6, np.float32) + rng.uniform(-5, 5, (6, 4)).astype(np.float32)
    valid = np.array([True, False, True, True, False, True])
    records = [dict(i=i) for i in np.flatnonzero(valid)]
    add_segmentations(records, masks, boxes, valid, 60, 80)
    for r in records:
        assert r["segmentation"] == jrle.encode_mask(jpaste_mask(masks[r["i"]], boxes[r["i"]], 60, 80))
