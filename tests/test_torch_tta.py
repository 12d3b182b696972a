"""Test-time augmentation of the PyTorch port against the JAX package.

- `ops/boxes.py` `bbox_flip`, `bbox_mapping` and `bbox_mapping_back`, and
  `eval/aug.py`'s five functions (the three merges, `flip_image_content`,
  `unflip_boxes`) against JAX's on the same seeded inputs, to 1e-6; `nms`
  against JAX `ops/nms.py nms` on rows with exact ties (equal).
- The detection-level merge (`merge_aug_detections`) against JAX's
  composition (tools/test_lvis.py:553-567: boxes offset by label x 1e5 in
  f64, cast to f32, `nms_keep` at 0.5, the kept sorted by score, top 300) at
  labels near 1230, where the f32 offsets snap coordinates to 8 px: the kept
  indices equal, and a pair the snapping merges is shown apart in f64.
- The three flows of the test CLI -- `--aug-rescore`, `--flip-aug` and
  `--aug-scales` -- through `tools.test_lvis.predict_aug` and
  `predict_masks`, on the tiny GS Mask R-CNN of tests/test_torch_mask_rcnn.py
  (weights converted by `convert.params_from_flax`), against JAX's pieces
  composed as tools/test_lvis.py:290-588 composes them: jitted `predict`,
  `propose`, `rescore` and `predict_masks` a bucket, JAX `ops/nms.py`, the
  JAX `eval/aug.py`. Views at a scale of (133, 100) with the multiplier
  0.5: 133 x 0.5 = 66.5 rounds to 66 (Python's `round`, halves to even).
  Bounds of tests/test_torch_cli.py: boxes 1e-4 px, scores 1e-5, labels
  and validity equal; masks 1e-5.
- The CLI takes the three flags and refuses them with `--tau-select`.

About 60 s on one worker, most of it JAX's compiles. PyTorch runs on one
thread (ROADMAP caveat v).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.data.pipeline import PipelineConfig as JPipelineConfig
from balancedgroupsoftmax_tpu.data.pipeline import preprocess_image as jax_preprocess_image
from balancedgroupsoftmax_tpu.eval import aug as jaug
from balancedgroupsoftmax_tpu.kernels import batched_multiclass_nms as jax_multiclass_nms
from balancedgroupsoftmax_tpu.models.detector import build_model as jax_build_model
from balancedgroupsoftmax_tpu.ops import boxes as jboxes
from balancedgroupsoftmax_tpu.ops import nms as jnms
from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig, preprocess_image
from balancedgroupsoftmax_torch.eval import aug as taug
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.ops import boxes as tboxes
from balancedgroupsoftmax_torch.ops import nms as tnms
from balancedgroupsoftmax_torch.tools import mini_lvis, test_lvis
from balancedgroupsoftmax_torch.utils.checkpoint import save_checkpoint
from balancedgroupsoftmax_torch import zoo
from tests.test_detector import tiny_partition
from test_torch_mask_rcnn import mask_config, port_model

SCALE = (133, 100)
MULT = 0.5  # 133 x 0.5 = 66.5: a half


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_boxes(rng, shape, k=1):
    xy = rng.uniform(0, 80, shape + (k, 2))
    wh = rng.uniform(5, 40, shape + (k, 2))
    return np.concatenate([xy, xy + wh], -1).reshape(shape + (4 * k,)).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_box_mapping_equals_jax(flip, k):
    rng = np.random.RandomState(k + 2 * flip)
    boxes = rand_boxes(rng, (2, 7), k)
    shapes = np.array([[100.0, 133.0], [96.0, 121.0]], np.float32)
    sfs = np.array([1.6625, 0.75], np.float32)
    close = lambda got, want: np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # one image, its (h, w) as numbers, and a batch with (B, 2) shapes and (B,) factors
    close(tboxes.bbox_flip(torch.from_numpy(boxes[0]), (100.0, 133.0)), jboxes.bbox_flip(boxes[0], (100.0, 133.0)))
    close(tboxes.bbox_flip(torch.from_numpy(boxes), torch.from_numpy(shapes)), jax.vmap(jboxes.bbox_flip)(boxes, shapes))
    for t_fn, j_fn in ((tboxes.bbox_mapping, jboxes.bbox_mapping), (tboxes.bbox_mapping_back, jboxes.bbox_mapping_back)):
        want = jax.vmap(lambda b, sh, sf: j_fn(b, sh, sf, flip))(boxes, shapes, sfs)
        close(t_fn(torch.from_numpy(boxes), torch.from_numpy(shapes), torch.from_numpy(sfs), flip), want)
        close(t_fn(torch.from_numpy(boxes[1]), (96.0, 121.0), 0.75, flip), j_fn(boxes[1], (96.0, 121.0), 0.75, flip))


def test_merges_and_flips_equal_jax():
    rng = np.random.RandomState(3)
    views = 3
    shapes = [(100.0, 133.0), (50.0, 66.0), (100.0, 133.0)]
    sfs = [1.6625, 0.825, 1.6625]
    flips = [False, False, True]
    boxes = [rand_boxes(rng, (40,)) for _ in range(views)]
    scores = [rng.rand(40).astype(np.float32) for _ in range(views)]
    valid = [rng.rand(40) > 0.2 for _ in range(views)]
    # JAX merges one image: the port's batch holds it and the same views reversed
    two = lambda xs: [torch.from_numpy(np.stack([x, x[::-1].copy()])) for x in xs]
    got = taug.merge_aug_proposals(two(boxes), two(scores), two(valid), [torch.tensor([s, s]) for s in shapes],
                                   [torch.tensor([f, f]) for f in sfs], flips, 0.7, 50)
    for i in range(2):
        rev = lambda xs: [x[::-1].copy() for x in xs] if i else xs
        want = jaug.merge_aug_proposals(rev(boxes), rev(scores), [jnp.asarray(v) for v in rev(valid)], shapes, sfs,
                                        flips, 0.7, 50)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=0, atol=1e-6)

    cls_boxes = [rand_boxes(rng, (30,), 3) for _ in range(views)]
    cls_scores = [rng.rand(30, 3).astype(np.float32) for _ in range(views)]
    wb, ws = jaug.merge_aug_bboxes(cls_boxes, cls_scores, shapes, sfs, flips)
    gb, gs = taug.merge_aug_bboxes([torch.from_numpy(x) for x in cls_boxes], [torch.from_numpy(x) for x in cls_scores],
                                   shapes, sfs, flips)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)

    masks = [rng.rand(5, 28, 28).astype(np.float32) for _ in range(views)]
    np.testing.assert_allclose(taug.merge_aug_masks(masks, flips), jaug.merge_aug_masks(masks, flips), rtol=0, atol=1e-6)

    images = rng.randn(2, 32, 48, 3).astype(np.float32)
    img_shapes = np.array([[32.0, 41.0], [30.0, 48.0]], np.float32)
    want = jaug.flip_image_content(images, img_shapes)
    np.testing.assert_array_equal(taug.flip_image_content(images, img_shapes), want)
    np.testing.assert_array_equal(taug.flip_image_content(torch.from_numpy(images), img_shapes).numpy(), want)
    assert not np.array_equal(want[0, :, 41:], images[0, :, 41:][:, ::-1])  # the pad is not flipped in
    np.testing.assert_array_equal(want[0, :, 41:], images[0, :, 41:])

    det = rand_boxes(rng, (20,))
    np.testing.assert_allclose(taug.unflip_boxes(det, 121.0, 0.75), jaug.unflip_boxes(det, 121.0, 0.75), rtol=0, atol=1e-6)


def tie_rows(seed, g=3, n=64):
    """Rows with exact duplicates and equal scores (the stable sort's ties)."""
    rng = np.random.RandomState(seed)
    boxes = rand_boxes(rng, (g, n))
    boxes[:, 1::5] = boxes[:, 0::5][:, : boxes[:, 1::5].shape[1]]
    scores = rng.choice([0.25, 0.5, 0.75], (g, n)).astype(np.float32)
    return boxes, scores, rng.rand(g, n) > 0.1


@pytest.mark.parametrize("max_out", [20, 100])  # 100 > 64: padded with invalid slots
def test_nms_equals_jax(max_out):
    boxes, scores, valid = tie_rows(max_out)
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.5, max_out)
    want = jax.vmap(lambda b, s, v: jnms.nms(b, s, v, 0.5, max_out))(boxes, scores, valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = tnms.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jax.vmap(lambda b, s, v: jnms.nms_keep(b, s, v, 0.5))(
        boxes, scores, valid)))


def jax_merge(boxes, scores, labels, valid):
    """JAX tools/test_lvis.py:553-567, image by image."""
    kept = []
    for bi in range(len(boxes)):
        off = labels[bi][:, None].astype(np.float64) * 1e5
        keep = np.asarray(jnms.nms_keep(jnp.asarray(boxes[bi] + off), jnp.asarray(scores[bi]),
                                        jnp.asarray(valid[bi]), 0.5))
        k = np.where(keep & valid[bi])[0]
        kept.append(k[np.argsort(-scores[bi][k], kind="stable")][:300])
    return kept


def test_detection_merge_equals_jax_at_high_labels():
    rng = np.random.RandomState(5)
    b, n = 2, 400
    boxes = rand_boxes(rng, (b, n))
    boxes[:, 1::4] = boxes[:, 0::4] + rng.uniform(-3, 3, boxes[:, 0::4].shape).astype(np.float32)  # near copies
    scores = rng.rand(b, n).astype(np.float32)
    scores[:, 2::7] = scores[:, 3::7][:, : scores[:, 2::7].shape[1]]  # equal scores
    labels = rng.randint(1222, 1230, (b, n)).astype(np.int32)
    valid = rng.rand(b, n) > 0.1
    got = taug.merge_aug_detections(boxes, scores, labels, valid, torch.device("cpu"))
    want = jax_merge(boxes, scores, labels, valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(100 < len(g) <= 300 for g in got)

    # at 1229 x 1e5 the f32 steps are 8 px: [0, 0, 9, 9] and [3.9, 0, 12.9, 9]
    # (IoU 0.439) snap to [0, 0, 8, 8] and [0, 0, 16, 8] (IoU 0.529): merged
    two = np.array([[[0.0, 0.0, 9.0, 9.0], [3.9, 0.0, 12.9, 9.0], [60.0, 0.0, 69.0, 9.0]]], np.float32)
    s, lab, v = np.array([[0.9, 0.8, 0.7]], np.float32), np.full((1, 3), 1229, np.int32), np.ones((1, 3), bool)
    exact = tboxes.bbox_overlaps(*(torch.from_numpy(two[0, i : i + 1].astype(np.float64) + 1229e5) for i in (0, 1)))
    assert exact.item() < 0.5
    assert [list(k) for k in taug.merge_aug_detections(two, s, lab, v, torch.device("cpu"))] == [[0, 2]]
    assert [list(k) for k in jax_merge(two, s, lab, v)] == [[0, 2]]
    lab[0, 1] = 1228  # another class: both kept
    assert [list(k) for k in taug.merge_aug_detections(two, s, lab, v, torch.device("cpu"))] == [[0, 1, 2]]


def test_views_round_halves_to_even():
    raw = np.random.RandomState(0).randint(0, 255, (60, 80, 3), np.uint8)
    pcfg = PipelineConfig(scale=SCALE)
    batch = test_lvis.stack_batch([preprocess_image(raw, cfg=pcfg)] * 2)
    batch["raw"] = [raw, raw]
    views = test_lvis.make_views(batch, pcfg, test_lvis.Aug(flip=True, scales=(MULT,)), torch.device("cpu"))
    assert [v.flip for v in views] == [False, True, False, True]
    assert views[2].shapes[0].tolist() == [50.0, 66.0] and tuple(views[2].images.shape[1:3]) == (64, 96)
    want = jax_preprocess_image(raw, np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                                JPipelineConfig(scale=(round(133 * MULT), round(100 * MULT))), False)
    np.testing.assert_array_equal(views[2].images[0].numpy(), want["image"])
    np.testing.assert_array_equal(views[3].images[0].numpy(), jaug.flip_image_content(want["image"][None],
                                                                                        want["img_shape"][None])[0])


@pytest.fixture(scope="module")
def mask_model():
    jcfg = mask_config(use_gs=True)
    # the full-width cap, so the detection-level merge's top 300 fit
    jcfg = dataclasses.replace(jcfg, rcnn_test=dataclasses.replace(jcfg.rcnn_test, max_per_img=300))
    jmodel = jax_build_model(jcfg, partition=tiny_partition())
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))))
    raws = [np.random.RandomState(s).randint(0, 255, (60, 80, 3), np.uint8) for s in (1, 2)]
    return dict(jcfg=jcfg, variables=variables, model=port_model(jcfg, variables, True).eval(), raws=raws, fns={})


def jax_fns(m, bucket):
    """The CLI's jitted functions of one bucket (tools/test_lvis.py:230-268, :285-321)."""
    if bucket not in m["fns"]:
        jm = jax_build_model(dataclasses.replace(m["jcfg"], image_size=bucket), partition=tiny_partition())
        m["fns"][bucket] = dict(
            predict=jax.jit(lambda v, im, sh, sf: jm.apply(v, im, sh, sf, method="predict")),
            propose=jax.jit(lambda v, im, sh: jm.apply(v, im, sh, method="propose")),
            rescore=jax.jit(lambda v, im, r, sh: jm.apply(v, im, r, sh, method="rescore")),
            masks=jax.jit(lambda v, im, db, dl, sf: jm.apply(v, im, db, dl, sf, method="predict_masks")),
        )
    return m["fns"][bucket]


def jax_views(raws, aug):
    """(bucket, flip, images, shapes, sfs) in the CLI's order, from JAX's preprocessing."""
    views = []
    for mult in (1.0,) + aug.scales:
        cfg = JPipelineConfig(scale=(round(SCALE[0] * mult), round(SCALE[1] * mult)))
        sm = [jax_preprocess_image(r, np.zeros((0, 4), np.float32), np.zeros(0, np.int32), cfg, False) for r in raws]
        im, sh, sf = (np.stack([s[k] for s in sm]) for k in ("image", "img_shape", "scale_factor"))
        views.append((sm[0]["bucket"], False, im, sh, sf))
        if aug.flip:
            views.append((sm[0]["bucket"], True, jaug.flip_image_content(im, sh), sh, sf))
    return views


def jax_aug(m, aug):
    """JAX tools/test_lvis.py:290-588 over one batch: (boxes, scores, labels,
    valid, masks) of the merged detections."""
    v, c = m["variables"], m["jcfg"]
    views = jax_views(m["raws"], aug)
    flip_b = lambda b, sh: jax.vmap(jboxes.bbox_flip)(b, sh)
    if aug.rescore:
        parts = []
        for bucket, fl, im, sh, sf in views:
            pr = jax_fns(m, bucket)["propose"](v, im, sh)
            b = flip_b(pr.boxes, sh) if fl else pr.boxes
            parts.append((b / sf[:, None, None], pr.scores, pr.valid))
        t = c.rpn_proposal_test
        merged_b, _, merged_v = jax.vmap(lambda b, s, vv: jnms.nms(b, s, vv, t.nms_thr, t.max_num))(
            *(jnp.concatenate([p[i] for p in parts], axis=1) for i in range(3)))
        box_acc = scr_acc = None
        for bucket, fl, im, sh, sf in views:
            r = merged_b * sf[:, None, None]
            r = flip_b(r, sh) if fl else r
            bx, sc = jax_fns(m, bucket)["rescore"](v, im, r, sh)
            bx = (flip_b(bx, sh) if fl else bx) / sf[:, None, None]
            box_acc = bx if box_acc is None else box_acc + bx
            scr_acc = sc if scr_acc is None else scr_acc + sc
        nv = float(len(views))
        r = c.rcnn_test
        out = [np.array(x) for x in jax_multiclass_nms(
            box_acc / nv, scr_acc / nv, merged_v, r.score_thr, r.nms_iou_thr, r.max_per_img,
            candidates_per_class=r.nms_candidates_per_class, nms_type=r.nms_type)]
    else:
        dets = []
        for bucket, fl, im, sh, sf in views:
            d = [np.array(x) for x in jax_fns(m, bucket)["predict"](v, im, sh, sf)]
            if fl:
                d[0] = np.stack([jaug.unflip_boxes(d[0][bi], float(sh[bi][1]), float(sf[bi])) for bi in range(len(sh))])
            dets.append(d)
        out = [x.copy() for x in dets[0]]
        cat = [np.concatenate([d[i] for d in dets], axis=1) for i in range(4)]
        for bi, kept in enumerate(jax_merge(*cat)):
            for o, src in zip(out, cat):
                o[bi] = 0
                o[bi, : len(kept)] = src[bi, kept]
    bucket, _, im, _, sf = views[0]
    out.append(np.asarray(jax_fns(m, bucket)["masks"](v, im, out[0], out[2], sf)))
    return out


@pytest.mark.parametrize(
    "aug",
    [
        test_lvis.Aug(flip=True, scales=(MULT,), rescore=True),
        test_lvis.Aug(flip=True),
        test_lvis.Aug(scales=(MULT,)),
    ],
    ids=["aug-rescore", "flip-aug", "aug-scales"],
)
def test_flows_equal_jax(mask_model, aug):
    m = mask_model
    model = m["model"]
    pcfg = PipelineConfig(scale=SCALE)
    batch = test_lvis.stack_batch([preprocess_image(r, cfg=pcfg) for r in m["raws"]])
    batch["raw"] = m["raws"]
    dets = test_lvis.predict_aug(model, batch, pcfg, aug)
    masks = model.predict_masks(torch.from_numpy(batch["image"]), dets.boxes, dets.labels,
                                torch.from_numpy(batch["scale_factor"]))
    want = jax_aug(m, aug)
    np.testing.assert_array_equal(dets.valid.numpy(), want[3])
    np.testing.assert_array_equal(dets.labels.numpy(), want[2])
    np.testing.assert_allclose(dets.scores.numpy(), want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dets.boxes.numpy(), want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks.numpy(), want[4], rtol=0, atol=1e-5)
    assert want[3].sum() > 20


def test_cli_takes_the_flags_and_tau_select_refuses_them(tmp_path, monkeypatch):
    """The flags reach `predict_aug` with the decoded raw images (the flows
    themselves are held above), and `--tau-select` refuses them."""
    ann, imgs = mini_lvis.write_lvis_fixture(str(tmp_path / "lvis"), image_sizes=((120, 160),) * 3)
    model = build_detector(zoo.faster_rcnn_r50_fpn_lvis(num_classes=9)).init_weights(3)
    save_checkpoint(str(tmp_path / "c.pt"), {"model": model.state_dict()}, meta={})
    base = ["--model", "faster_rcnn_r50", "--ann", ann, "--img-prefix", imgs, "--checkpoint", str(tmp_path / "c.pt"),
            "--scale", "128", "96", "--batch-size", "2", "--device", "cpu", "--no-eval"]
    seen = []

    def record(model, batch, pcfg, aug):
        seen.append((aug, [r.shape for r in batch["raw"]], pcfg.scale))
        none = torch.zeros(2, 1, dtype=torch.bool)
        return test_lvis.Detections(torch.zeros(2, 1, 4), torch.zeros(2, 1), torch.zeros(2, 1, dtype=torch.int32), none)

    monkeypatch.setattr(test_lvis, "predict_aug", record)
    test_lvis.main(base + ["--aug-rescore", "--flip-aug", "--aug-scales", "0.5", "1.25"])
    # a full batch, then the last image filled up
    assert seen == [(test_lvis.Aug(True, (0.5, 1.25), True), [(120, 160, 3)] * 2, (128, 96))] * 2
    with pytest.raises(SystemExit, match="single-view"):
        test_lvis.main(base + ["--tau-select", "1.0", "--flip-aug"])
