"""The BAGS flow's host modules of the PyTorch port against the JAX package's,
on the mini-LVIS fixture of tests/test_cli_e2e.py rebuilt by
`tools.mini_lvis.write_lvis_fixture` (its 6 landscape images draw for draw,
then 2 portrait ones, and the federated fields filled in).

Tolerances: the dataset, the partition, the samplers, the records and the
evaluator's metrics are numpy on both sides and must be equal (the metrics
to 1e-12); preprocessing runs the same cv2 and numpy operations, so boxes
must be bit-equal and images equal within 1e-6; tau-normalised fc_cls
weights within 1e-6 (f32 norms summed in another order).
"""

import importlib.util
import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.data import pipeline as jpipe
from balancedgroupsoftmax_tpu.data.lvis import LvisDataset as JLvisDataset
from balancedgroupsoftmax_tpu.eval.lvis_eval import LvisEvaluator as JLvisEvaluator
from balancedgroupsoftmax_tpu.eval.results import detections_to_records as jrecords
from balancedgroupsoftmax_tpu.gs import partition as jpart
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_tpu.utils.checkpoint import warm_start as jax_warm_start
from balancedgroupsoftmax_torch import apis
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.data import pipeline as tpipe
from balancedgroupsoftmax_torch.data.lvis import LvisDataset
from balancedgroupsoftmax_torch.eval.lvis_eval import LvisEvaluator
from balancedgroupsoftmax_torch.eval.results import detections_to_records
from balancedgroupsoftmax_torch.gs import partition as tpart
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture
from balancedgroupsoftmax_torch.utils.checkpoint import warm_start
from tests.test_detector import tiny_config, tiny_partition
from tests.test_lvis_eval_fixture import _synth_detections
from tests.test_torch_detector import to_port

ROOT = Path(__file__).resolve().parents[1]
SIZES = ((120, 160),) * 6 + ((160, 120),) * 2


@pytest.fixture(scope="module")
def lvis(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_lvis")
    ann, img_dir = write_lvis_fixture(str(root), image_sizes=SIZES, federated=True)
    return dict(root=root, ann=ann, img_prefix=img_dir, gt=json.loads(Path(ann).read_text()))


def test_fixture_is_the_cli_e2e_one(lvis, tmp_path):
    """The defaults rebuild tests/test_cli_e2e.py's fixture draw for draw."""
    from tests.test_cli_e2e import mini_lvis

    want = json.loads(Path(mini_lvis.__wrapped__(_Factory(tmp_path))["ann"]).read_text())
    ann, img_dir = write_lvis_fixture(str(tmp_path / "mine"))
    assert json.loads(Path(ann).read_text()) == want
    assert lvis["gt"]["annotations"][: len(want["annotations"])] == want["annotations"]
    for img in want["images"]:
        a = cv2.imread(str(tmp_path / "mini_lvis" / "images" / img["file_name"]))
        b = cv2.imread(str(Path(img_dir) / img["file_name"]))
        np.testing.assert_array_equal(a, b)


class _Factory:
    def __init__(self, base):
        self.base = base

    def mktemp(self, name):
        p = self.base / name
        p.mkdir()
        return p


@pytest.mark.parametrize("test_mode", [False, True])
def test_dataset_fields_equal_jax(lvis, test_mode):
    mine = LvisDataset(lvis["ann"], lvis["img_prefix"], test_mode=test_mode)
    ref = JLvisDataset(lvis["ann"], lvis["img_prefix"], test_mode=test_mode)
    for name in ("cat_ids", "cat2label", "label2cat", "class_names", "img_ids", "img_infos"):
        assert getattr(mine, name) == getattr(ref, name), name
    np.testing.assert_array_equal(mine.instance_counts(), ref.instance_counts())
    assert len(mine) == len(ref) == 8
    for i in range(len(ref)):
        a, b = mine.get_ann_info(i), ref.get_ann_info(i)
        for k in ("bboxes", "labels", "bboxes_ignore"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        assert a["masks"] == b["masks"]
        assert mine.federated_fields(i) == ref.federated_fields(i)
        assert mine.image_path(i) == ref.image_path(i)
    assert any(mine.federated_fields(i)[0] for i in range(len(mine)))


def _partition_arrays(p):
    return [p.label2binlabel, p.pred_slice, p.label2logit, p.label2bin]


@pytest.mark.parametrize("thresholds", [(10, 100, 1000), (100,)])
def test_partition_from_lvis_equal_and_files_cross_load(lvis, tmp_path, thresholds):
    mine = tpart.partition_from_lvis(lvis["ann"], 9, thresholds)
    ref = jpart.partition_from_lvis(lvis["ann"], 9, thresholds)
    for a, b in zip(_partition_arrays(mine), _partition_arrays(ref)):
        np.testing.assert_array_equal(a, b)
    tpart.save_partition(str(tmp_path / "port.npz"), mine)
    jpart.save_partition(str(tmp_path / "jax.npz"), ref)
    for a, b in zip(_partition_arrays(jpart.load_partition(str(tmp_path / "port.npz"))), _partition_arrays(ref)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_partition_arrays(tpart.load_partition(str(tmp_path / "jax.npz"))), _partition_arrays(mine)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rfs", [False, True])
def test_samplers_and_batcher_equal_jax(lvis, rfs):
    ds = LvisDataset(lvis["ann"], lvis["img_prefix"])
    labels = [ds.get_ann_info(i)["labels"] for i in range(len(ds))]
    flags = np.array([0 if i["width"] >= i["height"] else 1 for i in ds.img_infos], np.int64)
    repeat = None
    if rfs:
        repeat = tpipe.repeat_factors(labels, len(ds.cat_ids), t=0.5)
        np.testing.assert_array_equal(repeat, jpipe.repeat_factors(labels, len(ds.cat_ids), t=0.5))
        assert (repeat > 1).any()
        for seed in range(3):
            np.testing.assert_array_equal(
                tpipe.expand_indices_by_repeat(repeat, seed), jpipe.expand_indices_by_repeat(repeat, seed)
            )
    mine = tpipe.DetBatcher(flags, 2, seed=3, repeat=repeat)
    ref = jpipe.DetBatcher(flags, 2, seed=3, repeat=repeat)
    for epoch in range(3):
        a, b = mine.epoch_batches(epoch), ref.epoch_batches(epoch)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scale,train", [((1333, 800), False), ((1333, 800), True), ((128, 96), True)])
def test_preprocess_image_file_equals_jax(lvis, scale, train):
    ds = LvisDataset(lvis["ann"], lvis["img_prefix"])
    tcfg = tpipe.PipelineConfig(scale=scale)
    jcfg = jpipe.PipelineConfig(scale=scale)
    assert tcfg.buckets() == jcfg.buckets()
    flips = set()
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        mine = tpipe.preprocess_image_file(
            ds.image_path(i), ann["bboxes"].copy(), ann["labels"], tcfg, train, np.random.RandomState(i)
        )
        img = cv2.cvtColor(cv2.imread(ds.image_path(i)), cv2.COLOR_BGR2RGB)
        ref = jpipe.preprocess_image(img, ann["bboxes"].copy(), ann["labels"], jcfg, train, np.random.RandomState(i))
        np.testing.assert_array_equal(mine["gt_boxes"], ref["gt_boxes"])
        np.testing.assert_allclose(mine["image"], ref["image"], rtol=0, atol=1e-6)
        for k in ("gt_labels", "gt_mask", "img_shape", "scale_factor"):
            np.testing.assert_array_equal(mine[k], ref[k])
        assert mine["bucket"] == ref["bucket"] and mine["flipped"] == ref["flipped"]
        flips.add(mine["flipped"])
    assert flips == ({False, True} if train else {False})


def test_detections_to_records_equal_jax():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 100, (50, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    scores, labels, valid = rng.rand(50).astype(np.float32), rng.randint(0, 8, 50), rng.rand(50) < 0.7
    cat_ids = list(range(3, 11))
    assert detections_to_records(7, boxes, scores, labels, valid, cat_ids) == jrecords(
        7, boxes, scores, labels, valid, cat_ids
    )


@pytest.mark.parametrize("federated", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_equals_jax(lvis, seed, federated):
    dets = _synth_detections(lvis["gt"], seed)
    mine = LvisEvaluator(json.loads(json.dumps(lvis["gt"])), dets, federated=federated).run()
    ref = JLvisEvaluator(json.loads(json.dumps(lvis["gt"])), dets, federated=federated).run()
    assert list(mine) == list(ref)
    assert ref["AP"] > 0.05
    for key in ref:
        assert mine[key] == pytest.approx(ref[key], abs=1e-12), key


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_segm_equals_jax(lvis, seed):
    """The segm path (it raised before mask results were ported): notched
    box masks, JAX-encoded, with their boxes."""
    dets = _synth_detections(lvis["gt"], seed, segm=True)
    mine = LvisEvaluator(json.loads(json.dumps(lvis["gt"])), dets, iou_type="segm").run()
    ref = JLvisEvaluator(json.loads(json.dumps(lvis["gt"])), dets, iou_type="segm").run()
    assert list(mine) == list(ref) and ref["AP"] > 0.05
    for key in ref:
        assert mine[key] == pytest.approx(ref[key], abs=1e-12), key
    with pytest.raises(ValueError, match="bbox or segm"):
        LvisEvaluator(lvis["gt"], [], iou_type="keypoints")


def _jax_tau_norm():
    spec = importlib.util.spec_from_file_location("jax_test_lvis_cli", ROOT / "tools" / "test_lvis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tau_norm


@pytest.fixture(scope="module")
def tiny_variables():
    """The tiny GS and softmax detectors' flax variables (tests/test_detector.py)."""
    images = np.zeros((1, 128, 128, 3), np.float32)
    out = {}
    for use_gs in (True, False):
        model = jax_build_detector(tiny_config(use_gs=use_gs), partition=tiny_partition() if use_gs else None)
        out[use_gs] = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(int(use_gs)), images))
    return out


@pytest.mark.parametrize("skip_bg", [False, True])
def test_tau_norm_equals_jax(tiny_variables, skip_bg):
    variables = tiny_variables[True]
    ref = _jax_tau_norm()(variables["params"], 0.5, skip_bg=skip_bg)["bbox_head"]["fc_cls"]
    model = build_detector(to_port(tconfig.DetectorConfig, tiny_config(use_gs=True)), partition=tpart.make_partition(
        np.array([0, 5, 50, 500, 5000, 7, 70, 700, 7000])))
    model.load_state_dict(params_from_flax(variables))
    bias = model.bbox_head.fc_cls.bias.clone()
    apis.tau_norm(model.bbox_head.fc_cls, 0.5, skip_bg=skip_bg)
    np.testing.assert_allclose(model.bbox_head.fc_cls.weight.detach().numpy().T, ref["kernel"], rtol=0, atol=1e-6)
    assert torch.equal(model.bbox_head.fc_cls.bias, bias)


def test_warm_start_names_correspond_to_jax(tiny_variables):
    """Phase 2's warm start, tiny GS from tiny softmax: the JAX package's
    copied and fresh leaves are the port's copied and fresh parameters, leaf
    for tensor (each JAX leaf is tagged with its own constant and found again
    through `params_from_flax`); every BN statistic is copied, as the JAX CLI
    copies batch_stats whole."""
    gs, plain = tiny_variables[True], tiny_variables[False]
    _, copied, fresh = jax_warm_start(gs["params"], plain["params"])
    assert len(fresh) == 2

    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(gs["params"])]
    tag = {p: float(i + 1) for i, p in enumerate(paths)}
    tagged = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, tag[jax.tree_util.keystr(p)], np.float32), gs["params"]
    )
    port_of = {v: n for n, t in params_from_flax({"params": tagged, "batch_stats": gs["batch_stats"]}).items()
               if not n.endswith(("running_mean", "running_var")) for v in [float(t.flatten()[0])]}
    assert len(port_of) == len(paths)

    cfg = lambda use_gs: to_port(tconfig.DetectorConfig, tiny_config(use_gs=use_gs))
    model = build_detector(cfg(True), partition=tpart.make_partition(np.array([0, 5, 50, 500, 5000, 7, 70, 700, 7000])))
    mine_copied, mine_fresh = warm_start(model, params_from_flax(plain))
    params = {n for n, _ in model.named_parameters()}
    assert sorted(n for n in mine_copied if n in params) == sorted(port_of[tag[p]] for p in copied)
    assert sorted(mine_fresh) == sorted(port_of[tag[p]] for p in fresh) == ["bbox_head.fc_cls.bias", "bbox_head.fc_cls.weight"]
    assert {n for n in mine_copied if n not in params} == {n for n, _ in model.named_buffers()}
    loaded = params_from_flax(plain)
    for n, t in model.state_dict().items():
        if n in mine_copied:
            assert torch.equal(t, loaded[n]), n
