"""The detector variants through the port's configs, API and CLIs:

- the zoo's four variant configurations and their `TRAIN_CONFIGS` equal
  JAX `zoo.py`'s (81 classes by default, and at LVIS's 1231);
- `apis.MODELS` and both CLIs take `grid_rcnn_r50`, `mask_scoring_rcnn_r50`
  and `double_head_rcnn_r50`; Fast R-CNN stays API-only, as in JAX;
- the CLIs' class count: the port's zoo constructors size every head to the
  dataset (JAX's CLIs resize only `bbox_head`; ROADMAP §C);
- a record's "segm_score" ranks it in the segm evaluator, as in JAX's
  (the two equal to 1e-12), and leaves the bbox evaluator alone;
- the train CLI (one step with the gt crops) and then the test CLI on
  `mask_scoring_rcnn_r50` at 128 x 96 on the mini fixture: "loss_mask_iou"
  logged, every head of the checkpoint at the fixture's 9 classes, segm
  records carrying "segm_score", and the segm table ranked by it.

PyTorch runs on one CPU thread in this file (ROADMAP caveat v).
"""

import json

import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import zoo as jzoo
from balancedgroupsoftmax_tpu.eval.lvis_eval import LvisEvaluator as JLvisEvaluator
from balancedgroupsoftmax_torch import apis
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo as tzoo
from balancedgroupsoftmax_torch.eval.lvis_eval import LvisEvaluator
from balancedgroupsoftmax_torch.models.detector import build_model
from balancedgroupsoftmax_torch.tools import test_lvis, train
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture
from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint
from test_torch_detector import to_port
from test_torch_segm import jax_segm_records

VARIANT_ZOO = ("fast_rcnn_r50_fpn", "grid_rcnn_r50_fpn", "mask_scoring_rcnn_r50_fpn", "double_head_rcnn_r50_fpn")
CLI_MODELS = ("grid_rcnn_r50", "mask_scoring_rcnn_r50", "double_head_rcnn_r50")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", VARIANT_ZOO)
@pytest.mark.parametrize("num_classes", [None, 1231])
def test_zoo_variants_match_jax_zoo(name, num_classes):
    kw = {} if num_classes is None else dict(num_classes=num_classes)
    jdet, jtrain = getattr(jzoo, name)(**kw)
    assert getattr(tzoo, name)(**kw) == to_port(tconfig.DetectorConfig, jdet)
    assert tzoo.TRAIN_CONFIGS[name] == to_port(tconfig.TrainConfig, jtrain)
    assert jdet.bbox_head.num_classes == (num_classes or 81)


def test_the_clis_take_the_variant_models():
    assert set(CLI_MODELS) <= set(apis.MODELS)
    assert not any(name.startswith("fast_rcnn") for name in apis.MODELS)  # API-only, as in JAX
    common = ["--ann", "a.json", "--img-prefix", "img", "--device", "cpu"]
    for name in CLI_MODELS:
        assert train.parse_args(["--model", name, *common, "--work-dir", "w"]).model == name
        assert test_lvis.parse_args(["--model", name, *common, "--checkpoint", "c.pt"]).model == name
    with pytest.raises(SystemExit):
        train.parse_args(["--model", "fast_rcnn_r50", *common, "--work-dir", "w"])


@pytest.mark.parametrize("name", CLI_MODELS)
def test_cli_constructors_size_every_head_to_the_dataset(name):
    """The CLIs build `MODELS[name][0](num_classes=dataset classes)`: every
    head at the dataset's classes, mmdet's configs' rule. (JAX's CLIs
    replace only `bbox_head.num_classes`, so its `mask_scoring_rcnn_r50` on
    LVIS keeps an 81-class mask head and an 80-way MaskIoU head.)"""
    cfg = apis.MODELS[name][0](num_classes=9)
    assert cfg.bbox_head.num_classes == 9 and cfg.variant.kind == name[: -len("_rcnn_r50")]
    model = build_model(cfg)
    assert model.bbox_head.fc_cls.out_features == 9 and model.bbox_head.fc_reg.out_features == 36
    if name == "mask_scoring_rcnn_r50":
        assert cfg.mask_head.num_classes == 9
        assert model.mask_head.conv_logits.out_channels == 8 and model.mask_iou_head.fc_mask_iou.out_features == 8
    else:
        assert cfg.mask_head is None


def scored(gt, seed=0):
    """`jax_segm_records` with a seeded "segm_score" each, whose order
    differs from the scores'."""
    dets = jax_segm_records(gt, seed)
    rng = np.random.RandomState(7)
    for d in dets:
        d["segm_score"] = float(rng.rand())
    return dets


@pytest.fixture(scope="module")
def lvis(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_lvis")
    ann, imgs = write_lvis_fixture(str(root), image_sizes=((120, 160),) * 2 + ((160, 120),) * 2, federated=True)
    return dict(ann=ann, imgs=imgs, gt=json.loads(open(ann).read()))


def test_segm_score_ranks_the_segm_evaluation_alone(lvis):
    gt = lambda: json.loads(json.dumps(lvis["gt"]))
    dets = scored(lvis["gt"])
    plain = [{k: v for k, v in d.items() if k != "segm_score"} for d in dets]
    run = lambda cls, records, iou_type: cls(gt(), json.loads(json.dumps(records)), iou_type=iou_type).run()
    mine, ref = run(LvisEvaluator, dets, "segm"), run(JLvisEvaluator, dets, "segm")
    assert list(mine) == list(ref)
    for key in ref:
        assert mine[key] == pytest.approx(ref[key], abs=1e-12), key
    # ranked by segm_score: as if it were the score, and not as by the score
    assert mine == run(LvisEvaluator, [dict(p, score=d["segm_score"]) for d, p in zip(dets, plain)], "segm")
    assert mine["AP"] != run(LvisEvaluator, plain, "segm")["AP"]
    assert run(LvisEvaluator, dets, "bbox") == run(LvisEvaluator, plain, "bbox")


def test_train_and_test_cli_on_mask_scoring_rcnn(lvis, tmp_path):
    """One `mask_scoring_rcnn_r50` step through the train CLI (the
    full-width R50, the fixture's 9 classes, 128 x 96) with the gt crops in
    its batch, then the test CLI on its checkpoint: segm records with their
    "segm_score", and the segm table ranked by it."""
    common = ["--ann", lvis["ann"], "--img-prefix", lvis["imgs"], "--device", "cpu", "--scale", "128", "96",
              "--batch-size", "2"]
    out = train.main(["--model", "mask_scoring_rcnn_r50", *common, "--work-dir", str(tmp_path / "w"),
                      "--selectp", "0", "--max-steps", "1", "--log-interval", "1"])
    logged = out["log"][0]
    assert all(np.isfinite(logged[k]) and logged[k] > 0 for k in ("loss_mask", "loss_mask_iou"))
    sd = restore_checkpoint(out["checkpoint"])["model"]
    assert sd["bbox_head.fc_cls.weight"].shape[0] == 9 and sd["mask_head.conv_logits.weight"].shape[0] == 8
    assert sd["mask_iou_head.fc_mask_iou.weight"].shape == (8, 1024)
    res = test_lvis.main(["--model", "mask_scoring_rcnn_r50", *common, "--checkpoint", out["checkpoint"],
                          "--out", str(tmp_path / "res.json")])
    records = json.loads((tmp_path / "res.json").read_text())
    # the score times the predicted IoU of the class, a linear output
    assert records and all("segmentation" in r and np.isfinite(r["segm_score"]) for r in records)
    assert any(r["segm_score"] != r["score"] for r in records)
    segm = res["segm_evaluator"]
    assert segm is not None and segm.iou_type == "segm"
    ranked = [dict({k: v for k, v in r.items() if k != "segm_score"}, score=r["segm_score"]) for r in records]
    assert segm.results == LvisEvaluator(json.loads(json.dumps(lvis["gt"])), ranked, iou_type="segm").run()
    assert res["evaluator"].results == LvisEvaluator(
        json.loads(json.dumps(lvis["gt"])), records, iou_type="bbox").run()
