"""The port's CLIs end to end on the CPU (`python -m
balancedgroupsoftmax_torch.tools.*`, one thread, `--device cpu`, images
resized to 128 x 96), and its test loop against the JAX package.

The flow: gs_partition -> phase 1 (faster_rcnn_r50, selectp 0, from a
synthetic torchvision-layout backbone) -> phase 2 (gs_faster_rcnn_r50,
warm-started from phase 1, selectp 1) -> test_lvis -> eval_lvis, on the
mini-LVIS fixture of tests/test_torch_lvis_flow.py. A run resumed after 1
step must end bit-equal to an uninterrupted run of 2 steps (one thread, the
same data order, flips and sampling draws).

The slice against JAX: the tiny GS Faster R-CNN of tests/test_detector.py
(flax variables written as a port checkpoint by
`convert.save_flax_checkpoint`) through `tools.test_lvis.infer_dataset`
against JAX `predict` -> `detections_to_records` on the same preprocessed
batches: the same count, images and categories, boxes within 1e-4 px,
scores within 1e-5 (the tolerances of tests/test_torch_detector.py's
detections, whose boxes are 1e-6 relative), and the same AP table.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.eval.lvis_eval import LvisEvaluator as JLvisEvaluator
from balancedgroupsoftmax_tpu.eval.results import detections_to_records as jrecords
from balancedgroupsoftmax_tpu.gs.partition import partition_from_lvis as jpartition_from_lvis
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import save_flax_checkpoint
from balancedgroupsoftmax_torch.data.lvis import LvisDataset
from balancedgroupsoftmax_torch.data.pipeline import PipelineConfig
from balancedgroupsoftmax_torch.gs.partition import partition_from_lvis
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.models.resnet import ResNet
from balancedgroupsoftmax_torch.tools import test_lvis, train
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture
from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint
from tests.test_detector import tiny_config
from tests.test_torch_detector import to_port

ROOT = Path(__file__).resolve().parents[1]
SIZES = ((120, 160),) * 6 + ((160, 120),) * 2
SCALE = ["--scale", "128", "96"]


def cli(name, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"balancedgroupsoftmax_torch.tools.{name}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )


def ok(out):
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def torchvision_resnet50(path):
    """A torchvision-layout ResNet-50 state_dict: the port's names without
    "backbone.", plus `fc` and BN's `num_batches_tracked`, seeded values and
    BN statistics away from identity."""
    gen = torch.Generator().manual_seed(5)
    sd = {}
    for name, t in ResNet(50).state_dict().items():
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=gen) + 0.5
        elif name.endswith(("running_mean", "bn1.bias", "bn2.bias", "bn3.bias")):
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
        elif t.dim() == 4:
            sd[name] = torch.randn(t.shape, generator=gen) / t[0].numel() ** 0.5
        else:
            sd[name] = t.clone()
        if name.endswith("running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 2048, generator=gen), torch.zeros(1000)
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_flow")
    ann, imgs = write_lvis_fixture(str(root / "lvis"), image_sizes=SIZES, federated=True)
    part = str(root / "part.npz")
    backbone = torchvision_resnet50(root / "resnet50.pth")
    common = ["--ann", ann, "--img-prefix", imgs, *SCALE, "--device", "cpu", "--batch-size", "2"]
    phase1 = ["--model", "faster_rcnn_r50", *common, "--selectp", "0", "--log-interval", "1",
              "--pretrained-backbone", str(root / "resnet50.pth")]
    phase2 = ["--model", "gs_faster_rcnn_r50", *common, "--partition", part, "--log-interval", "1"]
    w = lambda name: str(root / name)
    out = dict(root=root, ann=ann, part=part, backbone=backbone, w=w)
    out["partition"] = ok(cli("gs_partition", "--ann", ann, "--out", part, "--num-classes", "9"))
    out["p1_first"] = ok(cli("train", *phase1, "--work-dir", w("p1a"), "--max-steps", "1"))
    out["p1_resumed"] = ok(cli("train", *phase1, "--work-dir", w("p1b"), "--max-steps", "2",
                               "--resume-from", w("p1a/ckpt_epoch_1.pt")))
    out["p1_straight"] = ok(cli("train", *phase1, "--work-dir", w("p1c"), "--max-steps", "2"))
    out["p2"] = ok(cli("train", *phase2, "--work-dir", w("p2"), "--max-steps", "1", "--selectp", "1",
                       "--load-from", w("p1c/ckpt_epoch_1.pt")))
    out["refused"] = cli("train", *phase2, "--work-dir", w("p3"), "--max-steps", "2", "--selectp", "0",
                         "--resume-from", w("p2/ckpt_epoch_1.pt"))
    out["test"] = ok(cli("test_lvis", "--model", "gs_faster_rcnn_r50", *common, "--partition", part,
                         "--checkpoint", w("p2/ckpt_epoch_1.pt"), "--out", w("results.json")))
    out["eval"] = ok(cli("eval_lvis", "--ann", ann, "--result", w("results.json")))
    return out


def test_partition_cli(flow):
    assert "5 bins, slice sizes (2, 1, 3, 3, 5), 14 logits" in flow["partition"]
    assert np.load(flow["part"])["label2logit"].shape == (9,)


def test_phase1_starts_from_the_torchvision_backbone(flow):
    assert "backbone warm start: 265 tensors" in flow["p1_first"]
    model = restore_checkpoint(flow["w"]("p1c/ckpt_epoch_1.pt"))["model"]
    # the stem and layer1 are frozen, so they keep the torchvision values
    for name in ("conv1.weight", "bn1.running_var", "layer1.0.conv2.weight", "layer1.2.bn3.bias"):
        assert torch.equal(model[f"backbone.{name}"], flow["backbone"][name]), name
    assert not torch.equal(model["backbone.layer4.2.conv3.weight"], flow["backbone"]["layer4.2.conv3.weight"])
    lines = [json.loads(l) for l in Path(flow["w"]("p1c/train_log.jsonl")).read_text().splitlines()]
    assert [l["step"] for l in lines] == [1, 2] and all(np.isfinite(l["loss"]) for l in lines)
    meta = json.loads(Path(flow["w"]("p1c/ckpt_epoch_1.meta.json")).read_text())
    assert meta["step"] == 2 and meta["model"] == "faster_rcnn_r50" and len(meta["classes"]) == 8


def test_resume_equals_uninterrupted(flow):
    assert "resumed from" in flow["p1_resumed"] and "at step 1 (with optimizer state), epoch 0 batch 1" in flow["p1_resumed"]
    a = restore_checkpoint(flow["w"]("p1b/ckpt_epoch_1.pt"))
    b = restore_checkpoint(flow["w"]("p1c/ckpt_epoch_1.pt"))
    assert a["model"].keys() == b["model"].keys()
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    sa, sb = a["train"]["optimizer"]["state"], b["train"]["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 100
    for i in sa:
        assert torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]), i
    assert a["train"]["scheduler"] == b["train"]["scheduler"]
    assert a["train"]["step"] == b["train"]["step"] == 2
    assert torch.equal(a["train"]["generator"], b["train"]["generator"])
    assert a["loader"] == b["loader"] == {"epoch": 0, "batch": 2}


def test_resume_refuses_another_selectp(flow):
    assert flow["refused"].returncode != 0
    assert "refusing to resume" in flow["refused"].stderr and "selectp" in flow["refused"].stderr


def test_phase2_warm_start_moves_only_fc_cls(flow):
    assert "copied 293, fresh 2 (bbox_head.fc_cls.weight, bbox_head.fc_cls.bias)" in flow["p2"]
    assert "loss_cls_bin4" in flow["p2"]
    p1 = restore_checkpoint(flow["w"]("p1c/ckpt_epoch_1.pt"))["model"]
    p2 = restore_checkpoint(flow["w"]("p2/ckpt_epoch_1.pt"))
    assert p2["train"]["trained"] == ["bbox_head.fc_cls.weight", "bbox_head.fc_cls.bias"]
    assert p2["model"]["bbox_head.fc_cls.weight"].shape == (9 + 5, 1024)
    for name, t in p2["model"].items():
        if "fc_cls" not in name:
            assert torch.equal(t, p1[name]), name


def test_eval_prints_the_test_table(flow):
    test, ev = flow["test"], flow["eval"]
    assert "inference done: 8 images" in test and "wrote" in test
    table = test[test.index("bbox results:"):]
    assert ev.strip() == table.strip()
    assert "|  (AP)  | 0.50:0.95 |    all | 300 |          all |" in table
    records = json.loads(Path(flow["w"]("results.json")).read_text())
    assert {r["image_id"] for r in records} == set(range(1, 9))
    assert all(np.isfinite(r["bbox"]).all() and 0 <= r["score"] <= 1 for r in records)


def test_init_detector_reads_a_train_checkpoint(tmp_path):
    from balancedgroupsoftmax_torch import apis, zoo
    from balancedgroupsoftmax_torch.gs.partition import synthetic_partition
    from balancedgroupsoftmax_torch.utils.checkpoint import save_checkpoint

    model = build_detector(zoo.gs_faster_rcnn_r50_fpn_lvis(), partition=synthetic_partition(1231)).init_weights(3)
    save_checkpoint(str(tmp_path / "c.pt"), {"model": model.state_dict(), "train": {}, "loader": {}}, meta={})
    det = apis.init_detector("gs_faster_rcnn_r50", checkpoint=str(tmp_path / "c.pt"), device="cpu")
    for name, t in det.model.state_dict().items():
        assert torch.equal(t, model.state_dict()[name]), name
    assert (tmp_path / "c.meta.json").exists()


def test_clis_refuse_without_a_card(flow, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--ann", flow["ann"], "--img-prefix", "x"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main([*args, "--work-dir", str(flow["root"] / "nocard")])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_lvis.main([*args, "--checkpoint", "x"])
    assert not (flow["root"] / "nocard").exists()


def test_rfs_refuses_a_noop(flow, capsys):
    with pytest.raises(SystemExit, match="no-op"):
        train.main(["--ann", flow["ann"], "--img-prefix", "x", "--work-dir", str(flow["root"] / "rfs"),
                    "--device", "cpu", "--use-rfs", "--rfs-t", "0.001"])


def test_test_loop_equals_jax_predict(flow, tmp_path):
    """`infer_dataset` on converted weights against JAX `predict`."""
    ann = flow["ann"]
    jcfg = tiny_config(use_gs=True)
    jmodel = jax_build_detector(jcfg, partition=jpartition_from_lvis(ann, 9))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 128, 128, 3))))
    save_flax_checkpoint(variables, str(tmp_path / "jax.pt"))

    model = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=partition_from_lvis(ann, 9))
    model.load_state_dict(restore_checkpoint(str(tmp_path / "jax.pt"))["model"])
    model.eval()
    ds = LvisDataset(ann, str(flow["root"] / "lvis" / "images"), test_mode=True)
    pcfg = PipelineConfig(scale=(128, 96))
    records, times = test_lvis.infer_dataset(model, ds, pcfg, batch_size=4)
    assert set(times) == {"preprocess", "predict", "records"}

    predict = jax.jit(lambda v, im, sh, sf: jmodel.apply(v, im, sh, sf, method="predict"))
    want, buckets = [], []
    for idxs, batch in test_lvis.bucket_batches(ds, pcfg, 4, len(ds), dict(preprocess=0.0)):
        dets = predict(variables, batch["image"], batch["img_shape"], batch["scale_factor"])
        boxes, scores, labels, valid = (np.asarray(x) for x in dets)
        buckets.append((batch["image"].shape[1:3], len(idxs)))
        for bi, idx in enumerate(idxs):
            want += jrecords(ds.img_infos[idx]["id"], boxes[bi], scores[bi], labels[bi], valid[bi], ds.cat_ids)
    # 6 landscape images: a full batch, then 2 padded to 4; 2 portrait padded to 4
    assert buckets == [((96, 128), 4), ((96, 128), 2), ((128, 96), 2)]
    assert len(records) == len(want) == 8 * 10
    for r, w in zip(records, want):
        assert (r["image_id"], r["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(r["bbox"], w["bbox"], rtol=0, atol=1e-4)
        assert r["score"] == pytest.approx(w["score"], abs=1e-5)

    mine = test_lvis.evaluate(ann, records)
    ref = JLvisEvaluator(json.loads(Path(ann).read_text()), want)
    ref.run()
    assert mine.results.keys() == ref.results.keys()
    for key in ref.results:
        assert mine.results[key] == pytest.approx(ref.results[key], abs=1e-6), key
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ref.print_results()
    assert printed.getvalue() == mine.table() + "\n"
