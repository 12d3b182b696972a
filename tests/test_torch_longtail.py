"""The BAGS ablation's tools against the JAX package, on the CPU.

- `tools.make_longtail` against JAX tools/make_longtail.py, both run as
  subprocesses at one seed and a small size: the same train.json and
  val.json, and every JPEG byte-equal.
- `tools.test_lvis_tnorm.gt_roi_hits`, the per-image classification of
  ground-truth RoIs, against JAX's composition (`extract_feats`,
  `multilevel_roi_align` over the FPN levels, `roi_head`, then
  `gs_merge_scores` or a softmax) on the tiny 128 x 128 configuration's
  converted weights, GS and softmax: the per-bin (correct, total) equal.
  Its CLI on a landscape and a portrait image at the default scale counts
  the landscape image's boxes alone.
- A tiny matrix through `tools.run_longtail_ablation --device cpu` (4
  classes, 96 x 96 images, 1 epoch of 2 steps a trained row, f32): every
  row present and finite; a second run trains nothing and reuses every
  row's detections; a checkpoint made newer than its row's detections makes
  that row, and only it, run its test again.

About 3 minutes on one worker, most of it the matrix's 10 subprocesses.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.gs.head import gs_merge_scores as jax_gs_merge_scores
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition, partition_from_lvis, save_partition
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.tools import mini_lvis, test_lvis_tnorm
from balancedgroupsoftmax_torch.utils.checkpoint import save_checkpoint
from tests.test_detector import tiny_config, tiny_partition
from tests.test_torch_detector import COUNTS, to_port

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def run(*cmd):
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_make_longtail_equals_jax(tmp_path):
    flags = ["--train-images", "12", "--val-images", "6", "--size", "96", "--seed", "3"]
    run("tools/make_longtail.py", "--out", str(tmp_path / "jax"), *flags)
    run("-m", "balancedgroupsoftmax_torch.tools.make_longtail", "--out", str(tmp_path / "port"), *flags)
    for name in ("train.json", "val.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == json.loads((tmp_path / "jax" / name).read_text())
    want = sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) == want
    assert len(want) > 18  # the injected images of classes the power law missed
    for name in want:
        assert (tmp_path / "port" / "images" / name).read_bytes() == (tmp_path / "jax" / "images" / name).read_bytes()


@pytest.mark.parametrize("use_gs", [True, False], ids=["gs", "softmax"])
def test_gt_roi_hits_equal_jax(use_gs):
    jcfg = tiny_config(use_gs=use_gs)
    jmodel = jax_build_detector(jcfg, partition=tiny_partition() if use_gs else None)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2), np.zeros((1, 128, 128, 3))))
    partition = make_partition(COUNTS)
    tmodel = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=partition if use_gs else None)
    tmodel.load_state_dict(params_from_flax(variables))
    tmodel.eval()

    rng = np.random.RandomState(7)
    image = rng.randn(128, 128, 3).astype(np.float32)
    xy = rng.uniform(0, 90, (40, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (40, 2)), 127)], 1).astype(np.float32)
    labels = rng.randint(1, 9, 40).astype(np.int32)
    strides = jcfg.roi_extractor.featmap_strides

    @jax.jit
    def jax_scores(v, im, rois):
        feats = jmodel.apply(v, im, method="extract_feats")
        pooled = jax.vmap(lambda f, r: jax_multilevel_roi_align(f, r, strides))(feats[:4], rois)
        logits, _ = jmodel.apply(v, pooled, method="roi_head")
        if use_gs:
            return jax_gs_merge_scores(logits[0], jmodel.partition)
        return jax.nn.softmax(logits[0], axis=-1)

    scores = np.asarray(jax_scores(variables, image[None], boxes[None]))
    top2 = np.sort(scores[:, 1:], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 2e-5  # the same argmax in both packages
    pred = scores[:, 1:].argmax(-1) + 1
    want_correct = np.bincount(partition.label2bin[labels], weights=pred == labels, minlength=5)
    want_total = np.bincount(partition.label2bin[labels], minlength=5)

    correct, total = test_lvis_tnorm.gt_roi_hits(tmodel, image, boxes, labels, partition.label2bin)
    np.testing.assert_array_equal(total, want_total)
    np.testing.assert_array_equal(correct, want_correct)
    assert total.sum() == 40 and total[0] == 0


def test_tnorm_cli_counts_the_landscape_bucket(tmp_path):
    # 640 x 480 is padded into (800, 1344), 480 x 640 into (1344, 800)
    ann, imgs = mini_lvis.write_lvis_fixture(str(tmp_path / "lvis"), image_sizes=((480, 640), (640, 480)),
                                             boxes_per_image=5, box_range=(40, 200))
    part = str(tmp_path / "part.npz")
    save_partition(part, partition_from_lvis(ann, 9))
    model = build_detector(zoo.faster_rcnn_r50_fpn_lvis(num_classes=9)).init_weights(1)
    save_checkpoint(str(tmp_path / "c.pt"), {"model": model.state_dict()}, meta={})
    lines = test_lvis_tnorm.main(["--ann", ann, "--img-prefix", imgs, "--checkpoint", str(tmp_path / "c.pt"),
                                  "--partition", part, "--taus", "0.0", "1.0", "--device", "cpu"])
    assert [l["tau"] for l in lines] == [0.0, 1.0]
    for line in lines:
        assert sum(line["counts"]) == 5 and line["counts"][0] == 0
        assert all(0 <= c <= t for c, t in zip(line["correct"], line["counts"]))
        assert list(line["per_bin_accuracy"]) == ["bg/fg", "(0,10)", "[10,100)", "[100,1000)", "[1000,~)"]
        assert line["per_bin_accuracy"]["bg/fg"] is None


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    root = tmp_path_factory.mktemp("longtail")
    data, work = str(root / "data"), str(root / "work")
    run("-m", "balancedgroupsoftmax_torch.tools.make_longtail", "--out", data, "--train-images", "4",
        "--val-images", "2", "--size", "96", "--hues", "2", "--shapes", "2")
    run("-m", "balancedgroupsoftmax_torch.tools.gs_partition", "--ann", os.path.join(data, "train.json"),
        "--out", os.path.join(data, "part.npz"), "--num-classes", "5", "--thresholds", "2", "4", "8")
    ablation = ["-m", "balancedgroupsoftmax_torch.tools.run_longtail_ablation", "--data", data, "--work-dir", work,
                "--epochs", "1", "--batch-size", "2", "--scale", "96", "96", "--dtype", "float32",
                "--rfs-t", "0.3", "--device", "cpu"]
    first = run(*ablation)
    rows = json.loads(Path(work, "ablation.json").read_text())
    second = run(*ablation)
    rfs_ckpt = Path(work, "rfs", "ckpt_epoch_1.pt")
    later = Path(work, "res_rfs.json").stat().st_mtime + 10
    os.utime(rfs_ckpt, (later, later))
    third = run(*ablation)
    return dict(work=work, rows=rows, first=first, second=second, third=third)


ROWS = ["baseline", "tau=0.5", "tau=0.7", "tau=1.0", "tnorm-select=1.0", "gs (BAGS)", "rfs"]


def test_matrix_has_every_row(matrix):
    rows = matrix["rows"]
    assert list(rows) == ROWS
    for name, row in rows.items():
        assert list(row) == ["AP", "AP50", "APr", "APc", "APf"], name
        assert all(np.isfinite(v) for v in row.values()), name
    table = Path(matrix["work"], "ablation.md").read_text().splitlines()
    assert [l.split(" | ")[0][2:] for l in table[2:]] == ROWS
    times = json.loads(Path(matrix["work"], "train_times.json").read_text())
    assert list(times) == ["baseline", "gs", "rfs"] and all(t["steps"] == 2 for t in times.values())
    first = matrix["first"]
    assert first.count("tools.train") == 3 and first.count("tools.test_lvis") == 7
    assert "images upsampled" in first and "tau-select tau=1.0" in first


def test_second_run_reuses_everything(matrix):
    second = matrix["second"]
    assert "tools.train" not in second and "tools.test_lvis" not in second
    assert second.count("checkpoint exists, skipping train") == 3
    assert json.loads(Path(matrix["work"], "ablation.json").read_text()) == matrix["rows"]


def test_newer_checkpoint_reruns_its_row(matrix):
    third = [l for l in matrix["third"].splitlines() if l.startswith("+ ")]
    assert len(third) == 1 and "tools.test_lvis" in third[0] and "rfs/ckpt_epoch_1.pt" in third[0]


def test_tnorm_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_lvis_tnorm.main(["--ann", "x", "--img-prefix", "x", "--checkpoint", "x", "--partition", "x"])
