"""The train CLI's HTC models on the CPU: `gs_htc_dcn_x101` (X101-64x4d,
deformable c3-c5, GS heads, resized to the fixture's 9 classes) for one step
on the mini-LVIS fixture at 128 x 96, one thread: the batch carries each
gt's box-normalised mask crop, rasterised from its annotation at the
original size as `rasterize_gt_masks` does and flipped with its image, and
the step logs every stage's mask loss.
"""

import json

import numpy as np
import pytest
import torch

from balancedgroupsoftmax_torch import apis, zoo
from balancedgroupsoftmax_torch.data.lvis import LvisDataset
from balancedgroupsoftmax_torch.ops.mask import GT_MASK_CROP, rasterize_gt_masks
from balancedgroupsoftmax_torch.tools import gs_partition, train
from balancedgroupsoftmax_torch.tools.mini_lvis import write_lvis_fixture


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_models_name_the_htc_configs():
    for name, (use_gs, dcn) in {"htc_x101": (False, False), "gs_htc_x101": (True, False),
                                "gs_htc_dcn_x101": (True, True)}.items():
        cfg = apis.MODELS[name][0](num_classes=9)
        assert cfg.htc is not None and cfg.bbox_head.use_gs == use_gs and cfg.backbone.depth == 101
        assert any(cfg.backbone.dcn_stages) == dcn
    assert apis.MODELS["gs_htc_dcn_x101"][1] == "gs_htc_x101_64x4d_fpn_lvis"
    # Mask R-CNN's names (JAX tools/train.py:137-138)
    for name, use_gs in {"mask_rcnn_r50": False, "gs_mask_rcnn_r50": True}.items():
        build, train_key = apis.MODELS[name]
        cfg = build(num_classes=9)
        assert cfg.mask_head is not None and cfg.htc is None and cfg.cascade is None
        assert cfg.bbox_head.use_gs == use_gs and cfg.backbone.depth == 50
        assert train_key == ("gs_" if use_gs else "") + "mask_rcnn_r50_fpn_lvis"
        assert cfg == zoo.mask_rcnn_r50_fpn_lvis(num_classes=9, use_gs=use_gs)


@pytest.mark.slow  # about 100 s: the full-width X101 on one thread
def test_train_cli_trains_htc_dcn_with_mask_crops(tmp_path, one_thread, monkeypatch, capsys):
    ann, imgs = write_lvis_fixture(str(tmp_path / "lvis"), image_sizes=((120, 160),) * 2 + ((160, 120),) * 2)
    part = str(tmp_path / "part.npz")
    gs_partition.main(["--ann", ann, "--out", part, "--num-classes", "9"])
    seen = []
    make_step = train.make_train_step

    def recording(state):
        step = make_step(state)
        return lambda batch, *a: (seen.append(batch), step(batch, *a))[1]

    monkeypatch.setattr(train, "make_train_step", recording)
    out = train.main([
        "--model", "gs_htc_dcn_x101", "--ann", ann, "--img-prefix", imgs, "--partition", part,
        "--work-dir", str(tmp_path / "work"), "--device", "cpu", "--scale", "128", "96", "--batch-size", "2",
        "--selectp", "0", "--max-steps", "1", "--log-interval", "1",
    ])
    (line,) = out["log"]
    assert {f"s{i}.loss_mask" for i in range(3)} <= set(line) and all(np.isfinite(v) for v in line.values())
    assert out["checkpoint"] and out["state"].step == 1
    (batch,) = seen
    crops = batch["gt_mask_crops"]
    assert crops.shape == (2, 100, GT_MASK_CROP, GT_MASK_CROP) and crops.dtype == np.float32
    # each valid gt has its crop, the padding slots none
    assert (crops.reshape(2, 100, -1).max(-1) > 0).tolist() == batch["gt_mask"].tolist()
    # the crops are the annotations' masks, flipped where the image was
    ds = LvisDataset(ann, imgs)
    raster = {}
    for i in range(len(ds)):
        info, a = ds.img_infos[i], ds.get_ann_info(i)
        raster[i] = rasterize_gt_masks(a["masks"], a["bboxes"], info["height"], info["width"], 100)
    for b in range(2):
        n = int(batch["gt_mask"][b].sum())
        hits = [i for i, r in raster.items() if np.array_equal(r[:n], crops[b, :n])
                or np.array_equal(r[:n, :, ::-1], crops[b, :n])]
        assert hits, f"sample {b}'s crops are no image's rasterised masks"
    assert "s2.loss_mask" in json.loads((tmp_path / "work" / "train_log.jsonl").read_text().splitlines()[0])

