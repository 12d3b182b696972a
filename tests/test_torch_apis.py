"""The port's user API: test-time preprocessing against the JAX pipeline,
and `init_detector` / `inference_detector` end to end on the CPU."""

import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.data.pipeline import PipelineConfig
from balancedgroupsoftmax_tpu.data.pipeline import preprocess_image as jax_preprocess_image
from balancedgroupsoftmax_torch import apis
from balancedgroupsoftmax_torch.data.pipeline import preprocess_image


@pytest.mark.parametrize("hw", [(480, 640), (640, 427)])  # landscape and portrait
def test_preprocess_matches_jax_pipeline(hw):
    img = np.random.RandomState(hw[0]).randint(0, 255, (*hw, 3), np.uint8)
    want = jax_preprocess_image(
        img, np.zeros((0, 4), np.float32), np.zeros(0, np.int32), PipelineConfig(), train=False
    )
    got = preprocess_image(img)
    assert got["bucket"] == want["bucket"]
    for key in ("image", "img_shape", "scale_factor"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_inference_detector_on_cpu_matches_predict():
    detector = apis.init_detector("gs_faster_rcnn_r50", device="cpu", seed=0)
    img = np.random.RandomState(0).randint(0, 255, (60, 90, 3), np.uint8)
    dets = apis.inference_detector(detector, img)
    assert 0 < len(dets) <= 300

    s = preprocess_image(img)
    assert s["bucket"] == (800, 1344)
    ref = detector.model.predict(
        torch.from_numpy(s["image"][None]),
        torch.from_numpy(s["img_shape"][None]),
        torch.tensor([s["scale_factor"]]),
    )
    n = int(ref.valid.sum())
    assert [d["score"] for d in dets] == ref.scores[0, :n].tolist()
    assert [d["label"] for d in dets] == ref.labels[0, :n].tolist()
    assert all(d["category_id"] == d["label"] + 1 for d in dets)
    boxes = np.array([d["bbox"] for d in dets])
    assert (boxes >= 0).all() and (boxes[:, 0::2] <= 90).all() and (boxes[:, 1::2] <= 60).all()


@pytest.mark.parametrize("names", [False, True])
def test_show_result_draws_as_jax(names, tmp_path):
    """`apis.show_result` pixel for pixel against JAX `apis.py show_result`
    (cv2 boxes and labels), the score threshold included, and the file it
    writes (BGR) read back as the returned image."""
    import cv2

    from balancedgroupsoftmax_tpu.apis import show_result as jax_show_result

    rng = np.random.RandomState(names)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    dets = [dict(bbox=[float(x) for x in rng.uniform(0, 100, 2)] + [float(x) for x in rng.uniform(100, 150, 2)],
                 score=float(s), label=int(rng.randint(0, 4)), category_id=int(rng.randint(1, 9)))
            for s in (0.9, 0.5, 0.31, 0.2)]
    class_names = ("a", "bb", "ccc", "dddd") if names else None
    want = jax_show_result(img, dets, class_names, score_thr=0.3)
    got = apis.show_result(img, dets, class_names, score_thr=0.3, out_file=str(tmp_path / "out.png"))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img) and np.array_equal(img, rng.__class__(names).randint(0, 255, img.shape, np.uint8))
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(tmp_path / "out.png")), cv2.COLOR_BGR2RGB), got)
