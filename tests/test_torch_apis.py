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
