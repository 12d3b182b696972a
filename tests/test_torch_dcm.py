"""DCM (nearest-class-mean scoring) and the bbox head's `return_feature`
hook against the JAX package (`models/dcm.py`, `models/bbox_head.py`).

- `CenterAccumulator` equals JAX's exactly (the same float64 sums).
- `dcm_scores` within 1e-6 of JAX's, with and without `bg_score`, with an
  unseen class (a zero centre scores 0) and a zero feature.
- A centres `.npz` written by either package loads in the other.
- `SharedFCBBoxHead(..., return_feature=True)` on the tiny configuration's
  converted weights: logits, deltas and the feature within 1e-5 of JAX's, the
  default return unchanged; DCM on that feature within 1e-6.

About 30 s on one worker.
"""

import jax
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.models import dcm as jdcm
from balancedgroupsoftmax_tpu.models.bbox_head import SharedFCBBoxHead as JSharedFCBBoxHead
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models import dcm
from balancedgroupsoftmax_torch.models.detector import build_detector
from tests.test_detector import tiny_config, tiny_partition
from tests.test_torch_detector import COUNTS, to_port


def accumulate(module, feats, labels, valid, c, d):
    acc = module.CenterAccumulator(c, d)
    for i in range(0, len(feats), 7):  # streamed in pieces
        acc.update(feats[i:i + 7], labels[i:i + 7], valid[i:i + 7])
    return acc


@pytest.mark.parametrize("seed", range(3))
def test_center_accumulator_equals_jax(seed):
    rng = np.random.RandomState(seed)
    c, d, n = 9, 16, 50
    feats = rng.randn(n, d).astype(np.float32)
    labels = rng.randint(0, c - 2, n)  # classes 7 and 8 never seen
    valid = rng.rand(n) > 0.2
    mine, ref = accumulate(dcm, feats, labels, valid, c, d), accumulate(jdcm, feats, labels, valid, c, d)
    np.testing.assert_array_equal(mine.sums, ref.sums)
    np.testing.assert_array_equal(mine.counts, ref.counts)
    centers = mine.centers()
    assert centers.dtype == np.float32
    np.testing.assert_array_equal(centers, ref.centers())
    assert not centers[[0, 7, 8]].any()


@pytest.mark.parametrize("with_bg", [False, True])
def test_dcm_scores_equal_jax(with_bg):
    rng = np.random.RandomState(4)
    feats = rng.randn(33, 16).astype(np.float32)
    feats[5] = 0.0
    centers = rng.randn(9, 16).astype(np.float32)
    centers[[0, 3]] = 0.0
    bg = rng.rand(33).astype(np.float32) if with_bg else None
    got = dcm.dcm_scores(torch.from_numpy(feats), torch.from_numpy(centers),
                         None if bg is None else torch.from_numpy(bg)).numpy()
    want = np.asarray(jdcm.dcm_scores(feats, centers, bg))
    assert got.dtype == np.float32 and got.shape == (33, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[:, 3].any() and not got[5, 1:].any()
    if with_bg:
        np.testing.assert_array_equal(got[:, 0], bg)


def test_centers_npz_loads_in_both(tmp_path):
    centers = np.random.RandomState(5).randn(9, 16).astype(np.float32)
    dcm.save_centers(str(tmp_path / "port.npz"), centers)
    jdcm.save_centers(str(tmp_path / "jax.npz"), centers)
    for load in (dcm.load_centers, jdcm.load_centers):
        for name in ("port.npz", "jax.npz"):
            np.testing.assert_array_equal(load(str(tmp_path / name)), centers)


@pytest.mark.parametrize("use_gs", [False, True], ids=["softmax", "gs"])
def test_return_feature_equals_jax(use_gs):
    jcfg = tiny_config(use_gs=use_gs)
    jmodel = jax_build_detector(jcfg, partition=tiny_partition() if use_gs else None)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1), np.zeros((1, 128, 128, 3))))
    tmodel = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    tmodel.load_state_dict(params_from_flax(variables))
    roi_feats = np.random.RandomState(6).randn(2, 12, 7, 7, 256).astype(np.float32)

    jhead = JSharedFCBBoxHead(jcfg.bbox_head)
    want = jhead.apply({"params": variables["params"]["bbox_head"]}, roi_feats, return_feature=True)
    with torch.no_grad():
        got = tmodel.bbox_head(torch.from_numpy(roi_feats), return_feature=True)
        plain = tmodel.bbox_head(torch.from_numpy(roi_feats))
    assert len(got) == 3 and len(plain) == 2
    assert got[2].shape == (2, 12, 64) and (got[2] >= 0).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)

    # DCM on the hook's feature, centres from the first image's rois
    labels = np.arange(12) % 9
    centers = accumulate(dcm, got[2][0].numpy(), labels, np.ones(12, bool), 9, 64).centers()
    scores = dcm.dcm_scores(got[2][1], torch.from_numpy(centers)).numpy()
    np.testing.assert_allclose(scores, np.asarray(jdcm.dcm_scores(np.asarray(want[2][1]), centers)), rtol=0, atol=1e-6)
