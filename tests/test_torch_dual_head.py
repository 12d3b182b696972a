"""tau-norm-select against the JAX package: `models/dual_head.py`, the
detector's single-view `propose` / `rescore`, and the test CLI's dual path.

- `tail_class_mask_from_counts` and `update_scores_with_reweight` equal
  JAX's exactly at several seeds, on score rows built to hold each case:
  the main argmax on background, the second head's argmax on a tail class,
  and exact ties (both take the first maximum).
- `propose` and `rescore` on the tiny 128 x 128 configuration of
  tests/test_detector.py (weights converted by `convert.params_from_flax`),
  GS and softmax, against JAX's methods: boxes within 1e-4 px, scores within
  1e-5, validity equal (the tolerances of the test loop in
  tests/test_torch_cli.py).
- The dual path (`tools.test_lvis.predict_tau_select`) on the softmax model,
  the ablation's tnorm-select model, against the same composition of JAX's
  methods: `propose`, `rescore` with the model's and with the tau-normalised
  classifier, `vmap(update_scores_with_reweight)`, the boxes divided by the
  scale factors, then `batched_multiclass_nms`: the same tolerances, labels
  and validity equal.
- `test_lvis --tau-select` leaves the main fc_cls as the checkpoint holds it.

About 40 s on one worker, most of it JAX's compile.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.kernels import batched_multiclass_nms as jax_multiclass_nms
from balancedgroupsoftmax_tpu.models import dual_head as jdual
from balancedgroupsoftmax_tpu.models.detector import build_detector as jax_build_detector
from balancedgroupsoftmax_torch import config as tconfig
from balancedgroupsoftmax_torch import zoo
from balancedgroupsoftmax_torch.apis import tau_norm
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.gs.partition import make_partition
from balancedgroupsoftmax_torch.models import dual_head
from balancedgroupsoftmax_torch.models.detector import build_detector
from balancedgroupsoftmax_torch.tools import mini_lvis, test_lvis
from balancedgroupsoftmax_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from tests.test_detector import make_batch, tiny_config, tiny_partition
from tests.test_torch_detector import COUNTS, to_port

ROOT = Path(__file__).resolve().parents[1]
TAU = 1.0
SCALE_FACTORS = np.array([1.0, 0.5], np.float32)


def jax_tau_norm():
    spec = importlib.util.spec_from_file_location("jax_test_lvis_cli", ROOT / "tools" / "test_lvis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tau_norm


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [1, 100, 5000])
def test_tail_mask_equals_jax(seed, threshold):
    counts = np.random.RandomState(seed).randint(0, 10000, 40)
    counts[1::5] = threshold  # the boundary: not a tail class
    mine = dual_head.tail_class_mask_from_counts(counts.copy(), threshold)
    want = jdual.tail_class_mask_from_counts(counts.copy(), threshold)
    assert mine.dtype == want.dtype == bool and not mine[0]
    np.testing.assert_array_equal(mine, want)


def reweight_cases(seed, n=96, c=11):
    """Main and second-head scores whose rows cover every case: blocks of
    rows with the main argmax on background, the second argmax on a tail
    class, on a head class, and exact ties of the maximum in either head."""
    rng = np.random.RandomState(seed)
    main = rng.rand(n, c).astype(np.float32)
    back = rng.rand(n, c).astype(np.float32)
    main[0::6, 0] = 2.0  # main argmax background
    back[1::6, 3] = 2.0  # back argmax a tail class (3 is tail below)
    back[2::6, 8] = 2.0  # back argmax a head class
    main[3::6, [0, 4]] = 2.0  # tie: background first
    main[4::6, [2, 5]] = 2.0  # tie between foreground classes
    back[4::6, [3, 8]] = 2.0  # tie: a tail class first
    back[5::6, [8, 3]] = 3.0  # tie: both 3 and 8, first index (3) wins
    tail = np.zeros(c, bool)
    tail[[1, 3, 5, 6]] = True
    tail[rng.randint(1, c)] = True
    return main, back, tail


@pytest.mark.parametrize("seed", range(4))
def test_update_scores_equals_jax(seed):
    main, back, tail = reweight_cases(seed)
    got = dual_head.update_scores_with_reweight(torch.from_numpy(main), torch.from_numpy(back), torch.from_numpy(tail))
    want = np.asarray(jdual.update_scores_with_reweight(jnp.asarray(main), jnp.asarray(back), jnp.asarray(tail)))
    np.testing.assert_array_equal(got.numpy(), want)
    replaced = (got.numpy() == back).all(1) & ~(back == main).all(1)
    assert 0 < replaced.sum() < len(main)
    # the batched call (images first) equals the per-image calls
    two = dual_head.update_scores_with_reweight(
        torch.from_numpy(np.stack([main, back])), torch.from_numpy(np.stack([back, main])), torch.from_numpy(tail)
    )
    np.testing.assert_array_equal(two[0].numpy(), want)


def models(use_gs):
    jcfg = tiny_config(use_gs=use_gs)
    jmodel = jax_build_detector(jcfg, partition=tiny_partition() if use_gs else None)
    images, _, _, _, _ = make_batch()
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), images[:1]))
    tmodel = build_detector(to_port(tconfig.DetectorConfig, jcfg), partition=make_partition(COUNTS) if use_gs else None)
    tmodel.load_state_dict(params_from_flax(variables))
    return jmodel, variables, tmodel.eval()


def batch():
    images = np.array(make_batch()[0])
    shapes = np.array([[128.0, 128.0], [100.0, 120.0]], np.float32)
    return images, shapes


@pytest.fixture(scope="module", params=[True, False], ids=["gs", "softmax"])
def both(request):
    return models(request.param)


def test_propose_and_rescore_equal_jax(both):
    jmodel, variables, tmodel = both
    images, shapes = batch()
    jprops = jax.jit(lambda v, im, sh: jmodel.apply(v, im, sh, method="propose"))(variables, images, shapes)
    props = tmodel.propose(torch.from_numpy(images), torch.from_numpy(shapes))
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(jprops.valid))
    np.testing.assert_allclose(props.boxes.numpy(), np.asarray(jprops.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(props.scores.numpy(), np.asarray(jprops.scores), rtol=0, atol=1e-5)

    # both rescore the same rois: JAX's proposals
    rois = np.array(jprops.boxes)
    jboxes, jscores = jax.jit(lambda v, im, r, sh: jmodel.apply(v, im, r, sh, method="rescore"))(
        variables, images, rois, shapes)
    boxes, scores = tmodel.rescore(torch.from_numpy(images), torch.from_numpy(rois), torch.from_numpy(shapes))
    assert boxes.shape == (2, 64, 9 * 4) and scores.shape == (2, 64, 9)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-5)
    # in the view's frame: clipped to each image's content, not rescaled
    assert (boxes[1, :, 2::4] <= 119).all() and (boxes[1, :, 3::4] <= 99).all()


def test_dual_path_equals_jax():
    jmodel, variables, tmodel = models(use_gs=False)
    images, shapes = batch()
    tail = dual_head.tail_class_mask_from_counts(COUNTS.copy(), 100)
    back_vars = dict(variables, params=jax_tau_norm()(variables["params"], TAU, skip_bg=True))
    c = jmodel.cfg.rcnn_test

    @jax.jit
    def jax_dual(v, vb, im, sh, sf):
        pr = jmodel.apply(v, im, sh, method="propose")
        bx, sc_main = jmodel.apply(v, im, pr.boxes, sh, method="rescore")
        _, sc_back = jmodel.apply(vb, im, pr.boxes, sh, method="rescore")
        sc = jax.vmap(lambda a, b: jdual.update_scores_with_reweight(a, b, jnp.asarray(tail)))(sc_main, sc_back)
        dets = jax_multiclass_nms(bx / sf[:, None, None], sc, pr.valid, c.score_thr, c.nms_iou_thr, c.max_per_img,
                                  candidates_per_class=c.nms_candidates_per_class, nms_type=c.nms_type)
        return dets, sc_main, sc_back

    want, jmain, jback = jax_dual(variables, back_vars, images, shapes, SCALE_FACTORS)

    back_cls = copy.deepcopy(tmodel.bbox_head.fc_cls)
    tau_norm(back_cls, TAU, skip_bg=True)
    np.testing.assert_allclose(back_cls.weight.detach().numpy(),
                               np.asarray(back_vars["params"]["bbox_head"]["fc_cls"]["kernel"]).T, rtol=1e-6, atol=0)
    # each head's top two are further apart than twice the scores'
    # tolerance, so both packages choose the same rows
    for s in (np.asarray(jmain), np.asarray(jback)):
        top2 = np.sort(s, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 2e-5
    mixed = np.asarray(jdual.update_scores_with_reweight(jmain.reshape(-1, 9), jback.reshape(-1, 9), tail))
    replaced = (mixed == np.asarray(jback).reshape(-1, 9)).all(1)
    assert 0 < replaced.sum() < len(replaced), "no row, or every row, taken from the second head"

    got = test_lvis.predict_tau_select(
        tmodel, back_cls, torch.from_numpy(tail), *(torch.from_numpy(x) for x in (images, shapes, SCALE_FACTORS)))
    boxes, scores, labels, valid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), boxes, rtol=0, atol=1e-4)
    assert valid.sum() > 0


def test_tau_select_cli_keeps_the_main_classifier(tmp_path, monkeypatch):
    ann, imgs = mini_lvis.write_lvis_fixture(str(tmp_path / "lvis"), image_sizes=((120, 160),) * 2)
    cfg = zoo.faster_rcnn_r50_fpn_lvis(num_classes=9)
    model = build_detector(cfg).init_weights(7)
    save_checkpoint(str(tmp_path / "c.pt"), {"model": model.state_dict()}, meta={})
    saved = restore_checkpoint(str(tmp_path / "c.pt"))["model"]["bbox_head.fc_cls.weight"]

    calls = []
    dual = test_lvis.predict_tau_select

    def record(model, back_cls, tail_mask, *batch):
        calls.append((model.bbox_head.fc_cls.weight.detach().clone(), back_cls.weight.detach().clone(), tail_mask))
        out = dual(model, back_cls, tail_mask, *batch)
        assert model.bbox_head.fc_cls is not back_cls
        calls.append(model.bbox_head.fc_cls.weight.detach().clone())
        return out

    monkeypatch.setattr(test_lvis, "predict_tau_select", record)
    out = test_lvis.main(["--model", "faster_rcnn_r50", "--ann", ann, "--img-prefix", imgs, "--checkpoint",
                          str(tmp_path / "c.pt"), "--tau-select", "1.0", "--tail-threshold", "500",
                          "--scale", "128", "96", "--batch-size", "2", "--device", "cpu", "--no-eval"])
    (main_w, back_w, tail_mask), after = calls
    assert torch.equal(main_w, saved) and torch.equal(after, saved)
    assert torch.equal(back_w[0], saved[0]) and not torch.equal(back_w[1:], saved[1:])
    np.testing.assert_allclose(back_w[1:].norm(dim=1).numpy(), 1.0, rtol=1e-5)
    # mini_lvis's counts are 10, 100, 1000, 10000 by class: 4 of 8 under 500
    assert tail_mask.tolist() == [False] + [True, True, False, False] * 2
    assert len(out["records"]) > 0
