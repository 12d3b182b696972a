"""K3 (gathered per-class NMS) and the multiclass NMS of the PyTorch port
against the JAX package. On the CPU the port runs K3's plain version; the JAX
side runs `pallas/nms.py nms_keep_gathered` in interpret mode and
`kernels.batched_multiclass_nms` through XLA.

Every output is a selection of input values plus the keep decision, so all
are compared for equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.pallas.nms import nms_keep_gathered as pallas_nms_keep_gathered
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.nms import nms_keep_gathered
from test_torch_cuda import gathered_case


@pytest.mark.parametrize(
    "seed,k,n,outside",
    [
        pytest.param(0, 40, 100, 0.0, id="0"),
        pytest.param(1, 40, 100, 0.0, id="1"),
        # indices outside [0, N), negative and >= N, on valid slots: the zero box
        pytest.param(2, 1, 100, 0.2, id="outside-k1"),
        pytest.param(3, 65, 100, 0.2, id="outside-k65"),
        pytest.param(4, 300, 1000, 0.2, id="outside-k300"),
    ],
)
def test_gathered_keep_and_candidates_match_pallas_interpret(seed, k, n, outside):
    planes, idx, valid = gathered_case(seed, k=k, n=n, outside=outside)
    if outside:
        assert (valid & ((idx < 0) | (idx >= n))).any()
    jk, jc = pallas_nms_keep_gathered(
        jnp.asarray(planes), jnp.asarray(idx), jnp.asarray(valid), 0.5, interpret=True
    )
    tk, tc = nms_keep_gathered(
        torch.from_numpy(planes), torch.from_numpy(idx), torch.from_numpy(valid), 0.5
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy().view(np.int32), np.asarray(jc).view(np.int32))


def detection_case(seed, b=2, n=60, c=41):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, n, c).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ctr = rng.uniform(0, 200, (b, n, c, 2))
    wh = rng.uniform(10, 60, (b, n, c, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).reshape(b, n, c * 4).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize(
    "c,max_per_img,score_thr",
    [
        (41, 10, 0.0),  # 40 foreground classes > 10: the class cap is active
        (41, 12, 0.02),
        (9, 10, 0.0),  # 8 classes: no cap
    ],
)
def test_multiclass_nms_matches_jax(c, max_per_img, score_thr):
    boxes, scores, valid = detection_case(c + max_per_img, c=c)
    args = (score_thr, 0.5, max_per_img)
    jout = jkernels.batched_multiclass_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), *args, candidates_per_class=20
    )
    tout = tkernels.batched_multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), *args,
        candidates_per_class=20,
    )
    for name, j, t in zip(("boxes", "scores", "labels", "valid"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert tout[3].all()


def soft_case(seed, g=6, n=50):
    """Rows of overlapping boxes (a few clusters) with random scores, some
    slots invalid."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(40, 80, (g, n, 2)) + rng.randint(0, 3, (g, n, 1)) * 60
    wh = rng.uniform(20, 50, (g, n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    return boxes, rng.rand(g, n).astype(np.float32), rng.rand(g, n) > 0.15


@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
@pytest.mark.parametrize("seed,max_out", [(0, 50), (1, 20), (2, 60)])
def test_soft_nms_matches_jax(method, seed, max_out):
    """`ops/nms.py soft_nms` against JAX `ops/nms.py soft_nms` row by row:
    the selections (indices through the boxes, validity) equal, scores to
    1e-6. max_out 60 runs past the 50 candidates: the tail stays invalid."""
    from balancedgroupsoftmax_tpu.ops.nms import soft_nms as jax_soft_nms
    from balancedgroupsoftmax_torch.ops.nms import soft_nms

    boxes, scores, valid = soft_case(seed)
    kw = dict(iou_thr=0.3, method=method, sigma=0.5, min_score=0.05, max_out=max_out)
    tb, ts, tv = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), **kw)
    jb, js, jv = jax.vmap(lambda b, sc, v: jax_soft_nms(b, sc, v, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # no row takes more boxes than it has valid ones
    assert tv.any() and not tv[:, valid.sum(1).max():].any()
    if method != "naive":  # decayed scores: some taken box scores below its raw score
        assert (ts[tv] < torch.from_numpy(scores).max()).any()


@pytest.mark.parametrize(
    "c,max_per_img,agnostic",
    [
        (41, 10, False),  # 40 foreground classes > 10: the class cap is active
        (41, 10, True),
        (9, 30, False),
        (9, 30, True),
    ],
)
def test_soft_multiclass_nms_matches_jax(c, max_per_img, agnostic):
    """`batched_multiclass_nms(nms_type="soft_nms")` on class-specific and
    class-agnostic boxes against JAX's XLA branch (kernels.py:214-228): the
    boxes and labels of the selections and their validity equal, scores to
    1e-6."""
    boxes, scores, valid = detection_case(c * 3 + max_per_img, c=c)
    # crowded: centres within 60 px, so overlaps above 0.3 decay many scores
    rng = np.random.RandomState(c + max_per_img)
    ctr = rng.uniform(60, 120, boxes.shape[:2] + (c, 2))
    wh = rng.uniform(30, 60, ctr.shape)
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).reshape(boxes.shape).astype(np.float32)
    if agnostic:
        boxes = np.ascontiguousarray(boxes[..., :4])
    args = (0.0, 0.3, max_per_img)
    kw = dict(candidates_per_class=20, nms_type="soft_nms", soft_min_score=0.01)
    jout = jkernels.batched_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), *args, **kw)
    tout = tkernels.batched_multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), *args, **kw
    )
    for name, j, t in zip(("boxes", "scores", "labels", "valid"), jout, tout):
        if name == "scores":
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert tout[3].any()
    if c - 1 > max_per_img:  # under the cap the top detections are each class's best, never decayed
        return
    # soft-NMS decays the scores of overlapping boxes a hard NMS removes or keeps whole
    hard = tkernels.batched_multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), *args, candidates_per_class=20
    )
    assert not torch.equal(hard[1], tout[1])
