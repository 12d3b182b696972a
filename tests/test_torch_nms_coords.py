"""K5 (greedy NMS keep on coordinate planes) and the class-agnostic branch of
the multiclass NMS (K6, then K5) of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
`pallas/nms.py nms_keep_batched_coords` in interpret mode, and
`kernels.batched_multiclass_nms` through its XLA branch. Every output is a
selection of input values plus the keep decision, so all are compared for
equality. The rows hold exact duplicates, pairs exactly at the threshold
(10 x 10 against 10 x 7 boxes at 0.7: IoU 70/100, which must not suppress)
and invalid slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.pallas.nms import nms_keep_batched_coords as pallas_nms_keep_batched_coords
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.nms import nms_keep_batched_coords
from test_torch_cuda import tie_rows


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("g,k", [(6, 60), (3, 300)])
def test_keep_matches_pallas_interpret(g, k, thr):
    boxes, valid = tie_rows(g + k, g, k, thr)
    coords = np.ascontiguousarray(boxes.transpose(0, 2, 1))
    want = np.asarray(pallas_nms_keep_batched_coords(jnp.asarray(coords), jnp.asarray(valid), thr, interpret=True))
    got = nms_keep_batched_coords(torch.from_numpy(coords), torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[~valid].any()


def test_exact_threshold_pair_duplicate_and_invalid_slot():
    # columns: [0,0,9,9], [0,0,9,6] (IoU 0.7 exactly: kept), a duplicate of
    # the first (suppressed), then an invalid slot that suppresses nothing
    coords = torch.tensor([[[0.0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [9, 9, 9, 9, 9], [9, 6, 9, 9, 9]]])
    valid = torch.tensor([[True, True, True, False, True]])
    assert nms_keep_batched_coords(coords, valid, 0.7).tolist() == [[True, True, False, False, False]]
    valid = torch.tensor([[False, True, True, False, True]])
    assert nms_keep_batched_coords(coords, valid, 0.7).tolist() == [[False, True, True, False, False]]


def agnostic_case(seed, b=2, n=60, c=41, thr=0.5):
    """Class-agnostic boxes (B, N, 4) with ties, scores (B, N, C), validity."""
    rng = np.random.RandomState(seed)
    boxes, _ = tie_rows(seed, b, n, thr, spread=150)
    logits = rng.randn(b, n, c).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = rng.rand(b, n) > 0.1
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize(
    "c,max_per_img,score_thr,candidates",
    [
        (41, 10, 0.0, 20),  # 40 foreground classes > 10: the class cap is active
        (41, 12, 0.02, 60),  # capped, every box a candidate, some below the threshold
        (9, 10, 0.0, 20),  # 8 classes: no cap
        (9, 50, 0.03, 60),  # no cap, fewer detections than slots
    ],
)
def test_class_agnostic_multiclass_nms_matches_jax(c, max_per_img, score_thr, candidates):
    boxes, scores, valid = agnostic_case(c + max_per_img, c=c)
    args = (score_thr, 0.5, max_per_img)
    jout = jkernels.batched_multiclass_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), *args, candidates_per_class=candidates
    )
    tout = tkernels.batched_multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), *args,
        candidates_per_class=candidates,
    )
    for name, j, t in zip(("boxes", "scores", "labels", "valid"), jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert tout[3].any()
