"""K1 (greedy NMS keep) of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side runs
`ops/nms.py nms_keep` and the Pallas kernel in interpret mode. Keep masks are
compared for equality: both compute IoU in the same f32 operation order, so
boxes exactly at the threshold decide alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.ops.nms import nms_keep as jax_nms_keep
from balancedgroupsoftmax_tpu.pallas.nms import nms_keep_batched as pallas_nms_keep_batched
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.nms import nms_keep_batched, nms_keep_reference
from tests.test_nms import np_greedy_nms
from test_torch_cuda import tie_rows


def jax_keep_rows(boxes, valid, thr):
    k = boxes.shape[1]
    return np.asarray(
        jax.vmap(lambda b, v: jax_nms_keep(b, jnp.zeros(k), v, thr, presorted=True))(
            jnp.asarray(boxes), jnp.asarray(valid)
        )
    )


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("g,k", [(4, 60), (3, 1000)])
def test_keep_matches_jax_nms_keep(g, k, thr):
    boxes, valid = tie_rows(g * k, g, k, thr)
    keep = nms_keep_batched(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(keep, jax_keep_rows(boxes, valid, thr))


def test_exact_threshold_ties_do_not_suppress():
    # IoU of [0,0,9,9] and [0,0,9,6] is 70/100, equal in f32 to 0.7
    boxes = torch.tensor([[[0.0, 0, 9, 9], [0, 0, 9, 6], [0, 0, 9, 9]]])
    valid = torch.tensor([[True, True, True]])
    assert nms_keep_batched(boxes, valid, 0.7).tolist() == [[True, True, False]]
    # an invalid slot neither keeps nor suppresses: slot 2 survives slot 0
    valid = torch.tensor([[False, True, True]])
    assert nms_keep_batched(boxes, valid, 0.7).tolist() == [[False, True, True]]


def test_keep_matches_pallas_kernel_interpret():
    boxes, valid = tie_rows(7, 2, 1000, 0.7)
    keep = nms_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid), 0.7).numpy()
    pallas = np.asarray(
        pallas_nms_keep_batched(jnp.asarray(boxes), jnp.asarray(valid), 0.7, interpret=True)
    )
    np.testing.assert_array_equal(keep, pallas)


def test_keep_matches_sequential_greedy():
    boxes, valid = tie_rows(11, 3, 200, 0.6)
    keep = nms_keep_batched(torch.from_numpy(boxes), torch.from_numpy(valid), 0.6).numpy()
    for i in range(3):
        v = valid[i]
        expected = np_greedy_nms(boxes[i][v], -np.arange(v.sum(), dtype=np.float32), 0.6)
        np.testing.assert_array_equal(keep[i][v], expected)
        assert not keep[i][~v].any()


@pytest.mark.parametrize("max_out", [40, 80])
def test_batched_nms_topk_matches_jax(max_out):
    # rows of K=60 score-descending boxes; max_out 80 > K exercises the padding
    rng = np.random.RandomState(max_out)
    boxes, valid = tie_rows(max_out, 5, 60, 0.7)
    scores = -np.sort(-rng.rand(5, 60).astype(np.float32), axis=1)
    jb, js, jv = (
        np.asarray(x)
        for x in jkernels.batched_nms_topk(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.7, max_out
        )
    )
    tb, ts, tv = (
        x.numpy()
        for x in tkernels.batched_nms_topk(
            torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.7, max_out
        )
    )
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb[tv], jb[jv])
