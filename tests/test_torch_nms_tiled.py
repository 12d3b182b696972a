"""K4 (the greedy keep for any K, the training RPN's K = 2000) of the PyTorch
port against the JAX package.

On the CPU the port's `nms_keep_tiled` runs its plain version; the JAX side
runs the Pallas kernel `nms_keep_tiled` in interpret mode. Keep masks are
compared for equality, on rows with duplicates, boxes exactly at the
threshold and invalid slots: both compute IoU in the same f32 operation
order. `batched_nms_topk` at K = 2000 (which the port sends to K4) is held to
the JAX function of the same name, which runs `ops/nms.py nms_keep` on the
CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu import kernels as jkernels
from balancedgroupsoftmax_tpu.pallas.nms import nms_keep_tiled as pallas_nms_keep_tiled
from balancedgroupsoftmax_torch import cuda
from balancedgroupsoftmax_torch import kernels as tkernels
from balancedgroupsoftmax_torch.ops.nms import nms_keep_tiled
from test_torch_cuda import tie_rows


@pytest.mark.parametrize("k", [2000, 1337])
def test_keep_matches_pallas_tiled_interpret(k):
    boxes, valid = tie_rows(k, 2, k, 0.7, spread=600)
    want = np.asarray(pallas_nms_keep_tiled(jnp.asarray(boxes), jnp.asarray(valid), 0.7, interpret=True))
    got = nms_keep_tiled(torch.from_numpy(boxes), torch.from_numpy(valid), 0.7).numpy()
    assert 0 < want.sum() < valid.sum()  # some boxes suppressed, some kept
    np.testing.assert_array_equal(got, want)


def test_batched_nms_topk_at_train_k_matches_jax():
    boxes, valid = tie_rows(11, 3, 2000, 0.7, spread=600)
    scores = np.sort(np.random.RandomState(0).rand(3, 2000).astype(np.float32), axis=1)[:, ::-1].copy()
    want = jkernels.batched_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.7, 1500)
    before = [k.launches for k in cuda.KERNELS]
    got = tkernels.batched_nms_topk(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.7, 1500
    )
    assert [k.launches for k in cuda.KERNELS] == before  # the CPU runs the plain versions
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
