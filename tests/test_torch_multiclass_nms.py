"""K3 (gathered per-class NMS) and the multiclass NMS of the PyTorch port
against the JAX package. On the CPU the port runs K3's plain version; the JAX
side runs `pallas/nms.py nms_keep_gathered` in interpret mode and
`kernels.batched_multiclass_nms` through XLA.

Every output is a selection of input values plus the keep decision, so all
are compared for equality.
"""

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


def test_unported_branches_raise():
    boxes, scores, valid = (torch.from_numpy(x) for x in detection_case(0, c=5))
    with pytest.raises(NotImplementedError):
        tkernels.batched_multiclass_nms(boxes, scores, valid, 0.0, 0.5, 10, nms_type="soft_nms")
    with pytest.raises(NotImplementedError):  # class-agnostic boxes too
        tkernels.batched_multiclass_nms(boxes[..., :4], scores, valid, 0.0, 0.5, 10, nms_type="soft_nms")
