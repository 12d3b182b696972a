"""How far f32 rounding alone moves the HTC-DCN and Mask R-CNN losses'
gradients: the readings behind `tests/test_torch_htc_train.py` OFFSET_SCALE,
`chip_smoke.py` GRAD_NORM_LIMIT and the mask-head tolerances of
`tests/test_torch_mask_rcnn.py`. A script, not a test: it prints what it
measures.

    python tests/f64_witness.py tiny    # about 5 min on 4 CPU threads
    python tests/f64_witness.py small   # about 2 min on 8 CPU threads
    python tests/f64_witness.py mask    # about 3 min on 4 CPU threads
    python tests/f64_witness.py variants  # about 2 min on 4 CPU threads

`tiny`: the HTC of test_torch_htc_train.py (GS heads, D = 4) with its offset
convs at a scale of 1.0, through JAX in f32 and in f64 (`jax.enable_x64`;
JAX's own f32 casts, such as the offsets', stay) and through the port in f32
and in f64, on the same weights and inputs. It prints the loss dicts' and
the gradients' largest differences of each pair (each tensor's largest
elementwise difference over its largest value), and the ReLU inputs of the
semantic head's laterals that the port's f32 run puts on the other side of 0
from its f64 run.

`small`: `chip_smoke.py`'s small HTC-DCN step (depth 50 at the X101's
widths, two 256 x 384 images) on the CPU, the port in f32 against the port
in f64: each gradient's relative norm and largest elementwise difference.

`mask`: the tiny GS Mask R-CNN of test_torch_mask_rcnn.py with its 0/1 gt
crops. JAX's gradient is taken from two compiles of the same loss: "jax A",
the whole `loss` in one jit, and "jax B", `_loss_core` in one jit and
`_mask_branch` on its features and targets in another (as the test's branch
check does); then JAX in f64, and the port in f32 and in f64. For each pair
it prints the rois' largest difference, the resampled target pixels that
differ with their sampled crop values in f64, and each mask-head gradient's
largest difference over its largest value; then the ReLU inputs after the
mask head's upsampling that the port's f32 run puts on the other side of 0
from its f64 run.

`variants`: Grid and Mask-Scoring R-CNN at tests/torch_variant_suite.py's
tiny configuration, the port in f32 and in f64 against JAX in f32, on the
same weights and inputs: the gradients of the heads that the suite holds in
f64 (`F64_HELD`), each tensor's largest difference over its largest value,
the five worst of each pair.
"""

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def tiny() -> None:
    import test_torch_htc_train as T
    from balancedgroupsoftmax_tpu.models.htc import build_htc as jax_build_htc
    from test_torch_cascade_train import total_loss
    from test_torch_deform_conv import _np, _offset_params
    from tests.test_detector import make_batch, tiny_partition

    torch.set_num_threads(4)
    jcfg = T.deterministic_htc(True, 4)
    batch = make_batch()
    crops, seg = T.mask_inputs(np.asarray(batch[3]))
    inputs = [np.asarray(x) for x in (*batch, crops, seg)]
    init = _np(jax.jit(jax_build_htc(jcfg, partition=tiny_partition()).init)(jax.random.PRNGKey(0), batch[0][:1]))
    variables = _offset_params(np.random.RandomState(7), copy.deepcopy(init), 1.0)
    setup = dict(jcfg=jcfg, use_gs=True, variables=variables)

    def jax_run(dtype):
        model = jax_build_htc(jcfg, partition=tiny_partition(), dtype=dtype)
        cast = lambda a: jnp.asarray(a, dtype) if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a)
        v = jax.tree_util.tree_map(cast, variables)
        ins = [cast(x) for x in inputs]

        def loss_fn(params):
            losses = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins, method="loss",
                                 rngs={"sampling": jax.random.PRNGKey(0)})
            return total_loss(losses), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        grads = {k: t.double().numpy() for k, t in T.port_tree(setup, _np(grads)).items()}
        return {k: float(x) for k, x in losses.items()}, grads, None

    def port_run(dtype):
        model = T.port_model(setup, dtype)
        relu_inputs = {}
        for i, lateral in enumerate(model.semantic_head.lateral):
            lateral.register_forward_hook(lambda mod, a, out, i=i: relu_inputs.__setitem__(i, out.detach().double()))
        ins = [torch.from_numpy(np.array(x)) for x in inputs]
        ins = [x.to(dtype) if x.is_floating_point() else x for x in ins]
        losses = model.loss(*ins, generator=torch.Generator().manual_seed(0))
        total_loss(losses).backward()
        grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
        return {k: v.item() for k, v in losses.items()}, grads, relu_inputs

    runs = {"jax f32": jax_run(jnp.float32)}
    with jax.enable_x64(True):
        runs["jax f64"] = jax_run(jnp.float64)
    runs["port f32"] = port_run(torch.float32)
    runs["port f64"] = port_run(torch.float64)
    names = sorted(runs["port f32"][1])
    print("tiny HTC-DCN, offset convs at a scale of 1.0: largest difference of each tensor over its largest value")
    for a, b in [("port f32", "jax f32"), ("port f64", "jax f32"), ("port f64", "jax f64"), ("jax f32", "jax f64"),
                 ("port f32", "port f64")]:
        la, ga, _ = runs[a]
        lb, gb, _ = runs[b]
        loss = max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb)
        rel = {n: np.abs(ga[n] - gb[n]).max() / max(np.abs(gb[n]).max(), 1e-30) for n in names}
        part = lambda pred: max(((r, n) for n, r in rel.items() if pred(n)), default=(0.0, "-"))
        bb, heads = part(lambda n: n.startswith("backbone")), part(lambda n: not n.startswith("backbone"))
        print(f"  {a} vs {b}: losses {loss:.3e}; backbone {bb[0]:.3e} ({bb[1]}); heads {heads[0]:.3e} ({heads[1]})")
    for i, hi in sorted(runs["port f64"][2].items()):
        flip = (runs["port f32"][2][i] > 0) != (hi > 0)
        if flip.any():
            print(f"  semantic_head.lateral.{i}: {int(flip.sum())} ReLU inputs change side in f32, f64 values "
                  f"{[float(f'{v:.3e}') for v in hi[flip].tolist()]} (largest |input| {hi.abs().max().item():.3e})")


def small() -> None:
    import chip_smoke
    from balancedgroupsoftmax_torch.models.detector import build_model

    torch.set_num_threads(8)
    model = chip_smoke.htc_model(torch, torch.device("cpu"))
    cfg, batch, weights = chip_smoke.small_mask_train_case(torch, model)
    keys = ("images", "gt_boxes", "gt_labels", "gt_mask", "img_shapes", "gt_mask_crops")
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = build_model(cfg, model.partition, dtype)
        m.load_state_dict(weights)
        m.to(dtype)
        ins = [batch[k].to(dtype) if batch[k].is_floating_point() else batch[k] for k in keys]
        losses = m.loss(*ins, generator=torch.Generator().manual_seed(0))
        sum(v for k, v in losses.items() if "loss" in k).backward()
        grads[dtype] = {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None}
    norm, peak = chip_smoke.grad_differences(grads[torch.float32], grads[torch.float64])
    dcn = [n for n in norm if n.endswith(("conv2.weight", "conv2.conv_offset.weight", "conv2.conv_offset.bias"))
           and n.rsplit("conv2.", 1)[0] + "conv2.conv_offset.weight" in norm]
    print("chip_smoke.py's small HTC-DCN step on the CPU, the port in f32 against f64:")
    for label, d in (("relative norm", norm), ("largest elementwise difference", peak)):
        top = sorted(d.items(), key=lambda kv: -kv[1])[:4]
        print(f"  {label}: " + ", ".join(f"{n} {v:.3e}" for n, v in top)
              + f"; over the {len(dcn)} deformable tensors {max(d[n] for n in dcn):.3e}")


def mask() -> None:
    import scipy.optimize
    import test_torch_mask_rcnn as T
    from balancedgroupsoftmax_torch import config as tconfig
    from balancedgroupsoftmax_torch.gs.partition import make_partition
    from balancedgroupsoftmax_torch.models import detector as port_detector
    from test_torch_cascade_train import total_loss
    from test_torch_detector import COUNTS, to_port
    from test_torch_deform_conv import _np
    from test_torch_htc_train import mask_inputs
    from tests.test_detector import make_batch, tiny_partition

    torch.set_num_threads(4)
    jcfg = T.deterministic_mask_config(True)
    batch = make_batch()
    crops, _ = mask_inputs(np.asarray(batch[3]))
    inputs = [np.asarray(x) for x in (*batch, crops)]
    build = lambda dtype: T.jax_build_model(jcfg, partition=tiny_partition(), dtype=dtype)
    variables = _np(jax.jit(build(jnp.float32).init)(jax.random.PRNGKey(0), batch[0][:1]))
    rngs = {"sampling": jax.random.PRNGKey(0)}
    setup = dict(variables=variables)
    as_port = lambda g: {k[len("mask_head."):]: t.double().numpy() for k, t in T.grads_as_port(setup, _np(g)).items()
                         if k.startswith("mask_head.")}

    def whole(m, *a):
        losses, feats, t = m._loss_core(*a[:-1])
        out = m._mask_branch(feats, t, a[1], a[-1], losses)
        return losses, (t.rois, t.pos_gt_inds, out["m_targets"])

    def jax_a(dtype):
        model = build(dtype)
        cast = lambda a: jnp.asarray(a, dtype) if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a)
        v = jax.tree_util.tree_map(cast, variables)
        ins = [cast(x) for x in inputs]

        def loss_fn(params):
            losses, aux = model.apply({"params": params, "batch_stats": v["batch_stats"]}, *ins, method=whole,
                                      rngs=rngs)
            return total_loss(losses), aux

        (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        return as_port(grads), [np.asarray(x) for x in aux], None

    def jax_b():
        model = build(jnp.float32)
        _, feats, t = jax.jit(lambda v: model.apply(v, *batch, method=lambda m, *a: m._loss_core(*a), rngs=rngs))(
            variables)

        def branch(m, f, tt, gb, c):
            out = {}
            return out, m._mask_branch(f, tt, gb, c, out)["m_targets"]

        def loss_fn(params):
            out, m_targets = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, feats, t,
                                         batch[1], jnp.asarray(crops), method=branch)
            return out["loss_mask"], m_targets

        (_, m_targets), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        return as_port(grads), [np.asarray(x) for x in (t.rois, t.pos_gt_inds, m_targets)], None

    def port(dtype):
        model = port_detector.build_model(to_port(tconfig.DetectorConfig, jcfg), make_partition(COUNTS), dtype)
        model.load_state_dict(T.to_torch_tree(variables))
        model.to(dtype)
        relu_inputs = []
        model.mask_head.upsample.register_forward_hook(lambda mod, a, out: relu_inputs.append(out.detach().double()))
        seen = []
        targets = port_detector.mask_targets

        def recorded(rois, *a, **k):
            out = targets(rois, *a, **k)
            seen.append((rois, a[1], out))
            return out

        port_detector.mask_targets = recorded
        try:
            ins = [torch.from_numpy(np.array(x)) for x in inputs]
            ins = [x.to(dtype) if x.is_floating_point() else x for x in ins]
            total_loss(model.loss(*ins, generator=torch.Generator().manual_seed(0))).backward()
        finally:
            port_detector.mask_targets = targets
        rois, gt_inds, m_targets = seen[0]
        grads = {n: p.grad.double().numpy() for n, p in model.mask_head.named_parameters()}
        return grads, [t.detach().double().numpy() for t in (rois, gt_inds, m_targets)], relu_inputs[0]

    runs = {"jax A": jax_a(jnp.float32), "jax B": jax_b()}
    with jax.enable_x64(True):
        runs["jax A f64"] = jax_a(jnp.float64)
    runs["port f32"] = port(torch.float32)
    runs["port f64"] = port(torch.float64)
    print("tiny GS Mask R-CNN, 0/1 gt crops: each mask-head gradient's largest difference over its largest value")
    for a, b in [("jax B", "jax A"), ("port f32", "jax A"), ("port f64", "jax A"), ("jax A f64", "jax A"),
                 ("port f64", "jax A f64"), ("port f32", "port f64")]:
        (ga, (ra, ia, ta), _), (gb, (rb, ib, tb), _) = runs[a], runs[b]
        rel = {n: np.abs(ga[n] - gb[n]).max() / np.abs(gb[n]).max() for n in gb}
        cap = ta.shape[1]
        # the two samplers may order equal candidates differently: pair the
        # rows of the same gt by their nearest rois
        dist = np.abs(ra[:, :cap, None] - rb[:, None, :cap]).max(-1) + 1e9 * (ia[:, :cap, None] != ib[:, None, :cap])
        pairs = [scipy.optimize.linear_sum_assignment(d) for d in dist]
        ra, ia, ta = (np.stack([x[i][r[np.argsort(c)]] for i, (r, c) in enumerate(pairs)])
                      for x in (ra[:, :cap], ia[:, :cap], ta))
        diff = ta != tb
        vals = T.sampled_crops(rb[:, :cap], inputs[1], ib[:, :cap], crops)[diff]
        print(f"  {a} vs {b}: rois {np.abs(ra - rb).max():.3e}, {int(diff.sum())} target pixels differ"
              + (f" (sampled values {[float(f'{v:.9f}') for v in vals]})" if diff.any() else ""))
        print("    " + ", ".join(f"{n} {r:.3e}" for n, r in rel.items()))
    lo, hi = runs["port f32"][2], runs["port f64"][2]
    flip = (lo > 0) != (hi > 0)
    print(f"  mask_head.upsample: {int(flip.sum())} ReLU inputs change side in the port's f32, f64 values "
          f"{[float(f'{v:.3e}') for v in hi[flip].tolist()]} (largest |input| {hi.abs().max().item():.3e})")


def variants() -> None:
    import torch_variant_suite as S

    torch.set_num_threads(4)
    for kind in ("grid", "mask_scoring"):
        setup = S.setup_of(kind)
        jax_grads = {k: t.double().numpy() for k, t in S.to_torch_tree(
            {"params": setup["grads"], "batch_stats": setup["variables"]["batch_stats"]}).items()}
        port = {}
        for dtype in (torch.float32, torch.float64):
            model = S.build_model(S.to_port(S.tconfig.DetectorConfig, setup["jcfg"]), dtype=dtype)
            model.load_state_dict(S.to_torch_tree(setup["variables"]))
            model.to(dtype)
            inputs = [x.to(dtype) if x.is_floating_point() else x for x in setup["batch"]]
            S.total_loss(model.loss(*inputs, generator=torch.Generator().manual_seed(0))).backward()
            port[dtype] = {n: p.grad.double().numpy() for n, p in model.named_parameters()
                           if n.startswith(S.F64_HELD[kind])}
        print(f"{kind}: the held heads' gradients, largest difference over the tensor's largest value")
        for label, got, want in (("port f32 vs JAX f32", port[torch.float32], jax_grads),
                                 ("port f32 vs port f64", port[torch.float32], port[torch.float64])):
            rel = {n: np.abs(got[n] - want[n]).max() / np.abs(want[n]).max() for n in got}
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
            print(f"  {label}: " + ", ".join(f"{n} {r:.3e}" for n, r in worst))


if __name__ == "__main__":
    {"tiny": tiny, "small": small, "mask": mask, "variants": variants}[sys.argv[1]]()
