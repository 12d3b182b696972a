"""How far f32 rounding alone moves the HTC-DCN loss's gradient: the readings
behind `tests/test_torch_htc_train.py` OFFSET_SCALE and `chip_smoke.py`
GRAD_NORM_LIMIT. A script, not a test: it prints what it measures.

    python tests/f64_witness.py tiny    # about 5 min on 4 CPU threads
    python tests/f64_witness.py small   # about 2 min on 8 CPU threads

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
    cfg, batch, weights = chip_smoke.small_htc_train_case(torch, model)
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


if __name__ == "__main__":
    {"tiny": tiny, "small": small}[sys.argv[1]]()
