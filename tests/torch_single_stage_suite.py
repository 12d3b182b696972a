"""The parity tests that every single-stage detector of the port passes
against the JAX package, shared by tests/test_torch_retinanet.py,
test_torch_fcos.py, test_torch_fovea.py, test_torch_reppoints.py,
test_torch_guided_anchor.py and test_torch_ssd.py, which import them and give
them their `model` fixture (`model_fixture`), one JAX build a model and
process.

The configurations are JAX's own tests' tiny ones (9 classes, 128 x 128;
SSD at 300 x 300; GA-RPN at its defaults) on JAX `tests/test_detector.py`'s
`make_batch`. The weights are seeded numpy arrays in the shapes of the flax
tree (`jax.eval_shape` of `init`: no XLA compile of `init`), laid out as
flax initialises them (lecun-normal convolutions, zero biases, identity
BatchNorm), and with what makes each path do work:
class biases of -1 (scores near 0.27, above `score_thr`), RepPoints' point
and GA-RPN's offset convs scaled so the deformable offsets spread over
several cells (K7's plain version at the exact gather, D = 0, far from
integer positions), and GA-RPN's location logits spread around its filter.
`convert.params_from_flax` carries them over. JAX runs one jit a model
(`jax_run`): the head outputs, the serving call, the loss dict and the
gradient of the losses' sum; `jax.debug.callback` records what the JAX loss
hands its loss functions (the targets) as it runs.

The tests and their tolerances:
- the converted tensors load with `strict=True`;
- every per-level head output within 1e-5 of its tensor's largest value;
- `predict` (GA-RPN: `propose`): labels and `valid` exact, boxes within
  1e-3 px, scores within 1e-5;
- each loss within 1e-4 relative;
- every gradient within 1e-3 of its tensor's largest value;
- the model's own file holds its targets to JAX's, exactly.

Where f32 rounding alone moves an output or a gradient past its tolerance,
and the port's f32 parts from its own f64 by as much as from JAX's (`python
tests/f64_witness.py single_stage` prints the readings), the spec names it
(`f64_heads`, `f64_grads`) and the model's own file holds it in f64 against
JAX in f64 (`f64_run`) within 1e-5 of its largest value: GA-RPN's RPN
logits and deltas, which the adaption DCN's 2304-term sums feed (its f32
parts from its f64 by up to 7.7e-6 of their largest value), and SSD's
first convolutions' gradients, where the whole VGG's backward cancels (JAX's
f32 parts from the port's f64 by up to 2.3e-3).

PyTorch runs on one CPU thread in these files (ROADMAP caveat v).
"""

import dataclasses
import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balancedgroupsoftmax_tpu.config import ProposalConfig as JaxProposalConfig
from balancedgroupsoftmax_tpu.models import fcos as jfcos
from balancedgroupsoftmax_tpu.models import fovea as jfovea
from balancedgroupsoftmax_tpu.models import guided_anchor as jga
from balancedgroupsoftmax_tpu.models import reppoints as jreppoints
from balancedgroupsoftmax_tpu.models import retinanet as jretina
from balancedgroupsoftmax_tpu.models import ssd as jssd
from balancedgroupsoftmax_torch.config import ProposalConfig
from balancedgroupsoftmax_torch.convert import params_from_flax
from balancedgroupsoftmax_torch.models import fcos, fovea, guided_anchor, reppoints, retinanet, ssd
from test_detector import make_batch

TINY = dict(num_classes=9, image_size=(128, 128), nms_pre=64, max_per_img=10)
PROPOSALS = dict(nms_pre=128, nms_post=64, max_num=64)  # JAX test_guided_anchor.py's
CLASS_BIAS = -1.0
# GA-RPN's adaption DCN gives exact zeros where all nine samples fall outside
# a small level; behind a zero bias the RPN logit is then exactly 0, where the
# BCE's kinks give JAX -t and PyTorch 1 - t as the derivative (the smooth
# loss's is 0.5 - t; ROADMAP "Known differences"). The bias keeps it off 0.
RPN_BIAS = 0.05


@dataclasses.dataclass(frozen=True)
class Spec:
    jax_module: Any
    jax_model: str
    jax_config: str
    port_model: Callable
    port_config: Callable
    config: dict
    size: int = 128
    loss_takes_shapes: bool = True
    # flax parameter paths -> how the seeded weights are changed: ("scale", f) multiplies, ("set", v) sets
    tweaks: tuple = ()
    # the loss functions of the JAX module whose arguments the run records
    recorded: tuple = ("sigmoid_focal_loss", "smooth_l1")
    # held in f64 (`f64_run`), not in f32: the head outputs of these indices, the gradients of these prefixes
    f64_heads: tuple = ()
    f64_grads: tuple = ()


SPECS = {
    "retinanet": Spec(jretina, "RetinaNet", "RetinaNetConfig", retinanet.RetinaNet, retinanet.RetinaNetConfig, TINY,
                      tweaks=(("bbox_head/retina_cls/bias", ("set", CLASS_BIAS)),)),
    "fcos": Spec(jfcos, "FCOS", "FCOSConfig", fcos.FCOS, fcos.FCOSConfig, TINY,
                 tweaks=(("bbox_head/fcos_cls/bias", ("set", CLASS_BIAS)),),
                 recorded=("sigmoid_focal_loss", "binary_cross_entropy_with_logits", "bbox_overlaps")),
    "fovea": Spec(jfovea, "FoveaBox", "FoveaConfig", fovea.FoveaBox, fovea.FoveaConfig, TINY,
                  tweaks=(("bbox_head/fovea_cls/bias", ("set", CLASS_BIAS)),)),
    "reppoints": Spec(jreppoints, "RepPoints", "RepPointsConfig", reppoints.RepPoints, reppoints.RepPointsConfig, TINY,
                      tweaks=(("bbox_head/cls_out/bias", ("set", CLASS_BIAS)),
                              ("bbox_head/pts_init_out/kernel", ("scale", 2.5)),
                              ("bbox_head/pts_refine_out/kernel", ("scale", 2.5)))),
    "guided_anchor": Spec(jga, "GARPN", "GAConfig", guided_anchor.GARPN, guided_anchor.GAConfig,
                          dict(image_size=(128, 128)),
                          tweaks=(("rpn_head/conv_loc/kernel", ("scale", 60.0)),
                                  ("rpn_head/conv_loc/bias", ("set", -4.595)),
                                  ("rpn_head/ga_rpn_cls/bias", ("set", RPN_BIAS))),
                          recorded=("sigmoid_focal_loss", "binary_cross_entropy_with_logits", "smooth_l1"),
                          f64_heads=(2, 3)),
    "ssd": Spec(jssd, "SSD", "SSDConfig", ssd.SSD, ssd.SSDConfig, dict(num_classes=9, max_per_img=10), size=300,
                loss_takes_shapes=False, recorded=("smooth_l1",), f64_grads=("backbone.conv1_",)),
}


def seeded_variables(shapes, seed: int = 0) -> dict:
    """numpy weights in the shapes of a flax tree, laid out as flax
    initialises them: conv kernels (and the raw deformable kernels) lecun-
    normal, zero biases, identity BatchNorm, FCOS's level scales 1; the
    L2Norm scale near 20."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape, last = leaf.shape, name.rsplit("/", 1)[-1]
        if len(shape) == 4:
            return rng.randn(*shape).astype(np.float32) / math.sqrt(np.prod(shape[:-1]))
        if "l2norm" in name:
            return (20 * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
        if last in ("scale", "var") or last.startswith("scale"):
            return np.ones(shape, np.float32)
        return np.zeros(shape, np.float32)  # biases, BatchNorm means

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tweak(variables: dict, tweaks) -> dict:
    for path, (how, value) in tweaks:
        *parents, leaf = path.split("/")
        node = variables["params"]
        for p in parents:
            node = node[p]
        node[leaf] = (node[leaf] * value if how == "scale" else np.full_like(node[leaf], value)).astype(np.float32)
    return variables


def recording(module, names, store: dict):
    """Patch `module.<name>` for each of `names` to record the arrays it is
    handed, as the jitted JAX loss runs, under (name, the call's order at
    trace time) in `store`. Returns the originals, to restore."""
    originals = {name: getattr(module, name) for name in names}
    count = {"n": 0}

    for name, fn in originals.items():
        def wrapped(*args, _fn=fn, _name=name, **kw):
            arrays = {str(i): a for i, a in enumerate(args)}
            arrays.update({k: v for k, v in kw.items() if isinstance(v, jax.Array)})
            key = (_name, count["n"])
            count["n"] += 1
            jax.debug.callback(lambda **a: store.__setitem__(key, {k: np.asarray(v) for k, v in a.items()}), **arrays)
            return _fn(*args, **kw)

        setattr(module, name, wrapped)
    return originals


def build_setup(kind: str) -> dict:
    """JAX's model of `kind` on the tiny batch: its variables, head outputs,
    serving outputs, loss dict, gradient and recorded loss arguments."""
    spec = SPECS[kind]
    jmodel = getattr(spec.jax_module, spec.jax_model)(cfg=getattr(spec.jax_module, spec.jax_config)(**spec.config))
    size = spec.size
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    variables = tweak(seeded_variables(shapes), spec.tweaks)
    batch = [np.asarray(a) for a in make_batch(size=(size, size))]
    images, img_shapes = batch[0], batch[4]
    sf = np.asarray([1.0, 0.5], np.float32)
    loss_args = batch if spec.loss_takes_shapes else batch[:4]

    def run(v):
        heads = jmodel.apply(v, images)
        if kind == "guided_anchor":
            served = jmodel.apply(v, images, img_shapes, JaxProposalConfig(**PROPOSALS), method="propose")
        else:
            served = jmodel.apply(v, images, img_shapes, sf, method="predict")

        def loss_fn(params):
            losses = jmodel.apply({**v, "params": params}, *loss_args, method="loss")
            return sum(losses.values()), losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return heads, served, losses, grads

    store: dict = {}
    originals = recording(spec.jax_module, spec.recorded, store)
    try:
        out = jax.jit(run)(variables)
        out = jax.tree_util.tree_map(np.asarray, out)
    finally:
        for name, fn in originals.items():
            setattr(spec.jax_module, name, fn)
    heads, served, losses, grads = out
    # the gradient under the port's names (the BatchNorm statistics ride along, and are dropped)
    grads = params_from_flax({**variables, "params": grads})
    grads = {k: v for k, v in grads.items() if "running_" not in k}
    return dict(kind=kind, spec=spec, variables=variables, heads=heads, served=served, losses=losses,
                grads=grads, recorded=store,
                batch=[torch.from_numpy(a) for a in batch], sf=torch.from_numpy(sf))


_SETUPS: dict = {}


def setup_of(kind: str) -> dict:
    """`build_setup(kind)`, built once a process."""
    if kind not in _SETUPS:
        _SETUPS[kind] = build_setup(kind)
    return _SETUPS[kind]


def model_fixture(kind: str):
    @pytest.fixture(scope="module")
    def model():
        return setup_of(kind)

    return model


def port_model(setup: dict):
    spec = setup["spec"]
    m = spec.port_model(spec.port_config(**spec.config))
    m.load_state_dict(params_from_flax(setup["variables"]), strict=True)
    return m


def recorded(setup: dict, name: str, nth: int = 0) -> dict:
    """The arguments of the `nth` call of JAX's `name` in its loss."""
    calls = sorted((k[1], v) for k, v in setup["recorded"].items() if k[0] == name)
    return calls[nth][1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_converted_weights_load_strictly(model):
    """`port_model` loads with strict=True; every tensor arrives as converted."""
    m = port_model(model)
    got = m.state_dict()
    for k, v in params_from_flax(model["variables"]).items():
        assert torch.equal(got[k], v), k


def test_head_outputs_match_jax(model):
    m = port_model(model)
    with torch.no_grad():
        outs = m(model["batch"][0])
    assert len(outs) == len(model["heads"])
    for lvl, (got, want) in enumerate(zip(outs, model["heads"])):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            g = g.permute(0, 2, 3, 1).numpy()
            assert g.shape == w.shape, (lvl, i)
            if i in model["spec"].f64_heads:
                continue  # `f64_run` holds it
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=f"level {lvl} output {i}")


def test_serving_matches_jax(model):
    m = port_model(model).eval()
    images, _, _, _, img_shapes = model["batch"]
    if model["kind"] == "guided_anchor":
        got = m.propose(images, img_shapes, ProposalConfig(**PROPOSALS))
    else:
        got = m.predict(images, img_shapes, model["sf"])
    want = model["served"]
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if hasattr(got, "labels"):
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)


def port_losses_and_grads(setup: dict):
    m = port_model(setup)
    batch = setup["batch"] if setup["spec"].loss_takes_shapes else setup["batch"][:4]
    losses = m.loss(*batch)
    sum(losses.values()).backward()
    return losses, {n: p.grad for n, p in m.named_parameters()}


def test_losses_and_every_gradient_match_jax(model):
    losses, grads = port_losses_and_grads(model)
    assert sorted(losses) == sorted(model["losses"])
    for k, v in model["losses"].items():
        assert float(v) > 0, k
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert sorted(grads) == sorted(model["grads"])
    for name, w in model["grads"].items():
        w = w.numpy()
        assert grads[name] is not None, name
        if name.startswith(model["spec"].f64_grads):
            continue  # `f64_run` holds it
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-12, err_msg=name)


def f64_run(setup: dict, images: int = 2):
    """JAX's model in f64 (`jax.enable_x64`) and the port's on the setup's
    weights and the first `images` of its batch cast to f64: ((JAX's head
    outputs, JAX's gradient under the port's names), (the port's head
    outputs, the port's gradient)). With `f64_grads`, only those tensors'
    gradients (their flax paths are their names, '/' for '.'; the others
    behind `stop_gradient` and `requires_grad=False`, which spares XLA's slow
    f64 weight-gradient convolutions)."""
    spec = setup["spec"]
    cast = lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a)
    batch = [cast(b.numpy()[:images]) for b in setup["batch"]]
    loss_args = batch if spec.loss_takes_shapes else batch[:4]
    with jax.enable_x64(True):
        jcfg = getattr(spec.jax_module, spec.jax_config)(**spec.config)
        jmodel = getattr(spec.jax_module, spec.jax_model)(cfg=jcfg, dtype=jnp.float64)
        v = jax.tree_util.tree_map(cast, setup["variables"])

        held = tuple(f"params/{p.replace('.', '/')}" for p in spec.f64_grads)
        path_of = lambda path: "params/" + "/".join(str(getattr(k, "key", k)) for k in path)
        keep = lambda path, x: x if not held or path_of(path).startswith(held) else jax.lax.stop_gradient(x)

        def run(v):
            def loss_fn(params):
                params = jax.tree_util.tree_map_with_path(keep, params)
                return sum(jmodel.apply({**v, "params": params}, *loss_args, method="loss").values())

            # the head outputs only where the spec holds some (XLA's f64 convolutions are slow on the CPU)
            return jmodel.apply(v, batch[0]) if spec.f64_heads else (), jax.grad(loss_fn)(v["params"])

        heads, grads = jax.tree_util.tree_map(np.asarray, jax.jit(run)(v))
    grads = params_from_flax({**setup["variables"], "params": grads})
    want = (heads, {k: g for k, g in grads.items() if "running_" not in k and k.startswith(spec.f64_grads or "")})

    m = spec.port_model(spec.port_config(**spec.config), dtype=torch.float64)
    m.load_state_dict(params_from_flax(setup["variables"]), strict=True)
    m.double()
    for n, p in m.named_parameters():
        p.requires_grad_(n.startswith(spec.f64_grads or ""))
    with torch.no_grad():
        outs = m(torch.from_numpy(batch[0]))
    sum(m.loss(*(torch.from_numpy(a) for a in loss_args)).values()).backward()
    return want, (outs, {n: p.grad for n, p in m.named_parameters() if p.requires_grad})
