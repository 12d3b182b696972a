"""Fused stride-1 ResNet bottleneck for inference: kernels K8 and K9, their
plain versions, the FrozenBN fold and the row-padding helpers.

`fused_bottleneck` replaces JAX `pallas/fused_block.py` `fused_bottleneck`
(:234) and launches `bags_fused_bottleneck` of `csrc/fused_block.cu` on a CUDA
tensor; `fused_layer` replaces `fused_layer` (:448) and launches
`bags_fused_layer`, once a call whatever the number of blocks. On a CPU tensor
each runs its plain version (`fused_bottleneck_reference`,
`fused_layer_reference`).

A block computes, with the FrozenBatchNorms folded into the convolutions
(`fold_bn`), f32 sums and f32 biases, rounding to x's dtype where the JAX
kernel rounds (:139-201):
    y1 = relu(x @ w1 + b1); y2 = relu(conv3x3(y1) + b2), zero padded;
    y3 = y2 @ w3 + b3; ident = x or x @ wd + bd; out = relu(y3 + ident).
Each of y1, y2, y3, ident and out is rounded to x's dtype.

Layouts are the JAX package's: NHWC activations, `FusedBlockParams` with
w1 (Cin, Cm), w2 (9, Cm, Cm) indexed [dy * 3 + dx], w3 (Cm, Cout), wd (Cin,
Cout) and biases (1, C). `fused_bottleneck` takes and returns row-padded
tensors, (B, H + 2, W, C): the halo rows of the input are never read into the
math and those of the output are unspecified, so chained blocks need no
re-padding. `fused_layer` takes and returns unpadded (B, H, W, C), at any H
and W.

`fused_plan` is the kernels' tile plan, from the shapes and the card's SM
count alone: the "halo" route (a tile of TH x 30 output pixels with its halo
on chip, where such tiles fill the card) or the "phase" route (each product a
GEMM over all pixels in work units of 64 or 128 pixels, y1 and y2 in a device
scratch). Both wrappers take the computed plan unless one is passed (the card
tests and `kernel_study` pass them); K9 runs each block with the plan K8
would take for it, so the two agree bit for bit.

As in the JAX package, neither kernel is wired into a model: the port's
backbone runs the unfused `Bottleneck` modules. `stride1_runs` picks the
blocks a backbone could hand to `fused_layer`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import cuda
from ..models.resnet import Bottleneck, FrozenBatchNorm, ResNet
from .deform_conv import DeformConv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FusedBlockParams(NamedTuple):
    """BN-folded weights of one bottleneck, f32 (see `fold_bn`)."""

    w1: torch.Tensor  # (Cin, Cm)
    b1: torch.Tensor  # (1, Cm)
    w2: torch.Tensor  # (9, Cm, Cm)  [dy * 3 + dx]
    b2: torch.Tensor  # (1, Cm)
    w3: torch.Tensor  # (Cm, Cout)
    b3: torch.Tensor  # (1, Cout)
    wd: Optional[torch.Tensor]  # (Cin, Cout) folded downsample, or None
    bd: Optional[torch.Tensor]  # (1, Cout)


def fold_bn(kernel: torch.Tensor, bn: FrozenBatchNorm):
    """Fold a FrozenBatchNorm into a kernel whose last axis is its output
    channels: W' = W * inv, b' = beta - mean * inv, inv = scale / sqrt(var +
    eps), in f32. Returns (W', b' of shape (1, C))."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.epsilon)
    return kernel.float() * inv, (bn.bias.float() - bn.running_mean.float() * inv)[None, :]


def _one_by_one(conv) -> torch.Tensor:
    """A 1x1 conv's (Cout, Cin, 1, 1) weight as (Cin, Cout)."""
    return conv.weight.detach()[:, :, 0, 0].t()


def fold_bottleneck(block: Bottleneck) -> FusedBlockParams:
    """Fold one port `Bottleneck` (convs and FrozenBatchNorms) into
    `FusedBlockParams`. Raises ValueError on a block the kernels cannot take:
    a stride-2 block, a grouped 3x3 (ResNeXt) or a deformable 3x3."""
    conv2 = block.conv2
    if isinstance(conv2, DeformConv):
        raise ValueError("the fused bottleneck takes a plain 3x3, not a deformable one")
    if conv2.groups != 1:
        raise ValueError(f"the fused bottleneck takes an ungrouped 3x3, not {conv2.groups} groups")
    if tuple(conv2.stride) != (1, 1):
        raise ValueError(f"the fused bottleneck takes stride-1 blocks, not stride {tuple(conv2.stride)}")
    with torch.no_grad():
        w1, b1 = fold_bn(_one_by_one(block.conv1), block.bn1)
        k2 = conv2.weight.detach().permute(2, 3, 1, 0)  # (3, 3, Cm_in, Cm_out)
        w2, b2 = fold_bn(k2, block.bn2)
        w2 = w2.reshape(9, k2.shape[2], k2.shape[3])
        w3, b3 = fold_bn(_one_by_one(block.conv3), block.bn3)
        wd = bd = None
        if block.downsample is not None:
            wd, bd = fold_bn(_one_by_one(block.downsample[0]), block.downsample[1])
    return FusedBlockParams(w1, b1, w2, b2, w3, b3, wd, bd)


def stride1_runs(resnet: ResNet) -> list[list[Bottleneck]]:
    """The stride-1 blocks of each of the four stages, in order: for the R50,
    layer1 blocks 0-2 (block 0 with a downsample at stride 1), layer2 1-3,
    layer3 1-5 and layer4 1-2. The stride-2 entry blocks stay out."""
    runs = []
    for stage in (resnet.layer1, resnet.layer2, resnet.layer3, resnet.layer4):
        runs.append([blk for blk in stage if tuple(blk.conv2.stride) == (1, 1)])
    return runs


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> row-padded (B, H + 2, W, C), halo rows zero."""
    return F.pad(x, (0, 0, 0, 0, 1, 1))


def unpad_rows(x: torch.Tensor) -> torch.Tensor:
    return x[:, 1:-1]


def _block_reference(x: torch.Tensor, p: FusedBlockParams) -> torch.Tensor:
    """One block on unpadded (B, H, W, Cin), in x's dtype."""
    dt = x.dtype
    _, h, w, _ = x.shape

    def mm(a, wgt):  # the weight as the kernel holds it (x's dtype), summed in f32
        return a.float() @ wgt.to(dt).float()

    y1 = torch.relu(mm(x, p.w1) + p.b1.float()).to(dt)
    y1p = F.pad(y1, (0, 0, 1, 1, 1, 1))
    acc = sum(mm(y1p[:, dy : dy + h, dx : dx + w], p.w2[dy * 3 + dx]) for dy in range(3) for dx in range(3))
    y2 = torch.relu(acc + p.b2.float()).to(dt)
    y3 = (mm(y2, p.w3) + p.b3.float()).to(dt)
    ident = x if p.wd is None else (mm(x, p.wd) + p.bd.float()).to(dt)
    return torch.relu((y3.float() + ident.float()).to(dt))


def fused_bottleneck_reference(x: torch.Tensor, p: FusedBlockParams) -> torch.Tensor:
    """Plain version of K8: row-padded (B, H + 2, W, Cin) -> (B, H + 2, W,
    Cout); the output's halo rows are zero."""
    return pad_rows(_block_reference(unpad_rows(x), p))


def fused_layer_reference(x: torch.Tensor, blocks: Sequence[FusedBlockParams]) -> torch.Tensor:
    """Plain version of K9: the blocks chained on unpadded (B, H, W, Cin)."""
    for p in blocks:
        x = _block_reference(x, p)
    return x


def _kernel_weights(p: FusedBlockParams, dt: torch.dtype, cin: int, stage: str) -> list:
    """The block's weights in x's dtype and biases in f32, checked for the
    kernel: [w1, b1, w2, b2, w3, b3, wd, bd], wd and bd None for an identity."""
    cm, cout = p.w1.shape[1], p.w3.shape[1]
    if p.w1.shape[0] != cin:
        raise ValueError(f"{stage}: w1 takes {p.w1.shape[0]} channels, the input has {cin}")
    if (p.wd is None) != (p.bd is None) or (p.wd is None and cin != cout):
        raise ValueError(f"{stage}: a block without downsample must keep its {cin} channels, not give {cout}")
    if cin % 16 or cm % 16 or cout % 16:
        raise ValueError(f"{stage}: the kernel takes channels in multiples of 16, got {cin}, {cm}, {cout}")
    shapes = [(cin, cm), (1, cm), (9, cm, cm), (1, cm), (cm, cout), (1, cout), (cin, cout), (1, cout)]
    out = []
    for i, (t, shape) in enumerate(zip(p, shapes)):
        if t is None:
            out.append(None)
            continue
        t = t.to(dt if i % 2 == 0 else torch.float32).contiguous()
        cuda.check(t, dt if i % 2 == 0 else torch.float32, shape, f"{stage} {FusedBlockParams._fields[i]}")
        out.append(t)
    return out


# csrc/fused_block.cu's geometry, mirrored for the plan
_TW, _HW = 30, 32  # a halo tile's output columns and its row pitch
_MAX_SHARED = 232448  # a block's shared memory on the H100
_BAR_BYTES = 64
_CHUNK_ROW = 128  # bytes of one row of a K-chunk
_B_BYTES = 16384  # a weight chunk
_MAX_MB = 2  # 64-row blocks a warpgroup holds of one job
_MAX_RING = 4
_ROUTES = {"halo": 0, "phase": 1}
H100_SMS = 132


class FusedPlan(NamedTuple):
    """How K8 and K9 tile one block (`fused_plan`)."""

    route: str  # "halo" or "phase"
    rows: int  # halo: output rows a tile (TH); phase: pixels a work unit
    smem: int  # shared memory of one block of threads, bytes
    units: tuple  # work units of each phase: (tiles,) or (conv1, conv2, conv3)
    note: str  # why a phase has fewer units than the card has SMs, or ""


def _unit_cols(n: int) -> int:
    return 128 if n % 128 == 0 else 64


def _part_rows(n: int) -> int:
    """Rows of one job: a product's rows run in parts of _MAX_MB 64-row
    blocks a warpgroup."""
    return (1 if _unit_cols(n) == 128 else 2) * _MAX_MB * 64


def _align(x: int) -> int:
    return (x + 127) & ~127


def _stage_smem(route: str, rows: int, cm: int, cout: int, es: int) -> tuple[int, int]:
    """(bytes before the ring, rows of the ring's A region) of one block."""
    ident = 256 * _MAX_MB * 32 * es  # the downsample's sum: 32 values a 64-row block and consumer thread
    if route == "halo":
        y1 = ((rows + 2) * _HW + 8) * cm * es
        arows = max(min((rows + 2) * _HW, _part_rows(cm)), min(rows * _HW, _part_rows(cout)))
        return _align(max(y1, ident)) + _align(rows * _HW * cm * es), arows
    return _align(ident), rows


def _plan_ok(route: str, rows: int, cm: int, cout: int) -> bool:
    if route == "halo":
        return rows >= 2 and rows % 2 == 0
    return rows >= 64 and rows % 64 == 0 and rows <= min(_part_rows(cm), _part_rows(cout))


def _shared_bytes(stages: Sequence[tuple], es: int) -> Optional[int]:
    """A launch's shared memory over its blocks' (route, rows, cm, cout), as
    the kernel lays it out (the ring takes 2-4 stages), or None if it does
    not fit."""
    fixed, arows = zip(*(_stage_smem(*st, es) for st in stages))
    ring_off, stage = _align(max(fixed)), _align(max(arows) * _CHUNK_ROW) + _B_BYTES
    room = _MAX_SHARED - _BAR_BYTES
    if room < ring_off + 2 * stage:
        return None
    ring = min(_MAX_RING, (room - ring_off) // stage)
    return ring_off + ring * stage + 16 * ring


def _units(route: str, rows: int, b: int, h: int, w: int, cm: int, cout: int) -> tuple:
    if route == "halo":
        return (b * -(-h // rows) * -(-w // _TW),)
    mt = -(-(b * h * w) // rows)
    return tuple(mt * -(-n // _unit_cols(n)) for n in (cm, cm, cout))


@functools.cache
def fused_plan(b: int, h: int, w: int, cin: int, cm: int, cout: int, dtype: torch.dtype, sms: int = H100_SMS,
               route: Optional[str] = None, rows: Optional[int] = None) -> FusedPlan:
    """The tile plan of one stride-1 block of (b, h, w) pixels, cin -> cm ->
    cout channels, in `dtype`, on a card of `sms` SMs.

    The rule: the halo route with the tallest TH of 8 and 6 (conv1 on at most
    1.42x the output pixels) that fits shared memory and gives at least four
    tiles an SM (a tile is a large unit of work, so fewer waves leave the
    last one's idle SMs a large share); else the phase route, with 128-pixel
    work units if every phase then has one an SM, else 64. On the H100 this
    takes the halo route for the R50's layer1 only: `kernel_study` times
    every plan at each run. `route` (and `rows`) force a route
    (and its size; by default the tallest TH or the larger unit that fits).
    Raises ValueError for a plan that fits nothing. Cached: the wrappers ask
    for it at every launch."""
    es = 2 if dtype == torch.bfloat16 else 4

    def fits(rt, r):
        return _plan_ok(rt, r, cm, cout) and _shared_bytes([(rt, r, cm, cout)], es) is not None

    if route is None:
        for th in (8, 6):
            if fits("halo", th) and _units("halo", th, b, h, w, cm, cout)[0] >= 4 * sms:
                route, rows = "halo", th
                break
        else:
            route = "phase"
            rows = 128 if fits("phase", 128) and min(_units("phase", 128, b, h, w, cm, cout)) >= sms else 64
    if route not in _ROUTES:
        raise ValueError(f"a fused plan's route is 'halo' or 'phase', not {route!r}")
    if rows is None:
        rows = next((r for r in ((8, 6, 4, 2) if route == "halo" else (128, 64)) if fits(route, r)), None)
        if rows is None:
            raise ValueError(f"no {route} plan fits a block of {cin} -> {cm} -> {cout} channels in {dtype}")
    if not fits(route, rows):
        raise ValueError(f"the {route} plan with {rows} rows does not fit a block of {cin} -> {cm} -> {cout} "
                         f"channels in {dtype}")
    units = _units(route, rows, b, h, w, cm, cout)
    note = ""
    if min(units) < sms:
        note = (f"{min(units)} work units in a phase, fewer than the {sms} SMs: "
                + ("the plan was forced" if route == "halo" else f"{b * h * w} pixels in units of {rows}"))
    return FusedPlan(route, rows, _shared_bytes([(route, rows, cm, cout)], es), units, note)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def run_plans(b: int, h: int, w: int, cin: int, blocks: Sequence[FusedBlockParams], dtype: torch.dtype,
              sms: int = H100_SMS) -> list:
    """The plan of each block of a run on (b, h, w, cin), as K8 takes it for
    that block alone: what K9 runs each block with."""
    plans = []
    for p in blocks:
        plans.append(fused_plan(b, h, w, cin, p.w1.shape[1], p.w3.shape[1], dtype, sms))
        cin = p.w3.shape[1]
    return plans


def fused_bottleneck(x: torch.Tensor, p: FusedBlockParams, plan: Optional[FusedPlan] = None) -> torch.Tensor:
    """K8: one stride-1 block on row-padded (B, H + 2, W, Cin) -> (B, H + 2,
    W, Cout) in x's dtype (f32 or bf16), with `plan` or the computed one."""
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, p)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_bottleneck takes f32 or bf16 input, got {x.dtype}")
    b, hp, w, cin = x.shape
    cuda.check(x, x.dtype, (b, hp, w, cin), "x")
    if hp < 3:
        raise ValueError(f"a row-padded input has at least 3 rows, got {hp}")
    wts = _kernel_weights(p, x.dtype, cin, "block")
    cm, cout = p.w1.shape[1], p.w3.shape[1]
    out = torch.empty(b, hp, w, cout, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = plan or fused_plan(b, hp - 2, w, cin, cm, cout, x.dtype, _sm_count(x.device.index or 0))
    scratch = torch.empty(2 * b * (hp - 2) * w * cm, dtype=x.dtype, device=x.device) if plan.route == "phase" else None
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    ptrs = [0 if t is None else t.data_ptr() for t in wts]
    cuda.FUSED_BOTTLENECK(
        _DTYPE_CODES[x.dtype], x.data_ptr(), *ptrs, out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        barrier.data_ptr(), b, hp - 2, w, cin, cm, cout, _ROUTES[plan.route], plan.rows,
    )
    return out


def fused_layer(x: torch.Tensor, blocks: Sequence[FusedBlockParams],
                plans: Optional[Sequence[FusedPlan]] = None) -> torch.Tensor:
    """K9: N stride-1 blocks chained in one launch, unpadded (B, H, W, Cin0)
    -> (B, H, W, Cout_last) in x's dtype (f32 or bf16), each block with its
    plan in `plans` or the one K8 would compute for it. The kernel takes at
    most 32 blocks (`kMaxStages`) and refuses more at launch."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("fused_layer needs at least one block")
    if x.device.type == "cpu":
        return fused_layer_reference(x, blocks)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_layer takes f32 or bf16 input, got {x.dtype}")
    b, h, w, cin = x.shape
    cuda.check(x, x.dtype, (b, h, w, cin), "x")
    if plans is None:
        plans = run_plans(b, h, w, cin, blocks, x.dtype, _sm_count(x.device.index or 0))
    if len(plans) != len(blocks):
        raise ValueError(f"fused_layer got {len(plans)} plans for {len(blocks)} blocks")
    weights, dims, routes, kept = [], [], [], []  # kept: the converted weights stay alive until the launch is queued
    for s, p in enumerate(blocks):
        wts = _kernel_weights(p, x.dtype, cin, f"block {s}")
        kept.append(wts)
        weights += [0 if t is None else t.data_ptr() for t in wts]
        dims += [cin, p.w1.shape[1], p.w3.shape[1]]
        routes += [_ROUTES[plans[s].route], plans[s].rows]
        cin = p.w3.shape[1]
    out = torch.empty(b, h, w, cin, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    inner = max((p.w3.shape[1] for p in blocks[:-1]), default=0)
    act = [torch.empty(b * h * w * inner, dtype=x.dtype, device=x.device) for _ in range(2)]
    scratch = None
    if _ROUTES["phase"] in routes[::2]:
        scratch = torch.empty(2 * b * h * w * max(p.w1.shape[1] for p in blocks), dtype=x.dtype, device=x.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    ptrs = (ctypes.c_uint64 * len(weights))(*weights)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    plan_arr = (ctypes.c_int * len(routes))(*routes)
    cuda.FUSED_LAYER(
        _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), act[0].data_ptr(), act[1].data_ptr(),
        0 if scratch is None else scratch.data_ptr(), barrier.data_ptr(), ctypes.addressof(ptrs),
        ctypes.addressof(dim_arr), ctypes.addressof(plan_arr), len(blocks), b, h, w,
    )
    return out
