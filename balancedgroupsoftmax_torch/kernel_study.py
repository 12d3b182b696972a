"""Where K7's, K7b's, K2b's, the NMS kernels', K8's and K6's time goes, and what one launch costs on the card's host.

    python3 -m balancedgroupsoftmax_torch.kernel_study [k7] [k7b] [k2b] [nms] [launch] [fused] [k6]

(all seven parts when none is named)

Needs an H100 and nvcc; it builds variants of `csrc/deform_conv.cu`,
`csrc/roi_align.cu`, `csrc/nms.cu`, `csrc/fused_block.cu` and `csrc/gather.cu`
into a temporary directory and leaves the package's own build alone. It
prints:

1. K7 (bf16, D = 4) at the HTC X101's four kinds of deformable layer at
   800 x 1344, batch 2 (c3's stride-2 first layer, c3, c4, c5), with the
   launch plan `launch_plan` picks, and the same with one part of the kernel
   cut out at a time (the weights' staging, the sampling, the products, the
   window copies; all three of the first, second and fourth together): what
   each part costs, as the difference;
2. every launch plan that fits at those layers, fastest first, each checked
   to give the same output as the picked plan (the sums run in one order
   whatever the plan);
2b. K7b (bf16, D = 4, v1, as the HTC-DCN step asks: dx, the offsets' and the
   weight's gradients) at the six distinct shapes of the X101's 30
   deformable layers, whole, each pass alone (the data gradients, the
   weight's), and with one part of the kernel cut out at a time (`K7B_CUTS`:
   for the tile-walking kernel, the window copies, the sampling pass, the
   grad_col product, the dW product, the dx lists, gather and flush, and dx
   by per-sample atomics in place of the window; for the first design, run
   from a tree that holds it, its data pass without its dx atomics or
   grad_col and its weight pass without its products or sampling); then,
   for the tile-walking kernel, each phase's cycles a (block, tile) from a
   variant that reads `clock64` at its barriers, with two blocks an SM and
   with one (more shared memory asked), and every plan that fits, fastest
   first, each held to the picked plan's result;
3. the host's cost of one launch: an empty kernel with nine arguments
   launched from C in a loop, through the static and the shared CUDA
   runtime, the same launch through one ctypes call, and through
   `_bags_launch.launch` (cuda.py's launch path);
4. K2b at the training shape, whole and with its atomics made plain stores
   or its writes cut out, beside the f32 buffer's memset and cast alone:
   what the scatter's atomics cost; and how many updates a scatter makes by
   sample corner, by distinct pixel of each bin and of each roi;
5. K1 and K4 at the RPN's shapes (G = 10 rows of K = 1000 at test time,
   2000 in training) and K3 and K5 at the multiclass NMS's (G = 600 rows of
   K = 300; K3 gathering from N = 1000), on `chip_smoke.py`'s tie boxes,
   whole and with one part cut out at a time: each one's mask pass alone
   and walk alone (on the mask the whole kernel left in the scratch); K1/K4
   with the settling warp's loads made plain (a chunk's words loaded when
   it settles, not while the chunk before settles), and without the other
   warps' OR (its result is then wrong; it shows whether the settling warp
   waits for them); and the design's choices each undone, each held to the
   plain version: K1 walking in K5's shared-memory walk, K3 gathering
   its candidates first with a small pass and then running K5's kernels on
   them, the IoU test by division on every pair, eight tiles a mask block,
   a 256-thread K1/K4 walk, the chain as a predicated OR in inline PTX.

6. K8 and K9 (the fused bottleneck, bf16) at the R50's four stride-1 runs
   at 800 x 1344, batch 2, with random weights: K8 on each run's first block
   with every plan that fits (the halo route at each tile height, the phase
   route at 64- and 128-pixel units), each held bit for bit to the computed
   plan's output where the plans share a route and size and to the plain
   version otherwise; K9 over each run with the computed plans and with each
   route forced; with the computed plans, the pipeline's choices undone (a
   ring of one or two stages, not up to four, the producer waiting for each chunk's
   copies to land before it copies the next, the consumers freeing a stage
   one chunk late with wait_group 1, which makes ptxas serialize the wgmmas)
   and one part cut out at a time (the products, the epilogues, the copies:
   what each costs, as the difference). It prints what `ptxas -v` reports
   for the kernels (registers, spills, serialized wgmma).

7. K6 (the class-agnostic candidate gather) at the cascade's shape (P = 2
   images of N = 1000 boxes, G = 600 groups of K = 300 distinct indices, as
   top-k gives them): its first kernel (`FIRST_GATHER`: one thread a slot,
   int64 index arithmetic, planes only) on planes, and with the transpose
   copy from the boxes' rows that had to run before it; the kernel of
   `csrc/gather.cu` on the rows (16-byte aligned, and one float off
   alignment: the scalar route) and on planes; and the same kernel with each
   choice of its design undone (scalar index loads, four scalar loads a
   candidate, scalar stores, int64 index arithmetic; and all four; blocks of
   128 or 256 threads, not 64), and cut to the launch of its grid alone. Each variant
   that computes the result is held bit for bit to the plain version, and
   timed by its device time a
   call under the profiler (the kernels' sum, the copy included) and by
   CUDA events a call (which the host's launch cost sets).

Its inputs are seeded; offsets have a spread of 2 cells, as in
`chip_smoke.py`'s HTC phase.
"""

from __future__ import annotations

import ctypes
import itertools
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import cuda
from .ops import deform_conv as ops_dcn

LAYERS = {  # name: (H, W, C, stride) of the layer's input; 64 groups, D = 4
    "c3.0": (200, 336, 512, 2),
    "c3.x": (100, 168, 512, 1),
    "c4.x": (50, 84, 1024, 1),
    "c5.x": (25, 42, 2048, 1),
}
CUTS = {  # part cut out: (text in deform_conv.cu, its replacement)
    "weights": ("  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {",
                "  if (0) for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {"),
    "sampling": ("    for (int e = pt_first; e < pt; e += step) {", "    if (0) for (int e = pt_first; e < pt; e += step) {"),
    "products": ("    for (int u = warp; u < units; u += kThreads / 32) {",
                 "    if (0) for (int u = warp; u < units; u += kThreads / 32) {"),
    "copies": ("  for (int pix = threadIdx.x < step * nq", "  if (0) for (int pix = threadIdx.x < step * nq"),
}
K2B_CUTS = {  # K2b's part cut out: (text in roi_align.cu, its replacement)
    "atomics (plain stores)": ("    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
                               "    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);"),
    "writes": ("            if (c0 < channels) add4<VEC>(dst + c0, min(4, channels - c0), sum[u]);",
               "            if (c0 < channels && sum[u][0] == 1.0e30f) add4<VEC>(dst + c0, min(4, channels - c0), sum[u]);"),
}
ROWS_WALK = "  nms_tile_walk_kernel<<<g, kRowThreads, tile_walk_bytes(k), stream>>>(m, valid, keep, k);"
COORDS_WALK = "  nms_coords_walk_kernel<<<g, kCoordsThreads, coords_walk_bytes(k), stream>>>(m, valid, keep, k);"
K3_MASK = "  err = launch_tile_mask<Src::kGather>(planes, idx, valid, m, cand, g, k, n, thr, stream);"
GATHER_FIRST = r"""// K3 gathering its candidates into cand first, for K5's kernels to read
__global__ void gather_cand_kernel(const float* __restrict__ planes, const int32_t* __restrict__ idx,
                                   float* __restrict__ cand, int g, int k, int n) {
  const int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (e >= int64_t(g) * k) return;
  const int64_t r = e / k;
  const int s = int(e % k);
  const float4 b = box_at<Src::kGather>(planes, idx, r, k, n, s);
  float* c = cand + r * 4 * int64_t(k) + s;
  c[0] = b.x;
  c[k] = b.y;
  c[2 * int64_t(k)] = b.z;
  c[3 * int64_t(k)] = b.w;
}

}  // namespace
"""
NMS_CUTS = {  # part of nms.cu cut out or done another way: edits (its text, the replacement[, text before it])
    "K1/K4 walk": (ROWS_WALK, "  if (0)" + ROWS_WALK[1:]),
    "K1/K4 mask pass": (
        "  cudaError_t err = launch_tile_mask<Src::kRows>(boxes, nullptr, valid, m, nullptr, g, k, 0, thr, stream);",
        "  cudaError_t err = cudaSuccess;"),
    "K1/K4 prefetch (loads on the chain)": (
        "      diag[lane] = d0;\n",
        "      d0 = word(c, c, lane), d1 = word(c, c, lane + 32), e0 = word(c + 1, c, lane), e1 = word(c + 1, c, lane + 32);\n"
        "      diag[lane] = d0;\n"),
    "K1/K4 other warps' OR": ("          if (lane == 0 && v != 0ull) or_into(removed + w, v);", ""),
    "K1 walk from device memory (K5's shared-memory walk)": (
        ROWS_WALK, "  err = coords_walk_fits(k);\n  if (err != cudaSuccess) return err;\n" + COORDS_WALK),
    "K1/K3/K4/K5 bounds (every pair divides)": ("          thr >= 0x1p-100f && thr <= 0x1p100f};", "          false};"),
    "K1/K3/K4/K5 four tiles a block (eight)": (
        "constexpr int kTileThreads = 256;  // the mask pass: four 64 x 64 tiles a block",
        "constexpr int kTileThreads = 512;"),
    "K1/K4 512-thread walk (256)": ("constexpr int kRowThreads = 512;     // K1 / K4 walk blocks, one row each",
                                    "constexpr int kRowThreads = 256;"),
    "K1/K3/K4/K5 C++ chain (a predicated OR in inline PTX)": (
        "    if (!(lo & (1u << b))) {\n      lo |= x.x;\n      hi |= x.y;\n    }\n",
        '    asm("{\\n\\t.reg .pred p;\\n\\t.reg .b32 t;\\n\\tand.b32 t, %0, %4;\\n\\tsetp.eq.u32 p, t, 0;\\n\\t"\n        "@p or.b32 %0, %0, %2;\\n\\t@p or.b32 %1, %1, %3;\\n\\t}"\n        : "+r"(lo), "+r"(hi) : "r"(x.x), "r"(x.y), "r"(1u << b));\n'),
    "K3 walk": (COORDS_WALK, "  if (0)" + COORDS_WALK[1:], "int bags_nms_keep_gathered("),
    "K3 mask pass": (K3_MASK, "  err = cudaSuccess;"),
    "K3 gather in the mask pass (gathered first)": [
        ("}  // namespace\n", GATHER_FIRST),
        (K3_MASK, "  gather_cand_kernel<<<(g * k + 255) / 256, 256, 0, stream>>>(planes, idx, cand, g, k, n);\n"
                  "  err = launch_tile_mask<Src::kPlanes>(cand, nullptr, valid, m, nullptr, g, k, 0, thr, stream);"),
    ],
    "K5 walk": (COORDS_WALK, "  if (0)" + COORDS_WALK[1:], "int bags_nms_keep_coords("),
    "K5 mask pass": ("  err = launch_tile_mask<Src::kPlanes>(coords, nullptr, valid, m, nullptr, g, k, 0, thr, stream);",
                     "  err = cudaSuccess;"),
}
NMS_PARTIAL = {"K1/K4 walk", "K1/K4 mask pass", "K1/K4 other warps' OR", "K3 walk", "K3 mask pass", "K5 walk",
               "K5 mask pass"}  # variants that compute only part of the result
LAUNCH_BENCH = r"""
#include <cuda_runtime.h>
#include <chrono>
__global__ void k9(const float* a, const int* b, float* c, int g, int r, int k, int n, int gpp) {}
extern "C" double from_c(int iters, cudaStream_t s) {
  k9<<<704, 256, 0, s>>>(nullptr, nullptr, nullptr, 1, 2, 3, 4, 5);
  cudaStreamSynchronize(s);
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    k9<<<704, 256, 0, s>>>(nullptr, nullptr, nullptr, 1, 2, 3, 4, 5);
    cudaGetLastError();
  }
  auto t1 = std::chrono::steady_clock::now();
  cudaStreamSynchronize(s);
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
extern "C" int one(cudaStream_t s) {
  k9<<<704, 256, 0, s>>>(nullptr, nullptr, nullptr, 1, 2, 3, 4, 5);
  return int(cudaGetLastError());
}
extern "C" int one_packed(const long long* slots) { return one(reinterpret_cast<cudaStream_t>(slots[0])); }
"""


FIRST_GATHER = r"""// K6's first kernel: one thread a (group, slot), int64 index arithmetic, planes only
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const float* __restrict__ planes, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int64_t gk, int r, int k, int n,
                    int groups_per_plane) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= gk) return;
  const int64_t g = t / k;
  const int64_t slot = t - g * k;
  const int j = idx[t];
  const bool in = j >= 0 && j < n;
  const float* src = planes + (g / groups_per_plane) * r * int64_t(n);
  float* dst = out + g * r * int64_t(k) + slot;
  for (int q = 0; q < r; ++q) dst[int64_t(q) * k] = in ? src[int64_t(q) * n + j] : 0.0f;
}

}  // namespace

extern "C" int bags_gather_lanes(const float* planes, const int32_t* idx, float* out, int g, int r, int k,
                                 int n, int groups_per_plane, cudaStream_t stream) {
  const int64_t gk = int64_t(g) * k;
  const int64_t blocks = (gk + kThreads - 1) / kThreads;
  gather_lanes_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(planes, idx, out, gk, r, k, n,
                                                                  groups_per_plane);
  return int(cudaGetLastError());
}

BAGS_PACKED(bags_gather_lanes)
"""
K6_CUTS = {  # a choice of csrc/gather.cu undone: (its text, the replacement)
    "int4 index loads (scalar)": ("    j = __ldg(reinterpret_cast<const int4*>(ids));",
                                  "    j = make_int4(__ldg(ids), __ldg(ids + 1), __ldg(ids + 2), __ldg(ids + 3));"),
    "float4 candidate loads (four scalar)": (
        "  return __ldg(reinterpret_cast<const float4*>(table) + j);",
        "  return make_float4(__ldg(table + 4 * j), __ldg(table + 4 * j + 1), __ldg(table + 4 * j + 2),\n"
        "                     __ldg(table + 4 * j + 3));"),
    "float4 stores (scalar)": ("    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);",
                               "    dst[0] = a, dst[1] = b, dst[2] = c, dst[3] = d;"),
    "32-bit index arithmetic (int64)": ("typedef int Index;", "typedef int64_t Index;"),
    "64-thread blocks (128)": ("constexpr int kThreads = 64;", "constexpr int kThreads = 128;"),
    "64-thread blocks (256)": ("constexpr int kThreads = 64;", "constexpr int kThreads = 256;"),
    # cut out (the result is then wrong): the launch of the same grid, every thread returning at once
    "work (the grid's launch alone)": ("  if (t >= Index(groups_per_plane) * quads) return;", "  if (t >= 0) return;"),
}
K6_PARTIAL = {"no work (the grid's launch alone)"}  # variants whose result is not held
FUSED_CUTS = {  # a choice of csrc/fused_block.cu undone: edits (its text, the replacement)
    "ring (one stage)": ("  a.ring = int(std::min<size_t>(kMaxRing, (room - a.ring_off) / a.stage_bytes));",
                         "  a.ring = 1;"),
    "wait for each chunk's products (the chunk before's, wait_group 1)": [
        ("    for (int c = 0; c < j.taps * kchunks; ++c, ++chunk) {\n      const int slot = chunk % a.ring, tap",
         "    int prev = -1;\n    for (int c = 0; c < j.taps * kchunks; ++c, ++chunk) {\n"
         "      const int slot = chunk % a.ring, tap", "struct Consumer {"),
        ('        if (nmb > 0) asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");\n'
         "#pragma unroll\n        for (int i = 0; i < kMaxMb; ++i) fence_acc(acc[i]);\n      }\n      release(slot);\n    }",
         '        if (prev >= 0 && nmb > 0) asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");\n'
         "        if (prev >= 0) release(prev);\n        prev = slot;\n      } else {\n        release(slot);\n      }\n    }\n"
         '    if constexpr (sizeof(T) == 2) {\n      if (nmb > 0) asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");\n'
         "#pragma unroll\n      for (int i = 0; i < kMaxMb; ++i) fence_acc(acc[i]);\n      if (prev >= 0) release(prev);\n    }"),
    ],
    "ring of up to four (two stages)": ("  a.ring = int(std::min<size_t>(kMaxRing, (room - a.ring_off) / a.stage_bytes));",
                                        "  a.ring = 2;"),
    "copies in flight across chunks (waited for a chunk at a time)": (
        "      cp_arrive(full + slot);\n", '      cp_arrive(full + slot);\n      asm volatile("cp.async.wait_all;" ::: "memory");\n'),
    # parts cut out (the result is then wrong): what each costs
    "products": ("      if (nmb > 0) mma(acc, nmb,", "      if (0) mma(acc, nmb,"),
    "epilogues": ("    epilogue(acc, st, j, l, nmb, mb0, mbstep, col0);\n", ""),
    "copies": [("          if (j.n0 + g * e < j.n) cp16(", "          if (0) cp16("),
               ("          for (int g = pt & 1; g < pieces; g += 2) cp16(",
                "          for (int g = pt & 1; g < pieces && 0; g += 2) cp16(")],
}
FUSED_PARTIAL = {"no products", "no epilogues", "no copies"}  # variants whose result is not held
R50_RUNS = [(200, 336), (100, 168), (50, 84), (25, 42)]  # (H, W) of each stride-1 run's input at 800 x 1344


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edited(src: str, edits, source: str, name: str) -> str:
    """`src` with one cut's edits made. An edit is (text, replacement) for a
    text that occurs once, or (text, replacement, anchor) for the first text
    after an anchor that occurs once; a cut is one edit or a list of them."""
    for old, new, *anchor in [edits] if isinstance(edits, tuple) else edits:
        start = src.find(anchor[0]) if anchor else 0
        if src.count(anchor[0] if anchor else old) != 1 or old not in src[start:]:
            raise RuntimeError(f"{source} no longer holds the {name} text this study cuts out")
        at = src.index(old, start)
        src = src[:at] + new + src[at + len(old):]
    return src


def build_variants(tmp: Path, source: str, symbols, cuts: dict, extra: dict = {}, others: dict = {}) -> dict:
    """The packed launchers `symbols` (one name, or several) of each variant
    of `source`: whole, with each cut of `cuts` (name: edits, see `edited`)
    made, with each set of cuts in `extra` (name: cut names) made together,
    and of each source text in `others` (name: text). Returns {variant:
    address}, or {variant: {symbol: address}} for several symbols."""
    src = (cuda.CSRC / source).read_text()
    texts = {"whole": src, **others}
    for name, edits in cuts.items():
        texts[f"no {name}"] = edited(src, edits, source, name)
    for name, parts in extra.items():
        text = src
        for part in parts:
            text = edited(text, cuts[part], source, part)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        stem = f"{Path(source).stem}_v{i}"
        (tmp / f"{stem}.cu").write_text(text)
        procs[name] = (stem, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", str(tmp / f"{stem}.cu"), "-o",
             str(tmp / f"lib{stem}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the variant '{name}':\n{log}")
        lib = ctypes.CDLL(str(tmp / f"lib{stem}.so"))
        address = lambda symbol: ctypes.cast(getattr(lib, f"{symbol}_packed"), ctypes.c_void_p).value
        fns[name] = address(symbols) if isinstance(symbols, str) else {sym: address(sym) for sym in symbols}
    return fns


def layer_inputs(h, w, c, stride, gen):
    x = torch.randn(2, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = (torch.randn(2, ho, wo, 18, generator=gen) * 2.0).cuda()
    weight = (torch.randn(c, c // 64, 3, 3, generator=gen) / (9 * c / 64) ** 0.5).to("cuda", torch.bfloat16)
    return x, off, weight, torch.empty(2, ho, wo, c, dtype=torch.bfloat16, device="cuda")


def launcher(address, x, off, weight, out, stride, plan):
    """A launch of the packed K7 entry at `address` (weight as the bf16
    route takes it, (C_out, kh, kw, c_g))."""
    b, h, w, c = x.shape
    launch = cuda.launch_module().launch
    args = (1, x.data_ptr(), off.data_ptr(), 0, weight.data_ptr(), out.data_ptr(), b, h, w, c, out.shape[1],
            out.shape[2], c, 3, 3, stride, 1, 64, 4, *plan[:5])

    def call():
        if launch(address, cuda.DEFORM_CONV.kinds, *args, cuda.current_stream()):
            raise RuntimeError(f"K7 variant refused plan {plan}")

    return call


def study_k7(fns: dict) -> None:
    gen = torch.Generator().manual_seed(13)
    for name, (h, w, c, stride) in LAYERS.items():
        x, off, weight, out = layer_inputs(h, w, c, stride, gen)
        ho, wo = out.shape[1:3]
        plan = ops_dcn.launch_plan(2, ho, wo, c, 64, c, 3, 3, stride, 4)
        ref = ops_dcn.deform_conv2d(x, off, weight, None, stride, 1, 64, 4)
        weight = weight.permute(0, 2, 3, 1).contiguous()
        times = {
            v: statistics.median(cuda_time_ms(launcher(fn, x, off, weight, out, stride, plan), 10) for _ in range(3))
            for v, fn in fns.items()
        }
        print(f"{name}: plan {tuple(plan)}; ms " + ", ".join(f"{v} {t:.4f}" for v, t in times.items()), flush=True)
        rows = []
        c_g = c // 64
        for (th, tw), cc in itertools.product([(8, 8), (4, 8), (8, 4), (4, 4), (16, 8), (8, 16), (16, 4)], [16, 32, 64]):
            if cc % c_g:
                continue
            smem = ops_dcn.plan_shared_bytes(th, tw, cc, c_g, c_g, 3, 3, stride, 4)
            if smem > ops_dcn.SHARED_BYTES:
                continue
            for nch in (d for d in (1, 2, 4, 8, 16, 32, 64) if (c // cc) % d == 0):
                p = (th, tw, cc, nch, smem)
                call = launcher(fns["whole"], x, off, weight, out, stride, p)
                call()
                torch.cuda.synchronize()
                rows.append((cuda_time_ms(call, 5), p, torch.equal(out, ref)))
        rows.sort()
        print(f"{name}: {len(rows)} plans, {sum(not r[2] for r in rows)} giving another output; fastest: "
              + "; ".join(f"{t:.4f} ms {p}" for t, p, _ in rows[:6]), flush=True)


DCN_GRAD_LAYERS = {  # name: (H, W, C, stride) of the six distinct K7b shapes; 64 groups, D = 4
    "c3.0": (200, 336, 512, 2),
    "c3.x": (100, 168, 512, 1),
    "c4.0": (100, 168, 1024, 2),
    "c4.x": (50, 84, 1024, 1),
    "c5.0": (50, 84, 2048, 2),
    "c5.x": (25, 42, 2048, 1),
}
# K7b's parts cut out, for each design of csrc/deform_conv.cu (the study takes
# the table whose texts the source holds): name: (edits, the gradients timed).
# "first" is the two-pass design that the tile-walking kernel ("tiles")
# replaced; run the study from a tree that holds it to time it.
K7B_CUTS = {
    "first": {
        "data pass: no dx atomics": (("        if (pix[r] >= 0)", "        if (pix[r] >= 0 && wk[r] == 1.0e30f)"), "data"),
        "data pass: no grad_col": (("    for (int o = 0; o < a.o_g; ++o) {", "    if (0) for (int o = 0; o < a.o_g; ++o) {"),
                                   "data"),
        "weight pass: no products": (("    for (int p = 0; p < a.tp; ++p) {", "    if (0) for (int p = 0; p < a.tp; ++p) {"),
                                     "weight"),
        "weight pass: no sampling": (("    for (int e = threadIdx.x; e < pt * nq; e += blockDim.x) {",
                                      "    if (0) for (int e = threadIdx.x; e < pt * nq; e += blockDim.x) {"), "weight"),
    },
    "tiles": {
        "window copies": (("    for (int e = threadIdx.x; e < a.npix * a.nq; e += kGradThreads) {\n      const int pix",
                           "    if (0) for (int e = threadIdx.x; e < a.npix * a.nq; e += kGradThreads) {\n      const int pix"),
                          "all"),
        "sampling pass": (("      for (int e0 = 0; e0 < a.pt; e0 += step) {",
                           "      if (0) for (int e0 = 0; e0 < a.pt; e0 += step) {"), "all"),
        "grad_col product": (("      for (int u = u0; u < u1; u += 2) {", "      if (0) for (int u = u0; u < u1; u += 2) {"),
                             "data"),
        "dW product": (("#pragma unroll 1\n        for (int k = 0; k < a.m; k += 16) {",
                        "#pragma unroll 1\n        if (0) for (int k = 0; k < a.m; k += 16) {"),
                       "weight"),
        "dx window (per-sample atomics instead)": ([
            ("  const bool gather = kWindow && a.dx != nullptr;", "  const bool gather = false;"),
            ("          if (!kWindow && a.dx != nullptr) {  // D = 0: each corner's share straight to dx",
             "          if (kWindow) {\n            const int b0 = ent.x & 0xffffff, wy = b0 / a.by_wc;\n"
             "            y0 = tt.wy0 + wy;\n            x0 = tt.wx0 + b0 - wy * a.wc;\n          }\n"
             "          if (a.dx != nullptr) {")], "all"),
        "dx lists, gather and flush": ([
            ("        for (int k = 0; k < 4; ++k) {\n          const int pos = atomicAdd(",
             "        if (0) for (int k = 0; k < 4; ++k) {\n          const int pos = atomicAdd("),
            ("      for (int k = k0; k <= k1; ++k) {", "      if (0) for (int k = k0; k <= k1; ++k) {")], "data"),
    },
}
# The tile-walking design with thread 0 of each block adding up the cycles
# between its barriers and inside phases B1 and C: the wait for the tile's
# copies, the table, B1's scan, its products (warp 0's share), its copies
# going out and the wait for the other warps, B2 (lists, sampling, the
# offsets' gradient), C's weight-gradient products and its dx gather, and the
# block's whole run.
K7B_CYCLES = [
    ('#include "launch.cuh"\n', '#include "launch.cuh"\n\n__device__ unsigned long long k7b_cycles[9];\n'
     "#define K7B_LAP(k) if (threadIdx.x == 0) { const unsigned long long now = clock64(); "
     "k7b_acc[k] += now - k7b_mark; k7b_mark = now; }\n"),
    ("  float dw[kGradSlots][4];\n", "  float dw[kGradSlots][4];\n  unsigned long long k7b_mark = clock64(), "
     "k7b_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const unsigned long long k7b_start = k7b_mark;\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();  // this tile's copies are in; the last tile's phase C is done\n",
     "    K7B_LAP(7);\n    cp_async_wait<0>();\n    __syncthreads();  // this tile's copies are in; the last tile's phase C is done\n"
     "    K7B_LAP(0);\n"),
    ("    if (gather) {\n      // the lists in equal runs",
     "    K7B_LAP(6);\n    if (gather) {\n      // the lists in equal runs"),
    ("    __syncthreads();  // the table, counts and grad_out are in; the staged offsets are free\n",
     "    __syncthreads();  // the table, counts and grad_out are in; the staged offsets are free\n    K7B_LAP(1);\n"),
    ("      if (lane == 31) wsum[warp] = incl;\n    }\n", "      if (lane == 31) wsum[warp] = incl;\n    }\n    K7B_LAP(2);\n"),
    ("    if (tile + 1 < last) {\n      grad_issue<kWindow>(a, grad_tile(a, tile + 1)",
     "    K7B_LAP(3);\n    if (tile + 1 < last) {\n      grad_issue<kWindow>(a, grad_tile(a, tile + 1)"),
    ("    __syncthreads();  // the scanned counts and grad_col are in\n",
     "    __syncthreads();  // the scanned counts and grad_col are in\n    K7B_LAP(4);\n"),
    ("    __syncthreads();  // the columns and the lists are in\n",
     "    __syncthreads();  // the columns and the lists are in\n    K7B_LAP(5);\n"),
    ("  if (!want_dw) return;\n  float* out = a.part + size_t(split)",
     "  K7B_LAP(7);\n  __syncthreads();\n  K7B_LAP(0);\n  if (threadIdx.x == 0) {\n    for (int k = 0; k < 8; ++k) atomicAdd(&k7b_cycles[k], k7b_acc[k]);\n"
     "    atomicAdd(&k7b_cycles[8], clock64() - k7b_start);\n  }\n  if (!want_dw) return;\n  float* out = a.part + size_t(split)"),
    ("BAGS_PACKED(bags_deform_conv_backward)\n", "BAGS_PACKED(bags_deform_conv_backward)\n"
     'extern "C" int k7b_cycles_read(unsigned long long* out, int zero) {\n'
     "  if (zero) {\n    const unsigned long long z[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    return int(cudaMemcpyToSymbol(k7b_cycles, z, sizeof z));\n  }\n"
     "  return int(cudaMemcpyFromSymbol(out, k7b_cycles, sizeof(k7b_cycles)));\n}\n"),
]
# The same with 120 KB more shared memory a block, so that one block, not two,
# holds an SM: whether a block's tile gets faster alone (throughput-bound) or
# not (latency-bound).
K7B_ONE_A_SM = [
    ("cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);\n  if (err != cudaSuccess) return int(err);\n"
     "  deform_grad_bf16_kernel<kWindow><<<unsigned(a.chunks * a.splits), kGradThreads, a.smem, stream>>>(a);",
     "cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem + 120000);\n  if (err != cudaSuccess) return int(err);\n"
     "  deform_grad_bf16_kernel<kWindow><<<unsigned(a.chunks * a.splits), kGradThreads, a.smem + 120000, stream>>>(a);"),
]
K7B_NEEDS = {"all": (True, True, True, False), "data": (True, True, False, False), "weight": (False, False, True, False)}


def study_k7b(tmp: Path) -> None:
    """K7b (bf16, D = 4, v1: dx, the offsets' and the weight's gradients, as
    the HTC-DCN step asks) at the six distinct shapes of the X101's 30
    deformable layers: whole, each pass alone, and each pass with one part
    cut out, timed through `deform_conv2d_backward` with the variant's
    launcher bound in turn (medians of 3 runs of 5 launches). The whole
    kernel is held to the plain version. For the tile-walking design, also
    every plan that fits (`study_k7b_plans`)."""
    src = (cuda.CSRC / "deform_conv.cu").read_text()
    text = lambda edits: (edits if isinstance(edits, tuple) else edits[0])[0]
    # the newest design first: the f32 route keeps the first design's kernels
    design = next(d for d, cuts in reversed(K7B_CUTS.items()) if all(text(e[0]) in src for e in cuts.values()))
    cuts = K7B_CUTS[design]
    fns = build_variants(tmp, "deform_conv.cu", "bags_deform_conv_backward", {k: v[0] for k, v in cuts.items()})
    kernel = cuda.DEFORM_CONV_BACKWARD
    kernel.bind()
    own = kernel.address
    runs = [("whole", "whole", n) for n in K7B_NEEDS] + [(v, f"no {v}", cuts[v][1]) for v in cuts]
    if design == "tiles":
        timed = edited(src, K7B_CYCLES, "deform_conv.cu", "cycle count")
        cycles = {}
        for label, text in (("two blocks an SM", timed),
                            ("one block an SM", edited(timed, K7B_ONE_A_SM, "deform_conv.cu", "launch"))):
            stem = f"k7b_cycles_{len(cycles)}"
            (tmp / f"{stem}.cu").write_text(text)
            subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", str(tmp / f"{stem}.cu"),
                            "-o", str(tmp / f"lib{stem}.so")], check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(tmp / f"lib{stem}.so"))
            cycles[label] = {name: ctypes.cast(getattr(lib, name), ctypes.c_void_p).value
                             for name in ("bags_deform_conv_backward_packed", "k7b_cycles_read")}
    print(f"K7b ({design} design), ms a call:", flush=True)
    gen = torch.Generator().manual_seed(17)
    try:
        for name, (h, w, c, stride) in DCN_GRAD_LAYERS.items():
            x, off, weight, out = layer_inputs(h, w, c, stride, gen)
            gout = torch.randn(out.shape, generator=gen).to("cuda", torch.bfloat16)
            args = (gout, x, off, weight, None, stride, 1, 64, 4)
            kernel.address = fns["whole"]
            got = ops_dcn.deform_conv2d_backward(*args)
            want = ops_dcn.deform_conv2d_backward_reference(*args)
            for g, r in zip(got, want):
                if r is not None and (g.float() - r.float()).abs().max().item() > 2.0**-7 * r.float().abs().max().item():
                    raise AssertionError(f"K7b at {name} differs from the plain version")
            del got, want
            times = {}
            for label, variant, needs in runs:
                kernel.address = fns[variant]
                call = lambda: ops_dcn.deform_conv2d_backward(*args, needs=K7B_NEEDS[needs])
                times[label if variant != "whole" else needs] = statistics.median(cuda_time_ms(call, 5) for _ in range(3))
            print(f"  {name} x {(2, h, w, c)} stride {stride}: " + ", ".join(f"{k} {t:.4f}" for k, t in times.items()),
                  flush=True)
            if design == "tiles":
                for label, fn in cycles.items():
                    k7b_phase_cycles(args, fn, kernel, label)
                study_k7b_plans(args, fns["whole"], kernel)
    finally:
        kernel.address = own


def k7b_phase_cycles(args, fns: dict, kernel, label: str) -> None:
    """The cycle-counting variant (`K7B_CYCLES`, or with `K7B_ONE_A_SM`):
    its time a call, and in one launch each phase's cycles a (block, tile)
    on thread 0's clock and its share of the blocks' runs."""
    kernel.address = fns["bags_deform_conv_backward_packed"]
    ms = statistics.median(cuda_time_ms(lambda: ops_dcn.deform_conv2d_backward(*args), 5) for _ in range(3))
    read = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int)(fns["k7b_cycles_read"])
    out = (ctypes.c_ulonglong * 9)()
    ops_dcn.deform_conv2d_backward(*args)
    torch.cuda.synchronize()
    read(None, 1)
    ops_dcn.deform_conv2d_backward(*args)
    torch.cuda.synchronize()
    if read(out, 0):
        raise RuntimeError("could not read K7b's cycle counts")
    gout, x, _, _, _, stride, _, groups, window = args
    b, ho, wo, c_out = gout.shape
    plan = ops_dcn.backward_plan(b, ho, wo, x.shape[-1], groups, c_out, 3, 3, stride, window)
    pairs = b * -(-ho // plan.th) * -(-wo // plan.tw) * (groups // plan.gc)
    names = ("wait for the copies", "T", "B1 scan", "B1 products (warp 0)", "B1 copies out + barrier", "B2", "C dW",
             "C gather")
    print(f"    {label}: {ms:.4f} ms; cycles a (block, tile): " + ", ".join(f"{n} {out[k] / pairs:.0f} ({out[k] / out[8]:.2f})"
                                                  for k, n in enumerate(names))
          + f"; a block's run {out[8] / plan.blocks:.0f}", flush=True)


def study_k7b_plans(args, address: int, kernel) -> None:
    """Every bf16 plan of K7b that fits the layer, timed whole (the picked
    plan first), fastest first, each held to the picked plan's result to one
    bf16 step (the gradients' sums run in another order)."""
    gout, x, off, weight, mask, stride, _, groups, window = args
    b, ho, wo, c_out = gout.shape
    kernel.address = address
    picked = ops_dcn.backward_plan(b, ho, wo, x.shape[-1], groups, c_out, 3, 3, stride, window)
    want = ops_dcn.deform_conv2d_backward(*args)
    own = ops_dcn.backward_plan
    rows = []
    try:
        for cost, plan in sorted(ops_dcn.backward_plans(b, ho, wo, x.shape[-1], groups, c_out, 3, 3, stride, window),
                                 key=lambda cp: cp[1] != picked):
            ops_dcn.backward_plan = lambda *_, plan=plan: plan
            got = ops_dcn.deform_conv2d_backward(*args)
            same = all(g is None or (g.float() - r.float()).abs().max().item() <= 2.0**-7 * r.float().abs().max().item()
                       for g, r in zip(got, want))
            t = statistics.median(cuda_time_ms(lambda: ops_dcn.deform_conv2d_backward(*args), 3) for _ in range(3))
            rows.append((t, plan[:5], plan.smem, round(cost), plan == picked, same))
    finally:
        ops_dcn.backward_plan = own
    rows.sort()
    print(f"    {len(rows)} plans (th, tw, gc, tiles a block, splits), {sum(not r[5] for r in rows)} disagreeing; "
          "fastest: " + "; ".join(f"{t:.4f} ms {p} {m} B cost {k}{' (picked)' if pk else ''}"
                                  for t, p, m, k, pk, _ in rows[:5])
          + "; picked: " + "; ".join(f"{t:.4f} ms {p}" for t, p, _, _, pk, _ in rows if pk), flush=True)


def study_k2b(fns: dict) -> None:
    """K2b at the training shape (B = 2, R = 512 an image, S = 7, C = 256,
    bf16, 800 x 1344, proposal-like rois as chip_smoke.py draws them): each
    variant's launch (memset, scatter, cast), and the memset and cast alone
    (R = 0), medians of 3 runs of 20 launches."""
    from .ops import roi_align as ops_roi

    gen = torch.Generator().manual_seed(7)
    b, r, strides = 2, 512, (4, 8, 16, 32)
    shapes = [(-(-800 // s), -(-1344 // s)) for s in strides]
    side = torch.exp(torch.empty(b, r, 2).uniform_(2.0, 6.7, generator=gen))
    x1, y1 = torch.rand(b, r, generator=gen) * 1343, torch.rand(b, r, generator=gen) * 799
    rois = torch.stack([x1, y1, (x1 + side[..., 0]).clamp(max=1343), (y1 + side[..., 1]).clamp(max=799)], -1).cuda()
    levels = ops_roi.map_roi_levels(rois, 4)
    grad = torch.randn(b, r, 7, 7, 256, generator=gen).to("cuda", torch.bfloat16)
    total = sum(b * h * w * 256 for h, w in shapes)
    acc = torch.empty(total, device="cuda")
    out = torch.empty(total, dtype=torch.bfloat16, device="cuda")
    _, lv = ops_roi._level_args(tuple(shapes), strides)
    launch = cuda.launch_module().launch

    def call(address, rois_n):
        args = (1, 4, *lv, rois.data_ptr(), levels.data_ptr(), grad.data_ptr(), acc.data_ptr(), out.data_ptr(), b,
                rois_n, 256, 7, 2)
        return lambda: launch(address, cuda.ROI_ALIGN_BACKWARD.kinds, *args, cuda.current_stream())

    # what a scatter updates: every sample corner; each bin's distinct pixels;
    # each roi's distinct pixels (what K2b adds, one atomic a 4-channel piece)
    index, weight, valid = ops_roi.sample_points(shapes, rois, strides, levels=levels)
    n = index.shape[1]
    corner = lambda t: t.reshape(4, n, 7, 2, 7, 2).permute(1, 2, 4, 0, 3, 5).reshape(n, 7, 7, 16)
    live = corner(valid.expand(4, -1, -1, -1)) & (corner(weight) != 0)
    keys = torch.where(live, corner(index), torch.full_like(corner(index), -1))

    def distinct(k):
        k = k.sort(dim=-1).values
        return int(((k[..., 1:] != k[..., :-1]) & (k[..., 1:] >= 0)).sum() + (k[..., 0] >= 0).sum())

    print(f"K2b, training shape: {int(live.sum())} sample corners, {distinct(keys)} pixels of bins, "
          f"{distinct(keys.reshape(n, -1))} pixels of rois, over {sum(b * h * w for h, w in shapes)} pyramid pixels",
          flush=True)
    times = {v: statistics.median(cuda_time_ms(call(fn, r), 20) for _ in range(3)) for v, fn in fns.items()}
    times["memset and cast alone (R = 0)"] = statistics.median(cuda_time_ms(call(fns["whole"], 0), 20) for _ in range(3))
    print("K2b, training shape: ms " + ", ".join(f"{v} {t:.4f}" for v, t in times.items()), flush=True)


def nms_case(label: str, g: int, k: int, thr: float):
    """`chip_smoke.py`'s tie boxes at a kernel's path shape: the launcher's
    arguments (tensors, which the caller keeps alive while it launches, and
    numbers), the outputs to zero, a check of the outputs against the plain
    version, the plain keep and valid. K3 gathers its rows from (G, 4, 1000)
    planes through distinct indices, as `chip_smoke.py` times it."""
    from chip_smoke import tie_boxes  # the repository's root is on the path under `python3 -m`

    from .ops import nms as ops_nms

    gen = torch.Generator().manual_seed(6)
    keep = torch.empty(g, k, dtype=torch.bool, device="cuda")
    mask = torch.empty(g, k, -(-k // 64), dtype=torch.int64, device="cuda")
    if label == "K3":
        n = 1000
        boxes, _ = tie_boxes(gen, g, n, thr, "cpu")
        planes = boxes.transpose(1, 2).contiguous().cuda()
        idx = torch.argsort(torch.rand(g, n, generator=gen), dim=1)[:, :k].to(torch.int32).cuda()
        valid = (torch.rand(g, k, generator=gen) > 0.1).cuda()
        cand = torch.empty(g, 4, k, device="cuda")
        ref_keep, ref_cand = ops_nms.nms_keep_gathered_reference(planes, idx, valid, thr)
        same = lambda: torch.equal(keep, ref_keep) and torch.equal(cand.view(torch.int32), ref_cand.view(torch.int32))
        return (planes, idx, valid, keep, cand, mask, g, k, n, thr), (keep, cand), same, ref_keep, valid
    boxes, valid = tie_boxes(gen, g, k, thr, "cuda")
    src = boxes.transpose(1, 2).contiguous() if label == "K5" else boxes
    ref = ops_nms.nms_keep_reference(boxes, valid, thr)
    return (src, valid, keep, mask, g, k, thr), (keep,), lambda: torch.equal(keep, ref), ref, valid


def study_nms(fns: dict) -> None:
    """K1 and K4 (the RPN at test time and in training) and K3 and K5 (the
    class-specific and the class-agnostic multiclass NMS) at their paths'
    shapes, each variant's launch timed (medians of 3 runs of 20 launches) in
    the order built, on buffers the variants share: the whole kernel runs
    first, so a walk alone reads the mask the whole kernel left. Every
    variant that computes the whole result is held to the plain version."""
    launch = cuda.launch_module().launch
    cases = (
        ("K1", "bags_nms_keep", cuda.NMS_KEEP, 10, 1000, 0.7),
        ("K4", "bags_nms_keep_tiled", cuda.NMS_KEEP_TILED, 10, 2000, 0.7),
        ("K3", "bags_nms_keep_gathered", cuda.NMS_KEEP_GATHERED, 600, 300, 0.5),
        ("K5", "bags_nms_keep_coords", cuda.NMS_KEEP_COORDS, 600, 300, 0.5),
    )
    for label, symbol, kernel, g, k, thr in cases:
        inputs, outs, same, ref, valid = nms_case(label, g, k, thr)
        args = tuple(x.data_ptr() if isinstance(x, torch.Tensor) else x for x in inputs)
        times = {}
        for name, by_symbol in fns.items():
            if name != "whole" and label not in name.split(" ")[1]:  # "no K1/K4 ...", "no K3 ..."
                continue
            call = lambda: launch(by_symbol[symbol], kernel.kinds, *args, cuda.current_stream())
            for out in outs:
                out.zero_()
            if call():
                raise RuntimeError(f"{label} variant '{name}' refused the launch")
            torch.cuda.synchronize()
            if name.removeprefix("no ") not in NMS_PARTIAL and not same():
                raise AssertionError(f"{label}: the variant '{name}' differs from the plain version")
            times[name] = statistics.median(cuda_time_ms(call, 20) for _ in range(3))
        print(f"{label} (G={g} K={k} kept {int(ref.sum())} of {int(valid.sum())}): ms "
              + ", ".join(f"{v} {t:.4f}" for v, t in times.items()), flush=True)


def study_launch(tmp: Path) -> None:
    (tmp / "launch.cu").write_text(LAUNCH_BENCH)
    stream = cuda.current_stream()
    for runtime in ("static", "shared"):
        lib_path = tmp / f"liblaunch_{runtime}.so"
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-cudart", runtime, "-shared", str(tmp / "launch.cu"), "-o",
                        str(lib_path)], check=True, capture_output=True)
        lib = ctypes.PyDLL(str(lib_path))
        lib.from_c.argtypes, lib.from_c.restype = (ctypes.c_int, ctypes.c_void_p), ctypes.c_double
        lib.one.argtypes, lib.one.restype = (ctypes.c_void_p,), ctypes.c_int
        from_c = [lib.from_c(2000, stream) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            lib.one(stream)
        one_call = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"launch, CUDA runtime {runtime}: from C {min(from_c):.3f}-{max(from_c):.3f} us, "
              f"through one ctypes call {one_call:.3f} us", flush=True)
    launch, address = cuda.launch_module().launch, ctypes.cast(lib.one_packed, ctypes.c_void_p).value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        launch(address, b"p", stream)
    module_call = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    print(f"launch through _bags_launch.launch: {module_call:.3f} us", flush=True)


def fused_weights(run, gen):
    """Folded weights of one R50 run, kernel-ready (bf16 weights, f32
    biases), each product scaled to keep unit variance."""
    from .ops.fused_block import FusedBlockParams

    def wt(*shape):
        return (torch.randn(*shape, generator=gen) / shape[-2] ** 0.5 / (3.0 if len(shape) == 3 else 1.0)).to(
            "cuda", torch.bfloat16)

    def bias(c):
        return (torch.randn(1, c, generator=gen) * 0.1).cuda()

    blocks = []
    for cin, cm, cout in run:
        ds = cin != cout
        blocks.append(FusedBlockParams(wt(cin, cm), bias(cm), wt(9, cm, cm), bias(cm), wt(cm, cout), bias(cout),
                                       wt(cin, cout) if ds else None, bias(cout) if ds else None))
    return blocks


def fused_plans(b, h, w, cin, cm, cout):
    """Every plan that fits one block: the halo route at each tile height,
    the phase route at 64 and 128 pixels a unit."""
    from .ops import fused_block as ops_fb

    plans = []
    for route, rows in [("halo", th) for th in (8, 6, 4, 2)] + [("phase", 128), ("phase", 64)]:
        try:
            plans.append(ops_fb.fused_plan(b, h, w, cin, cm, cout, torch.bfloat16, route=route, rows=rows))
        except ValueError:
            pass
    return plans


def fused_launch(address, x, p, out, scratch, barrier, plan):
    """A K8 launch of the packed entry at `address` with `plan`."""
    from .ops import fused_block as ops_fb

    b, hp, w, cin = x.shape
    launch = cuda.launch_module().launch
    args = (1, x.data_ptr(), *[0 if t is None else t.data_ptr() for t in p], out.data_ptr(), scratch.data_ptr(),
            barrier.data_ptr(), b, hp - 2, w, cin, p.w1.shape[1], p.w3.shape[1], ops_fb._ROUTES[plan.route],
            plan.rows)

    def call():
        barrier.zero_()
        if launch(address, cuda.FUSED_BOTTLENECK.kinds, *args, cuda.current_stream()):
            raise RuntimeError(f"K8 variant refused plan {plan}")

    return call


def study_fused(fns: dict, tmp: Path) -> None:
    from .ops import fused_block as ops_fb

    src = cuda.CSRC / "fused_block.cu"
    log = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(cuda.CSRC), "-c", str(src), "-o",
                          str(tmp / "fused_ptxas.o")], capture_output=True, text=True).stderr
    for line in log.splitlines():
        if "C7519" not in line and ("registers" in line or "spill" in line or "Compiling entry" in line
                                    or "Performance Loss" in line):
            print(f"ptxas: {line.strip()[:220]}", flush=True)
    print(f"ptxas: warpgroup.arrive injected at {log.count('warpgroup.arrive is injected')} places, "
          f"warpgroup.wait at {log.count('warpgroup.wait is injected')}", flush=True)
    gen = torch.Generator().manual_seed(21)
    resnet_runs = [[(64, 64, 256)] + [(256, 64, 256)] * 2, [(512, 128, 512)] * 3, [(1024, 256, 1024)] * 5,
                   [(2048, 512, 2048)] * 2]
    sms = ops_fb._sm_count(0)
    for name, (h, w), run in zip(["layer1", "layer2", "layer3", "layer4"], R50_RUNS, resnet_runs):
        blocks = fused_weights(run, gen)
        cin, cm, cout = run[0]
        x = torch.randn(2, h, w, cin, generator=gen).to("cuda", torch.bfloat16)
        xp = ops_fb.pad_rows(x)
        computed = ops_fb.fused_plan(2, h, w, cin, cm, cout, torch.bfloat16, sms)
        ref = ops_fb.unpad_rows(ops_fb.fused_bottleneck_reference(xp, blocks[0])).float()
        limit = 2 * 2.0**-7 * ref.abs().max().item()
        scratch = torch.empty(2 * 2 * h * w * cm, dtype=torch.bfloat16, device="cuda")
        barrier = torch.zeros(1, dtype=torch.int32, device="cuda")
        want = torch.empty(2, h + 2, w, cout, dtype=torch.bfloat16, device="cuda")
        fused_launch(fns["whole"], xp, blocks[0], want, scratch, barrier, computed)()
        print(f"K8 {name} block 0, {cin} -> {cm} -> {cout} at {h} x {w}; computed plan {computed.route} "
              f"{computed.rows}", flush=True)
        for plan in fused_plans(2, h, w, cin, cm, cout):
            times = {}
            for variant, address in fns.items():
                if variant != "whole" and plan != computed:
                    continue
                out = torch.empty_like(want)
                call = fused_launch(address, xp, blocks[0], out, scratch, barrier, plan)
                call()
                torch.cuda.synchronize()
                if variant in FUSED_PARTIAL:
                    pass
                elif (plan.route, plan.rows) == (computed.route, computed.rows):
                    if not torch.equal(ops_fb.unpad_rows(out), ops_fb.unpad_rows(want)):
                        raise AssertionError(f"K8 {name} variant '{variant}' differs from the whole kernel")
                elif not (ops_fb.unpad_rows(out).float() - ref).abs().max().item() <= limit:
                    raise AssertionError(f"K8 {name} plan {plan} is not within two bf16 steps of the plain version")
                times[variant] = statistics.median(cuda_time_ms(call, 10) for _ in range(3))
            print(f"  {plan.route} {plan.rows}: units {plan.units}, shared {plan.smem} B: "
                  + ", ".join(f"{v} {t:.4f} ms" for v, t in times.items()), flush=True)
        k9 = {"computed": None}
        for route in ("halo", "phase"):
            try:
                k9[route] = [ops_fb.fused_plan(2, h, w, c_in, c_m, c_out, torch.bfloat16, route=route)
                             for c_in, c_m, c_out in run]
            except ValueError:
                pass
        line = []
        for label, plans in k9.items():
            t = statistics.median(cuda_time_ms(lambda: ops_fb.fused_layer(x, blocks, plans), 10) for _ in range(3))
            line.append(f"{label} {t:.4f} ms")
        print(f"  K9 over the run of {len(run)}: " + ", ".join(line), flush=True)


def device_ms_a_call(fn, calls: int = 200) -> float:
    """Device time of one call of `fn` under the profiler: every CUDA kernel
    it launches, summed, over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    self_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return sum(self_us(e) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA) / calls / 1e3


def study_k6(fns: dict) -> None:
    """K6 at the cascade's shape, each variant on the layouts it takes, held
    to the plain version and timed (medians of 3)."""
    from .ops import gather as ops_gather

    gen = torch.Generator().manual_seed(14)
    p, n, g, k = 2, 1000, 600, 300
    boxes = (torch.rand(p, n, 4, generator=gen) * 1333 + 2.0**-13).cuda()
    idx = torch.argsort(torch.rand(g, n, generator=gen), dim=1)[:, :k].to(torch.int32).cuda()
    flat = torch.empty(p * n * 4 + 1, device="cuda")
    flat[1:] = boxes.ravel()
    tables = {
        "rows": boxes.transpose(1, 2),
        "rows off 16-byte alignment": flat[1:].view(p, n, 4).transpose(1, 2),
        "planes": boxes.transpose(1, 2).contiguous(),
    }
    ref = ops_gather.gather_lanes_reference(tables["planes"], idx, g // p)
    out = torch.empty(g, 4, k, device="cuda")
    launch = cuda.launch_module().launch
    first_kinds = cuda.GATHER_LANES.kinds[:8] + cuda.GATHER_LANES.kinds[9:]  # no layout argument
    copy = torch.empty(p, 4, n, device="cuda")

    def first(address, with_copy):
        def call():
            if with_copy:
                copy.copy_(tables["rows"])
            return launch(address, first_kinds, copy.data_ptr(), idx.data_ptr(), out.data_ptr(), g, 4, k, n, g // p,
                          cuda.current_stream())
        if not with_copy:
            copy.copy_(tables["planes"])
        return call

    def current(address, table):
        rows = ops_gather.table_layout(table)
        return lambda: launch(address, cuda.GATHER_LANES.kinds, table.data_ptr(), idx.data_ptr(), out.data_ptr(), g, 4,
                              k, n, g // p, rows, cuda.current_stream())

    cases = {"first kernel, planes": first(fns["first kernel"], False),
             "first kernel, transpose copy from the rows and planes": first(fns["first kernel"], True)}
    for name, address in fns.items():
        if name == "first kernel":
            continue
        for layout in (("rows", "rows off 16-byte alignment", "planes") if name == "whole" else ("rows", "planes")):
            cases[f"{name}, {layout}"] = current(address, tables[layout])
    print(f"K6 (P={p} N={n} G={g} K={k}): device ms a call (profiler, 200 calls) / ms a call by events (300 calls), "
          "medians of 3", flush=True)
    for name, call in cases.items():
        out.zero_()
        if call():
            raise RuntimeError(f"K6 variant '{name}' refused the launch")
        torch.cuda.synchronize()
        if name.split(", ")[0] not in K6_PARTIAL and not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K6: the variant '{name}' differs from the plain version")
        dev = statistics.median(device_ms_a_call(call) for _ in range(3))
        ev = statistics.median(cuda_time_ms(call, 300) for _ in range(3))
        print(f"  {name}: {dev:.5f} / {ev:.5f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    parts = set(sys.argv[1:]) or {"k7", "k7b", "k2b", "nms", "launch", "fused", "k6"}
    with tempfile.TemporaryDirectory() as tmp:
        if "k7" in parts:
            study_k7(build_variants(Path(tmp), "deform_conv.cu", "bags_deform_conv_forward", CUTS,
                                    {"no weights, sampling, copies": ("weights", "sampling", "copies")}))
        if "k7b" in parts:
            study_k7b(Path(tmp))
        if "k2b" in parts:
            study_k2b(build_variants(Path(tmp), "roi_align.cu", "bags_roi_align_backward", K2B_CUTS))
        if "nms" in parts:
            symbols = ("bags_nms_keep", "bags_nms_keep_tiled", "bags_nms_keep_gathered", "bags_nms_keep_coords")
            study_nms(build_variants(Path(tmp), "nms.cu", symbols, NMS_CUTS))
        if "launch" in parts:
            study_launch(Path(tmp))
        if "fused" in parts:
            study_fused(build_variants(Path(tmp), "fused_block.cu", "bags_fused_bottleneck", FUSED_CUTS), Path(tmp))
        if "k6" in parts:
            study_k6(build_variants(Path(tmp), "gather.cu", "bags_gather_lanes", K6_CUTS,
                                    {"all four undone": tuple(K6_CUTS)[:4]}, {"first kernel": FIRST_GATHER}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
