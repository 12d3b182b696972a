"""Where K7's time goes, and what one launch costs on the card's host.

    python3 -m balancedgroupsoftmax_torch.kernel_study

Needs an H100 and nvcc; it builds variants of `csrc/deform_conv.cu` into a
temporary directory and leaves the package's own build alone. It prints:

1. K7 (bf16, D = 4) at the HTC X101's four kinds of deformable layer at
   800 x 1344, batch 2 (c3's stride-2 first layer, c3, c4, c5), with the
   launch plan `launch_plan` picks, and the same with one part of the kernel
   cut out at a time (the weights' staging, the sampling, the products, the
   window copies; all three of the first, second and fourth together): what
   each part costs, as the difference;
2. every launch plan that fits at those layers, fastest first, each checked
   to give the same output as the picked plan (the sums run in one order
   whatever the plan);
3. the host's cost of one launch: an empty kernel with K6's nine arguments
   launched from C in a loop, through the static and the shared CUDA
   runtime, the same launch through one ctypes call, and through
   `_bags_launch.launch` (cuda.py's launch path).

Its inputs are seeded; offsets have a spread of 2 cells, as in
`chip_smoke.py`'s HTC phase.
"""

from __future__ import annotations

import ctypes
import itertools
import statistics
import subprocess
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


def build_variants(tmp: Path) -> dict:
    """The packed K7 launcher of each variant of deform_conv.cu."""
    src = (cuda.CSRC / "deform_conv.cu").read_text()
    texts = {"whole": src}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"deform_conv.cu no longer holds the {name} loop this study cuts out")
        texts[f"no {name}"] = src.replace(old, new)
    texts["no weights, sampling, copies"] = texts["no weights"].replace(*CUTS["sampling"]).replace(*CUTS["copies"])
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        (tmp / f"v{i}.cu").write_text(text)
        procs[name] = (i, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", str(tmp / f"v{i}.cu"), "-o",
             str(tmp / f"libv{i}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (i, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the variant '{name}':\n{log}")
        fn = getattr(ctypes.CDLL(str(tmp / f"libv{i}.so")), "bags_deform_conv_forward_packed")
        fns[name] = ctypes.cast(fn, ctypes.c_void_p).value
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        study_k7(build_variants(Path(tmp)))
        study_launch(Path(tmp))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
