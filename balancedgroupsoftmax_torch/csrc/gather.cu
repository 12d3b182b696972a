// Lane gather from shared coordinate planes: K6 `bags_gather_lanes`.
//
// Replaces (TPU Pallas, JAX package pallas/gather.py): gather_lanes_matmul (:59,
// via _gather_kernel :32; `pallas_call` at :105) -- the candidate gather of
// the class-agnostic multiclass NMS: out[g, r, k] = planes[g / groups_per_plane,
// r, idx[g, k]], an index outside [0, N) giving 0. On the detector's path P = B
// images share one (4, N = 1000) plane each across their 300 capped classes,
// G = 600, K = 300.
//
// Design. The TPU's gather was slow, so it built each group's (N, K) one-hot
// in VMEM and contracted the planes against it on the MXU, split into three
// bf16 terms to stay f32-exact. On the card a load is exact and cheap: one
// thread per (g, k) loads the index once and copies the R coordinates; for
// each plane row r, neighbouring threads write neighbouring k, so every store
// is coalesced. The planes (32 KB at the path's shape) stay in L1/L2 and are
// read at random lanes; nothing is replicated per class.
//
// What bounds it on an H100: by its work, bytes -- it writes 2.88 MB and reads
// 0.72 MB of indices (and 32 KB of planes) at the path's shape, about 1.1 us
// at 3.35 TB/s; its body takes about 4 us of device time. What sets its time
// a call is the host: a launch from C costs about 3.5 us on the card's host,
// and the wrapper's checks, its one allocation and the ctypes call add the
// rest. So the launch path is the part kept short (cuda.py, pylaunch.cu,
// launch.cuh): one CPython call puts the arguments into 8-byte slots and
// calls `bags_gather_lanes_packed`, whose address ctypes looked up once.
//
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

extern "C" {

// planes (P, R, N) f32, idx (G, K) i32 with G = P * groups_per_plane
//   -> out (G, R, K) f32.
int bags_gather_lanes(const float* planes, const int32_t* idx, float* out, int g, int r, int k,
                      int n, int groups_per_plane, cudaStream_t stream) {
  const int64_t gk = int64_t(g) * k;
  const int64_t blocks = (gk + kThreads - 1) / kThreads;
  gather_lanes_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(planes, idx, out, gk, r, k, n,
                                                                  groups_per_plane);
  return int(cudaGetLastError());
}

}  // extern "C"

BAGS_PACKED(bags_gather_lanes)
