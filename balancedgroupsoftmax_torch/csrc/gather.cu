// Lane gather of the class-agnostic candidates: K6 `bags_gather_lanes`.
//
// Replaces (TPU Pallas, JAX package pallas/gather.py): gather_lanes_matmul (:59,
// via _gather_kernel :32; `pallas_call` at :105) -- the candidate gather of
// the class-agnostic multiclass NMS: out[g, r, k] = table[g / groups_per_plane,
// r, idx[g, k]], an index outside [0, N) giving 0. On the detector's path P = B
// = 2 images share one table of N = 1000 decoded boxes (R = 4) each across
// their 300 capped classes, G = 600, K = 300.
//
// Why the card needs no contraction. The TPU has no fast gather across lanes,
// so its kernel built each group's (N, K) one-hot in VMEM and contracted
// lane-major (R, N) coordinate planes against it on the MXU, split into three
// bf16 terms to stay f32-exact; the planes are why the JAX path transposes
// its boxes first. On the card a load from any address is exact and cheap:
// the gather is one load a candidate, and the rows the decoder wrote, (N, 4)
// f32, are the best layout for it: one candidate is one 16-byte row.
//
// What bounds it on an H100: bytes. At the path's shape it writes 2.88 MB of
// candidates and reads 0.72 MB of indices and 32 KB of boxes, 3.6 MB: 0.00108
// ms at 3.35 TB/s.
//
// The design, against what held the first version back:
// 1. No copy before it. The table comes as contiguous (P, R, N) planes
//    (rows = 0) or as the transposed view of contiguous (P, N, R) rows, strides
//    (N R, 1, R) (rows = 1): what `boxes.transpose(1, 2)` gives, so the
//    multiclass NMS hands over the decoded boxes where they lie and the
//    transpose copy, a kernel launch of its own, is gone. The wrapper refuses
//    every other layout.
// 2. One 16-byte load a candidate. In the row layout at R = 4 with a 16-byte
//    aligned table a candidate's four coordinates are one read-only (`__ldg`)
//    float4 load. A misaligned table, another R and the plane layout take
//    scalar read-only loads. The plane layout is not staged in shared memory:
//    a block gathers 256 candidates (4 KB) and staging would copy the whole
//    (4, 1000) plane (16 KB) into each of 352 blocks, four times what the
//    gather reads, where the loads now hit L1/L2; no path hands over planes.
// 3. Four slots a thread. A thread takes four consecutive slots of one group:
//    one int4 load of their indices, four independent candidate loads in
//    flight together, then one float4 store a coordinate row, neighbouring
//    threads on neighbouring 16 bytes (coalesced along K). That needs K % 4 ==
//    0 and 16-byte-aligned indices and output; otherwise the same thread
//    covers its up to four slots with scalar loads and stores. Stores are
//    ordinary, not streaming: K5 reads the 2.88 MB right after, from L2.
// 4. 32-bit index arithmetic. blockIdx.y is the image; one 32-bit division of
//    the thread's index within it gives its group and slots. The launcher
//    refuses shapes whose offsets do not fit 32 bits (G R K, P R N) and more
//    than 65535 images. At the path's shape the grid is 2 x 352 blocks of
//    64 threads, 45,000 of them working: one wave, 5.3 blocks an SM, which
//    spreads the stores more evenly over the SMs than 256-thread blocks.
// The four candidate loads are unconditional: an index outside [0, N) reads
// box 0 and its coordinates give way to 0 (the launcher refuses N = 0).
// The host's cost of a launch (cuda.py, pylaunch.cu, launch.cuh) is kept
// short; the launcher picks the route from the layout, K and the pointers.
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSlots = 4;  // consecutive slots of one group a thread

typedef int Index;  // every offset fits 32 bits (the launcher checks)

enum class Src { kPlanes, kRows, kRows4 };

// coordinate q of candidate j in one image's table (R = r coordinates, N = n boxes)
template <Src S>
__device__ __forceinline__ float coord(const float* __restrict__ table, Index j, int q, int r, int n) {
  return S == Src::kPlanes ? __ldg(table + Index(q) * n + j) : __ldg(table + j * r + q);
}

// candidate j's four coordinates from a 16-byte-aligned table of rows
__device__ __forceinline__ float4 row4(const float* __restrict__ table, Index j) {
  return __ldg(reinterpret_cast<const float4*>(table) + j);
}

// a candidate's coordinates, or 0 for an index outside [0, N)
__device__ __forceinline__ float4 inside(bool in, float4 v) {
  return in ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// slots s .. s + count - 1 of one coordinate row of the output
template <bool kVecK>
__device__ __forceinline__ void put(float* __restrict__ dst, int count, float a, float b, float c, float d) {
  if (kVecK) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    dst[0] = a;
    if (count > 1) dst[1] = b;
    if (count > 2) dst[2] = c;
    if (count > 3) dst[3] = d;
  }
}

template <Src S, bool kVecK>
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx, float* __restrict__ out,
                    int r, int k, int n, int groups_per_plane, int quads) {
  const Index t = Index(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= Index(groups_per_plane) * quads) return;
  const Index in_plane = t / quads;  // the group within the image
  const Index s = (t - in_plane * quads) * kSlots;
  const Index g = Index(blockIdx.y) * groups_per_plane + in_plane;
  const float* src = table + Index(blockIdx.y) * r * n;
  const int32_t* ids = idx + g * k + s;
  float* dst = out + g * r * k + s;
  const int count = kVecK ? kSlots : min(kSlots, int(k - s));
  int4 j;
  if (kVecK) {
    j = __ldg(reinterpret_cast<const int4*>(ids));
  } else {
    j = make_int4(__ldg(ids), count > 1 ? __ldg(ids + 1) : -1, count > 2 ? __ldg(ids + 2) : -1,
                  count > 3 ? __ldg(ids + 3) : -1);
  }
  const bool in0 = unsigned(j.x) < unsigned(n), in1 = unsigned(j.y) < unsigned(n);
  const bool in2 = unsigned(j.z) < unsigned(n), in3 = unsigned(j.w) < unsigned(n);
  const Index c0 = in0 ? j.x : 0, c1 = in1 ? j.y : 0, c2 = in2 ? j.z : 0, c3 = in3 ? j.w : 0;
  if (S == Src::kRows4) {
    const float4 a = inside(in0, row4(src, c0)), b = inside(in1, row4(src, c1));
    const float4 c = inside(in2, row4(src, c2)), d = inside(in3, row4(src, c3));
    put<kVecK>(dst, count, a.x, b.x, c.x, d.x);
    put<kVecK>(dst + k, count, a.y, b.y, c.y, d.y);
    put<kVecK>(dst + 2 * k, count, a.z, b.z, c.z, d.z);
    put<kVecK>(dst + 3 * k, count, a.w, b.w, c.w, d.w);
  } else {
    for (int q = 0; q < r; ++q) {
      const float a = coord<S>(src, c0, q, r, n), b = coord<S>(src, c1, q, r, n);
      const float c = coord<S>(src, c2, q, r, n), d = coord<S>(src, c3, q, r, n);
      put<kVecK>(dst + Index(q) * k, count, in0 ? a : 0.0f, in1 ? b : 0.0f, in2 ? c : 0.0f, in3 ? d : 0.0f);
    }
  }
}

typedef void (*GatherKernel)(const float*, const int32_t*, float*, int, int, int, int, int);

template <Src S>
GatherKernel pick(bool vec_k) {
  return vec_k ? gather_lanes_kernel<S, true> : gather_lanes_kernel<S, false>;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// table (P, R, N) f32: contiguous planes (rows = 0) or the transposed view of
// contiguous (P, N, R) rows (rows = 1); idx (G, K) i32, contiguous, with
// G = P * groups_per_plane -> out (G, R, K) f32, contiguous.
int bags_gather_lanes(const float* table, const int32_t* idx, float* out, int g, int r, int k, int n,
                      int groups_per_plane, int rows, cudaStream_t stream) {
  if (g <= 0 || r <= 0 || k <= 0 || n <= 0 || groups_per_plane <= 0 || g % groups_per_plane) {
    return int(cudaErrorInvalidValue);
  }
  const int p = g / groups_per_plane;
  const int quads = (k + kSlots - 1) / kSlots;
  const int64_t per_plane = int64_t(groups_per_plane) * quads;
  if (p > 65535 || int64_t(g) * r * k > INT32_MAX || int64_t(p) * r * n > INT32_MAX ||
      per_plane > INT32_MAX - kThreads) {
    return int(cudaErrorInvalidValue);  // beyond the 32-bit route
  }
  const bool vec_k = k % kSlots == 0 && aligned16(idx) && aligned16(out);
  const GatherKernel kernel = !rows ? pick<Src::kPlanes>(vec_k)
                              : r == 4 && aligned16(table) ? pick<Src::kRows4>(vec_k)
                                                           : pick<Src::kRows>(vec_k);
  const dim3 grid(unsigned((per_plane + kThreads - 1) / kThreads), unsigned(p));
  kernel<<<grid, kThreads, 0, stream>>>(table, idx, out, r, k, n, groups_per_plane, quads);
  return int(cudaGetLastError());
}

}  // extern "C"

BAGS_PACKED(bags_gather_lanes)
