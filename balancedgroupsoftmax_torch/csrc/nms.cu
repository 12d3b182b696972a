// Exact greedy NMS keep masks: K1 `bags_nms_keep`, K3 `bags_nms_keep_gathered`
// and K4 `bags_nms_keep_tiled`.
//
// Replaces (TPU Pallas, JAX package pallas/nms.py):
//   K1  nms_keep_batched  (:304, via _keep_from_coords :273, _nms_block_kernel :29,
//       _fixpoint_keep :42) -- RPN NMS at test time, rows of K <= 1000 boxes.
//   K3  nms_keep_gathered (:371, via _nms_gathered_kernel :331) -- per-(image, class)
//       candidate gather from coordinate planes fused with the same keep.
//   K4  nms_keep_tiled    (:213, via _nms_tiled_kernel :102) -- the K1 keep for any
//       K; the RPN in training, rows of K = 2000.
//
// Semantics (all three): rows of score-descending boxes with a validity mask; box i
// suppresses box j when i < j, both are valid and iou(i, j) > thr under the +1
// pixel convention; a box is kept when it is valid and no kept box suppresses
// it. Invalid slots neither keep nor suppress. This equals the fixpoint the TPU
// kernels iterate to.
//
// Design. Three steps, each a device function below:
//  1. load a row's boxes (K3: gather them straight from the (G, 4, N) planes
//     with plain loads, which are exact; the TPU needed a bf16x3 one-hot
//     matmul to gather) into shared memory with their areas;
//  2. build the suppression bitmask, K x ceil(K/64) uint64 words: one warp
//     makes a word, its lanes testing 64 neighbouring boxes j against box i
//     (no bank conflicts), two ballots assembling the bits;
//  3. walk the boxes in score order with one warp: lane w holds word w of the
//     removed set in a register, a shuffle tells every lane whether box i is
//     still in, and a kept box ORs its mask row in.
// K3 runs all three in one block per row: its B * 300 rows fill the card.
// K1 has only G = B * 5 rows, so step 2 -- K^2 / 2 IoUs a row, most of its
// time when one SM did a whole row -- runs as its own kernel over
// (ceil(K/64) row blocks) x G, into a (G, K, ceil(K/64)) mask in device memory
// that the walk kernel copies into shared memory. Only that mask goes
// through device memory; the boxes are read once and the keep mask (and K3's
// candidates) written once.
//
// K4 shares K1's mask kernel and replaces only the walk. The TPU walked
// 256-box tiles and iterated a fixpoint inside each; here a row's mask (512 KB
// at K = 2000, more than a block's shared memory) stays in device memory (and
// in L2: 5 MB for the ten training rows) and one warp walks it 64 boxes at a
// time. For the chunk of boxes [64 c, 64 c + 64) it loads the chunk's diagonal
// words (mask[i][c], two per lane), settles the chunk's keeps among
// themselves with shuffles, starting from word c of the removed set, and then
// ORs the rows of the boxes it kept into the later words of the removed set:
// lane l accumulates words c + 1 + l, c + 33 + l, ..., eight row loads in
// flight at a time. The removed set (ceil(K/64) words) sits in shared memory,
// so any K works; the walk reads each kept box's row once, coalesced.
//
// What bounds them on an H100: neither bytes nor FLOPs but latency. The walks
// are K dependent steps of one warp, at most G of the 132 SMs busy. Shared
// memory: a K1 walk block at K = 1000 holds the 128 KB mask row, which caps K
// near 1350, as K3's fused block at K = 300 (20 KB) is capped; the register
// walk allows K <= 2048. A K that does not fit makes the launcher return an
// error; `kernels.batched_nms_topk` sends K > 1280 to K4.
//
// IoU is computed in the JAX formula order with round-to-nearest intrinsics,
// which the compiler never contracts into FMAs, so a box exactly at the
// threshold decides as it does in ops/boxes.py bbox_overlaps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;      // fused (K3) and walk blocks
constexpr int kMaskThreads = 256;  // K1 mask blocks, one per 64 rows
constexpr int kMaxWords = 32;      // the walk keeps one word per lane

__device__ __forceinline__ bool iou_above(float ax1, float ay1, float ax2, float ay2,
                                          float aarea, float bx1, float by1, float bx2,
                                          float by2, float barea, float thr) {
  float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.0f), 0.0f);
  float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.0f), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(aarea, barea), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-6f)) > thr;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__host__ __device__ inline int num_words(int k) { return (k + 63) / 64; }

// A row's boxes in shared memory: x1, y1, x2, y2, area (K floats each), valid (K bytes).
struct Row {
  float *x1, *y1, *x2, *y2, *area;
  uint8_t* v;
};

__device__ Row carve_row(void* at, int k) {
  Row r;
  r.x1 = static_cast<float*>(at);
  r.y1 = r.x1 + k;
  r.x2 = r.y1 + k;
  r.y2 = r.x2 + k;
  r.area = r.y2 + k;
  r.v = reinterpret_cast<uint8_t*>(r.area + k);
  return r;
}

size_t row_bytes(int k) { return size_t(k) * (5 * sizeof(float) + 1); }

// Step 1 (whole block). kGather=false: src is boxes (G, K, 4). kGather=true:
// src is planes (G, 4, N); idx (G, K) picks the candidates and cand (G, 4, K)
// receives them (0 for an index outside [0, N)).
template <bool kGather>
__device__ void load_row(Row r, const float* __restrict__ src, const int32_t* __restrict__ idx,
                         const uint8_t* __restrict__ valid, float* __restrict__ cand, int64_t g,
                         int k, int n) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float c[4];
    if (kGather) {
      const int j = idx[g * k + i];
      const bool in = j >= 0 && j < n;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = in ? src[(g * 4 + q) * n + j] : 0.0f;
        cand[(g * 4 + q) * k + i] = c[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[q] = src[(g * k + i) * 4 + q];
    }
    r.x1[i] = c[0];
    r.y1[i] = c[1];
    r.x2[i] = c[2];
    r.y2[i] = c[3];
    r.area[i] = box_area(c[0], c[1], c[2], c[3]);
    r.v[i] = valid[g * k + i] != 0;
  }
}

// Step 2 (whole block): mask[i * words + w] for rows i in [i_begin, i_end).
// Word (i, w) holds bit b for box j = 64 w + b that box i suppresses; lane l
// of the warp making it tests j = 64 w + l and 64 w + 32 + l.
__device__ void build_mask(Row r, int k, int i_begin, int i_end, float thr,
                           unsigned long long* mask) {
  const int words = num_words(k);
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < (i_end - i_begin) * words; t += blockDim.x >> 5) {
    const int i = i_begin + t / words;
    const int w = t % words;
    unsigned long long bits = 0ull;
    if (r.v[i] && 64 * w + 63 > i) {  // the same for every lane of the warp
      const int j0 = 64 * w + lane;
      const int j1 = j0 + 32;
      const bool s0 = j0 > i && j0 < k && r.v[j0] &&
                      iou_above(r.x1[i], r.y1[i], r.x2[i], r.y2[i], r.area[i], r.x1[j0],
                                r.y1[j0], r.x2[j0], r.y2[j0], r.area[j0], thr);
      const bool s1 = j1 > i && j1 < k && r.v[j1] &&
                      iou_above(r.x1[i], r.y1[i], r.x2[i], r.y2[i], r.area[i], r.x1[j1],
                                r.y1[j1], r.x2[j1], r.y2[j1], r.area[j1], thr);
      bits = static_cast<unsigned long long>(__ballot_sync(0xffffffffu, s0)) |
             (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, s1)) << 32);
    }
    if (lane == 0) mask[size_t(i) * words + w] = bits;
  }
}

// Step 3 (warp 0): keep[i] for the row whose mask (K x words) and valid flags
// are in shared memory.
__device__ void walk(const unsigned long long* mask, const uint8_t* v, uint8_t* keep, int k) {
  if (threadIdx.x >= 32) return;
  const int words = num_words(k);
  const int lane = threadIdx.x;
  unsigned long long removed = 0ull;  // word `lane` of the removed set
  for (int i = 0; i < k; ++i) {
    const unsigned long long row = lane < words ? mask[size_t(i) * words + lane] : 0ull;
    const unsigned long long word = __shfl_sync(0xffffffffu, removed, i >> 6);
    const bool kept = v[i] && !((word >> (i & 63)) & 1ull);
    if (kept) removed |= row;
    if (lane == 0) keep[i] = kept;
  }
}

// K3: one block per row, all three steps.
__global__ void __launch_bounds__(kThreads)
nms_gathered_kernel(const float* __restrict__ planes, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                    float* __restrict__ cand, int k, int n, float thr) {
  extern __shared__ unsigned long long smem[];
  const int64_t g = blockIdx.x;
  unsigned long long* mask = smem;
  Row r = carve_row(mask + size_t(k) * num_words(k), k);
  load_row<true>(r, planes, idx, valid, cand, g, k, n);
  __syncthreads();
  build_mask(r, k, 0, k, thr, mask);
  __syncthreads();
  walk(mask, r.v, keep + g * k, k);
}

// K1 step 2: block (rb, g) makes the mask words of rows [64 rb, 64 rb + 64) of row g.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                unsigned long long* __restrict__ mask, int k, float thr) {
  extern __shared__ unsigned long long smem[];
  const int64_t g = blockIdx.y;
  Row r = carve_row(smem, k);
  load_row<false>(r, boxes, nullptr, valid, nullptr, g, k, 0);
  __syncthreads();
  const int i_begin = 64 * blockIdx.x;
  build_mask(r, k, i_begin, min(i_begin + 64, k), thr, mask + g * k * num_words(k));
}

// K1 step 3: one block per row copies the row's mask into shared memory, then walks.
__global__ void __launch_bounds__(kThreads)
nms_walk_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k) {
  extern __shared__ unsigned long long smem[];
  const int64_t g = blockIdx.x;
  const size_t n_words = size_t(k) * num_words(k);
  uint8_t* v = reinterpret_cast<uint8_t*>(smem + n_words);
  for (size_t t = threadIdx.x; t < n_words; t += blockDim.x) smem[t] = mask[g * n_words + t];
  for (int i = threadIdx.x; i < k; i += blockDim.x) v[i] = valid[g * k + i] != 0;
  __syncthreads();
  walk(smem, v, keep + g * k, k);
}

// K4 step 3: one warp per row walks the mask in device memory, 64 boxes a chunk.
__global__ void __launch_bounds__(32)
nms_stream_walk_kernel(const unsigned long long* __restrict__ mask,
                       const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int k) {
  extern __shared__ unsigned long long removed[];  // ceil(K/64) words
  const int64_t g = blockIdx.x;
  const int words = num_words(k);
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + g * k * int64_t(words);
  const uint8_t* v = valid + g * k;
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();
  for (int c = 0; c < words; ++c) {
    const int i0 = 64 * c;
    const int n = min(64, k - i0);
    // the chunk's diagonal words and validity: box i0 + lane and i0 + 32 + lane
    const bool in0 = lane < n;
    const bool in1 = lane + 32 < n;
    const unsigned long long d0 = in0 ? m[int64_t(i0 + lane) * words + c] : 0ull;
    const unsigned long long d1 = in1 ? m[int64_t(i0 + 32 + lane) * words + c] : 0ull;
    const unsigned long long vbits =
        static_cast<unsigned long long>(__ballot_sync(0xffffffffu, in0 && v[i0 + lane])) |
        (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, in1 && v[i0 + 32 + lane]))
         << 32);
    // settle the chunk: box b is kept when valid and not yet removed
    unsigned long long cur = removed[c];
    unsigned long long kept = 0ull;
    for (int b = 0; b < n; ++b) {
      const unsigned long long d = __shfl_sync(0xffffffffu, b < 32 ? d0 : d1, b & 31);
      if (((vbits & ~cur) >> b) & 1ull) {
        kept |= 1ull << b;
        cur |= d;
      }
    }
    if (in0) keep[g * k + i0 + lane] = (kept >> lane) & 1ull;
    if (in1) keep[g * k + i0 + 32 + lane] = (kept >> (lane + 32)) & 1ull;
    // OR the kept boxes' rows into the later words of the removed set
    for (int w = c + 1 + lane; w < words; w += 32) {
      unsigned long long acc = 0ull;
      for (int b0 = 0; b0 < n; b0 += 8) {
        unsigned long long r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int b = b0 + j;
          r[j] = (b < n && ((kept >> b) & 1ull)) ? m[int64_t(i0 + b) * words + w] : 0ull;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc |= r[j];
      }
      removed[w] |= acc;
    }
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace

extern "C" {

// boxes (G, K, 4) f32, valid (G, K) bool -> keep (G, K) bool; mask is
// (G, K, ceil(K/64)) uint64 scratch.
int bags_nms_keep(const float* boxes, const uint8_t* valid, uint8_t* keep, void* mask, int g,
                  int k, float thr, cudaStream_t stream) {
  if (num_words(k) > kMaxWords) return int(cudaErrorInvalidValue);
  auto* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(num_words(k), g), kMaskThreads, row_bytes(k), stream>>>(boxes, valid,
                                                                                  m, k, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t walk_bytes = size_t(k) * num_words(k) * sizeof(unsigned long long) + k;
  err = allow_smem(nms_walk_kernel, walk_bytes);
  if (err != cudaSuccess) return int(err);
  nms_walk_kernel<<<g, kThreads, walk_bytes, stream>>>(m, valid, keep, k);
  return int(cudaGetLastError());
}

// K4: boxes (G, K, 4) f32, valid (G, K) bool -> keep (G, K) bool, any K whose
// row fits the mask kernel's shared memory (K <= ~11000); mask is
// (G, K, ceil(K/64)) uint64 scratch.
int bags_nms_keep_tiled(const float* boxes, const uint8_t* valid, uint8_t* keep, void* mask,
                        int g, int k, float thr, cudaStream_t stream) {
  auto* m = static_cast<unsigned long long*>(mask);
  cudaError_t err = allow_smem(nms_mask_kernel, row_bytes(k));
  if (err != cudaSuccess) return int(err);
  nms_mask_kernel<<<dim3(num_words(k), g), kMaskThreads, row_bytes(k), stream>>>(boxes, valid,
                                                                                  m, k, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t walk_bytes = size_t(num_words(k)) * sizeof(unsigned long long);
  nms_stream_walk_kernel<<<g, 32, walk_bytes, stream>>>(m, valid, keep, k);
  return int(cudaGetLastError());
}

// planes (G, 4, N) f32, idx (G, K) i32, valid (G, K) bool
//   -> keep (G, K) bool, cand (G, 4, K) f32 with cand[g, :, k] = planes[g, :, idx[g, k]].
int bags_nms_keep_gathered(const float* planes, const int32_t* idx, const uint8_t* valid,
                           uint8_t* keep, float* cand, int g, int k, int n, float thr,
                           cudaStream_t stream) {
  if (num_words(k) > kMaxWords) return int(cudaErrorInvalidValue);
  const size_t bytes = size_t(k) * num_words(k) * sizeof(unsigned long long) + row_bytes(k);
  cudaError_t err = allow_smem(nms_gathered_kernel, bytes);
  if (err != cudaSuccess) return int(err);
  nms_gathered_kernel<<<g, kThreads, bytes, stream>>>(planes, idx, valid, keep, cand, k, n, thr);
  return int(cudaGetLastError());
}

}  // extern "C"
