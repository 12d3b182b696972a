// Exact greedy NMS keep masks: K1 `bags_nms_keep`, K3 `bags_nms_keep_gathered`,
// K4 `bags_nms_keep_tiled` and K5 `bags_nms_keep_coords`.
//
// Replaces (TPU Pallas, JAX package pallas/nms.py):
//   K1  nms_keep_batched  (:304, via _keep_from_coords :273, _nms_block_kernel :29,
//       _fixpoint_keep :42) -- RPN NMS at test time, rows of K <= 1000 boxes.
//   K3  nms_keep_gathered (:371, via _nms_gathered_kernel :331) -- per-(image, class)
//       candidate gather from coordinate planes fused with the same keep.
//   K4  nms_keep_tiled    (:213, via _nms_tiled_kernel :102) -- the K1 keep for any
//       K; the RPN in training, rows of K = 2000.
//   K5  nms_keep_batched_coords (:316, via _keep_from_coords :273) -- the K1 keep on
//       (G, 4, K) coordinate planes; the class-agnostic multiclass NMS, G = B * 300
//       (image, class) rows of K = 300 candidates that K6 (gather.cu) gathered.
//
// Semantics (all four): rows of score-descending boxes with a validity mask; box i
// suppresses box j when i < j, both are valid and iou(i, j) > thr under the +1
// pixel convention; a box is kept when it is valid and no kept box suppresses
// it. Invalid slots neither keep nor suppress. This equals the fixpoint the TPU
// kernels iterate to.
//
// Design (all four). Each cuts a row's K boxes into T = ceil(K/64) blocks of
// 64 and keeps the mask transposed, word (w, i) at [w * K + i]: bit b is set
// when box i suppresses box 64 w + b. Only the T (T + 1) / 2 tiles of 64 x 64
// words on or above the diagonal (w >= i / 64) are ever built or read: box i
// never suppresses an earlier box. Each runs two kernels.
//  a. The mask pass (`nms_tile_mask_kernel`, shared; K1 and K4 read 16-byte
//     boxes, K5 its four coordinate planes, coalesced; K3 gathers each box
//     from its (G, 4, N) planes through idx, the zero box for an index
//     outside [0, N), as the plain version and the TPU's one-hot gather do).
//     A grid enumerates only the upper tiles, four a block. A thread holds
//     its row box i in registers, the tile's 64 column boxes sit in shared
//     memory (read as broadcasts), and the thread builds its 64-bit word in
//     a register (`row_word`): no ballots, no runtime division, no whole-row
//     copy into every block. Neighbouring threads store neighbouring words.
//     Bounds on the product thr * union decide every pair whose IoU is not
//     within a relative 2^-20 of thr without the division (`Threshold`),
//     eight pairs at a time without a branch; the others divide. In K3 the
//     group that builds a row block's diagonal tile also writes the block's
//     64 candidates to cand: each column block has one diagonal tile, so
//     each candidate is written once, inside K3's own launches.
//  b. The walk, 64 boxes a chunk. The invalid boxes and the boxes removed
//     by earlier chunks start as set bits of `cur`; then one thread settles
//     the chunk from its 64 diagonal words as a chain of a test and an OR a
//     box on 32-bit halves (`settle`): box b is kept when bit b of cur is
//     clear, and then cur |= d_b. As d_b holds only bits above b, the
//     chunk's kept set is ~cur at the end. A warp ORs the kept boxes' words
//     into a later word of the removed set, each lane taking two of the
//     chunk's 64 words and two `__reduce_or_sync` finishing it (`or_kept`).
// K1 and K4 (the RPN's G = B * 5 rows: K = 1000 at test time, 2000 in
// training; 136 and 528 tiles a row) share `keep_rows` and walk each row in
// one block straight from the scratch in device memory
// (`nms_tile_walk_kernel`). Only word c + 1 has to be final before chunk
// c + 1 settles, so warp 0 settles chunk after chunk and ORs each chunk's
// kept words into the next word itself, with the next chunk's words already
// in its registers (loaded while the chunk before settled); the other warps
// OR the chunk into the words after that, loading them as they go, while
// warp 0 settles the next chunk. Named barriers hand the kept set over and
// tell warp 0, one chunk later, that the OR is done: no load of the mask
// and no block-wide barrier is on the chain's path. K3 and K5 (G = B * 300
// rows of K = 300; 15 tiles a row) copy each row's mask (12 KB) into one
// block's shared memory and walk it there (`nms_coords_walk_kernel`).
//
// What bounds them on an H100: neither bytes nor FLOPs but latency and the
// IoU tests' instructions. K1 and K4 keep little in shared memory, so only
// the mask pass's grid bounds K (<= 46272); K3 and K5 keep a row's mask in
// shared memory, so K <= 1344. A K that does not fit makes the launcher
// return an error before anything is launched; `kernels.batched_nms_topk`
// sends K > 1280 to K4, as the JAX package does.
//
// IoU is computed in the JAX formula order with round-to-nearest intrinsics,
// which the compiler never contracts into FMAs, so a box exactly at the
// threshold decides as it does in ops/boxes.py bbox_overlaps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTileThreads = 256;  // the mask pass: four 64 x 64 tiles a block
constexpr int kTilesPerBlock = kTileThreads / 64;
constexpr int kMaxTileWords = 723;  // the mask pass's grid: T (T + 1) / 2 tiles <= 65535 blocks of 4
constexpr int kRowThreads = 512;     // K1 / K4 walk blocks, one row each
constexpr int kCoordsThreads = 256;  // K3 / K5 walk blocks, one row each
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can have on sm_90 (227 KB)

// The intersection and union of two boxes in the JAX formula order.
__device__ __forceinline__ void inter_union(float ax1, float ay1, float ax2, float ay2, float aarea,
                                            float bx1, float by1, float bx2, float by2, float barea,
                                            float& inter, float& uni) {
  float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.0f), 0.0f);
  float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.0f), 0.0f);
  inter = __fmul_rn(iw, ih);
  uni = __fsub_rn(__fadd_rn(aarea, barea), inter);
}

__device__ __forceinline__ bool iou_above(float ax1, float ay1, float ax2, float ay2,
                                          float aarea, float bx1, float by1, float bx2,
                                          float by2, float barea, float thr) {
  float inter, uni;
  inter_union(ax1, ay1, ax2, ay2, aarea, bx1, by1, bx2, by2, barea, inter, uni);
  return __fdiv_rn(inter, fmaxf(uni, 1e-6f)) > thr;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f), __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__host__ __device__ inline int num_words(int k) { return (k + 63) / 64; }

// How a kernel finds a row's boxes.
enum class Src {
  kRows,    // K1, K4: src is boxes (G, K, 4)
  kPlanes,  // K5: src is coordinate planes (G, 4, K)
  kGather,  // K3: src is planes (G, 4, N), gathered through idx (G, K)
};

// Box i of row g as (x1, y1, x2, y2): one 16-byte load from (G, K, 4) boxes
// (four where a caller's view is not 16-byte aligned), four coalesced loads
// from (G, 4, K) planes, or four loads from (G, 4, N) planes at idx[g, i] (the
// zero box for an index outside [0, N)).
template <Src kSrc>
__device__ __forceinline__ float4 box_at(const float* __restrict__ src, const int32_t* __restrict__ idx,
                                         int64_t g, int k, int n, int i) {
  if constexpr (kSrc == Src::kGather) {
    const int at = __ldg(idx + g * k + i);
    if (at < 0 || at >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* p = src + g * 4 * int64_t(n) + at;
    return make_float4(__ldg(p), __ldg(p + n), __ldg(p + 2 * int64_t(n)), __ldg(p + 3 * int64_t(n)));
  } else if constexpr (kSrc == Src::kPlanes) {
    const float* p = src + g * 4 * int64_t(k) + i;
    return make_float4(p[0], p[k], p[2 * int64_t(k)], p[3 * int64_t(k)]);
  } else {
    const float* p = src + (g * k + i) * 4;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

__device__ __forceinline__ float area_of(float4 b) { return box_area(b.x, b.y, b.z, b.w); }

// The bits above b: the boxes of a chunk that box b of it may suppress.
__device__ __forceinline__ u64 above(int b) { return b >= 63 ? 0ull : ~0ull << (b + 1); }

// Tile u of the T (T + 1) / 2 tiles on or above a row's diagonal, counted row
// block by row block, as (row block, column block).
__device__ __forceinline__ int2 upper_tile(int u, int t) {
  const int v = t * (t + 1) / 2 - 1 - u;  // counted back from the last tile
  int r = int((sqrtf(8.0f * v + 1.0f) - 1.0f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= v) ++r;
  while (r * (r + 1) / 2 > v) --r;
  const int rb = t - 1 - r;  // row block rb holds t - rb tiles
  return make_int2(rb, rb + r - (v - r * (r + 1) / 2));
}

// iou_above without the division where the IoU is not within a relative
// 2^-20 of thr. With u = max(uni, 1e-6), thr_hi = fl(thr (1 + 2^-20)) and
// thr_lo = fl(thr (1 - 2^-20)), and each product below off by at most 2^-24:
// inter > fl(thr_hi u) gives inter / u > thr (1 + 2^-21), above the midpoint
// between thr and the next f32, so the rounded quotient is above thr; inter <
// fl(thr_lo u) gives inter / u < thr, so the rounded quotient is at most thr.
// Both need the products normal, which thr in [2^-100, 2^100] and u >= 1e-6
// ensure (an overflow to inf decides as the quotient would); outside that
// range, and for NaN and the pairs between the bounds, the division decides.
struct Threshold {
  float thr, hi, lo;
  bool bounds;  // thr in [2^-100, 2^100]: the bounds decide
};

__device__ __forceinline__ Threshold threshold(float thr) {
  return {thr, __fmul_rn(thr, 1.0f + 0x1p-20f), __fmul_rn(thr, 1.0f - 0x1p-20f),
          thr >= 0x1p-100f && thr <= 0x1p100f};
}

// Step a: the word of box a (t of its row block, in registers) against the
// 64 column boxes of a tile (shared memory, read as broadcasts). cv has bit
// j when column box j exists and is valid; on the diagonal only j > t count,
// and the warp skips the columns below its first lane's. Bit j is set when a
// suppresses column box j. Eight columns at a time are tested without a
// branch by the bounds; a group with a pair the bounds leave open divides for
// those pairs.
__device__ __forceinline__ u64 row_word(float4 a, float aarea, bool a_valid, const float4* cbox,
                                        const float* carea, u64 cv, int t, bool diag, Threshold thr) {
  if (!a_valid) return 0ull;
  const u64 live = diag ? cv & above(t) : cv;
  const u64 warp_live = diag ? cv & above(t & ~31) : cv;  // the same for the warp's lanes
  unsigned half[2] = {0u, 0u};
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // eight columns at a time, skipped when none is live
    if ((warp_live >> (8 * q)) & 0xffull) {
      unsigned sure = 0u, open = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = cbox[8 * q + j];
        float inter, uni;
        inter_union(a.x, a.y, a.z, a.w, aarea, b.x, b.y, b.z, b.w, carea[8 * q + j], inter, uni);
        const float u = fmaxf(uni, 1e-6f);
        const bool yes = thr.bounds && inter > __fmul_rn(thr.hi, u);
        const bool no = thr.bounds && inter < __fmul_rn(thr.lo, u);
        sure |= static_cast<unsigned>(yes) << j;
        open |= static_cast<unsigned>(!yes && !no) << j;
      }
      for (; open != 0u; open &= open - 1u) {
        const int j = 8 * q + __ffs(open) - 1;
        const float4 b = cbox[j];
        sure |= static_cast<unsigned>(iou_above(a.x, a.y, a.z, a.w, aarea, b.x, b.y, b.z, b.w, carea[j], thr.thr))
                << (j - 8 * q);
      }
      half[q >> 2] |= sure << (8 * (q & 3));
    }
  }
  return ((static_cast<u64>(half[1]) << 32) | half[0]) & live;
}

// Step a over the card: block (g, y) builds tiles 4 y .. 4 y + 3 of row g's
// upper tiles, word (w, i) of the row at mask[(g * T + w) * K + i]. The lower
// tiles are never written. With kGather, the diagonal tiles' groups write the
// gathered boxes to cand (G, 4, K).
template <Src kSrc>
__global__ void __launch_bounds__(kTileThreads)
nms_tile_mask_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid, u64* __restrict__ mask, float* __restrict__ cand,
                     int k, int n, float thr) {
  __shared__ float4 cbox[kTilesPerBlock][64];
  __shared__ float carea[kTilesPerBlock][64];
  __shared__ unsigned cvalid[kTilesPerBlock][2];
  const int64_t g = blockIdx.x;
  const int words = num_words(k);
  const int grp = threadIdx.x >> 6;
  const int t = threadIdx.x & 63;
  const int u = blockIdx.y * kTilesPerBlock + grp;
  const bool live = u < words * (words + 1) / 2;  // the same for the group's 64 threads
  const int2 tile = live ? upper_tile(u, words) : make_int2(0, 0);
  const bool diag = tile.x == tile.y;
  const int i = 64 * tile.x + t;
  const int j = 64 * tile.y + t;
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool j_valid = false;
  if (live && j < k) {
    b = box_at<kSrc>(src, idx, g, k, n, j);
    cbox[grp][t] = b;
    carea[grp][t] = area_of(b);
    j_valid = valid[g * k + j] != 0;
    if constexpr (kSrc == Src::kGather) {
      if (diag) {
        float* c = cand + g * 4 * int64_t(k) + j;
        c[0] = b.x;
        c[k] = b.y;
        c[2 * int64_t(k)] = b.z;
        c[3 * int64_t(k)] = b.w;
      }
    }
  }
  float4 a = b;  // on the diagonal, row box i is column box j
  bool a_valid = j_valid;
  if (live && !diag && i < k) {
    a = box_at<kSrc>(src, idx, g, k, n, i);
    a_valid = valid[g * k + i] != 0;
  }
  const unsigned half = __ballot_sync(0xffffffffu, j_valid);
  if ((threadIdx.x & 31) == 0) cvalid[grp][t >> 5] = half;
  __syncthreads();
  if (!live || i >= k) return;
  const u64 cv = cvalid[grp][0] | (static_cast<u64>(cvalid[grp][1]) << 32);
  mask[(g * words + tile.y) * int64_t(k) + i] =
      row_word(a, area_of(a), a_valid, cbox[grp], carea[grp], cv, t, diag, threshold(thr));
}

// Whole block: vbits[w] bit b set when box 64 w + b exists and is valid; the
// removed set zeroed.
__device__ void row_bits(const uint8_t* __restrict__ v, int k, u64* vbits, u64* removed) {
  const int words = num_words(k);
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x & ~31; base < 64 * words; base += blockDim.x) {
    const int i = base + lane;
    const unsigned half = __ballot_sync(0xffffffffu, i < k && v[i] != 0);
    if (lane == 0) reinterpret_cast<unsigned*>(vbits)[base >> 5] = half;
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
}

// Step b for one chunk: cur starts with the chunk's invalid and removed boxes
// set; d holds its 64 diagonal words, zero past the row's end. Returns the
// kept set. The chain runs on 32-bit halves: box b < 32 tests the low half
// and ORs in both halves of d_b; from b = 32 on a diagonal word has only
// high bits (bits above b), so only the high halves take part. A box costs
// a test, a select and an OR on the chain; a test and a predicated OR in
// inline PTX measured within 2% of it on the H100 (`kernel_study` times
// both), so the plain form stays.
__device__ __forceinline__ u64 settle(const u64* d, u64 cur) {
  if (~cur == 0ull) return 0ull;
  unsigned lo = static_cast<unsigned>(cur);
  unsigned hi = static_cast<unsigned>(cur >> 32);
  const uint2* w = reinterpret_cast<const uint2*>(d);
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint2 x = w[b];
    if (!(lo & (1u << b))) {
      lo |= x.x;
      hi |= x.y;
    }
  }
#pragma unroll
  for (int b = 32; b < 64; ++b) {
    const unsigned x = w[b].y;
    if (!(hi & (1u << (b - 32)))) hi |= x;
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

// The OR over a warp of the kept boxes' words for one later word: lane l
// holds the words of boxes l (v0) and l + 32 (v1) of the chunk.
__device__ __forceinline__ u64 or_kept(u64 v0, u64 v1, u64 kept, int lane) {
  const u64 v = (((kept >> lane) & 1ull) ? v0 : 0ull) | (((kept >> (lane + 32)) & 1ull) ? v1 : 0ull);
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The same for the words (w, 64 c + b) at r, read only where box b is kept.
__device__ __forceinline__ u64 or_kept(const u64* r, u64 kept, int lane) {
  const u64 v0 = ((kept >> lane) & 1ull) ? r[lane] : 0ull;
  const u64 v1 = ((kept >> (lane + 32)) & 1ull) ? r[lane + 32] : 0ull;
  return or_kept(v0, v1, kept, lane);
}

// *word |= v for words other warps OR into as well: two native 32-bit
// atomics (a 64-bit atomicOr on shared memory is a compare-and-swap loop).
__device__ __forceinline__ void or_into(u64* word, u64 v) {
  atomicOr(reinterpret_cast<unsigned*>(word), static_cast<unsigned>(v));
  atomicOr(reinterpret_cast<unsigned*>(word) + 1, static_cast<unsigned>(v >> 32));
}

// Named barriers between K1's / K4's settling warp and the others (0 is __syncthreads).
constexpr int kKeptBar = 1;  // + c % 2: chunk c's kept set is out
constexpr int kOredBar = 3;  // + c % 2: chunk c's kept words are ORed into the words after c + 1

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(static_cast<int>(blockDim.x)) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(static_cast<int>(blockDim.x)) : "memory");
}

// K1's / K4's walk bytes: the removed set, the valid bits, two kept sets, a
// chunk's diagonal words; at most 12 KB, no attribute to raise.
size_t tile_walk_bytes(int k) { return (2 * size_t(num_words(k)) + 2 + 64) * sizeof(u64); }

// K1 and K4 step b: one block per row walks the mask in device memory. Warp 0
// settles chunk after chunk: its lanes hold the chunk's diagonal words and
// its words for c + 1, loaded while the chunk before settled; once chunk c
// is settled it ORs the kept boxes' words into word c + 1 itself, so word
// c + 1 is final but for chunks <= c - 1. The other warps OR chunk c's kept
// words into the words after c + 1, loading them as they go, while warp 0
// settles chunk c + 1; warp 0 waits for them only before chunk c + 2.
__global__ void __launch_bounds__(kRowThreads)
nms_tile_walk_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int k) {
  extern __shared__ u64 smem[];
  const int64_t g = blockIdx.x;
  const int words = num_words(k);
  u64* removed = smem;
  u64* vbits = removed + words;
  u64* kept_at = vbits + words;  // chunk c's kept set at kept_at[c % 2]
  u64* diag = kept_at + 2;
  const u64* m = mask + g * words * int64_t(k);
  uint8_t* out = keep + g * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  row_bits(valid + g * k, k, vbits, removed);
  __syncthreads();
  // word (w, 64 c + b) of the row, 0 past its end
  auto word = [&](int w, int c, int b) -> u64 {
    const int i = 64 * c + b;
    return w < words && i < k ? __ldg(m + int64_t(w) * k + i) : 0ull;
  };
  if (warp == 0) {
    u64 d0 = word(0, 0, lane), d1 = word(0, 0, lane + 32);  // chunk c's diagonal words
    u64 e0 = word(1, 0, lane), e1 = word(1, 0, lane + 32);  // its words for c + 1
    for (int c = 0; c < words; ++c) {
      if (c >= 2) bar_sync(kOredBar + (c & 1));  // chunk c - 2 is ORed in
      diag[lane] = d0;
      diag[lane + 32] = d1;
      __syncwarp();
      d0 = word(c + 1, c + 1, lane);
      d1 = word(c + 1, c + 1, lane + 32);
      const u64 f0 = word(c + 2, c + 1, lane), f1 = word(c + 2, c + 1, lane + 32);
      const int n = min(64, k - 64 * c);
      u64 kept = 0ull;
      if (lane == 0) kept = settle(diag, removed[c] | ~vbits[c]);
      kept = __shfl_sync(0xffffffffu, kept, 0);
      if (lane < n) out[64 * c + lane] = (kept >> lane) & 1ull;
      if (lane + 32 < n) out[64 * c + 32 + lane] = (kept >> (lane + 32)) & 1ull;
      if (c + 2 < words) {
        if (lane == 0) kept_at[c & 1] = kept;
        bar_arrive(kKeptBar + (c & 1));
      }
      if (c + 1 < words && kept != 0ull) {
        const u64 v = or_kept(e0, e1, kept, lane);
        if (lane == 0) or_into(removed + c + 1, v);
      }
      e0 = f0;
      e1 = f1;
      __syncwarp();
    }
  } else {
    for (int c = 0; c + 2 < words; ++c) {
      bar_sync(kKeptBar + (c & 1));
      const u64 kept = kept_at[c & 1];
      if (kept != 0ull) {
        for (int w = c + 2 + warp - 1; w < words; w += (blockDim.x >> 5) - 1) {
          const u64 v = or_kept(m + int64_t(w) * k + 64 * c, kept, lane);
          if (lane == 0 && v != 0ull) or_into(removed + w, v);
        }
      }
      bar_arrive(kOredBar + (c & 1));
    }
  }
}

// K3's / K5's walk bytes: the row's mask, 64 zero words after it (the last chunk's
// diagonal words past the row's end), the removed set, the valid bits, the
// kept set.
size_t coords_walk_bytes(int k) {
  const size_t words = num_words(k);
  return (words * k + 64 + 2 * words + 1) * sizeof(u64);
}

// K3 and K5 step b: one block per row copies the row's mask (the upper tiles the
// mask pass wrote) into shared memory and walks it there: thread 0 settles a
// chunk, then the warps OR its kept words into the later words.
__global__ void __launch_bounds__(kCoordsThreads)
nms_coords_walk_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep, int k) {
  extern __shared__ u64 smem[];
  const int64_t g = blockIdx.x;
  const int words = num_words(k);
  u64* m = smem;  // word (w, i) at m[w * k + i]
  u64* removed = m + size_t(words) * k + 64;
  u64* vbits = removed + words;
  u64* kept_at = vbits + words;
  uint8_t* out = keep + g * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  row_bits(valid + g * k, k, vbits, removed);
  const u64* src = mask + g * words * int64_t(k);
  for (int e = threadIdx.x; e < words * k + 64; e += blockDim.x) m[e] = e < words * k ? src[e] : 0ull;
  for (int c = 0; c < words; ++c) {
    __syncthreads();  // the mask copied, or chunk c - 1 ORed in
    const int n = min(64, k - 64 * c);
    if (threadIdx.x == 0) *kept_at = settle(m + size_t(c) * k + 64 * c, removed[c] | ~vbits[c]);
    __syncthreads();
    const u64 kept = *kept_at;
    if (threadIdx.x < n) out[64 * c + threadIdx.x] = (kept >> threadIdx.x) & 1ull;
    if (kept == 0ull) continue;
    for (int w = c + 1 + warp; w < words; w += blockDim.x >> 5) {
      const u64 v = or_kept(m + size_t(w) * k + 64 * c, kept, lane);
      if (lane == 0) removed[w] |= v;
    }
  }
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, raised for a kernel once to
// each larger size it is launched with, on each device.
constexpr int kMaxDevices = 64;

struct SmemSet {
  size_t bytes[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, SmemSet& set, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set.bytes[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) set.bytes[dev] = bytes;
  return err;
}

// Step a over the card for G rows of K boxes.
template <Src kSrc>
cudaError_t launch_tile_mask(const float* src, const int32_t* idx, const uint8_t* valid, u64* mask, float* cand,
                             int g, int k, int n, float thr, cudaStream_t stream) {
  const int tiles = num_words(k) * (num_words(k) + 1) / 2;
  nms_tile_mask_kernel<kSrc><<<dim3(g, (tiles + kTilesPerBlock - 1) / kTilesPerBlock), kTileThreads, 0, stream>>>(
      src, idx, valid, mask, cand, k, n, thr);
  return cudaGetLastError();
}

// Whether K3's and K5's walk takes rows of K (a row's mask in one block's
// shared memory), its shared memory allowed; asked before anything is launched.
cudaError_t coords_walk_fits(int k) {
  static SmemSet set;  // one for the kernel, whichever entry launches it
  const size_t bytes = coords_walk_bytes(k);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return allow_smem(nms_coords_walk_kernel, set, bytes);
}

// K1 and K4: boxes (G, K, 4); the mask pass, then the walk from device memory.
cudaError_t keep_rows(const float* boxes, const uint8_t* valid, uint8_t* keep, u64* m, int g, int k, float thr,
                      cudaStream_t stream) {
  if (num_words(k) > kMaxTileWords) return cudaErrorInvalidValue;
  cudaError_t err = launch_tile_mask<Src::kRows>(boxes, nullptr, valid, m, nullptr, g, k, 0, thr, stream);
  if (err != cudaSuccess) return err;
  nms_tile_walk_kernel<<<g, kRowThreads, tile_walk_bytes(k), stream>>>(m, valid, keep, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: boxes (G, K, 4) f32, valid (G, K) bool -> keep (G, K) bool, K <= 46272
// (the mask pass's grid); mask is (G, K, ceil(K/64)) uint64 scratch.
int bags_nms_keep(const float* boxes, const uint8_t* valid, uint8_t* keep, void* mask, int g, int k, float thr,
                  cudaStream_t stream) {
  return int(keep_rows(boxes, valid, keep, static_cast<u64*>(mask), g, k, thr, stream));
}

// K5: coords (G, 4, K) f32, valid (G, K) bool -> keep (G, K) bool, K <= 1344
// (a row's mask in one block's shared memory); mask is (G, K, ceil(K/64))
// uint64 scratch.
int bags_nms_keep_coords(const float* coords, const uint8_t* valid, uint8_t* keep, void* mask,
                         int g, int k, float thr, cudaStream_t stream) {
  cudaError_t err = coords_walk_fits(k);
  if (err != cudaSuccess) return int(err);
  auto* m = static_cast<u64*>(mask);
  err = launch_tile_mask<Src::kPlanes>(coords, nullptr, valid, m, nullptr, g, k, 0, thr, stream);
  if (err != cudaSuccess) return int(err);
  nms_coords_walk_kernel<<<g, kCoordsThreads, coords_walk_bytes(k), stream>>>(m, valid, keep, k);
  return int(cudaGetLastError());
}

// K4: the K1 keep for the training RPN's rows of K = 2000, on the same kernels.
int bags_nms_keep_tiled(const float* boxes, const uint8_t* valid, uint8_t* keep, void* mask,
                        int g, int k, float thr, cudaStream_t stream) {
  return int(keep_rows(boxes, valid, keep, static_cast<u64*>(mask), g, k, thr, stream));
}

// K3: planes (G, 4, N) f32, idx (G, K) i32, valid (G, K) bool -> keep (G, K)
// bool, cand (G, 4, K) f32 with cand[g, :, k] = planes[g, :, idx[g, k]] (0 for
// an index outside [0, N)), K <= 1344 (K5's walk); mask is (G, K, ceil(K/64))
// uint64 scratch.
int bags_nms_keep_gathered(const float* planes, const int32_t* idx, const uint8_t* valid, uint8_t* keep,
                           float* cand, void* mask, int g, int k, int n, float thr, cudaStream_t stream) {
  cudaError_t err = coords_walk_fits(k);
  if (err != cudaSuccess) return int(err);
  auto* m = static_cast<u64*>(mask);
  err = launch_tile_mask<Src::kGather>(planes, idx, valid, m, cand, g, k, n, thr, stream);
  if (err != cudaSuccess) return int(err);
  nms_coords_walk_kernel<<<g, kCoordsThreads, coords_walk_bytes(k), stream>>>(m, valid, keep, k);
  return int(cudaGetLastError());
}

}  // extern "C"

BAGS_PACKED(bags_nms_keep)
BAGS_PACKED(bags_nms_keep_coords)
BAGS_PACKED(bags_nms_keep_tiled)
BAGS_PACKED(bags_nms_keep_gathered)
