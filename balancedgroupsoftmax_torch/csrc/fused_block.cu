// Fused stride-1 ResNet bottleneck, BN folded: K8 `bags_fused_bottleneck` and
// K9 `bags_fused_layer`.
//
// Replaces (TPU Pallas, JAX package pallas/fused_block.py): fused_bottleneck
// (:234, via _kernel :84; pallas_call :300) and fused_layer (:448, via
// _layer_kernel :310; pallas_call :546).
//
// What it computes, per output pixel and channel, with f32 sums and the
// rounding of the plain version (ops/fused_block.py):
//   y1 = T(relu(x @ w1 + b1))      0 outside the image (conv2's zero padding)
//   y2 = T(relu(sum over the 9 taps of shifted y1 @ w2[dy * 3 + dx] + b2))
//   y3 = T(y2 @ w3 + b3)
//   id = x, or T(x @ wd + bd)
//   out = T(relu(T(y3 + id)))
// T is x's dtype (bf16 or f32). The weights are in T, the biases f32.
//
// What bounds it on an H100. At the R50's shapes (800 x 1344, batch 2) a
// block is 9.4 G multiply-adds, 0.019 ms at the published 989 TFLOP/s (bf16,
// dense). layer1's blocks move 86-138 MB of input and output, 0.026-0.041 ms
// at 3.35 TB/s, so layer1 and layer2 are bound by bytes, layer3 and layer4
// by operations: the 13 blocks by about 0.30 ms, the four runs of K9 by 0.25.
// This design takes 9-12x that a block (PERF.md): the phase route is bound by
// its copies from L2 (every work unit reads its weight columns again), the
// halo route by epilogues that no product overlaps; the products themselves
// are a few percent.
//
// Design. One kernel serves both entries: K8 is a run of one block. A block
// of threads is two consumer warpgroups and one producer warpgroup (setmaxnreg
// moves registers from the producer, 48 a thread, to the consumers, 224), one
// block an SM, persistent, launched cooperatively. Every product (conv1, the
// nine taps of conv2, conv3, the downsample) is a chain of K-chunks (64 bf16
// or 32 f32 channels) through one core:
// - the producer copies each chunk's weights (KC x 64 or 128 columns) and,
//   where the A operand comes from device memory, its activation rows (zero
//   outside the image) into a ring of 2-4 stages in shared memory with
//   cp.async, and reports each stage full on an mbarrier; the consumers free
//   a stage on another. cp.async, not TMA: the copies are 16-byte pieces with
//   a per-row source (halo pixels, conv2's shifted rows, zero padding), and
//   it needs no tensor map. The producer runs ahead across tiles, products
//   and K9's grid barriers (weights do not depend on the previous stage), and
//   waits at a barrier only before the first activation copy after it.
// - bf16: each consumer warpgroup runs wgmma.mma_async m64n64k16, A and B
//   both from shared memory, f32 accumulators in registers (at most two
//   64-row blocks a warpgroup: a longer product runs in parts), and waits for
//   a chunk's products before freeing its stage (waiting one chunk behind
//   makes ptxas serialize every wgmma). No swizzle: an operand is 8 x 16-byte
//   core matrices. A (pixels x channels) is stored [channel piece][row][8
//   channels], so any 64 consecutive rows from any row are an operand:
//   conv2's taps are A at a shifted start row. B (a weight chunk, its rows
//   contiguous in device memory as in JAX) is [column piece][k][8 columns]
//   and is read transposed (MN-major). f32 stays on the CUDA cores, every
//   multiply and add rounded on its own (-fmad=false), with the same
//   accumulator layout, stages and plan.
// - the epilogue works from the accumulators: bias, relu and the rounding to
//   T, then y1 and y2 straight into the next product's A layout in shared
//   memory (a quad's 4-byte pairs fill 16-byte pieces), or a butterfly
//   transpose inside each lane quad and 16-byte stores of 8 channels into
//   device memory. The downsample's rounded sum stays in shared memory for
//   conv3's epilogue, which adds it (or x) and writes the output.
// The plan (ops/fused_block.py `fused_plan`, from the shapes and the SM
// count, passed in) picks one of two routes for each block:
// - halo (the R50's layer1, where such tiles give four or more an SM): a
//   tile is TH x 30 output pixels of one image.
//   conv1 runs over its (TH + 2) x 32 halo pixels into y1 in shared memory
//   (1.33x the pixels at TH = 8, 1.42x at 6); conv2, the downsample and conv3
//   run over TH rows of 32, the last two columns of each thrown away, so that
//   a tap's rows are y1's rows at one offset. y2 stays in shared memory.
// - phase (layer2-4; at layer3 and layer4 128-pixel tiles are too few to
//   fill 132 SMs): conv1, conv2 and conv3 each run as a GEMM over all pixels
//   in work units of 64 or 128 pixels x 64 or 128 channels, separated by grid
//   barriers; y1 and y2 go to a device scratch that L2 holds; conv2 is an
//   implicit GEMM whose A rows are y1's pixels at the tap's offset. No halo
//   is recomputed, and a weight chunk is read once a work unit.
// The reduction order of every output follows from the plan alone, so K9
// (each block with the plan K8 takes for it) equals the chain of K8 calls
// bit for bit.
//
// Limits: channels multiples of 16; at most 32 blocks a K9 launch; stride 1,
// ungrouped, not deformable (the wrapper refuses the rest); a plan whose
// shared memory does not fit 227 KB, or whose phase work unit is more than
// one job, is refused before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 256;                   // two warpgroups
constexpr int kProducers = 128;                   // and the producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 48, kConsumerRegs = 224;  // setmaxnreg: 128 x 48 + 256 x 224 <= 64K
constexpr int kMaxMb = 2;                         // 64-row blocks a warpgroup holds of one job
constexpr int kTw = 30;                           // output columns of a halo tile
constexpr int kHw = 32;                           // its halo columns, and the row pitch of its products
constexpr int kChunkRow = 128;                    // bytes of one row of a K-chunk
constexpr int kBBytes = 16384;                    // a weight chunk: KC rows x 128 columns
constexpr int kMaxRing = 4;
constexpr int kMaxStages = 32;
constexpr size_t kMaxShared = 232448;
constexpr size_t kBarBytes = 2 * kMaxRing * 8;
enum Route { kHalo = 0, kPhase = 1 };
enum Kind { kConv1, kConv2, kDs, kConv3 };

template <typename T> __host__ __device__ constexpr int chunk_k() { return kChunkRow / int(sizeof(T)); }
template <typename T> __host__ __device__ constexpr int piece() { return 16 / int(sizeof(T)); }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
// columns of one product's work unit: 128 split between the warpgroups, else 64 for both
__host__ __device__ inline int unit_cols(int n) { return n % 128 == 0 ? 128 : 64; }
// rows of one job: a product's rows run in parts of kMaxMb 64-row blocks a warpgroup
__host__ __device__ inline int part_rows(int n) { return (unit_cols(n) == 128 ? 1 : 2) * kMaxMb * 64; }

struct Stage {
  const void* in;   // (B, H + 2 in_pad, W, cin)
  void* out;        // (B, H + 2 out_pad, W, cout)
  const void* w1;   // (cin, cm)
  const void* w2;   // (9, cm, cm)
  const void* w3;   // (cm, cout)
  const void* wd;   // (cin, cout) or null
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;
  int cin, cm, cout, in_pad, out_pad;
  int route, rows;  // the plan: halo tile rows (TH), or pixels a phase work unit
};

// Shared memory of one stage, before the ring: halo y1 (its rows as
// [piece][p1][16 B]; the downsample's sum reuses it) and y2; phase the sum.
struct Smem {
  size_t y2, fixed;
  int p1, arows;  // y1's rows; rows of the ring's A region this stage fills
};
// the downsample's rounded sum: every consumer thread's 2 x 64-row blocks x 32 values
template <typename T> __host__ __device__ constexpr size_t sum_bytes() {
  return size_t(kConsumers) * kMaxMb * 32 * sizeof(T);
}

template <typename T>
__host__ __device__ Smem stage_smem(int route, int rows, int cm, int cout) {
  const size_t es = sizeof(T);
  Smem s;
  if (route == kHalo) {
    s.p1 = (rows + 2) * kHw + 8;  // conv2's last thrown-away columns read 2 rows past the halo
    s.arows = imax(imin((rows + 2) * kHw, part_rows(cm)), imin(rows * kHw, part_rows(cout)));
    const size_t y1 = size_t(s.p1) * cm * es, sum = sum_bytes<T>();
    s.y2 = align128(y1 > sum ? y1 : sum);
    s.fixed = s.y2 + align128(size_t(rows) * kHw * cm * es);
  } else {
    s.p1 = 0;
    s.arows = rows;
    s.y2 = 0;
    s.fixed = align128(sum_bytes<T>());
  }
  return s;
}

struct LayerArgs {
  Stage st[kMaxStages];
  int n, b, h, w;
  int ring;              // stages of the ring
  unsigned ring_off;     // its offset in shared memory
  unsigned stage_bytes;  // one ring stage: the A region, then the weight chunk
  unsigned a_bytes;
  void* y1s;             // phase route: y1 and y2, (B H W, cm) each
  void* y2s;
  unsigned* barrier;     // grid barrier, zeroed
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return uint32_t(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// 16 bytes from device memory into shared memory; zeros where src is null
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src ? src : any),
               "r"(src ? 16 : 0)
               : "memory");
}

// the mbarrier sees one arrival once this thread's earlier copies have landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// threadIdx.x / 32, which the compiler then knows to be the same across a
// warp: wgmma in a branch on it is not a divergent path
__device__ __forceinline__ int warp_index() { return __shfl_sync(0xFFFFFFFFu, int(threadIdx.x) >> 5, 0); }

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory"); }

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, K-major) @ B (16 x 64, MN-major), both in shared memory
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- 8 channels of T

template <typename T> struct Vec8;
template <> struct Vec8<bf16> {
  uint4 u;
  __device__ float get(int i) const {
    const uint32_t w = (&u.x)[i >> 1];
    return __uint_as_float(i & 1 ? (w & 0xFFFF0000u) : (w << 16));
  }
  __device__ void load(const void* p) { u = __ldcg(reinterpret_cast<const uint4*>(p)); }
  __device__ void store(void* p) const { *reinterpret_cast<uint4*>(p) = u; }
};
template <> struct Vec8<float> {
  float4 a, b;
  __device__ float get(int i) const { return i < 4 ? (&a.x)[i] : (&b.x)[i - 4]; }
  __device__ void load(const void* p) {
    a = __ldcg(reinterpret_cast<const float4*>(p));
    b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void store(void* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
};

// two rounded values of T: the unit the quad transpose moves
template <typename T> struct Pair;
template <> struct Pair<bf16> {
  using P = uint32_t;
  __device__ static P make(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float lo(P v) { return __uint_as_float(v << 16); }
  __device__ static float hi(P v) { return __uint_as_float(v & 0xFFFF0000u); }
  __device__ static P shfl_xor(P v, int m) { return __shfl_xor_sync(0xFFFFFFFFu, v, m); }
  __device__ static Vec8<bf16> join(const P (&p)[4]) { return Vec8<bf16>{make_uint4(p[0], p[1], p[2], p[3])}; }
};
template <> struct Pair<float> {
  using P = float2;
  __device__ static P make(float x, float y) { return make_float2(x, y); }
  __device__ static float lo(P v) { return v.x; }
  __device__ static float hi(P v) { return v.y; }
  __device__ static P shfl_xor(P v, int m) {
    return make_float2(__shfl_xor_sync(0xFFFFFFFFu, v.x, m), __shfl_xor_sync(0xFFFFFFFFu, v.y, m));
  }
  __device__ static Vec8<float> join(const P (&p)[4]) {
    return Vec8<float>{make_float4(p[0].x, p[0].y, p[1].x, p[1].y), make_float4(p[2].x, p[2].y, p[3].x, p[3].y)};
  }
};

// Lane q of a quad holds the pairs of columns 8 j + 2 q of j = 0..3 (a 4 x 4
// matrix of pairs, a row a lane); after this it holds the 8 columns of j = q,
// in order: two butterfly exchanges, with the lanes 2 apart, then 1 apart.
template <typename T>
__device__ __forceinline__ Vec8<T> quad_transpose(typename Pair<T>::P (&v)[4]) {
  using P = typename Pair<T>::P;
  const int q = threadIdx.x & 3;
  const bool b1 = q & 2, b0 = q & 1;
  P t0 = Pair<T>::shfl_xor(b1 ? v[0] : v[2], 2), t1 = Pair<T>::shfl_xor(b1 ? v[1] : v[3], 2);
  if (b1) {
    v[0] = t0, v[1] = t1;
  } else {
    v[2] = t0, v[3] = t1;
  }
  t0 = Pair<T>::shfl_xor(b0 ? v[0] : v[1], 1), t1 = Pair<T>::shfl_xor(b0 ? v[2] : v[3], 1);
  if (b0) {
    v[0] = t0, v[2] = t1;
  } else {
    v[1] = t0, v[3] = t1;
  }
  return Pair<T>::join(v);
}

// ---------------------------------------------------------------- the schedule

struct Job {
  int kind, n0, nt, n, k, taps, rows;
  int roff;        // the job's first row among the product's (a halo tile's rows)
  int tb, r0, c0;  // halo: the tile's image and first output row and column
  int p0;          // phase: the work unit's first pixel
};

// One product of a halo tile over `rows` rows, in jobs of at most kMaxMb
// 64-row blocks a warpgroup.
template <typename V>
__device__ __forceinline__ void halo_parts(V& v, const Stage& st, Job j, int rows) {
  const int part = part_rows(j.n);
  for (j.roff = 0; j.roff < rows; j.roff += part) {
    j.rows = min(part, rows - j.roff);
    v.job(st, j);
  }
}

// Walks the products of this block's work units in order, handing each to
// v.job; the producer and the consumers walk the same schedule.
template <typename V>
__device__ __forceinline__ void walk(const LayerArgs& a, V& v) {
  const int m = a.b * a.h * a.w;
  for (int s = 0; s < a.n; ++s) {
    const Stage& st = a.st[s];
    if (st.route == kHalo) {
      const int th = st.rows, rt = cdiv(a.h, th), ct = cdiv(a.w, kTw), tiles = a.b * rt * ct;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        Job j{kConv1, 0, unit_cols(st.cm), st.cm, st.cin, 1, 0, 0,
              t / (rt * ct), (t / ct) % rt * th, t % ct * kTw, 0};
        for (j.n0 = 0; j.n0 < j.n; j.n0 += j.nt) halo_parts(v, st, j, (th + 2) * kHw);
        v.block_sync();
        j.kind = kConv2, j.k = st.cm, j.taps = 9;
        for (j.n0 = 0; j.n0 < j.n; j.n0 += j.nt) halo_parts(v, st, j, th * kHw);
        v.block_sync();
        j.n = st.cout, j.nt = unit_cols(st.cout), j.taps = 1;
        const int part = part_rows(j.n);
        for (j.n0 = 0; j.n0 < j.n; j.n0 += j.nt) {
          for (j.roff = 0; j.roff < th * kHw; j.roff += part) {  // the downsample's sum, then conv3 on it
            j.rows = min(part, th * kHw - j.roff);
            if (st.wd != nullptr) {
              j.kind = kDs, j.k = st.cin;
              v.job(st, j);
            }
            j.kind = kConv3, j.k = st.cm;
            v.job(st, j);
          }
        }
        v.block_sync();
      }
      if (s + 1 < a.n) v.grid_sync();
    } else {
      const int mu = st.rows, mt = cdiv(m, mu);
      for (int ph = 0; ph < 3; ++ph) {
        const int n = ph < 2 ? st.cm : st.cout, nt = unit_cols(n), nn = cdiv(n, nt);
        for (int u = blockIdx.x; u < mt * nn; u += gridDim.x) {
          Job j{ph == 0 ? kConv1 : ph == 1 ? kConv2 : kConv3, u % nn * nt, nt, n, ph == 0 ? st.cin : st.cm,
                ph == 1 ? 9 : 1, mu, 0, 0, 0, 0, u / nn * mu};
          if (ph == 2 && st.wd != nullptr) {
            j.kind = kDs, j.k = st.cin;
            v.job(st, j);
            j.kind = kConv3, j.k = st.cm;
          }
          v.job(st, j);
        }
        if (ph < 2 || s + 1 < a.n) v.grid_sync();
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* pixel(const void* base, int pad, int h, int w, int c, int b, int row, int col) {
  return static_cast<const T*>(base) + ((size_t(b) * (h + 2 * pad) + row + pad) * w + col) * c;
}

// The job's weights, at the chunk's tap; a row holds j.n columns.
template <typename T>
__device__ __forceinline__ const T* job_weights(const Stage& st, const Job& j, int tap) {
  switch (j.kind) {
    case kConv1: return static_cast<const T*>(st.w1);
    case kConv2: return static_cast<const T*>(st.w2) + size_t(tap) * st.cm * st.cm;
    case kDs: return static_cast<const T*>(st.wd);
    default: return static_cast<const T*>(st.w3);
  }
}

// ---------------------------------------------------------------- the producer

template <typename T>
struct Producer {
  const LayerArgs& a;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int chunk = 0, syncs = 0, waited = 0;

  __device__ void block_sync() {}
  __device__ void grid_sync() { ++syncs; }

  // The source of A row r of chunk (tap, k0), or null for a row of zeros.
  __device__ const T* a_row(const Stage& st, const Job& j, int r, int tap, int k0) const {
    if (st.route == kHalo) {
      int row, col;
      r += j.roff;
      if (j.kind == kConv1) {
        row = j.r0 - 1 + r / kHw, col = j.c0 - 1 + r % kHw;
      } else {  // the downsample over the tile's output grid
        if (r % kHw >= kTw) return nullptr;
        row = j.r0 + r / kHw, col = j.c0 + r % kHw;
      }
      if (row < 0 || row >= a.h || col < 0 || col >= a.w) return nullptr;
      return pixel<T>(st.in, st.in_pad, a.h, a.w, st.cin, j.tb, row, col) + k0;
    }
    const int p = j.p0 + r, hw = a.h * a.w;
    if (p >= a.b * hw) return nullptr;
    const int b = p / hw, row = p % hw / a.w, col = p % a.w;
    switch (j.kind) {
      case kConv1:
      case kDs: return pixel<T>(st.in, st.in_pad, a.h, a.w, st.cin, b, row, col) + k0;
      case kConv2: {
        const int yy = row + tap / 3 - 1, xx = col + tap % 3 - 1;
        if (yy < 0 || yy >= a.h || xx < 0 || xx >= a.w) return nullptr;
        return static_cast<const T*>(a.y1s) + size_t(p + (tap / 3 - 1) * a.w + tap % 3 - 1) * st.cm + k0;
      }
      default: return static_cast<const T*>(a.y2s) + size_t(p) * st.cm + k0;
    }
  }

  __device__ __forceinline__ void job(const Stage& st, const Job& j) {
    constexpr int kc = chunk_k<T>(), e = piece<T>();
    const int pt = threadIdx.x - kConsumers, kchunks = cdiv(j.k, kc);
    const bool stages_a = st.route == kPhase || j.kind == kConv1 || j.kind == kDs;
    const int arows = stage_smem<T>(st.route, st.rows, st.cm, st.cout).arows;
    for (int c = 0; c < j.taps * kchunks; ++c, ++chunk) {
      const int slot = chunk % a.ring, tap = c / kchunks, k0 = c % kchunks * kc;
      const int klen = min(kc, j.k - k0), pieces = klen / e;
      mbar_wait(empty + slot, ((chunk / a.ring) & 1) ^ 1);
      unsigned char* stage = smem + a.ring_off + size_t(slot) * a.stage_bytes;
      const uint32_t bdst = smem_u32(stage + a.a_bytes);
      const T* wgt = job_weights<T>(st, j, tap) + size_t(k0) * j.n;
      // weights: threads 2i and 2i + 1 take neighbouring pieces of one row (one 32-byte sector)
      for (int k = pt >> 1; k < klen; k += kProducers / 2)
        for (int g = pt & 1; g < j.nt / e; g += 2)
          if (j.n0 + g * e < j.n) cp16(bdst + (g * kc + k) * 16, wgt + size_t(k) * j.n + j.n0 + g * e, wgt);
      if (stages_a) {
        if (waited < syncs) {  // the rows come from the previous phase: wait for its grid barrier
          while (load_acquire(a.barrier) < unsigned(syncs) * gridDim.x) __nanosleep(64);
          waited = syncs;
        }
        const uint32_t adst = smem_u32(stage);
        for (int r = pt >> 1; r < j.rows; r += kProducers / 2) {
          const T* src = a_row(st, j, r, tap, k0);
          for (int g = pt & 1; g < pieces; g += 2) cp16(adst + (g * arows + r) * 16, src ? src + g * e : nullptr, wgt);
        }
      }
      cp_arrive(full + slot);
    }
  }
};

// ---------------------------------------------------------------- the consumers

template <typename T>
struct Consumer {
  using P = typename Pair<T>::P;
  const LayerArgs& a;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int chunk = 0, syncs = 0;

  __device__ void block_sync() {  // y1 or y2 written, before wgmma reads them
    if constexpr (sizeof(T) == 2) fence_async_smem();
    consumer_sync();
  }

  __device__ void grid_sync() {
    ++syncs;
    consumer_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(a.barrier, 1u);
      while (load_acquire(a.barrier) < unsigned(syncs) * gridDim.x) __nanosleep(64);
    }
    consumer_sync();
  }

  // A at chunk (tap, k0): the address of the job's first row and the stride
  // between its 8-channel pieces (the row count of its buffer x 16). Halo
  // conv2 and conv3 read y1 and y2, which hold all cm channels.
  __device__ void a_operand(const Stage& st, const Job& j, const Smem& l, int slot, int tap, int k0, uint32_t& base,
                            uint32_t& lbo) const {
    if (st.route == kHalo && j.kind == kConv2) {
      lbo = l.p1 * 16;
      base = smem_u32(smem) + ((tap / 3) * kHw + tap % 3 + j.roff) * 16 + k0 / piece<T>() * lbo;
    } else if (st.route == kHalo && j.kind == kConv3) {
      lbo = st.rows * kHw * 16;
      base = smem_u32(smem + l.y2) + j.roff * 16 + k0 / piece<T>() * lbo;
    } else {
      base = smem_u32(smem + a.ring_off + size_t(slot) * a.stage_bytes);
      lbo = l.arows * 16;
    }
  }

  __device__ __forceinline__ void mma(float (&acc)[kMaxMb][32], int nmb, int mb0, int mbstep, uint32_t abase,
                                      uint32_t lbo, uint32_t bbase, int klen) {
    if constexpr (sizeof(T) == 2) {
      constexpr uint32_t sbo_b = chunk_k<T>() * 16;
#pragma unroll
      for (int i = 0; i < kMaxMb; ++i) fence_acc(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < kMaxMb; ++i) {
        if (i >= nmb) break;
        const uint32_t arow = abase + (mb0 + i * mbstep) * 64 * 16;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk * 16 >= klen) break;
          wgmma_64x64x16(acc[i], smem_desc(arow + 2 * kk * lbo, lbo, 128), smem_desc(bbase + kk * 256, 128, sbo_b));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < kMaxMb; ++i) fence_acc(acc[i]);
    } else {
      // f32: the element (row, column) of the wgmma layout, summed in k order
      constexpr int kc = chunk_k<T>();
      const int t = threadIdx.x & 127, lane = t & 31, q = lane & 3;
      const float* bs = reinterpret_cast<const float*>(__cvta_shared_to_generic(bbase));
#pragma unroll
      for (int i = 0; i < kMaxMb; ++i) {
        if (i >= nmb) break;
        const int r = (mb0 + i * mbstep) * 64 + (t >> 5) * 16 + (lane >> 2);
        const float* as = reinterpret_cast<const float*>(__cvta_shared_to_generic(abase));
        for (int k = 0; k < klen; ++k) {
          const float* ak = as + (k >> 2) * (lbo / 4) + (k & 3);
          const float a0 = ak[r * 4], a1 = ak[(r + 8) * 4];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int n = 8 * jj + 2 * q;
            const float2 bv = *reinterpret_cast<const float2*>(bs + ((n >> 2) * kc + k) * 4 + (n & 3));
            acc[i][4 * jj] = acc[i][4 * jj] + a0 * bv.x;
            acc[i][4 * jj + 1] = acc[i][4 * jj + 1] + a0 * bv.y;
            acc[i][4 * jj + 2] = acc[i][4 * jj + 2] + a1 * bv.x;
            acc[i][4 * jj + 3] = acc[i][4 * jj + 3] + a1 * bv.y;
          }
        }
      }
    }
  }

  __device__ void release(int slot) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
  }

  __device__ __forceinline__ void job(const Stage& st, const Job& j) {
    constexpr int kc = chunk_k<T>();
    float acc[kMaxMb][32];
    const int wg = warp_index() >> 2, kchunks = cdiv(j.k, kc), total = j.rows / 64;
    // 128 columns: each warpgroup takes 64 of them over every row block;
    // 64 columns: both take all of them over alternate row blocks
    const bool split_n = j.nt == 128;
    const int mb0 = split_n ? 0 : wg, mbstep = split_n ? 1 : 2;
    const int nmb = split_n ? total : (total - wg + 1) / 2;
    const int col0 = j.n0 + (split_n ? 64 * wg : 0);
    const Smem l = stage_smem<T>(st.route, st.rows, st.cm, st.cout);
#pragma unroll
    for (int i = 0; i < kMaxMb; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;
    for (int c = 0; c < j.taps * kchunks; ++c, ++chunk) {
      const int slot = chunk % a.ring, tap = c / kchunks, k0 = c % kchunks * kc;
      mbar_wait(full + slot, (chunk / a.ring) & 1);
      if constexpr (sizeof(T) == 2) fence_async_smem();
      uint32_t abase, lbo;
      a_operand(st, j, l, slot, tap, k0, abase, lbo);
      const uint32_t bbase = smem_u32(smem + a.ring_off + size_t(slot) * a.stage_bytes + a.a_bytes) +
                             (col0 - j.n0) / 8 * chunk_k<T>() * 16 * (8 / piece<T>());
      if (nmb > 0) mma(acc, nmb, mb0, mbstep, abase, lbo, bbase, min(kc, j.k - k0));
      // the chunk's products done before its stage is freed: waiting for the
      // chunk before instead (wait_group 1) makes ptxas serialize every wgmma
      if constexpr (sizeof(T) == 2) {
        if (nmb > 0) asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int i = 0; i < kMaxMb; ++i) fence_acc(acc[i]);
      }
      release(slot);
    }
    epilogue(acc, st, j, l, nmb, mb0, mbstep, col0);
  }

  // Where an output row of the job lands; false if it lies outside the image.
  __device__ bool out_row(const Stage& st, const Job& j, int r, int& b, int& row, int& col) const {
    if (st.route == kHalo) {
      r += j.roff;
      b = j.tb, row = j.r0 + r / kHw, col = j.c0 + r % kHw;
      return r % kHw < kTw && row < a.h && col < a.w;
    }
    const int p = j.p0 + r, hw = a.h * a.w;
    b = p / hw, row = p % hw / a.w, col = p % a.w;
    return p < a.b * hw;
  }

  // The job's outputs from the accumulators: bias, relu where the product
  // has one, rounding to T. A thread holds rows r and r + 8 of each of its
  // 64-row blocks, columns 8 jj + 2 q and + 1 (the wgmma layout).
  __device__ __forceinline__ void epilogue(const float (&acc)[kMaxMb][32], const Stage& st, const Job& j,
                                           const Smem& l, int nmb, int mb0, int mbstep, int col0) {
    constexpr int e = piece<T>();
    const int t = threadIdx.x & 127, lane = t & 31, q = lane & 3;
    const float* bias = j.kind == kConv1 ? st.b1 : j.kind == kConv2 ? st.b2 : j.kind == kDs ? st.bd : st.b3;
    const bool relu = j.kind == kConv1 || j.kind == kConv2;
    const bool halo = st.route == kHalo, ds = st.wd != nullptr;
    float2 bv[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = col0 + 8 * jj + 2 * q;
      bv[jj] = n < j.n ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.0f, 0.0f);
    }
    // conv3 on an identity: x's 8 channels of each row and group the quad
    // transpose will hand this thread, all loaded before the first store
    Vec8<T> idv[kMaxMb][2][2];
    if (j.kind == kConv3 && !ds) {
#pragma unroll
      for (int i = 0; i < kMaxMb; ++i) {
        if (i >= nmb) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jb = 0; jb < 2; ++jb) {
            const int r = (mb0 + i * mbstep) * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * h, n = col0 + 8 * (4 * jb + q);
            int b, row, col;
            if (n < j.n && out_row(st, j, r, b, row, col))
              idv[i][h][jb].load(pixel<T>(st.in, st.in_pad, a.h, a.w, st.cin, b, row, col) + n);
          }
      }
    }
    // the downsample's rounded sum: slots of this thread's own, at a stride of
    // the consumer threads, read back by the same thread in conv3's epilogue
    P* sum = reinterpret_cast<P*>(smem) + threadIdx.x;
    const bool to_device = j.kind == kConv3 || (!halo && j.kind != kDs);
    // every group's pairs first, then every transpose, then the stores: the
    // groups' chains are independent and interleave (two warps a scheduler)
    P v[kMaxMb][2][2][4];
#pragma unroll
    for (int i = 0; i < kMaxMb; ++i) {
      if (i >= nmb) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (mb0 + i * mbstep) * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * h;
        bool zero = false;  // y1 outside the image
        if (halo && j.kind == kConv1) {
          const int row = j.r0 - 1 + (j.roff + r) / kHw, col = j.c0 - 1 + (j.roff + r) % kHw;
          zero = row < 0 || row >= a.h || col < 0 || col >= a.w;
        }
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
#pragma unroll
          for (int jq = 0; jq < 4; ++jq) {
            const int jj = 4 * jb + jq, slot = ((i * 2 + h) * 2 + jb) * 4 + jq;
            float x = acc[i][4 * jj + 2 * h] + bv[jj].x, y = acc[i][4 * jj + 2 * h + 1] + bv[jj].y;
            if (relu) x = fmaxf(x, 0.0f), y = fmaxf(y, 0.0f);
            if (zero) x = y = 0.0f;
            P p = Pair<T>::make(x, y);
            if (j.kind == kDs) {
              sum[slot * kConsumers] = p;
            } else if (j.kind == kConv3 && ds) {  // T(relu(T(y3 + the downsample's sum)))
              const P d = sum[slot * kConsumers];
              const P s = Pair<T>::make(Pair<T>::lo(p) + Pair<T>::lo(d), Pair<T>::hi(p) + Pair<T>::hi(d));
              p = Pair<T>::make(fmaxf(Pair<T>::lo(s), 0.0f), fmaxf(Pair<T>::hi(s), 0.0f));
            } else if (!to_device) {  // y1 or y2, in the A layout the next product reads
              const int n = col0 + 8 * jj + 2 * q;
              const size_t off = j.kind == kConv1 ? 0 : l.y2;
              const int rows = j.kind == kConv1 ? l.p1 : st.rows * kHw;
              if (n < j.n)
                *reinterpret_cast<P*>(smem + off + (size_t(n / e) * rows + j.roff + r) * 16 + (n % e) * sizeof(T)) = p;
            }
            v[i][h][jb][jq] = p;
          }
      }
    }
    if (!to_device) return;
    Vec8<T> o[kMaxMb][2][2];
#pragma unroll
    for (int i = 0; i < kMaxMb; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
          if (i < nmb) o[i][h][jb] = quad_transpose<T>(v[i][h][jb]);
#pragma unroll
    for (int i = 0; i < kMaxMb; ++i) {
      if (i >= nmb) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          const int r = (mb0 + i * mbstep) * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * h, n = col0 + 8 * (4 * jb + q);
          int b, row, col;
          if (n >= j.n || !out_row(st, j, r, b, row, col)) continue;
          if (j.kind != kConv3) {  // phase y1 or y2, in the device scratch
            o[i][h][jb].store(static_cast<T*>(j.kind == kConv1 ? a.y1s : a.y2s) + (size_t(j.p0) + r) * st.cm + n);
            continue;
          }
          Vec8<T> out = o[i][h][jb];
          if (!ds) {  // T(relu(T(y3 + x)))
            P w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const P s = Pair<T>::make(out.get(2 * u) + idv[i][h][jb].get(2 * u),
                                        out.get(2 * u + 1) + idv[i][h][jb].get(2 * u + 1));
              w[u] = Pair<T>::make(fmaxf(Pair<T>::lo(s), 0.0f), fmaxf(Pair<T>::hi(s), 0.0f));
            }
            out = Pair<T>::join(w);
          }
          out.store(const_cast<T*>(pixel<T>(st.out, st.out_pad, a.h, a.w, st.cout, b, row, col)) + n);
        }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.ring_off + size_t(a.ring) * a.stage_bytes);
  uint64_t* empty = full + a.ring;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.ring; ++i) {
      mbar_init(full + i, kProducers);           // the producer's threads
      mbar_init(empty + i, kConsumers / 32);     // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp_index() >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    Producer<T> p{a, smem, full, empty};
    walk(a, p);
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    Consumer<T> c{a, smem, full, empty};
    walk(a, c);
  }
}

// ---------------------------------------------------------------- host

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool dims_ok(int cin, int cm, int cout, bool has_ds) {
  return cin > 0 && cm > 0 && cout > 0 && cin % 16 == 0 && cm % 16 == 0 && cout % 16 == 0 &&
         (has_ds || cin == cout);
}

// A plan the kernel takes: halo rows even (the products' rows are whole
// 64-row blocks), phase rows a multiple of 64 that is one job (at most
// kMaxMb blocks a warpgroup) in every product.
bool plan_ok(const Stage& st) {
  if (st.route == kHalo) return st.rows >= 2 && st.rows % 2 == 0;
  return st.route == kPhase && st.rows >= 64 && st.rows % 64 == 0 && st.rows <= part_rows(st.cm) &&
         st.rows <= part_rows(st.cout);
}

int units(const Stage& st, int b, int h, int w) {
  if (st.route == kHalo) return b * cdiv(h, st.rows) * cdiv(w, kTw);
  const int mt = cdiv(b * h * w, st.rows);
  return std::max(mt * cdiv(st.cm, unit_cols(st.cm)), mt * cdiv(st.cout, unit_cols(st.cout)));
}

template <typename T>
int launch(LayerArgs& a, cudaStream_t stream) {
  size_t fixed = 0;
  int arows = 0, most = 1;
  for (int s = 0; s < a.n; ++s) {
    const Stage& st = a.st[s];
    if (!plan_ok(st)) return int(cudaErrorInvalidValue);
    const Smem l = stage_smem<T>(st.route, st.rows, st.cm, st.cout);
    fixed = std::max(fixed, l.fixed);
    arows = std::max(arows, l.arows);
    most = std::max(most, units(st, a.b, a.h, a.w));
  }
  a.ring_off = unsigned(align128(fixed));
  a.a_bytes = unsigned(align128(size_t(arows) * kChunkRow));
  a.stage_bytes = a.a_bytes + kBBytes;
  const size_t room = kMaxShared - kBarBytes;
  if (room < a.ring_off + 2 * size_t(a.stage_bytes)) return int(cudaErrorInvalidValue);
  a.ring = int(std::min<size_t>(kMaxRing, (room - a.ring_off) / a.stage_bytes));
  const size_t smem = a.ring_off + size_t(a.ring) * a.stage_bytes + 2 * a.ring * 8;
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm == 0) return int(cudaErrorInvalidConfiguration);
  const int grid = std::min(most, per_sm * sm_count());
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_kernel<T>), dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

int launch_dtype(int dtype, LayerArgs& a, cudaStream_t stream) {
  if (dtype == 0) return launch<float>(a, stream);
  if (dtype == 1) return launch<bf16>(a, stream);
  return int(cudaErrorInvalidValue);
}

bool needs_scratch(const LayerArgs& a) {
  for (int s = 0; s < a.n; ++s)
    if (a.st[s].route == kPhase) return true;
  return false;
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, the weights and out); biases f32. x and out are
// row-padded, (B, H + 2, W, C); their halo rows are neither read nor written.
// wd and bd are null for an identity residual (then cin == cout). The plan:
// route 0 (halo, `rows` output rows a tile) or 1 (phase, `rows` pixels a work
// unit). scratch holds 2 B H W cm elements for the phase route (else may be
// null); barrier is one zeroed unsigned.
int bags_fused_bottleneck(int dtype, const void* x, const void* w1, const float* b1, const void* w2,
                          const float* b2, const void* w3, const float* b3, const void* wd, const float* bd,
                          void* out, void* scratch, unsigned* barrier, int b, int h, int w, int cin, int cm,
                          int cout, int route, int rows, cudaStream_t stream) {
  if (!dims_ok(cin, cm, cout, wd != nullptr) || b <= 0 || h <= 0 || w <= 0 || barrier == nullptr)
    return int(cudaErrorInvalidValue);
  LayerArgs a{};
  a.st[0] = Stage{x, out, w1, w2, w3, wd, b1, b2, b3, bd, cin, cm, cout, 1, 1, route, rows};
  a.n = 1, a.b = b, a.h = h, a.w = w;
  a.barrier = barrier;
  const size_t es = dtype == 1 ? 2 : 4;
  a.y1s = scratch;
  a.y2s = scratch == nullptr ? nullptr : static_cast<char*>(scratch) + size_t(b) * h * w * cm * es;
  if (needs_scratch(a) && scratch == nullptr) return int(cudaErrorInvalidValue);
  return launch_dtype(dtype, a, stream);
}

// n blocks in one launch. x (B, H, W, C0) and out (B, H, W, C_n) unpadded;
// act0 and act1 hold B H W (the widest inner output) elements each; scratch
// 2 B H W (the widest cm) for a phase plan; barrier is one zeroed unsigned.
// weights: host array of n * 8 device pointers (w1, b1, w2, b2, w3, b3, wd,
// bd; wd and bd null for an identity); dims: host array of n * 3 ints (cin,
// cm, cout); plans: host array of n * 2 ints (route, rows), each block's plan
// as K8 would take it.
int bags_fused_layer(int dtype, const void* x, void* out, void* act0, void* act1, void* scratch, unsigned* barrier,
                     const uint64_t* weights, const int* dims, const int* plans, int n, int b, int h, int w,
                     cudaStream_t stream) {
  if (n <= 0 || n > kMaxStages || b <= 0 || h <= 0 || w <= 0 || barrier == nullptr) return int(cudaErrorInvalidValue);
  LayerArgs a{};
  a.n = n, a.b = b, a.h = h, a.w = w;
  a.barrier = barrier;
  int cm_max = 0;
  for (int s = 0; s < n; ++s) {
    const uint64_t* p = weights + 8 * s;
    Stage& st = a.st[s];
    st.cin = dims[3 * s];
    st.cm = dims[3 * s + 1];
    st.cout = dims[3 * s + 2];
    st.route = plans[2 * s];
    st.rows = plans[2 * s + 1];
    st.w1 = reinterpret_cast<const void*>(p[0]);
    st.b1 = reinterpret_cast<const float*>(p[1]);
    st.w2 = reinterpret_cast<const void*>(p[2]);
    st.b2 = reinterpret_cast<const float*>(p[3]);
    st.w3 = reinterpret_cast<const void*>(p[4]);
    st.b3 = reinterpret_cast<const float*>(p[5]);
    st.wd = reinterpret_cast<const void*>(p[6]);
    st.bd = reinterpret_cast<const float*>(p[7]);
    st.in = s == 0 ? x : (s % 2 == 1 ? act0 : act1);
    st.out = s == n - 1 ? out : (s % 2 == 0 ? act0 : act1);
    st.in_pad = st.out_pad = 0;
    if (!dims_ok(st.cin, st.cm, st.cout, st.wd != nullptr) || (s > 0 && st.cin != a.st[s - 1].cout))
      return int(cudaErrorInvalidValue);
    cm_max = std::max(cm_max, st.cm);
  }
  const size_t es = dtype == 1 ? 2 : 4;
  a.y1s = scratch;
  a.y2s = scratch == nullptr ? nullptr : static_cast<char*>(scratch) + size_t(b) * h * w * cm_max * es;
  if (needs_scratch(a) && scratch == nullptr) return int(cudaErrorInvalidValue);
  return launch_dtype(dtype, a, stream);
}

}  // extern "C"

BAGS_PACKED(bags_fused_bottleneck)
BAGS_PACKED(bags_fused_layer)
