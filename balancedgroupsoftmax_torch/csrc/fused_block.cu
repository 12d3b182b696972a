// Fused stride-1 ResNet bottleneck, BN folded: K8 `bags_fused_bottleneck` and
// K9 `bags_fused_layer`.
//
// Replaces (TPU Pallas, JAX package pallas/fused_block.py): fused_bottleneck
// (:234, via _kernel :84; pallas_call :300) and fused_layer (:448, via
// _layer_kernel :310; pallas_call :546).
//
// What it computes, per output pixel p and channel, with f32 accumulation and
// the rounding of the plain version (ops/fused_block.py):
//   y1 = T(relu(x @ w1 + b1))      at every pixel of a one-pixel halo; 0 outside the image
//   y2 = T(relu(sum over the 9 taps of shifted y1 @ w2[dy * 3 + dx] + b2))
//   y3 = T(y2 @ w3 + b3)
//   id = x, or T(x @ wd + bd)
//   out = T(relu(y3 + id))
// T is x's dtype (bf16 or f32). The weights are in T, the biases f32.
//
// Design. The TPU tile was TH full-width rows with a block's whole weights in
// VMEM. A Hopper block has 227 KB of shared memory, so an output tile here is
// TH rows x 16 columns, and the weights stay in device memory, where the 50 MB
// L2 holds them across tiles (layer4's w2 alone is 4.7 MB in bf16). One block
// of 8 warps runs a tile in four phases, each a product whose A operand lies in
// shared memory and whose B operand (a weight) streams from L2:
//   1. conv1 over the (TH + 2) x 18 halo pixels, flattened into rows of 16;
//      each warp stages its 16 pixels x 64 channels of x into its own slice of
//      shared memory (zero outside the image: the halo rows of a row-padded
//      input are never read), and y1 lands in shared memory;
//   2. conv2 as nine shifted products: output row ty reads the 16 halo pixels
//      (ty + dy, dx .. dx + 15), which lie at one stride in y1, so a tap needs
//      no copy; y2 lands in shared memory;
//   3. the downsample, if any, from staged x, its rounded sum written to the
//      output, where phase 4 reads it back;
//   4. conv3 and the residual, written to the output.
// A warp owns up to 4 x 2 (phases 2 and 4) or 1 x 4 (phases 1 and 3) tiles of
// 16 x 16 outputs. In bf16 they contract on the tensor cores (WMMA
// m16n16k16, f32 accumulators); in f32 on the CUDA cores, with every multiply
// and add rounded on its own. Accumulators pass through a per-warp 16 x 16 f32
// scratch for the bias, relu and rounding.
// K9 runs N such blocks in one launch: a persistent cooperative grid (at most
// the blocks that can be resident) walks the tiles of stage s with the same
// tile body, then waits at a grid-wide barrier before stage s + 1. The
// activations between stages go through two scratch buffers that the wrapper
// allocates; a growing halo held on chip, as the TPU kernel did along rows,
// does not fit 227 KB at layer3's 1024 channels.
//
// What bounds it on an H100. At the R50's shapes (800 x 1344, batch 2) a block
// is 9.4 G multiply-adds, 0.019 ms at the published 989 TFLOP/s (bf16,
// dense), against 86-138 MB of input and output for layer1's blocks, 0.026-0.041
// ms at the published 3.35 TB/s: layer1 is bound by bytes, layers 3-4 by
// operations; the 13 blocks by about 0.30 ms, the four runs of K9 by 0.25 ms.
// This first version took 13.3 ms (K8, 13 launches) and 13.8 ms (K9, 4
// launches) a pass in chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W,
// 0.6-1.7 ms a block: every warp loads its 16 x 16 weight fragments from L2
// for each row group it owns, so a tile reads all of a block's weights once
// per row group and waits on L2 between products; WMMA from shared memory
// without a pipeline keeps few products in flight; and the halo recomputes
// conv1 on up to 2.25x the pixels at small TH. Weight K-chunks staged once a
// tile in shared memory (cp.async or TMA) and shared by the warps, then
// wgmma, are the way down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch.cuh"

#include <algorithm>
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTw = 16;             // output columns a tile
constexpr int kHw = kTw + 2;        // halo columns
constexpr int kKc = 64;             // staged channels of x at a time
constexpr int kMaxStages = 32;
constexpr size_t kMaxShared = 227 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Row padding of the shared-memory operands, in elements: WMMA wants rows at
// a multiple of 32 bytes; the f32 path only wants rows off the same bank.
template <typename T> __host__ __device__ constexpr int row_pad() { return sizeof(T) == 2 ? 16 : 4; }

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
};

struct Geo {
  int h, w, th, row_tiles, col_tiles, tiles;
};

struct LayerArgs {
  Stage st[kMaxStages];
  Geo g;
  int n;
  unsigned* barrier;
};

inline __host__ __device__ size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared memory of one block: y1 [(th + 2) * 18][cm + pad], y2 [th * 16][cm + pad],
// the warps' staging [8][16][64 + pad] and their f32 scratch [8][16][16].
struct Layout {
  size_t y2, stage, scratch, total;
};
template <typename T>
__host__ __device__ Layout layout(int th, int cm) {
  const size_t ld = cm + row_pad<T>();
  Layout l;
  l.y2 = align128(size_t(th + 2) * kHw * ld * sizeof(T));
  l.stage = l.y2 + align128(size_t(th) * kTw * ld * sizeof(T));
  l.scratch = l.stage + align128(size_t(kWarps) * 16 * (kKc + row_pad<T>()) * sizeof(T));
  l.total = l.scratch + size_t(kWarps) * 256 * sizeof(float);
  return l;
}

// A warp's MT x NT tiles of 16 x 16 products: c[i][j] += A_i @ B[:, 16 j ..],
// A_i the 16 x k_len rows at a + i * a_mstep (row stride lda, shared memory),
// B (k_len, ldb) row-major in device memory. Only i < mt, j < nt take part.
template <typename T> struct Mma;

template <> struct Mma<bf16> {
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  __device__ static void zero(Acc& c) { nvcuda::wmma::fill_fragment(c, 0.0f); }
  template <int MT, int NT>
  __device__ static void run(Acc (&c)[MT][NT], const bf16* a, int a_mstep, int lda, const bf16* b, int ldb,
                             int k_len, int mt, int nt) {
    using namespace nvcuda;
    for (int k = 0; k < k_len; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) wmma::load_matrix_sync(fb[j], b + size_t(k) * ldb + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + size_t(i) * a_mstep + k, lda);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) wmma::mma_sync(c[i][j], fa, fb[j], c[i][j]);
      }
    }
  }
  __device__ static void store(float* s, const Acc& c) {
    nvcuda::wmma::store_matrix_sync(s, c, 16, nvcuda::wmma::mem_row_major);
  }
};

// f32 on the CUDA cores: lane l holds column l % 16 of rows l / 16 + 2q.
template <> struct Mma<float> {
  struct Acc {
    float v[8];
  };
  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int q = 0; q < 8; ++q) c.v[q] = 0.0f;
  }
  template <int MT, int NT>
  __device__ static void run(Acc (&c)[MT][NT], const float* a, int a_mstep, int lda, const float* b, int ldb,
                             int k_len, int mt, int nt) {
    const int lane = threadIdx.x & 31;
    const int col = lane & 15;
    const int row = lane >> 4;
    for (int k = 0; k < k_len; ++k) {
      float bv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) bv[j] = j < nt ? __ldg(b + size_t(k) * ldb + j * 16 + col) : 0.0f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt) break;
        const float* ai = a + size_t(i) * a_mstep + k;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float av = ai[(row + 2 * q) * lda];
#pragma unroll
          for (int j = 0; j < NT; ++j) c[i][j].v[q] = c[i][j].v[q] + av * bv[j];
        }
      }
    }
  }
  __device__ static void store(float* s, const Acc& c) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < 8; ++q) s[((lane >> 4) + 2 * q) * 16 + (lane & 15)] = c.v[q];
  }
};

// Copy 16 rows x kc channels into a warp's staging (row stride ld); `src(r)`
// gives row r's first channel in device memory, or null for a row of zeros.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int ld, int kc, Src src) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = kc / kVec;
  for (int v = threadIdx.x & 31; v < 16 * per_row; v += 32) {
    const int r = v / per_row;
    const int c = (v - r * per_row) * kVec;
    const T* p = src(r);
    const uint4 val = p != nullptr ? *reinterpret_cast<const uint4*>(p + c) : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Hand each element of a stored 16 x 16 scratch tile to f(row, col, value).
template <typename F>
__device__ __forceinline__ void each_element(const float* s, F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = lane + 32 * q;
    f(e >> 4, e & 15, s[e]);
  }
}

// One output tile (th rows x 16 columns of one image) of one bottleneck.
template <typename T>
__device__ void tile_body(const Stage& st, const Geo& g, int tile, unsigned char* smem) {
  using M = Mma<T>;
  using Acc = typename M::Acc;
  const int th = g.th;
  const int per_image = g.row_tiles * g.col_tiles;
  const int b = tile / per_image;
  const int rt = (tile - b * per_image) / g.col_tiles;
  const int r0 = rt * th;
  const int c0 = (tile - b * per_image - rt * g.col_tiles) * kTw;
  const int cin = st.cin, cm = st.cm, cout = st.cout;
  const int ld = cm + row_pad<T>();
  const int lds = kKc + row_pad<T>();
  const Layout l = layout<T>(th, cm);
  T* y1 = reinterpret_cast<T*>(smem);
  T* y2 = reinterpret_cast<T*>(smem + l.y2);
  const int warp = threadIdx.x >> 5;
  T* wst = reinterpret_cast<T*>(smem + l.stage) + warp * 16 * lds;
  float* wsc = reinterpret_cast<float*>(smem + l.scratch) + warp * 256;

  const T* x = static_cast<const T*>(st.in) + size_t(b) * (g.h + 2 * st.in_pad) * g.w * cin;
  T* out = static_cast<T*>(st.out) + size_t(b) * (g.h + 2 * st.out_pad) * g.w * cout;
  auto x_at = [&](int row, int col) { return x + (size_t(row + st.in_pad) * g.w + col) * cin; };
  auto out_at = [&](int row, int col) { return out + (size_t(row + st.out_pad) * g.w + col) * cout; };
  auto inside = [&](int row, int col) { return row >= 0 && row < g.h && col >= 0 && col < g.w; };
  const T* w1 = static_cast<const T*>(st.w1);
  const T* w2 = static_cast<const T*>(st.w2);
  const T* w3 = static_cast<const T*>(st.w3);
  const T* wd = static_cast<const T*>(st.wd);

  // 1. conv1 over the halo pixels m = hy * 18 + hx
  const int halo = (th + 2) * kHw;
  {
    const int groups = (cm + 63) / 64;
    const int tasks = (halo + 15) / 16 * groups;
    for (int task = warp; task < tasks; task += kWarps) {
      const int m0 = task / groups * 16;
      const int n0 = task % groups * 64;
      const int nt = min(4, (cm - n0) / 16);
      Acc acc[1][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) M::zero(acc[0][j]);
      for (int k0 = 0; k0 < cin; k0 += kKc) {
        const int kc = min(kKc, cin - k0);
        __syncwarp();
        stage_rows(wst, lds, kc, [&](int r) -> const T* {
          const int m = m0 + r;
          const int row = r0 - 1 + m / kHw, col = c0 - 1 + m % kHw;
          return m < halo && inside(row, col) ? x_at(row, col) + k0 : nullptr;
        });
        __syncwarp();
        M::template run<1, 4>(acc, wst, 0, lds, w1 + size_t(k0) * cm + n0, cm, kc, 1, nt);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) break;
        M::store(wsc, acc[0][j]);
        __syncwarp();
        each_element(wsc, [&](int r, int c, float v) {
          const int m = m0 + r;
          if (m >= halo) return;
          const int n = n0 + 16 * j + c;
          const bool in = inside(r0 - 1 + m / kHw, c0 - 1 + m % kHw);
          y1[m * ld + n] = from_float<T>(in ? fmaxf(v + st.b1[n], 0.0f) : 0.0f);
        });
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 2. conv2: output row ty, tap (dy, dx) reads halo pixels (ty + dy) * 18 + dx + tx
  {
    const int mgroups = (th + 3) / 4;
    const int groups = (cm + 31) / 32;
    for (int task = warp; task < mgroups * groups; task += kWarps) {
      const int ty0 = task / groups * 4;
      const int n0 = task % groups * 32;
      const int mt = min(4, th - ty0);
      const int nt = min(2, (cm - n0) / 16);
      Acc acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) M::zero(acc[i][j]);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        M::template run<4, 2>(acc, y1 + ((ty0 + dy) * kHw + dx) * ld, kHw * ld, ld,
                              w2 + size_t(tap) * cm * cm + n0, cm, cm, mt, nt);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= mt) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= nt) break;
          M::store(wsc, acc[i][j]);
          __syncwarp();
          each_element(wsc, [&](int r, int c, float v) {
            const int n = n0 + 16 * j + c;
            y2[((ty0 + i) * kTw + r) * ld + n] = from_float<T>(fmaxf(v + st.b2[n], 0.0f));
          });
          __syncwarp();
        }
      }
    }
  }

  // 3. the downsample's rounded sum, into the output
  if (wd != nullptr) {
    const int groups = (cout + 63) / 64;
    for (int task = warp; task < th * groups; task += kWarps) {
      const int ty = task / groups;
      const int n0 = task % groups * 64;
      const int nt = min(4, (cout - n0) / 16);
      const int row = r0 + ty;
      Acc acc[1][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) M::zero(acc[0][j]);
      for (int k0 = 0; k0 < cin; k0 += kKc) {
        const int kc = min(kKc, cin - k0);
        __syncwarp();
        stage_rows(wst, lds, kc, [&](int r) -> const T* {
          return inside(row, c0 + r) ? x_at(row, c0 + r) + k0 : nullptr;
        });
        __syncwarp();
        M::template run<1, 4>(acc, wst, 0, lds, wd + size_t(k0) * cout + n0, cout, kc, 1, nt);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nt) break;
        M::store(wsc, acc[0][j]);
        __syncwarp();
        each_element(wsc, [&](int r, int c, float v) {
          const int n = n0 + 16 * j + c;
          if (inside(row, c0 + r)) out_at(row, c0 + r)[n] = from_float<T>(v + st.bd[n]);
        });
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 4. conv3, the residual and relu, into the output
  {
    const int mgroups = (th + 3) / 4;
    const int groups = (cout + 31) / 32;
    for (int task = warp; task < mgroups * groups; task += kWarps) {
      const int ty0 = task / groups * 4;
      const int n0 = task % groups * 32;
      const int mt = min(4, th - ty0);
      const int nt = min(2, (cout - n0) / 16);
      Acc acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) M::zero(acc[i][j]);
      M::template run<4, 2>(acc, y2 + ty0 * kTw * ld, kTw * ld, ld, w3 + n0, cout, cm, mt, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= mt) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= nt) break;
          M::store(wsc, acc[i][j]);
          __syncwarp();
          each_element(wsc, [&](int r, int c, float v) {
            const int row = r0 + ty0 + i, col = c0 + r;
            if (!inside(row, col)) return;
            const int n = n0 + 16 * j + c;
            T* o = out_at(row, col) + n;
            const float y3 = round_to<T>(v + st.b3[n]);
            const float id = to_float(wd != nullptr ? *o : x_at(row, col)[n]);
            *o = from_float<T>(fmaxf(round_to<T>(y3 + id), 0.0f));
          });
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();  // the next tile reuses shared memory
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_kernel(Stage st, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile_body<T>(st, g, blockIdx.x, smem);
}

// Every block of the (co-resident) grid arrives; the count only grows, so
// barrier k waits for k * gridDim.x arrivals.
__device__ void grid_sync(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (atomicAdd(counter, 0u) < target) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) layer_kernel(LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int s = 0; s < a.n; ++s) {
    for (int t = blockIdx.x; t < a.g.tiles; t += gridDim.x) tile_body<T>(a.st[s], a.g, t, smem);
    if (s + 1 < a.n) grid_sync(a.barrier, unsigned(s + 1) * gridDim.x);
  }
}

// The tile height: the tallest of 8, 4, 2, 1 whose shared memory fits and
// which still gives two tiles an SM; else the shortest that fits (0: none).
template <typename T>
int pick_th(int b, int h, int w, int cm, int sms) {
  int fits = 0;
  for (int th : {8, 4, 2, 1}) {
    if (layout<T>(th, cm).total > kMaxShared) continue;
    fits = th;
    if (long(b) * ((h + th - 1) / th) * ((w + kTw - 1) / kTw) >= 2L * sms) return th;
  }
  return fits;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

Geo geometry(int b, int h, int w, int th) {
  Geo g;
  g.h = h;
  g.w = w;
  g.th = th;
  g.row_tiles = (h + th - 1) / th;
  g.col_tiles = (w + kTw - 1) / kTw;
  g.tiles = b * g.row_tiles * g.col_tiles;
  return g;
}

bool dims_ok(int cin, int cm, int cout, bool has_ds) {
  return cin > 0 && cm > 0 && cout > 0 && cin % 16 == 0 && cm % 16 == 0 && cout % 16 == 0 &&
         (has_ds || cin == cout);
}

template <typename T>
int launch_bottleneck(const Stage& st, int b, int h, int w, cudaStream_t stream) {
  const int th = pick_th<T>(b, h, w, st.cm, sm_count());
  if (th == 0) return int(cudaErrorInvalidValue);
  const Geo g = geometry(b, h, w, th);
  const size_t smem = layout<T>(th, st.cm).total;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  bottleneck_kernel<T><<<g.tiles, kThreads, smem, stream>>>(st, g);
  return int(cudaGetLastError());
}

template <typename T>
int launch_layer(LayerArgs& a, int b, int h, int w, int cm_max, cudaStream_t stream) {
  const int sms = sm_count();
  const int th = pick_th<T>(b, h, w, cm_max, sms);
  if (th == 0) return int(cudaErrorInvalidValue);
  a.g = geometry(b, h, w, th);
  const size_t smem = layout<T>(th, cm_max).total;
  cudaError_t err = cudaFuncSetAttribute(layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm == 0) return int(cudaErrorInvalidConfiguration);
  const int grid = std::min(a.g.tiles, per_sm * sms);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(layer_kernel<T>), dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, the weights and out); biases f32. x and out are
// row-padded, (B, H + 2, W, C); their halo rows are neither read nor written.
// wd and bd are null for an identity residual (then cin == cout).
int bags_fused_bottleneck(int dtype, const void* x, const void* w1, const float* b1, const void* w2,
                          const float* b2, const void* w3, const float* b3, const void* wd, const float* bd,
                          void* out, int b, int h, int w, int cin, int cm, int cout, cudaStream_t stream) {
  if (!dims_ok(cin, cm, cout, wd != nullptr) || b <= 0 || h <= 0 || w <= 0) return int(cudaErrorInvalidValue);
  Stage st{x, out, w1, w2, w3, wd, b1, b2, b3, bd, cin, cm, cout, 1, 1};
  if (dtype == 0) return launch_bottleneck<float>(st, b, h, w, stream);
  if (dtype == 1) return launch_bottleneck<bf16>(st, b, h, w, stream);
  return int(cudaErrorInvalidValue);
}

// n stages in one launch. x (B, H, W, C0) and out (B, H, W, C_n) unpadded;
// act0 and act1 hold B * H * W * (the widest inner output) elements each;
// barrier is one zeroed unsigned. weights: host array of n * 8 device
// pointers (w1, b1, w2, b2, w3, b3, wd, bd; wd and bd null for an identity);
// dims: host array of n * 3 ints (cin, cm, cout).
int bags_fused_layer(int dtype, const void* x, void* out, void* act0, void* act1, unsigned* barrier,
                     const uint64_t* weights, const int* dims, int n, int b, int h, int w, cudaStream_t stream) {
  if (n <= 0 || n > kMaxStages || b <= 0 || h <= 0 || w <= 0) return int(cudaErrorInvalidValue);
  LayerArgs a{};
  a.n = n;
  a.barrier = barrier;
  int cm_max = 0;
  for (int s = 0; s < n; ++s) {
    const uint64_t* p = weights + 8 * s;
    Stage& st = a.st[s];
    st.cin = dims[3 * s];
    st.cm = dims[3 * s + 1];
    st.cout = dims[3 * s + 2];
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
  if (dtype == 0) return launch_layer<float>(a, b, h, w, cm_max, stream);
  if (dtype == 1) return launch_layer<bf16>(a, b, h, w, cm_max, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"

BAGS_PACKED(bags_fused_bottleneck)
BAGS_PACKED(bags_fused_layer)
