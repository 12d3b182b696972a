// Multi-level RoIAlign: K2 `bags_roi_align_forward` and its gradient, K2b
// `bags_roi_align_backward`.
//
// Replaces (JAX package pallas/roi_align.py):
//   K2  multilevel_roi_align_pallas (:511; `pallas_call` at :482, via
//       _forward :334, _kernel :108, _compute_one_roi :218) -- TPU Pallas.
//   K2b its custom_vjp backward (:510-537, _bwd :700), which the TPU ran as
//       the XLA "dense2" contraction _bwd_dense (:569), no Pallas kernel.
//
// Semantics (ops/roi_align.py roi_align :67, map_roi_levels :104 and
// multilevel_roi_align_reference :113): each roi is pooled on the FPN level
// floor(log2(sqrt(area) / finest_scale + 1e-6)), clamped to the pyramid; it
// spans [x1 * scale, (x2 + 1) * scale) and each of the S x S bins averages
// sample_num^2 bilinear samples at (i + 0.5) / sample_num offsets, with the
// reference CUDA kernel's boundary rules: a sample outside [-1, size]
// contributes 0, coordinates clamp at 0 and the last row / column collapses.
// Output (B, R, S, S, C) in the feature dtype, each channel summed in f32 as
// the plain version does: iy outer, ix inner, the four-term blend left to
// right, then divided by sample_num^2.
//
// Design. A sample's geometry is per roi and per axis, never per channel:
// y depends only on (ph, iy) and x only on (pw, ix). So one block takes one
// roi. Its first 2 x S x sample_num threads build the roi's two axis tables
// in shared memory (`Axis`: the low and high row or column, the two
// fractions, and whether the sample is in range; 14 entries an axis at
// S = 7), and a sample's four weights are the products of one y and one x
// entry -- the same f32 products the plain version forms. The level routing
// is done there too, once a roi, with map_roi_levels' operations as PyTorch
// runs them on the card (its division by the integer finest_scale multiplies
// by the f32 reciprocal); K2 writes the (B, R) levels for K2b when asked.
// Then the block's 7 warps walk (bin, channel piece) items: a piece is 16
// bytes of one NHWC pixel (8 bf16 or 4 f32 channels), neighbouring lanes take
// neighbouring pieces, so at C = 256 one warp reads 512 contiguous bytes
// (bf16) of each corner pixel of its bin, and keeps the piece's f32 sums in
// registers across the bin's samples before one 16-byte store. Neighbouring
// bins' shared corner pixels are served from L1. When C is no multiple of the
// piece width (or a pointer is not 16-byte aligned) pixel rows are not
// aligned, and the same kernel reads and writes channel by channel, the last
// piece holding C mod V channels.
//
// What bounds K2 on an H100: memory. Its least traffic is one read of the
// pixels the rois touch and one write of the output (50 MB in bf16 at
// Faster R-CNN's B = 2, R = 1000, S = 7, C = 256: about 0.037 ms at 3.35
// TB/s); the 16 corner reads a sample piece make are served by L1 and L2.
//
// K2b computes the transpose with the same tables: every sample adds
// w * g / sample_num^2 to the four corners it read. The TPU had no scatter
// worth the name and contracted dense (roi x level extent) interpolation
// matrices on the MXU instead (_bwd_dense). On the card one block of 32 warps
// again takes one roi and adds into one f32 buffer that holds the pyramid level
// after level (each level (B, H_l, W_l, C)). Weights and validity are
// separable, so the roi's gradient at pixel (Y, X) is a sum over its bins of
// RY(Y) * CX(X) * g: the block lays RY and CX out densely over the rows and
// columns its samples read (the roi's window, in pieces of at most 64 x 64),
// and a warp takes one pixel of the window at a time, its lanes the pixel's
// 4-channel pieces (two a lane at C = 256, summed side by side so that their
// loads are in flight together). Each lane sums the weighted gradient pieces of the
// (typically 1-4) bins that read the pixel in registers and adds the result
// with one 16-byte vector atomic (`atomicAdd` on float4, compute capability
// 9.x): every pixel a roi touches gets one atomic a piece, and a warp's
// atomic covers 512 contiguous bytes at C = 256. At Faster R-CNN's training
// shape that is 213 k pixel updates against the 787 k sample corners and the
// 447 k pixels of a per-bin merge (`kernel_study` counts them).
// Sums stay in f32 and are rounded to the feature dtype once: the launcher
// zeroes the buffer with one memset, runs the scatter, and for a bf16
// gradient casts the whole buffer in one pass into one bf16 allocation.
// Atomics change the order of the sums from run to run, so results agree
// with the plain version to rounding, not bits.
// What bounds K2b: the f32 buffer, then the atomics. The memset writes the
// buffer and the cast reads it and writes the bf16 gradient: 182.8 + 274.2
// MB at 800x1344, batch 2, C = 256, a floor of 0.136 ms at 3.35 TB/s, against
// the 0.035 ms its inputs and output alone would take. The atomics go to L2.
//
// Built with -fmad=false, and the sample arithmetic is written with
// __fmul_rn / __fadd_rn, so every multiply and add rounds as the plain
// PyTorch version's separate operations do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 224;  // 7 warps: S x S is 49 or 196 bins, one warp a bin at C = 256 bf16
constexpr int kBackwardThreads = 1024;  // K2b: 32 warps share a roi's window
constexpr int kWin = 64;  // K2b: rows (columns) of a roi's window weighted at a time
constexpr int kPieces = 2;  // K2b: 4-channel pieces a lane sums at once (C = 256: all of a pixel's)
constexpr int kCastThreads = 256;
constexpr int kCastBlocks = 2048;

struct Pyramid {
  const void* data[kMaxLevels];  // K2: (B, H_l, W_l, C) each
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int64_t offset[kMaxLevels];  // K2b: where level l starts in the f32 buffer
};

// One entry of a roi's axis table: sample k of the axis (bin k / sample_num).
// lo and hi are the low and high rows (K2: times the level's width) or
// columns, both -1 when the sample lies outside [-1, size]; l is the high
// corner's fraction and h = 1 - l the low one's.
struct Axis {
  int lo, hi;
  float l, h;
};

// The level map_roi_levels gives `roi` on the card, with its operations:
// (x2 - x1 + 1) * (y2 - y1 + 1), sqrt, times the f32 reciprocal of
// finest_scale, + 1e-6 as an f32, log2, floor, clamp. A NaN (an area below
// 0) becomes level 0, as PyTorch's float-to-int conversion on the card does.
__device__ __forceinline__ int route(const float* roi, int num_levels, int finest_scale) {
  const float w = __fadd_rn(__fsub_rn(roi[2], roi[0]), 1.0f);
  const float h = __fadd_rn(__fsub_rn(roi[3], roi[1]), 1.0f);
  const float s = __fsqrt_rn(__fmul_rn(w, h));
  const float v = __fadd_rn(__fmul_rn(s, __fdiv_rn(1.0f, float(finest_scale))), float(1e-6));
  return int(fminf(fmaxf(floorf(log2f(v)), 0.0f), float(num_levels - 1)));
}

// A roi's start and bin size on its level, as the plain version computes them.
struct Span {
  float start_y, start_x, bin_y, bin_x;
};

__device__ __forceinline__ Span span(const float* roi, float scale, int out_size) {
  Span s;
  s.start_x = __fmul_rn(roi[0], scale);
  s.start_y = __fmul_rn(roi[1], scale);
  const float end_x = __fmul_rn(__fadd_rn(roi[2], 1.0f), scale);
  const float end_y = __fmul_rn(__fadd_rn(roi[3], 1.0f), scale);
  s.bin_x = __fdiv_rn(fmaxf(__fsub_rn(end_x, s.start_x), 0.0f), float(out_size));
  s.bin_y = __fdiv_rn(fmaxf(__fsub_rn(end_y, s.start_y), 0.0f), float(out_size));
  return s;
}

// Sample k of one axis: at start + bin * (k / sn + (k % sn + 0.5) / sn), with
// K2's boundary rules. `stride` is the level's width for y, 1 for x.
__device__ __forceinline__ Axis axis_entry(float start, float bin, int size, int stride, int k, int sn) {
  const int cell = k / sn;
  const float pos = __fadd_rn(float(cell), __fdiv_rn(float(k - cell * sn) + 0.5f, float(sn)));
  float y = __fadd_rn(start, __fmul_rn(bin, pos));
  Axis a = {-1, -1, 0.0f, 0.0f};
  if (!(y >= -1.0f && y <= float(size))) return a;
  y = fmaxf(y, 0.0f);
  int lo = int(floorf(y));
  int hi;
  if (lo >= size - 1) {
    lo = hi = size - 1;
    y = float(lo);
  } else {
    hi = lo + 1;
  }
  a.l = __fsub_rn(y, float(lo));
  a.h = __fsub_rn(1.0f, a.l);
  a.lo = lo * stride;
  a.hi = hi * stride;
  return a;
}

// Fills the block's two tables (y entries, then x entries; n = S x sn each)
// for an (h, w) level; y entries' rows are multiplied by row_stride.
__device__ __forceinline__ void build_tables(Axis* tab, const Span& s, int h, int w, int row_stride, int out_size,
                                             int sn) {
  const int n = out_size * sn;
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x)
    tab[k] = k < n ? axis_entry(s.start_y, s.bin_y, h, row_stride, k, sn)
                   : axis_entry(s.start_x, s.bin_x, w, 1, k - n, sn);
}

// 16-byte pieces: V channels of T.
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
};

__device__ __forceinline__ float lo_bf16(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The piece at p as f32: one 16-byte load when VEC, else its n channels one
// by one (the rest 0).
template <bool VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, int n, float (&v)[4]) {
  if (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, int n, float (&v)[8]) {
  if (VEC) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) v[2 * j] = lo_bf16(u[j]), v[2 * j + 1] = hi_bf16(u[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store(float* p, int n, const float (&v)[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) p[j] = v[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, int n, const float (&v)[8]) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// x / sn^2 as the plain version's division rounds it (a power of two exactly
// as a product).
template <int SN>
__device__ __forceinline__ float per_sample(float x) {
  if constexpr ((SN & (SN - 1)) == 0) return __fmul_rn(x, 1.0f / float(SN * SN));
  else return __fdiv_rn(x, float(SN * SN));
}

template <typename T, int SN, bool VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_forward_kernel(Pyramid p, const float* __restrict__ rois, int32_t* __restrict__ levels,
                         T* __restrict__ out, int num_rois, int num_levels, int channels, int out_size,
                         int finest_scale) {
  constexpr int V = Vec<T>::V;
  extern __shared__ Axis tab[];
  const int br = blockIdx.x;  // b * num_rois + r
  const int b = br / num_rois;
  const float* roi = rois + int64_t(br) * 4;
  const int lvl = route(roi, num_levels, finest_scale);
  if (levels != nullptr && threadIdx.x == 0) levels[br] = lvl;
  const int h = p.height[lvl];
  const int w = p.width[lvl];
  build_tables(tab, span(roi, p.scale[lvl], out_size), h, w, w, out_size, SN);
  __syncthreads();

  const Axis* ytab = tab;
  const Axis* xtab = tab + out_size * SN;
  const T* f = static_cast<const T*>(p.data[lvl]) + int64_t(b) * h * w * channels;
  T* o = out + int64_t(br) * out_size * out_size * channels;
  const int pieces = (channels + V - 1) / V;
  const int items = out_size * out_size * pieces;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int bin = item / pieces;
    const int c0 = (item - bin * pieces) * V;
    const int nc = min(V, channels - c0);
    const int ph = bin / out_size;
    const int pw = bin - ph * out_size;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int iy = 0; iy < SN; ++iy) {
      const Axis y = ytab[ph * SN + iy];
#pragma unroll
      for (int ix = 0; ix < SN; ++ix) {
        const Axis x = xtab[pw * SN + ix];
        if (y.lo < 0 || x.lo < 0) continue;  // outside [-1, size]: adds 0
        const float w00 = __fmul_rn(y.h, x.h), w01 = __fmul_rn(y.h, x.l);
        const float w10 = __fmul_rn(y.l, x.h), w11 = __fmul_rn(y.l, x.l);
        float v00[V], v01[V], v10[V], v11[V];
        load<VEC>(f + int64_t(y.lo + x.lo) * channels + c0, nc, v00);
        load<VEC>(f + int64_t(y.lo + x.hi) * channels + c0, nc, v01);
        load<VEC>(f + int64_t(y.hi + x.lo) * channels + c0, nc, v10);
        load<VEC>(f + int64_t(y.hi + x.hi) * channels + c0, nc, v11);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float s = __fmul_rn(w00, v00[j]);
          s = __fadd_rn(s, __fmul_rn(w01, v01[j]));
          s = __fadd_rn(s, __fmul_rn(w10, v10[j]));
          s = __fadd_rn(s, __fmul_rn(w11, v11[j]));
          acc[j] = __fadd_rn(acc[j], s);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = per_sample<SN>(acc[j]);
    store<VEC>(o + int64_t(bin) * channels + c0, nc, acc);
  }
}

// Four channels of a gradient piece as f32: 16 bytes (f32) or 8 (bf16) when
// VEC, else its n channels one by one (the rest 0).
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, int n, float (&v)[4]) {
  load<VEC>(p, n, v);
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p, int n, float (&v)[4]) {
  if (VEC) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = lo_bf16(q.x), v[1] = hi_bf16(q.x), v[2] = lo_bf16(q.y), v[3] = hi_bf16(q.y);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
  }
}

// p[j] += v[j] for n channels: one 16-byte vector atomic when VEC, else one
// f32 atomic a channel.
template <bool VEC>
__device__ __forceinline__ void add4(float* p, int n, const float (&v)[4]) {
  if (VEC) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) atomicAdd(p + j, v[j]);
  }
}

// K2b: acc is the f32 pyramid buffer, level l at offset[l] elements.
//
// A roi's gradient on its level is separable: pixel (Y, X) receives
// sum over bins (ph, pw) of RY[ph](Y) * CX[pw](X) * g[ph, pw] / sn^2, where
// RY[ph](Y) sums the fractions with which bin row ph's samples read row Y
// (hy at their low row, ly at their high one, over the samples in range)
// and CX likewise for the columns. So the block works on the roi's window --
// the rows and columns its samples read, at most kWin x kWin at a time --
// with RY and CX dense in shared memory and, for each row (column), the range
// of bins that read it. A warp takes one window pixel at a time and its lanes
// the pixel's 4-channel pieces: each lane sums the (typically 1-4) bins'
// weighted gradient pieces in registers and adds the pixel's piece with one
// 16-byte vector atomic, so a warp's atomic covers 512 contiguous bytes at
// C = 256 and every pixel of the roi gets one atomic a piece, however many
// samples and bins read it. Pixels no sample reads (rows or columns between
// the samples of large bins) get none.
template <typename T, int SN, bool VEC>
__global__ void __launch_bounds__(kBackwardThreads)
roi_align_backward_kernel(Pyramid p, const float* __restrict__ rois, const int32_t* __restrict__ levels,
                          const T* __restrict__ grad, float* __restrict__ acc, int num_rois, int channels,
                          int out_size) {
  extern __shared__ float4 smem[];
  const int n = out_size * SN;
  Axis* tab = reinterpret_cast<Axis*>(smem);  // y entries, then x entries; rows and columns unscaled
  float* ry = reinterpret_cast<float*>(tab + 2 * n);  // (S, kWin): RY of the current rows
  float* cx = ry + out_size * kWin;  // (S, kWin): CX of the current columns
  int2* yr = reinterpret_cast<int2*>(cx + out_size * kWin);  // per row: first and last bin row reading it
  int2* xr = yr + kWin;  // per column: first and last bin column
  int* win = reinterpret_cast<int*>(xr + kWin);  // the window: first and last row, first and last column

  const int br = blockIdx.x;
  const int b = br / num_rois;
  const int lvl = levels[br];
  const int h = p.height[lvl];
  const int w = p.width[lvl];
  build_tables(tab, span(rois + int64_t(br) * 4, p.scale[lvl], out_size), h, w, 1, out_size, SN);
  if (threadIdx.x == 0) win[0] = win[2] = INT_MAX, win[1] = win[3] = -1;
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) {
    const Axis e = tab[k];
    if (e.lo < 0) continue;
    atomicMin(win + (k < n ? 0 : 2), e.lo);
    atomicMax(win + (k < n ? 1 : 3), e.hi);
  }
  __syncthreads();
  if (win[1] < 0 || win[3] < 0) return;  // no sample in range on one of the axes

  const T* gr = grad + int64_t(br) * out_size * out_size * channels;
  float* f = acc + p.offset[lvl] + int64_t(b) * h * w * channels;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pieces = (channels + 3) / 4;
  for (int y0 = win[0]; y0 <= win[1]; y0 += kWin) {
    for (int x0 = win[2]; x0 <= win[3]; x0 += kWin) {
      const int rows = min(kWin, win[1] - y0 + 1);
      const int cols = min(kWin, win[3] - x0 + 1);
      for (int e = threadIdx.x; e < out_size * kWin; e += blockDim.x) ry[e] = cx[e] = 0.0f;
      __syncthreads();
      // RY and CX of these rows and columns: one thread a bin row (column),
      // adding its samples' fractions in order
      for (int t = threadIdx.x; t < 2 * out_size; t += blockDim.x) {
        const bool is_y = t < out_size;
        const int bin = is_y ? t : t - out_size;
        const int first = is_y ? y0 : x0;
        const int count = is_y ? rows : cols;
        float* weights = (is_y ? ry : cx) + bin * kWin;
        const Axis* entries = tab + (is_y ? 0 : n) + bin * SN;
#pragma unroll
        for (int i = 0; i < SN; ++i) {
          const Axis e = entries[i];
          if (e.lo < 0) continue;
          if (unsigned(e.lo - first) < unsigned(count)) weights[e.lo - first] = __fadd_rn(weights[e.lo - first], e.h);
          if (unsigned(e.hi - first) < unsigned(count)) weights[e.hi - first] = __fadd_rn(weights[e.hi - first], e.l);
        }
      }
      __syncthreads();
      // the bins that read each row (column): first and last with a weight
      for (int t = threadIdx.x; t < rows + cols; t += blockDim.x) {
        const bool is_y = t < rows;
        const int at = is_y ? t : t - rows;
        const float* weights = (is_y ? ry : cx) + at;
        int2 range = make_int2(out_size, -1);
        for (int bin = 0; bin < out_size; ++bin)
          if (weights[bin * kWin] != 0.0f) range.x = min(range.x, bin), range.y = bin;
        (is_y ? yr : xr)[at] = range;
      }
      __syncthreads();
      for (int pix = warp; pix < rows * cols; pix += kBackwardThreads / 32) {
        const int y = pix / cols;
        const int x = pix - y * cols;
        const int2 bins_y = yr[y];
        const int2 bins_x = xr[x];
        if (bins_y.x > bins_y.y || bins_x.x > bins_x.y) continue;  // no sample reads this pixel
        float* dst = f + (int64_t(y0 + y) * w + (x0 + x)) * channels;
        // a lane's pieces kPieces at a time, so that each bin's weight is
        // read once and its gradient loads are in flight together
        for (int q0 = lane; q0 < pieces; q0 += 32 * kPieces) {
          float sum[kPieces][4] = {};
          for (int ph = bins_y.x; ph <= bins_y.y; ++ph) {
            const float wy = ry[ph * kWin + y];
            if (wy == 0.0f) continue;
            for (int pw = bins_x.x; pw <= bins_x.y; ++pw) {
              const float wx = cx[pw * kWin + x];
              if (wx == 0.0f) continue;
              const float wt = __fmul_rn(wy, wx);
              const T* g_bin = gr + int64_t(ph * out_size + pw) * channels;
              float g[kPieces][4] = {};
#pragma unroll
              for (int u = 0; u < kPieces; ++u) {
                const int c0 = (q0 + 32 * u) * 4;
                if (c0 < channels) load4<VEC>(g_bin + c0, min(4, channels - c0), g[u]);
              }
#pragma unroll
              for (int u = 0; u < kPieces; ++u)
#pragma unroll
                for (int j = 0; j < 4; ++j) sum[u][j] = __fadd_rn(sum[u][j], __fmul_rn(wt, per_sample<SN>(g[u][j])));
            }
          }
#pragma unroll
          for (int u = 0; u < kPieces; ++u) {
            const int c0 = (q0 + 32 * u) * 4;
            if (c0 < channels) add4<VEC>(dst + c0, min(4, channels - c0), sum[u]);
          }
        }
      }
      __syncthreads();
    }
  }
}

// out[i] = bf16(acc[i]), rounded to nearest even: eight elements a step.
__global__ void __launch_bounds__(kCastThreads)
cast_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t pieces = n / 8;
  for (int64_t i = first; i < pieces; i += step) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(acc) + 2 * i);
    const float4 c = __ldg(reinterpret_cast<const float4*>(acc) + 2 * i + 1);
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
  for (int64_t i = pieces * 8 + first; i < n; i += step) out[i] = __float2bfloat16_rn(acc[i]);
}

bool aligned(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

Pyramid make_pyramid(int num_levels, const void* const* feats, const int* heights,
                     const int* widths, const float* scales) {
  Pyramid p = {};
  for (int l = 0; l < num_levels; ++l) {
    p.data[l] = feats ? feats[l] : nullptr;
    p.height[l] = heights[l];
    p.width[l] = widths[l];
    p.scale[l] = scales[l];
  }
  return p;
}

template <typename T, int SN>
int launch_forward(const Pyramid& p, bool vec, const float* rois, int32_t* levels, void* out, int batch,
                   int num_rois, int num_levels, int channels, int out_size, int finest_scale,
                   cudaStream_t stream) {
  const size_t shared = 2 * size_t(out_size) * SN * sizeof(Axis);
  auto kernel = vec ? roi_align_forward_kernel<T, SN, true> : roi_align_forward_kernel<T, SN, false>;
  kernel<<<unsigned(batch * num_rois), kThreads, shared, stream>>>(
      p, rois, levels, static_cast<T*>(out), num_rois, num_levels, channels, out_size, finest_scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_forward(int sample_num, const Pyramid& p, bool vec, const float* rois, int32_t* levels,
                     void* out, int batch, int num_rois, int num_levels, int channels, int out_size,
                     int finest_scale, cudaStream_t stream) {
#define BAGS_FORWARD(SN)                                                                           \
  case SN:                                                                                         \
    return launch_forward<T, SN>(p, vec, rois, levels, out, batch, num_rois, num_levels, channels, \
                                 out_size, finest_scale, stream);
  switch (sample_num) {
    BAGS_FORWARD(1)
    BAGS_FORWARD(2)
    BAGS_FORWARD(3)
    BAGS_FORWARD(4)
  }
#undef BAGS_FORWARD
  return int(cudaErrorInvalidValue);
}

template <typename T, int SN>
int launch_backward(const Pyramid& p, bool vec, const float* rois, const int32_t* levels, const void* grad,
                    float* acc, int batch, int num_rois, int channels, int out_size, cudaStream_t stream) {
  const size_t shared = 2 * size_t(out_size) * SN * sizeof(Axis) + 2 * size_t(out_size) * kWin * sizeof(float) +
                        2 * kWin * sizeof(int2) + 4 * sizeof(int);
  auto kernel = vec ? roi_align_backward_kernel<T, SN, true> : roi_align_backward_kernel<T, SN, false>;
  kernel<<<unsigned(batch * num_rois), kBackwardThreads, shared, stream>>>(
      p, rois, levels, static_cast<const T*>(grad), acc, num_rois, channels, out_size);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_backward(int sample_num, const Pyramid& p, bool vec, const float* rois, const int32_t* levels,
                      const void* grad, float* acc, int batch, int num_rois, int channels, int out_size,
                      cudaStream_t stream) {
#define BAGS_BACKWARD(SN) \
  case SN:                \
    return launch_backward<T, SN>(p, vec, rois, levels, grad, acc, batch, num_rois, channels, out_size, stream);
  switch (sample_num) {
    BAGS_BACKWARD(1)
    BAGS_BACKWARD(2)
    BAGS_BACKWARD(3)
    BAGS_BACKWARD(4)
  }
#undef BAGS_BACKWARD
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K2. dtype 0: f32 features and output; 1: bf16. feats/heights/widths/scales
// are host arrays of num_levels entries; rois (B, R, 4) f32; out (B, R, S, S,
// C). levels, when not null, receives each roi's level, (B, R) i32.
// sample_num 1-4.
int bags_roi_align_forward(int dtype, int num_levels, const void* const* feats,
                           const int* heights, const int* widths, const float* scales,
                           const float* rois, int32_t* levels, void* out, int batch,
                           int num_rois, int channels, int out_size, int sample_num,
                           int finest_scale, cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) return int(cudaErrorInvalidValue);
  if (int64_t(batch) * num_rois == 0) return int(cudaSuccess);
  const Pyramid p = make_pyramid(num_levels, feats, heights, widths, scales);
  bool vec = aligned(out);
  for (int l = 0; l < num_levels; ++l) vec = vec && aligned(feats[l]);
  if (dtype == 0)
    return dispatch_forward<float>(sample_num, p, vec && channels % 4 == 0, rois, levels, out, batch,
                                   num_rois, num_levels, channels, out_size, finest_scale, stream);
  if (dtype == 1)
    return dispatch_forward<__nv_bfloat16>(sample_num, p, vec && channels % 8 == 0, rois, levels, out,
                                           batch, num_rois, num_levels, channels, out_size,
                                           finest_scale, stream);
  return int(cudaErrorInvalidValue);
}

// K2b. dtype 0: f32 gradient; 1: bf16. heights/widths/scales are host arrays
// of num_levels entries; grad (B, R, S, S, C); rois (B, R, 4) f32, levels
// (B, R) i32 (K2's). acc is an f32 buffer of B x sum(H_l x W_l) x C elements
// that receives the gradient level after level, each (B, H_l, W_l, C); it is
// zeroed here first. out, when not null, receives acc rounded to bf16 (the
// same layout). sample_num 1-4.
int bags_roi_align_backward(int dtype, int num_levels, const int* heights, const int* widths,
                            const float* scales, const float* rois, const int32_t* levels,
                            const void* grad, float* acc, __nv_bfloat16* out, int batch,
                            int num_rois, int channels, int out_size, int sample_num,
                            cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || sample_num < 1 || sample_num > 4)
    return int(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  Pyramid p = make_pyramid(num_levels, nullptr, heights, widths, scales);
  int64_t total = 0;
  for (int l = 0; l < num_levels; ++l) {
    p.offset[l] = total;
    total += int64_t(batch) * heights[l] * widths[l] * channels;
  }
  int err = int(cudaMemsetAsync(acc, 0, total * sizeof(float), stream));
  if (err) return err;
  if (int64_t(batch) * num_rois > 0) {
    const bool vec = aligned(acc) && aligned(grad) && channels % 4 == 0;
    err = dtype == 0 ? dispatch_backward<float>(sample_num, p, vec, rois, levels, grad, acc, batch, num_rois,
                                                channels, out_size, stream)
                     : dispatch_backward<__nv_bfloat16>(sample_num, p, vec, rois, levels, grad, acc, batch,
                                                        num_rois, channels, out_size, stream);
    if (err) return err;
  }
  if (out != nullptr && total > 0) {
    const int64_t blocks = (total / 8 + kCastThreads - 1) / kCastThreads;
    cast_bf16_kernel<<<unsigned(blocks < 1 ? 1 : blocks < kCastBlocks ? blocks : kCastBlocks), kCastThreads,
                       0, stream>>>(acc, out, total);
    err = int(cudaGetLastError());
  }
  return err;
}

}  // extern "C"

BAGS_PACKED(bags_roi_align_forward)
BAGS_PACKED(bags_roi_align_backward)
