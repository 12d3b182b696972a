// Deformable convolution v1/v2 forward: K7 `bags_deform_conv_forward`.
//
// Replaces (JAX package pallas/deform_conv.py): deform_conv2d_fused (:501, via
// _fused_forward :252, _kernel :49, the block-diagonal build_dense_weight :478)
// -- TPU Pallas; its semantics are those of ops/deform_conv.py deform_conv2d
// (:240): `_shift_window_cols` (:136) at a shift window D > 0, `_bilinear_hw`
// (:45) at D = 0.
//
// What it computes, per output position (b, i, j) and tap k = (ky, kx):
//   D > 0: rel = (ky, kx) + clip((dy, dx), -D, D); the fractions are rel -
//          floor(rel); the position is base + rel, base = (i, j) * stride -
//          padding.
//   D = 0: the position is (base + (ky, kx)) + (dy, dx); the fractions are its
//          own.
// A position outside (-1, H) x (-1, W) samples 0; a corner outside the image
// reads 0. The four corners blend in f32 as
// ((w00 v00 + w01 v01) + w10 v10) + w11 v11, the sample rounds to x's dtype,
// and a v2 mask (rounded to x's dtype) scales it, rounded again. Then
// out[b, i, j, o] = sum over taps k and the channels c of o's group g of
// sample[k, g * c_g + c] * weight[o, c, k], in f32, rounded to x's dtype.
// Input group g contracts only with output slice g (the CUDA reference's
// `group`); the TPU's block-diagonal dense weight, whose zeros only kept the
// MXU's layouts clean, is not built.
//
// Design: one block takes TILE = 32 output positions of one image and a chunk
// of whole groups, at most 64 input and 64 output channels (blockIdx.y picks
// the chunk). It (1) works out each (position, tap)'s four corner pixels and
// bilinear weights once, (2) stages the chunk's weights in shared memory as
// [tap][c][o], so neighbouring threads read neighbouring words, (3) samples
// the chunk's channels of every (position, tap) into shared memory,
// neighbouring threads reading neighbouring channels of one NHWC pixel, and
// (4) gives each thread one output channel at four positions, contracting on
// the CUDA cores in f32. The im2col never leaves the SM. Samples and weights
// sit in shared memory in x's dtype, which holds them exactly (the samples
// are rounded to it), so a bf16 block needs half the space and more blocks
// share an SM; each thread keeps four samples' corner loads in flight.
//
// What bounds it on an H100: at the HTC X101's shapes, mostly the operations.
// Bytes (x read once, the f32 offsets, the weights, the output written once)
// take about 0.01 ms a c4 layer at 3.35 TB/s; the sampling on the CUDA cores
// and the contraction, 2 * 9 * c_g operations an output, on the tensor cores
// take about as long. This first version is some 80x slower than that: it
// contracts on the CUDA cores with every multiply and add rounded on its own
// (-fmad=false), reading shared memory 1.25 times a multiply-add, and its
// sampling waits on L2 gathers with few warps an SM. wgmma tiles and a
// pipelined gather are the way down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // output positions a block
constexpr int kChunk = 64;    // input and output channels a block takes at most
constexpr size_t kMaxShared = 227 * 1024;
constexpr int kRows = 4;      // positions a thread contracts at once
constexpr int kLoads = 4;     // samples a thread gathers at once
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

struct Args {
  const void* x;         // (B, H, W, C)
  const float* offsets;  // (B, Ho, Wo, 2 * taps): dy, dx of tap k at 2k, 2k + 1
  const float* mask;     // (B, Ho, Wo, taps) or null
  const void* weight;    // (C_out, c_g, kh, kw)
  void* out;             // (B, Ho, Wo, C_out)
  int h, w, c, ho, wo, c_out, kh, kw, stride, pad, c_g, o_g, per_chunk, window, tiles;
};

// Shared memory of one block, in this order:
// int4 corner[kTile * taps], float4 cweight[kTile * taps],
// float cmask[kTile * taps], T cols[kTile][taps * cci + 1], T wts[taps][c_g][cco].
// The samples and weights are values of x's dtype T, so T holds them exactly.
inline size_t shared_layout(int taps, int c_g, int o_g, int per_chunk, size_t elem) {
  const size_t pt = size_t(kTile) * taps;
  return pt * (16 + 16 + 4) + size_t(kTile) * (taps * per_chunk * c_g + 1) * elem +
         size_t(taps) * c_g * per_chunk * o_g * elem;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) deform_conv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int taps = a.kh * a.kw;
  const int cci = a.per_chunk * a.c_g;
  const int cco = a.per_chunk * a.o_g;
  const int pt = kTile * taps;
  const int row = taps * cci + 1;
  int4* corner = reinterpret_cast<int4*>(smem4);
  float4* cweight = smem4 + pt;
  float* cmask = reinterpret_cast<float*>(smem4 + 2 * pt);
  T* cols = reinterpret_cast<T*>(cmask + pt);
  T* wts = cols + kTile * row;

  const int b = blockIdx.x / a.tiles;
  const int p0 = (blockIdx.x - b * a.tiles) * kTile;
  const int c0 = blockIdx.y * cci;
  const int o0 = blockIdx.y * cco;
  const int hw_out = a.ho * a.wo;
  const T* x = static_cast<const T*>(a.x) + size_t(b) * a.h * a.w * a.c + c0;
  const T* weight = static_cast<const T*>(a.weight);

  // 1. corners and bilinear weights of every (position, tap)
  for (int e = threadIdx.x; e < pt; e += blockDim.x) {
    const int p = e / taps;
    const int t = e - p * taps;
    const int pos = p0 + p;
    int4 q = make_int4(-1, -1, -1, -1);
    float4 wq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float m = 1.0f;
    if (pos < hw_out) {
      const int i = pos / a.wo;
      const int j = pos - i * a.wo;
      const size_t at = size_t(b) * hw_out + pos;
      float dy = a.offsets[at * 2 * taps + 2 * t];
      float dx = a.offsets[at * 2 * taps + 2 * t + 1];
      if (a.mask != nullptr) m = a.mask[at * taps + t];
      const int ty = t / a.kw;
      const int tx = t - ty * a.kw;
      const int by = i * a.stride - a.pad;
      const int bx = j * a.stride - a.pad;
      float ys, xs, ly, lx;
      int y0, x0;
      if (a.window > 0) {
        const float d = float(a.window);
        const float ry = float(ty) + fminf(fmaxf(dy, -d), d);
        const float rx = float(tx) + fminf(fmaxf(dx, -d), d);
        ys = float(by) + ry;
        xs = float(bx) + rx;
        const float fy = floorf(ry);
        const float fx = floorf(rx);
        ly = ry - fy;
        lx = rx - fx;
        y0 = by + int(fy);
        x0 = bx + int(fx);
      } else {
        ys = (float(by) + float(ty)) + dy;
        xs = (float(bx) + float(tx)) + dx;
        const float fy = floorf(ys);
        const float fx = floorf(xs);
        ly = ys - fy;
        lx = xs - fx;
        y0 = int(fy);
        x0 = int(fx);
      }
      if (ys > -1.0f && ys < float(a.h) && xs > -1.0f && xs < float(a.w)) {
        const float hy = 1.0f - ly;
        const float hx = 1.0f - lx;
        wq = make_float4(hy * hx, hy * lx, ly * hx, ly * lx);
        const bool y0in = y0 >= 0 && y0 < a.h, y1in = y0 + 1 >= 0 && y0 + 1 < a.h;
        const bool x0in = x0 >= 0 && x0 < a.w, x1in = x0 + 1 >= 0 && x0 + 1 < a.w;
        q.x = y0in && x0in ? y0 * a.w + x0 : -1;
        q.y = y0in && x1in ? y0 * a.w + x0 + 1 : -1;
        q.z = y1in && x0in ? (y0 + 1) * a.w + x0 : -1;
        q.w = y1in && x1in ? (y0 + 1) * a.w + x0 + 1 : -1;
      }
    }
    corner[e] = q;
    cweight[e] = wq;
    cmask[e] = round_to<T>(m);
  }

  // 2. the chunk's weights as [tap][c][o]
  const int nw = taps * a.c_g * cco;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) {
    const int o = e % cco;
    const int tc = e / cco;
    const int c = tc % a.c_g;
    const int t = tc / a.c_g;
    wts[e] = weight[(size_t(o0 + o) * a.c_g + c) * taps + t];
  }
  __syncthreads();

  // 3. the samples of the chunk's channels, kLoads of them a thread at a
  // time so that their corner loads are in flight together
  const int ns = pt * cci;
  for (int e0 = threadIdx.x; e0 < ns; e0 += kLoads * blockDim.x) {
    float v[kLoads][4];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      const int4 q = e < ns ? corner[e / cci] : make_int4(-1, -1, -1, -1);
      const size_t c = e % cci;
      v[u][0] = q.x >= 0 ? to_float(x[size_t(q.x) * a.c + c]) : 0.0f;
      v[u][1] = q.y >= 0 ? to_float(x[size_t(q.y) * a.c + c]) : 0.0f;
      v[u][2] = q.z >= 0 ? to_float(x[size_t(q.z) * a.c + c]) : 0.0f;
      v[u][3] = q.w >= 0 ? to_float(x[size_t(q.w) * a.c + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= ns) break;
      const int k = e / cci;  // p * taps + t
      const float4 wq = cweight[k];
      float s = wq.x * v[u][0];
      s = s + wq.y * v[u][1];
      s = s + wq.z * v[u][2];
      s = s + wq.w * v[u][3];
      s = round_to<T>(s);
      if (a.mask != nullptr) s = round_to<T>(s * cmask[k]);
      const int p = k / taps;
      cols[p * row + (k - p * taps) * cci + e % cci] = from_float<T>(s);
    }
  }
  __syncthreads();

  // 4. the grouped contraction: one output channel at kRows positions a thread
  constexpr int kStep = kTile / kRows;
  T* out = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < kStep * cco; e += blockDim.x) {
    const int o = e % cco;
    const int pr = e / cco;
    const int g = o / a.o_g;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const T* wrow = wts + t * a.c_g * cco + o;
      const T* crow = cols + pr * row + t * cci + g * a.c_g;
      for (int c = 0; c < a.c_g; ++c) {
        const float wv = to_float(wrow[c * cco]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = acc[r] + to_float(crow[r * kStep * row + c]) * wv;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = p0 + pr + r * kStep;
      if (pos < hw_out) out[(size_t(b) * hw_out + pos) * a.c_out + o0 + o] = from_float<T>(acc[r]);
    }
  }
}

// The most whole groups that fit in kChunk input and output channels and
// divide `groups` (at least one).
inline int groups_per_chunk(int groups, int c_g, int o_g) {
  int best = 1;
  for (int n = 1; n <= groups; ++n)
    if (groups % n == 0 && n * c_g <= kChunk && n * o_g <= kChunk) best = n;
  return best;
}

template <typename T>
int launch(Args a, int b, int groups, cudaStream_t stream) {
  const int taps = a.kh * a.kw;
  a.per_chunk = groups_per_chunk(groups, a.c_g, a.o_g);
  const size_t smem = shared_layout(taps, a.c_g, a.o_g, a.per_chunk, sizeof(T));
  if (smem > kMaxShared) return int(cudaErrorInvalidValue);  // groups too wide for one block
  cudaError_t err = cudaFuncSetAttribute(deform_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(b * a.tiles), unsigned(groups / a.per_chunk));
  deform_conv_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, weight and out). offsets and mask f32; mask may
// be null (v1). window: D (0: no clamp).
int bags_deform_conv_forward(int dtype, const void* x, const float* offsets, const float* mask,
                             const void* weight, void* out, int b, int h, int w, int c, int ho,
                             int wo, int c_out, int kh, int kw, int stride, int pad, int groups,
                             int window, cudaStream_t stream) {
  if (groups <= 0 || c % groups || c_out % groups) return int(cudaErrorInvalidValue);
  Args a{x, offsets, mask, weight, out, h, w, c, ho, wo, c_out, kh, kw, stride, pad,
         c / groups, c_out / groups, 1, window, (ho * wo + kTile - 1) / kTile};
  if (dtype == 0) return launch<float>(a, b, groups, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, groups, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
