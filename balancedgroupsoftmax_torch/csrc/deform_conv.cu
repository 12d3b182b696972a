// Deformable convolution v1/v2 forward: K7 `bags_deform_conv_forward`.
//
// Replaces (JAX package pallas/deform_conv.py): deform_conv2d_fused (:501, via
// _fused_forward :252, _kernel :49, the block-diagonal build_dense_weight :478;
// `pallas_call` at :453) -- TPU Pallas; its semantics are those of
// ops/deform_conv.py deform_conv2d (:240): `_shift_window_cols` (:136) at a
// shift window D > 0, `_bilinear_hw` (:45) at D = 0.
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
// The bf16 route (the detector's path). One block takes a tile of TH x TW
// output positions of one image and walks NCH chunks of CC channels (whole
// groups, a multiple of 8) in turn; the wrapper's launch plan
// (ops/deform_conv.py `launch_plan`) picks TH, TW, CC and NCH per layer so
// that two blocks share an SM and the grid still holds two blocks an SM.
//   1. Once a tile, each (position, tap)'s corner and bilinear weights go to
//      shared memory, whatever the number of chunks.
//   2. D > 0: every corner of the tile lies inside a window of x of
//      (TH - 1) s + kh + 2D + 1 rows by (TW - 1) s + kw + 2D + 1 columns
//      (12 x 12 more than the tile's footprint at D = 4), known before any
//      offset is read. The block copies the window's CC channels into shared
//      memory with cp.async, 16 bytes a copy, pixels outside the image
//      zero-filled (they are the zero corners), double-buffered: chunk i+1's
//      copy is in flight while chunk i is sampled and contracted. A corner
//      then reads shared memory, not L2. D = 0 (unbounded offsets) gathers
//      its corners from device memory in the same 16-byte pieces.
//   3. Sampling: a thread takes eight channels of a (position, tap) at once,
//      four 16-byte corner reads, neighbouring threads on neighbouring
//      channels; the index arithmetic runs once a (position, tap). The blend
//      is written with __fmul_rn / __fadd_rn, so a sample equals the plain
//      version's bit for bit. Samples go to shared memory as A, positions x
//      (group, tap, channel), each group's K = taps * c_g padded to 16 with
//      zeros; the chunk's weights go beside them as B, (group, output,
//      tap * c_g + channel), o_g padded to 8 with zero rows, copied by
//      cp.async while the chunk is sampled (the wrapper hands the weight
//      over as (C_out, kh, kw, c_g), so each row of B is one run of it).
//   4. The products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//      accumulate), both operands read by ldmatrix; a warp takes one (16
//      positions, group, 8 outputs) unit at a time, so a k16 step spans two
//      taps at c_g = 8 and four at c_g = 4. Rows are padded so that ldmatrix
//      reads without bank conflicts. The sums round to bf16 and go straight
//      to the output.
// The f32 route (card tests and the small f32 HTC comparison only) is a
// simpler kernel: the same sampling order, corners gathered from L2 one
// channel a thread, the contraction on the CUDA cores in f32 (no TF32).
//
// What bounds it on an H100: its work is bound by bytes at c3's stride-2 layer
// (x is 138 MB) and by operations elsewhere -- the blend's seven f32
// operations a sample and channel on the CUDA cores, about 0.01 ms a c4
// layer; the contraction (2 * 9 * c_g operations an output) on the tensor
// cores takes a few microseconds. This kernel runs well above that: what sets
// its pace is the sampling's instructions (about 110 a piece of eight
// channels: unpacking, the exact blend, packing) and its shared-memory reads
// (four 16-byte corner reads a piece, the products' ldmatrix), then the
// window copies (the halo of 2D + 2 pixels makes a window 3-11 times the
// tile's own pixels) and the weights. Overlapping those across the block's
// phases, not more instruction-level parallelism inside one, is the way down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr size_t kMaxShared = 227 * 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// The corner of one (position, tap): its sampling position, the floor of that
// position (y0, x0), its bilinear weights, and whether it samples at all.
struct Corner {
  int y0, x0;
  float4 w;
  bool valid;
};

__device__ __forceinline__ Corner corner_of(const float* offsets, int at, int t, int taps, int kw, int by,
                                            int bx, int h, int w, int window) {
  const float dy = offsets[size_t(at) * 2 * taps + 2 * t];
  const float dx = offsets[size_t(at) * 2 * taps + 2 * t + 1];
  const int ty = t / kw;
  const int tx = t - ty * kw;
  float ys, xs, ly, lx;
  Corner q;
  if (window > 0) {
    const float d = float(window);
    const float ry = float(ty) + fminf(fmaxf(dy, -d), d);
    const float rx = float(tx) + fminf(fmaxf(dx, -d), d);
    ys = float(by) + ry;
    xs = float(bx) + rx;
    const float fy = floorf(ry);
    const float fx = floorf(rx);
    ly = ry - fy;
    lx = rx - fx;
    q.y0 = by + int(fy);
    q.x0 = bx + int(fx);
  } else {
    ys = (float(by) + float(ty)) + dy;
    xs = (float(bx) + float(tx)) + dx;
    const float fy = floorf(ys);
    const float fx = floorf(xs);
    ly = ys - fy;
    lx = xs - fx;
    q.y0 = int(fy);
    q.x0 = int(fx);
  }
  q.valid = ys > -1.0f && ys < float(h) && xs > -1.0f && xs < float(w);
  const float hy = 1.0f - ly;
  const float hx = 1.0f - lx;
  q.w = q.valid ? make_float4(hy * hx, hy * lx, ly * hx, ly * lx) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return q;
}

// ---------------------------------------------------------------------------
// The f32 route: blocks of 32 positions, the contraction on the CUDA cores.

constexpr int kTile = 32;     // output positions a block
constexpr int kChunk = 64;    // input and output channels a block takes at most
constexpr int kRows = 4;      // positions a thread contracts at once
constexpr int kLoads = 4;     // samples a thread gathers at once

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
      const int at = b * hw_out + pos;
      if (a.mask != nullptr) m = a.mask[size_t(at) * taps + t];
      const Corner cq = corner_of(a.offsets, at, t, taps, a.kw, i * a.stride - a.pad, j * a.stride - a.pad,
                                  a.h, a.w, a.window);
      if (cq.valid) {
        wq = cq.w;
        const int y0 = cq.y0, x0 = cq.x0;
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

int launch_f32(Args a, int b, int groups, cudaStream_t stream) {
  const int taps = a.kh * a.kw;
  a.per_chunk = groups_per_chunk(groups, a.c_g, a.o_g);
  const size_t smem = shared_layout(taps, a.c_g, a.o_g, a.per_chunk, sizeof(float));
  if (smem > kMaxShared) return int(cudaErrorInvalidValue);  // groups too wide for one block
  cudaError_t err = cudaFuncSetAttribute(deform_conv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(b * a.tiles), unsigned(groups / a.per_chunk));
  deform_conv_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 route: the tensor-core kernel.

typedef __nv_bfloat16 bf16;

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Everything the bf16 kernel needs, shapes, launch plan and the shared
// memory layout, worked out once on the host.
struct Plan {
  const bf16* x;         // (B, H, W, C)
  const float* offsets;  // (B, Ho, Wo, 2 * taps)
  const float* mask;     // (B, Ho, Wo, taps) or null
  const bf16* weight;    // (C_out, kh, kw, c_g): each (output, tap) row's channels contiguous
  bf16* out;             // (B, Ho, Wo, C_out)
  int b, h, w, c, ho, wo, c_out, kh, kw, taps, stride, pad, c_g, o_g, window;
  int th, tw, cc, nch;            // the tile, the chunk's channels, the chunks a block walks
  int tiles_y, tiles_x, splits;   // the grid: B x tiles_y x tiles_x tiles, `splits` channel ranges each
  int gc, kp, ogp, row_a, row_b;  // groups a chunk; K a group padded to 16; o_g padded to 8; row strides
  int wr, wc;                     // the window's rows and columns (D > 0)
  int off_w, off_mask, off_a, off_b, off_win, win_elems;  // shared memory: byte offsets; a window buffer's elements
  int smem;
};

// The shared memory layout; ops/deform_conv.py `plan_shared_bytes` computes
// the same total.
inline void lay_out(Plan& p) {
  const int m = p.th * p.tw;
  const int pt = m * p.taps;
  p.gc = p.cc / p.c_g;
  p.kp = round_up(p.taps * p.c_g, 16);
  p.ogp = round_up(p.o_g, 8);
  p.row_a = p.gc * p.kp + 8;  // (row_a / 8) odd: ldmatrix's eight rows fall in distinct banks
  p.row_b = p.kp + 8;
  p.wr = (p.th - 1) * p.stride + p.kh + 2 * p.window + 1;
  p.wc = (p.tw - 1) * p.stride + p.kw + 2 * p.window + 1;
  int off = round_up(pt * (p.window > 0 ? 4 : 16), 16);  // corner index: int (window) or int4 (device memory)
  p.off_w = off;
  off += pt * 16;  // float4 bilinear weights
  p.off_mask = off;
  off += round_up(pt * 4, 16);  // float mask, rounded to bf16
  p.off_a = off;
  off += m * p.row_a * 2;
  p.off_b = off;
  off += p.gc * p.ogp * p.row_b * 2;
  p.off_win = off;
  p.win_elems = p.window > 0 ? p.wr * p.wc * p.cc : 0;
  off += 2 * p.win_elems * 2;
  p.smem = off;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, or 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
// 8 bytes from device memory into shared memory.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned addr, unsigned& r0, unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two bf16 of a 32-bit word as f32 (exact).
__device__ __forceinline__ float lo_bf16(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// One sample channel: the plain version's blend, in f32 and in its order.
__device__ __forceinline__ float blend(const float4& w, float v00, float v01, float v10, float v11) {
  float s = __fmul_rn(w.x, v00);
  s = __fadd_rn(s, __fmul_rn(w.y, v01));
  s = __fadd_rn(s, __fmul_rn(w.z, v10));
  s = __fadd_rn(s, __fmul_rn(w.w, v11));
  return s;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Eight channels of one sample from the four corners' 16-byte pieces,
// blended, rounded, masked: four words of two bf16.
__device__ __forceinline__ uint4 blend8(const float4& w, float m, bool masked, const uint4& c00,
                                        const uint4& c01, const uint4& c10, const uint4& c11) {
  const unsigned* p00 = reinterpret_cast<const unsigned*>(&c00);
  const unsigned* p01 = reinterpret_cast<const unsigned*>(&c01);
  const unsigned* p10 = reinterpret_cast<const unsigned*>(&c10);
  const unsigned* p11 = reinterpret_cast<const unsigned*>(&c11);
  uint4 r;
  unsigned* pr = reinterpret_cast<unsigned*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float lo = blend(w, lo_bf16(p00[u]), lo_bf16(p01[u]), lo_bf16(p10[u]), lo_bf16(p11[u]));
    float hi = blend(w, hi_bf16(p00[u]), hi_bf16(p01[u]), hi_bf16(p10[u]), hi_bf16(p11[u]));
    if (masked) {
      lo = __fmul_rn(round_to<bf16>(lo), m);
      hi = __fmul_rn(round_to<bf16>(hi), m);
    }
    pr[u] = pack_bf16(lo, hi);
  }
  return r;
}

// Copies chunk `chunk`'s channels of the window at (wy0, wx0) into `win`,
// pixels outside the image as zeros.
__device__ __forceinline__ void stage_window(const Plan& a, bf16* win, const bf16* x_img, int chunk, int wy0,
                                             int wx0) {
  const int nq = a.cc >> 3;
  const int step = kThreads / nq;
  const int npix = a.wr * a.wc;
  const int q = threadIdx.x % nq;
  const bf16* xc = x_img + size_t(chunk) * a.cc;
  for (int pix = threadIdx.x < step * nq ? threadIdx.x / nq : npix; pix < npix; pix += step) {
    const int wy = pix / a.wc;
    const int y = wy0 + wy;
    const int xx = wx0 + pix - wy * a.wc;
    const bool inside = y >= 0 && y < a.h && xx >= 0 && xx < a.w;
    const bf16* src = inside ? xc + (size_t(y) * a.w + xx) * a.c + q * 8 : x_img;
    cp_async16(win + pix * a.cc + q * 8, src, inside);
  }
}

// Copies chunk `chunk`'s weights into B. The wrapper hands the weight over
// as (C_out, kh, kw, c_g), so each (group, output) row of B, tap * c_g +
// channel, is one contiguous run of the weight: 16-byte copies, 8-byte ones
// when c_g is not a multiple of 8.
__device__ __forceinline__ void stage_weights(const Plan& a, bf16* sb, int chunk) {
  const int row = a.taps * a.c_g;  // elements of a row
  const int piece = (a.c_g & 7) ? 4 : 8;  // elements a copy
  const int per_row = row / piece;
  const int rows = a.gc * a.o_g;
  const bf16* src = a.weight + size_t(chunk) * rows * row;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int j = e - r * per_row;
    const int gi = r / a.o_g;
    bf16* dst = sb + (gi * a.ogp + r - gi * a.o_g) * a.row_b + j * piece;
    if (piece == 8) cp_async16(dst, src + size_t(r) * row + j * 8, true);
    else cp_async8(dst, src + size_t(r) * row + j * 4);
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 2) deform_conv_bf16_kernel(const Plan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cidx = reinterpret_cast<int*>(smem);    // kWindow: window pixel of corner (y0, x0), -1: no sample
  int4* cidx4 = reinterpret_cast<int4*>(smem);  // !kWindow: the four corners' pixels in the image, -1: zero
  float4* cw = reinterpret_cast<float4*>(smem + a.off_w);
  float* cmask = reinterpret_cast<float*>(smem + a.off_mask);
  bf16* sa = reinterpret_cast<bf16*>(smem + a.off_a);
  bf16* sb = reinterpret_cast<bf16*>(smem + a.off_b);
  bf16* win = reinterpret_cast<bf16*>(smem + a.off_win);

  // tiles of one channel range next to each other: neighbours share halos in L2
  int blk = blockIdx.x;
  const int tx = blk % a.tiles_x;
  blk /= a.tiles_x;
  const int ty = blk % a.tiles_y;
  blk /= a.tiles_y;
  const int b = blk % a.b;
  const int split = blk / a.b;
  const int i0 = ty * a.th, j0 = tx * a.tw;
  const int m = a.th * a.tw;
  const int pt = m * a.taps;
  const int wy0 = i0 * a.stride - a.pad - a.window;
  const int wx0 = j0 * a.stride - a.pad - a.window;
  const bf16* x_img = a.x + size_t(b) * a.h * a.w * a.c;
  const int chunk0 = split * a.nch;

  if (kWindow) {
    stage_window(a, win, x_img, chunk0, wy0, wx0);
    cp_async_commit();
  }

  // 1. once a tile: corners, bilinear weights and mask of every (position, tap)
  for (int e = threadIdx.x; e < pt; e += kThreads) {
    const int p = e / a.taps;
    const int t = e - p * a.taps;
    const int pi = p / a.tw;
    const int i = i0 + pi, j = j0 + p - pi * a.tw;
    float4 wq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float mk = 1.0f;
    int4 q4 = make_int4(-1, -1, -1, -1);
    int q1 = -1;
    if (i < a.ho && j < a.wo) {
      const int at = (b * a.ho + i) * a.wo + j;
      if (a.mask != nullptr) mk = a.mask[size_t(at) * a.taps + t];
      const Corner cq = corner_of(a.offsets, at, t, a.taps, a.kw, i * a.stride - a.pad, j * a.stride - a.pad,
                                  a.h, a.w, a.window);
      if (cq.valid) {
        wq = cq.w;
        if (kWindow) {
          q1 = (cq.y0 - wy0) * a.wc + (cq.x0 - wx0);  // the clamp keeps all four corners inside
        } else {
          const int y0 = cq.y0, x0 = cq.x0;
          const bool y0in = y0 >= 0 && y0 < a.h, y1in = y0 + 1 >= 0 && y0 + 1 < a.h;
          const bool x0in = x0 >= 0 && x0 < a.w, x1in = x0 + 1 >= 0 && x0 + 1 < a.w;
          q4.x = y0in && x0in ? y0 * a.w + x0 : -1;
          q4.y = y0in && x1in ? y0 * a.w + x0 + 1 : -1;
          q4.z = y1in && x0in ? (y0 + 1) * a.w + x0 : -1;
          q4.w = y1in && x1in ? (y0 + 1) * a.w + x0 + 1 : -1;
        }
      }
    }
    if (kWindow) cidx[e] = q1;
    else cidx4[e] = q4;
    cw[e] = wq;
    cmask[e] = round_to<bf16>(mk);
  }
  // zeros once: A's K padding (sampling never writes it) and all of B
  {
    const int pad_k = a.kp - a.taps * a.c_g;
    if (pad_k > 0) {
      for (int e = threadIdx.x; e < m * a.gc * pad_k; e += kThreads) {
        const int k = e % pad_k;
        const int rg = e / pad_k;
        sa[(rg / a.gc) * a.row_a + (rg % a.gc) * a.kp + a.taps * a.c_g + k] = __float2bfloat16_rn(0.0f);
      }
    }
    uint4* b4 = reinterpret_cast<uint4*>(sb);
    for (int e = threadIdx.x; e < a.gc * a.ogp * a.row_b / 8; e += kThreads) b4[e] = make_uint4(0, 0, 0, 0);
  }

  // this thread's eight channels of a chunk: q, and where each half of four
  // channels goes in a row of A (group, channel)
  const int nq = a.cc >> 3;
  const int step = kThreads / nq;
  const int q = threadIdx.x % nq;
  const int pt_first = threadIdx.x < step * nq ? threadIdx.x / nq : pt;  // nq need not divide kThreads
  const int g_lo = (q * 8) / a.c_g, g_hi = (q * 8 + 4) / a.c_g;
  const int col_lo = g_lo * a.kp + (q * 8) % a.c_g;
  const int col_hi = g_hi * a.kp + (q * 8 + 4) % a.c_g;
  const bool whole = (a.c_g & 7) == 0;  // the eight channels are one group's, contiguous in A
  const bool masked = a.mask != nullptr;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ntiles = a.ogp >> 3;
  const int units = (m >> 4) * a.gc * ntiles;
  const int ksteps = a.kp >> 4;
  const bool pairs = ((a.o_g | a.c_out) & 1) == 0;  // two outputs a 4-byte store

  for (int ci = 0; ci < a.nch; ++ci) {
    const int chunk = chunk0 + ci;
    const bf16* wbuf = win + (ci & 1) * a.win_elems;
    cp_async_wait<0>();  // this chunk's window (the only copy in flight)
    __syncthreads();  // ... is in for all; the last chunk's sampling and products are done with A, B, the other window

    // 2. copies in flight while this chunk is sampled: its weights into B,
    // then the next chunk's window into the other buffer
    stage_weights(a, sb, chunk);
    cp_async_commit();
    const bool next = kWindow && ci + 1 < a.nch;
    if (next) {
      stage_window(a, win + ((ci + 1) & 1) * a.win_elems, x_img, chunk + 1, wy0, wx0);
      cp_async_commit();
    }

    // 3. the chunk's samples as A: (position, group, tap * c_g + channel)
    const bf16* xsrc = x_img + size_t(chunk) * a.cc + q * 8;
    for (int e = pt_first; e < pt; e += step) {
      const int p = e / a.taps;
      const int t = e - p * a.taps;
      uint4 c00, c01, c10, c11;
      if (kWindow) {
        const int base = cidx[e];
        if (base < 0) {
          c00 = c01 = c10 = c11 = make_uint4(0, 0, 0, 0);
        } else {
          const bf16* s0 = wbuf + base * a.cc + q * 8;
          c00 = *reinterpret_cast<const uint4*>(s0);
          c01 = *reinterpret_cast<const uint4*>(s0 + a.cc);
          c10 = *reinterpret_cast<const uint4*>(s0 + a.wc * a.cc);
          c11 = *reinterpret_cast<const uint4*>(s0 + (a.wc + 1) * a.cc);
        }
      } else {
        const int4 g = cidx4[e];
        const uint4 z = make_uint4(0, 0, 0, 0);
        c00 = g.x >= 0 ? __ldg(reinterpret_cast<const uint4*>(xsrc + size_t(g.x) * a.c)) : z;
        c01 = g.y >= 0 ? __ldg(reinterpret_cast<const uint4*>(xsrc + size_t(g.y) * a.c)) : z;
        c10 = g.z >= 0 ? __ldg(reinterpret_cast<const uint4*>(xsrc + size_t(g.z) * a.c)) : z;
        c11 = g.w >= 0 ? __ldg(reinterpret_cast<const uint4*>(xsrc + size_t(g.w) * a.c)) : z;
      }
      const uint4 s = blend8(cw[e], cmask[e], masked, c00, c01, c10, c11);
      bf16* row = sa + p * a.row_a + t * a.c_g;
      if (whole) {
        *reinterpret_cast<uint4*>(row + col_lo) = s;
      } else {
        *reinterpret_cast<uint2*>(row + col_lo) = make_uint2(s.x, s.y);
        *reinterpret_cast<uint2*>(row + col_hi) = make_uint2(s.z, s.w);
      }
    }
    if (next) cp_async_wait<1>();  // the weights; the window may still be in flight
    else cp_async_wait<0>();
    __syncthreads();  // A and B are in

    // 4. products: a warp takes (16 positions, group, 8 outputs) units
    for (int u = warp; u < units; u += kThreads / 32) {
      const int nt = u % ntiles;
      const int r = u / ntiles;
      const int gi = r % a.gc;
      const int mt = r / a.gc;
      const unsigned a_addr =
          smem_addr(sa + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * a.row_a + gi * a.kp + (lane >> 4) * 8);
      const unsigned b_addr = smem_addr(sb + (gi * a.ogp + nt * 8 + (lane & 7)) * a.row_b + ((lane >> 3) & 1) * 8);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a0, a1, a2, a3, b0, b1;
        ldmatrix_x4(a_addr + ks * 32, a0, a1, a2, a3);
        ldmatrix_x2(b_addr + ks * 32, b0, b1);
        mma_bf16(acc, a0, a1, a2, a3, b0, b1);
      }
      const int o = nt * 8 + (lane & 3) * 2;
      const int oc = (chunk * a.gc + gi) * a.o_g + o;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + (lane >> 2) + half * 8;
        const int pi = p / a.tw;
        const int i = i0 + pi, j = j0 + p - pi * a.tw;
        if (i >= a.ho || j >= a.wo || o >= a.o_g) continue;
        bf16* dst = a.out + (size_t(b * a.ho + i) * a.wo + j) * a.c_out + oc;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[half * 2], acc[half * 2 + 1]);
        } else {
          dst[0] = __float2bfloat16_rn(acc[half * 2]);
          if (o + 1 < a.o_g) dst[1] = __float2bfloat16_rn(acc[half * 2 + 1]);
        }
      }
    }
  }
}

template <bool kWindow>
int launch_bf16_kernel(const Plan& a, unsigned blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(deform_conv_bf16_kernel<kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return int(err);
  deform_conv_bf16_kernel<kWindow><<<blocks, kThreads, a.smem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch_bf16(Plan a, cudaStream_t stream) {
  // the plan must be one this kernel can run, and the wrapper's count of its
  // shared memory must be this kernel's
  if (a.th <= 0 || a.tw <= 0 || a.cc <= 0 || a.nch <= 0 || a.c_g % 4 || a.cc % 8 || a.cc % a.c_g ||
      a.c % a.cc || (a.th * a.tw) % 16 || (a.c / a.cc) % a.nch || a.cc / 8 > kThreads)
    return int(cudaErrorInvalidValue);
  a.taps = a.kh * a.kw;
  const int smem = a.smem;
  lay_out(a);
  if (a.smem != smem || size_t(smem) > kMaxShared) return int(cudaErrorInvalidValue);
  a.tiles_y = (a.ho + a.th - 1) / a.th;
  a.tiles_x = (a.wo + a.tw - 1) / a.tw;
  a.splits = a.c / a.cc / a.nch;
  const long long blocks = 1LL * a.b * a.tiles_y * a.tiles_x * a.splits;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  return a.window > 0 ? launch_bf16_kernel<true>(a, unsigned(blocks), stream)
                      : launch_bf16_kernel<false>(a, unsigned(blocks), stream);
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, weight and out). The weight is (C_out, c_g, kh,
// kw) for f32 and (C_out, kh, kw, c_g) for bf16. offsets and mask f32; mask
// may be null (v1). window: D (0: no clamp). th, tw, cc, nch, smem: the bf16
// route's launch plan (ops/deform_conv.py `launch_plan`; the f32 route
// ignores them).
int bags_deform_conv_forward(int dtype, const void* x, const float* offsets, const float* mask,
                             const void* weight, void* out, int b, int h, int w, int c, int ho,
                             int wo, int c_out, int kh, int kw, int stride, int pad, int groups,
                             int window, int th, int tw, int cc, int nch, int smem, cudaStream_t stream) {
  if (groups <= 0 || c % groups || c_out % groups) return int(cudaErrorInvalidValue);
  if (dtype == 0) {
    Args a{x, offsets, mask, weight, out, h, w, c, ho, wo, c_out, kh, kw, stride, pad,
           c / groups, c_out / groups, 1, window, (ho * wo + kTile - 1) / kTile};
    return launch_f32(a, b, groups, stream);
  }
  if (dtype == 1) {
    Plan a{};
    a.x = static_cast<const bf16*>(x);
    a.offsets = offsets;
    a.mask = mask;
    a.weight = static_cast<const bf16*>(weight);
    a.out = static_cast<bf16*>(out);
    a.b = b, a.h = h, a.w = w, a.c = c, a.ho = ho, a.wo = wo, a.c_out = c_out, a.kh = kh, a.kw = kw;
    a.stride = stride, a.pad = pad, a.c_g = c / groups, a.o_g = c_out / groups, a.window = window;
    a.th = th, a.tw = tw, a.cc = cc, a.nch = nch, a.smem = smem;
    return launch_bf16(a, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"

BAGS_PACKED(bags_deform_conv_forward)
