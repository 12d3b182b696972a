// Deformable convolution v1/v2: K7 `bags_deform_conv_forward`, the forward, and
// K7b `bags_deform_conv_backward`, its gradient (the second note below).
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

//
// K7b, the gradient of x, the offsets, the mask and the weight. It replaces
// no Pallas kernel: JAX's custom VJP of deform_conv2d_fused
// (pallas/deform_conv.py :544-564) differentiates the XLA shift path, and
// this computes that gradient (JAX's autodiff of ops/deform_conv.py
// deform_conv2d :240): with grad_col[k, c] = sum over the outputs o of c's
// group of grad_out[o] * weight[o, c, k] (times the rounded mask in v2), dx
// gets each corner's bilinear weight times grad_col; d(dy) the channel sum of
// grad_col times the blend's derivative in the row's fraction, hx (v10 - v00)
// + lx (v11 - v01), times the clamp's slope (1 inside +-D, 1/2 at exactly +-D
// as jnp.clip's, 0 beyond; and the high corners left out where the fraction's
// floor is the top of JAX's static shift range, k - 1 + D); d(mask) the
// channel sum of grad_col times the rounded sample; d(weight) the positions'
// sum of grad_out times the sample K7 contracted. An invalid sample gets
// nothing, a corner outside the image nothing.
//
// The bf16 route (the detector's path, D > 0 and D = 0, v1 and v2) is one
// kernel that walks the positions once. A block owns a chunk of whole groups
// (CC channels, 16-byte pieces a power of two) and a range of tiles of TH x
// TW output positions of one image; it is persistent over the range, so the
// weight gradient's sums stay in registers (mma fragments, at most
// kGradSlots a warp). The wrapper's plan (ops/deform_conv.py
// `backward_plan`) picks TH, TW, the groups a chunk and the tiles a block at
// each layer; `lay_out_grad` recomputes its shared memory and refuses a
// mismatch. Per tile (`deform_grad_bf16_kernel`'s comment has the phases):
//   1. Staging. At D > 0 every corner lies in a window of (TH - 1) s + kh +
//      2D + 1 rows by (TW - 1) s + kw + 2D + 1 columns, known before any
//      offset is read: the window's CC channels, the tile's offsets and mask
//      and its grad_out rows are copied with cp.async (zeros outside the image
//      and past the output's edge), double-buffered: the next tile's copies
//      fly while this one is worked on. One (position, tap) table a tile.
//   2. grad_col[g] = grad_out (positions x o_g) . W_g (o_g x taps c_g) on the
//      tensor cores (mma.sync m16n8k16, or k8 when o_g pads to 8, operands by
//      ldmatrix; W_g staged once a block), into shared memory in f32.
//   3. One pass over (position, tap, 8 channels) reads the four corners from
//      the window once: the sample with K7's blend, bit for bit, rounded and
//      masked as K7 rounds it, goes to the columns (bf16, positions x
//      (group, tap, channel)); the channel sums of grad_s times each corner
//      give d(dy) and d(dx) (hx (hy' S10 - S00) + lx (hy' S11 - S01), and
//      alike), the sample gives d(mask); they are summed over the chunk with
//      shuffles and written once a (position, tap): a store when one chunk
//      holds all the groups, else one atomic a chunk.
//   4. dW[g] += columns^T (taps c_g x positions) . grad_out (positions x o_g)
//      on the tensor cores (ldmatrix .trans for both operands). Each block
//      writes one partial; a small kernel adds the ranges' partials in order
//      and rounds once, so dW is deterministic.
//   5. dx is gathered in shared memory: every corner of the tile is entered
//      in its window pixel's list (grad_col row, bilinear weight times the
//      mask), by counts, a scan and a fill with int atomics, so that the
//      lists laid end to end are the tile's corners sorted by pixel; equal
//      runs of them, one a thread and 8 channels, sum each pixel's shares
//      and add them to the f32 dx buffer with 16-byte atomics where the
//      pixel changes, skipping pixels outside the image: about one atomic a
//      window pixel and 4 channels, not four a sample. A shared-memory f32 atomicAdd would be simpler, but ptxas
//      builds it on sm_90a as a compare-and-swap loop (ATOMS.CAST.SPIN); the
//      lists use only the native int atomics.
//   At D = 0 (unbounded offsets) there is no window: corners are read from
//   device memory and dx takes each sample's shares with 16-byte atomics.
//   The f32 dx buffer is zeroed first and rounded to bf16 once at the end.
// The f32 route (card tests and the small f32 HTC comparison only) keeps the
// first design: a data pass (grad_col on the CUDA cores, four 16-byte f32
// atomics a sample and 4 channels into the dx buffer) and a weight pass
// (the columns sampled again, block partials over ranges of the positions).
//
// What bounds K7b on an H100: by bytes, reading x, grad_out, the offsets and
// the mask once and writing dx (through its f32 buffer, read again by the
// cast), the offsets' and the mask's gradients; by operations, the two
// grouped contractions (grad_col and the weight's gradient, 2 * taps * c_g *
// C_out each a position) on the tensor cores, and the samples' blend and
// derivatives on the CUDA cores. Against the first design's costs, this one
// samples each column once (the weight pass sampled them again, four times
// over at c5), runs both products on the tensor cores (the first ran them as
// scalar FMAs on shared loads), reads corners from the staged window (the
// first read them from L2) and reaches dx through the window (the first
// issued four atomics a sample and 4 channels). What sets its pace now is
// latency: each tile is five barrier-separated phases of a few hundred
// instructions a thread, and two blocks of eight warps an SM do not hide the
// shared-memory round trips of the sampling pass and the gather
// (kernel_study's cycle counts a phase); a warp's share of issue slots makes
// every index division on the way costly, hence the FastDivs.
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
  // for the gradient (K7b): the fractions, the clamp's slopes (1 inside +-D,
  // 1/2 at exactly +-D, 0 beyond; 1 at D = 0), and 1 or 0 as the fraction's
  // derivative counts the high corners (0 at the top of JAX's shift range)
  float ly, lx, gy, gx, hy, hx;
};

__device__ __forceinline__ Corner corner_at(float dy, float dx, int ty, int tx, int by, int bx, int kh, int kw, int h,
                                            int w, int window) {
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
    q.gy = fabsf(dy) < d ? 1.0f : fabsf(dy) == d ? 0.5f : 0.0f;
    q.gx = fabsf(dx) < d ? 1.0f : fabsf(dx) == d ? 0.5f : 0.0f;
    q.hy = fy < float(kh - 1 + window) ? 1.0f : 0.0f;
    q.hx = fx < float(kw - 1 + window) ? 1.0f : 0.0f;
  } else {
    ys = (float(by) + float(ty)) + dy;
    xs = (float(bx) + float(tx)) + dx;
    const float fy = floorf(ys);
    const float fx = floorf(xs);
    ly = ys - fy;
    lx = xs - fx;
    q.y0 = int(fy);
    q.x0 = int(fx);
    q.gy = q.gx = q.hy = q.hx = 1.0f;
  }
  q.ly = ly;
  q.lx = lx;
  q.valid = ys > -1.0f && ys < float(h) && xs > -1.0f && xs < float(w);
  const float hy = 1.0f - ly;
  const float hx = 1.0f - lx;
  q.w = q.valid ? make_float4(hy * hx, hy * lx, ly * hx, ly * lx) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return q;
}

// The same, with tap t's offsets read from (B, Ho, Wo, 2 * taps) at position `at`.
__device__ __forceinline__ Corner corner_of(const float* offsets, int at, int t, int taps, int kw, int by,
                                            int bx, int h, int w, int window) {
  const int ty = t / kw;
  return corner_at(offsets[size_t(at) * 2 * taps + 2 * t], offsets[size_t(at) * 2 * taps + 2 * t + 1], ty, t - ty * kw,
                   by, bx, taps / kw, kw, h, w, window);
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


// ---------------------------------------------------------------------------
// K7b: the gradient. See the note at the top of the file.

constexpr int kGradThreads = 256;

// ---- The f32 route: two passes on the CUDA cores.

constexpr int kGradAcc = 16;  // weight-gradient sums a thread of the weight pass holds

struct GradArgs {
  const float* x;        // (B, H, W, C)
  const float* offsets;  // (B, Ho, Wo, 2 * taps)
  const float* mask;     // (B, Ho, Wo, taps) or null
  const float* weight;   // (C_out, c_g, kh, kw)
  const float* grad;     // (B, Ho, Wo, C_out), the output's gradient
  float* dx;             // (B, H, W, C), zeroed; null: no dx
  float* doff;           // (B, Ho, Wo, 2 * taps), zeroed; null: none
  float* dmask;          // (B, Ho, Wo, taps), zeroed; null: none
  float* part;           // (splits, C_out, c_g, kh, kw): the weight pass's partial sums; null: none
  int n;                 // B * Ho * Wo output positions
  int h, w, c, ho, wo, c_out, kh, kw, taps, stride, pad, c_g, o_g, window;
  int tp, gpc, oc, splits, tiles, per_split;  // the plan; tiles of tp positions, per_split of them a range
};

// The shared memory of the two passes; ops/deform_conv.py `backward_plan_f32`
// computes the same totals.
inline int grad_data_bytes(const GradArgs& a) {
  const int pt = a.tp * a.taps;
  return pt * 80 + a.tp * a.gpc * a.o_g * 4 + a.taps * a.gpc * a.o_g * a.c_g * 4;
}
__host__ __device__ inline int grad_weight_cin(const GradArgs& a) { return (a.oc >= a.o_g ? a.oc / a.o_g : 1) * a.c_g; }
inline int grad_weight_bytes(const GradArgs& a) {
  const int pt = a.tp * a.taps;
  return pt * 36 + a.tp * a.oc * 4 + pt * grad_weight_cin(a) * 4;
}

// Four channels of x at pixel `pix` (global over the batch; -1: zeros), from channel c.
__device__ __forceinline__ float4 corner4(const float* x, int pix, int c, int channels) {
  if (pix < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return *reinterpret_cast<const float4*>(x + size_t(pix) * channels + c);
}
__device__ __forceinline__ float elem(float4 v, int k) { return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w; }

// The tile's (position, tap) table: each corner's pixel (global over the
// batch; -1 outside the image, or every corner when the sample is not
// valid), the bilinear weights, the mask, and (when `coef` is not null) the
// coefficients of the corners in the row's and the column's derivative,
// slopes included: d/d(dy) = sum over corners of coef[2e] . v.
__device__ void grad_table(const GradArgs& a, int n0, int4* corner, float4* cw, float* cmask, float4* coef) {
  const int hw_out = a.ho * a.wo;
  for (int e = threadIdx.x; e < a.tp * a.taps; e += blockDim.x) {
    const int p = e / a.taps;
    const int t = e - p * a.taps;
    const int at = n0 + p;
    int4 q = make_int4(-1, -1, -1, -1);
    float4 wq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 cy = wq, cx = wq;
    float m = 1.0f;
    if (at < a.n) {
      const int b = at / hw_out;
      const int pos = at - b * hw_out;
      const int i = pos / a.wo;
      const int j = pos - i * a.wo;
      if (a.mask != nullptr) m = a.mask[size_t(at) * a.taps + t];
      const Corner cq = corner_of(a.offsets, at, t, a.taps, a.kw, i * a.stride - a.pad, j * a.stride - a.pad,
                                  a.h, a.w, a.window);
      if (cq.valid) {
        wq = cq.w;
        const int y0 = cq.y0, x0 = cq.x0, base = b * a.h * a.w;
        const bool y0in = y0 >= 0 && y0 < a.h, y1in = y0 + 1 >= 0 && y0 + 1 < a.h;
        const bool x0in = x0 >= 0 && x0 < a.w, x1in = x0 + 1 >= 0 && x0 + 1 < a.w;
        q.x = y0in && x0in ? base + y0 * a.w + x0 : -1;
        q.y = y0in && x1in ? base + y0 * a.w + x0 + 1 : -1;
        q.z = y1in && x0in ? base + (y0 + 1) * a.w + x0 : -1;
        q.w = y1in && x1in ? base + (y0 + 1) * a.w + x0 + 1 : -1;
        // d s / d ly = hx (hy' v10 - v00) + lx (hy' v11 - v01), and in x alike
        const float hy = 1.0f - cq.ly, hx = 1.0f - cq.lx;
        cy = make_float4(-hx * cq.gy, -cq.lx * cq.gy, hx * cq.hy * cq.gy, cq.lx * cq.hy * cq.gy);
        cx = make_float4(-hy * cq.gx, hy * cq.hx * cq.gx, -cq.ly * cq.gx, cq.ly * cq.hx * cq.gx);
      }
    }
    corner[e] = q;
    cw[e] = wq;
    cmask[e] = m;
    if (coef != nullptr) {
      coef[2 * e] = cy;
      coef[2 * e + 1] = cx;
    }
  }
}

// The data pass: one block takes `tp` positions and `gpc` groups. A thread
// takes four channels of one (position, tap) at a time: their gradient
// grad_col (the group's outputs' gradients against the weight), the four
// corners and the sample, the four corners' shares of dx (one 16-byte f32
// atomic each), and its part of the offsets' and the mask's channel sums,
// which meet in shared memory and go out with one atomic a (position, tap).
__global__ void __launch_bounds__(kGradThreads) deform_grad_data_kernel(GradArgs a) {
  extern __shared__ float4 smem4[];
  const int pt = a.tp * a.taps;
  const int cci = a.gpc * a.c_g, cco = a.gpc * a.o_g;
  int4* corner = reinterpret_cast<int4*>(smem4);
  float4* cw = smem4 + pt;
  float4* coef = smem4 + 2 * pt;  // two a (position, tap)
  float* cmask = reinterpret_cast<float*>(smem4 + 4 * pt);
  float* sums = cmask + pt;         // d/d(dy), d/d(dx), d/d(mask) a (position, tap)
  float* gt = sums + 3 * pt;        // [p][o]: the tile's output gradients
  float* wt = gt + a.tp * cco;      // [t][o][c]: the chunk's weights
  const int n0 = blockIdx.x * a.tp;
  const int c0 = blockIdx.y * cci, o0 = blockIdx.y * cco;

  grad_table(a, n0, corner, cw, cmask, coef);
  for (int e = threadIdx.x; e < 3 * pt; e += blockDim.x) sums[e] = 0.0f;
  for (int e = threadIdx.x; e < a.tp * cco; e += blockDim.x) {
    const int p = e / cco;
    gt[e] = n0 + p < a.n ? a.grad[size_t(n0 + p) * a.c_out + o0 + e - p * cco] : 0.0f;
  }
  for (int e = threadIdx.x; e < a.taps * cco * a.c_g; e += blockDim.x) {
    const int cg = e % a.c_g;
    const int o = (e / a.c_g) % cco;
    const int t = e / (a.c_g * cco);
    wt[e] = a.weight[(size_t(o0 + o) * a.c_g + cg) * a.taps + t];
  }
  __syncthreads();

  const int nq = cci / 4;
  for (int e = threadIdx.x; e < pt * nq; e += blockDim.x) {
    const int k = e / nq;  // p * taps + t
    const int cl = (e - k * nq) * 4;
    const int4 q = corner[k];
    if (q.x < 0 && q.y < 0 && q.z < 0 && q.w < 0) continue;  // not a valid sample: no gradient
    const int p = k / a.taps;
    const int t = k - p * a.taps;
    const int gl = cl / a.c_g;
    const float* grow = gt + p * cco + gl * a.o_g;
    const float* wrow = wt + (t * cco + gl * a.o_g) * a.c_g + (cl - gl * a.c_g);
    float gc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int o = 0; o < a.o_g; ++o) {
      const float g = grow[o];
      const float4 wv = *reinterpret_cast<const float4*>(wrow + o * a.c_g);
      gc[0] = fmaf(g, wv.x, gc[0]);
      gc[1] = fmaf(g, wv.y, gc[1]);
      gc[2] = fmaf(g, wv.z, gc[2]);
      gc[3] = fmaf(g, wv.w, gc[3]);
    }
    const int ch = c0 + cl;
    const float4 v00 = corner4(a.x, q.x, ch, a.c), v01 = corner4(a.x, q.y, ch, a.c);
    const float4 v10 = corner4(a.x, q.z, ch, a.c), v11 = corner4(a.x, q.w, ch, a.c);
    const float4 wq = cw[k], cy = coef[2 * k], cx = coef[2 * k + 1];
    const float m = cmask[k];
    float gs[4], dy = 0.0f, dx = 0.0f, dm = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float c00 = elem(v00, u), c01 = elem(v01, u), c10 = elem(v10, u), c11 = elem(v11, u);
      gs[u] = gc[u];
      if (a.mask != nullptr) {
        dm = fmaf(gc[u], blend(wq, c00, c01, c10, c11), dm);
        gs[u] = gc[u] * m;
      }
      dy = fmaf(gs[u], cy.x * c00 + cy.y * c01 + cy.z * c10 + cy.w * c11, dy);
      dx = fmaf(gs[u], cx.x * c00 + cx.y * c01 + cx.z * c10 + cx.w * c11, dx);
    }
    if (a.dx != nullptr) {
      const int pix[4] = {q.x, q.y, q.z, q.w};
      const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (pix[r] >= 0)
          atomicAdd(reinterpret_cast<float4*>(a.dx + size_t(pix[r]) * a.c + ch),
                    make_float4(wk[r] * gs[0], wk[r] * gs[1], wk[r] * gs[2], wk[r] * gs[3]));
    }
    if (a.doff != nullptr) {
      atomicAdd(sums + 3 * k, dy);
      atomicAdd(sums + 3 * k + 1, dx);
    }
    if (a.dmask != nullptr) atomicAdd(sums + 3 * k + 2, dm);
  }
  __syncthreads();

  if (a.doff == nullptr && a.dmask == nullptr) return;
  for (int e = threadIdx.x; e < pt; e += blockDim.x) {
    const int p = e / a.taps;
    const int t = e - p * a.taps;
    const int at = n0 + p;
    if (at >= a.n) continue;
    if (a.doff != nullptr) {
      atomicAdd(a.doff + size_t(at) * 2 * a.taps + 2 * t, sums[3 * e]);
      atomicAdd(a.doff + size_t(at) * 2 * a.taps + 2 * t + 1, sums[3 * e + 1]);
    }
    if (a.dmask != nullptr) atomicAdd(a.dmask + size_t(at) * a.taps + t, sums[3 * e + 2]);
  }
}

// The weight pass: one block takes `oc` output channels and one range of
// the position tiles. Per tile it samples the columns its outputs read into
// shared memory with the tile's output gradients, and each thread adds
// grad_out x column over the tile's positions into its own sums (at most
// kGradAcc, one an (output, tap, channel)). The block's sums go out as one
// partial of the weight's gradient, which a second kernel adds up.
__global__ void __launch_bounds__(kGradThreads) deform_grad_weight_kernel(GradArgs a) {
  extern __shared__ float4 smem4[];
  const int pt = a.tp * a.taps;
  const int cin = grad_weight_cin(a);
  int4* corner = reinterpret_cast<int4*>(smem4);
  float4* cw = smem4 + pt;
  float* cmask = reinterpret_cast<float*>(smem4 + 2 * pt);
  float* gt = cmask + pt;         // [p][o]
  float* col = gt + a.tp * a.oc;  // [p][t][c]: the samples of the channels the outputs read
  const int o0 = blockIdx.x * a.oc;
  const int g0 = o0 / a.o_g;
  const int ci0 = g0 * a.c_g;
  const int units = a.oc * a.taps * a.c_g;

  // each thread's sums: output o, tap t, channel cg of o's group; where they read
  int go[kGradAcc], gcol[kGradAcc];
  float acc[kGradAcc];
#pragma unroll
  for (int r = 0; r < kGradAcc; ++r) {
    const int u = threadIdx.x + r * kGradThreads;
    const int uu = u < units ? u : 0;
    const int o = uu / (a.taps * a.c_g);
    const int rest = uu - o * a.taps * a.c_g;
    const int t = rest / a.c_g;
    const int cg = rest - t * a.c_g;
    go[r] = o;
    gcol[r] = t * cin + ((o0 + o) / a.o_g - g0) * a.c_g + cg;
    acc[r] = 0.0f;
  }

  const int first = blockIdx.y * a.per_split;
  const int last = min(first + a.per_split, a.tiles);
  const int nq = cin / 4;
  for (int tile = first; tile < last; ++tile) {
    const int n0 = tile * a.tp;
    grad_table(a, n0, corner, cw, cmask, nullptr);
    for (int e = threadIdx.x; e < a.tp * a.oc; e += blockDim.x) {
      const int p = e / a.oc;
      gt[e] = n0 + p < a.n ? a.grad[size_t(n0 + p) * a.c_out + o0 + e - p * a.oc] : 0.0f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < pt * nq; e += blockDim.x) {
      const int k = e / nq;
      const int cl = (e - k * nq) * 4;
      const int4 q = corner[k];
      const int ch = ci0 + cl;
      const float4 v00 = corner4(a.x, q.x, ch, a.c), v01 = corner4(a.x, q.y, ch, a.c);
      const float4 v10 = corner4(a.x, q.z, ch, a.c), v11 = corner4(a.x, q.w, ch, a.c);
      const float4 wq = cw[k];
      const float m = cmask[k];
      float* dst = col + k * cin + cl;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v = blend(wq, elem(v00, u), elem(v01, u), elem(v10, u), elem(v11, u));
        if (a.mask != nullptr) v = v * m;
        dst[u] = v;
      }
    }
    __syncthreads();
    for (int p = 0; p < a.tp; ++p) {
      const float* gp = gt + p * a.oc;
      const float* cp = col + p * a.taps * cin;
#pragma unroll
      for (int r = 0; r < kGradAcc; ++r) acc[r] = fmaf(gp[go[r]], cp[gcol[r]], acc[r]);
    }
    __syncthreads();
  }
  float* out = a.part + size_t(blockIdx.y) * a.c_out * a.c_g * a.taps;
#pragma unroll
  for (int r = 0; r < kGradAcc; ++r) {
    const int u = threadIdx.x + r * kGradThreads;
    if (u >= units) break;
    const int rest = u - go[r] * a.taps * a.c_g;
    const int t = rest / a.c_g;
    const int cg = rest - t * a.c_g;
    out[(size_t(o0 + go[r]) * a.c_g + cg) * a.taps + t] = acc[r];
  }
}

// The weight's gradient: the partials added up in order, rounded once to T.
template <typename T>
__global__ void deform_grad_weight_sum_kernel(const float* part, T* out, int splits, int size) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size; i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[size_t(k) * size + i];
    out[i] = from_float<T>(s);
  }
}

template <typename T>
int launch_weight_sum(const float* part, void* dweight, int splits, int size, cudaStream_t stream) {
  deform_grad_weight_sum_kernel<T><<<(size + 255) / 256, 256, 0, stream>>>(part, static_cast<T*>(dweight), splits, size);
  return int(cudaGetLastError());
}

int launch_grad_f32(GradArgs a, void* dweight, cudaStream_t stream) {
  cudaError_t err;
  if (a.dx != nullptr || a.doff != nullptr || a.dmask != nullptr) {
    const int smem = grad_data_bytes(a);
    err = cudaFuncSetAttribute(deform_grad_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid(unsigned(a.tiles), unsigned(a.c / (a.gpc * a.c_g)));
    deform_grad_data_kernel<<<grid, kGradThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (a.part != nullptr) {
    const int smem = grad_weight_bytes(a);
    err = cudaFuncSetAttribute(deform_grad_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid(unsigned(a.c_out / a.oc), unsigned(a.splits));
    deform_grad_weight_kernel<<<grid, kGradThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    return launch_weight_sum<float>(a.part, dweight, a.splits, a.c_out * a.c_g * a.taps, stream);
  }
  return int(cudaSuccess);
}

// ---- The bf16 route: one pass over the positions, both products on the
// tensor cores, dx gathered in shared memory.

constexpr int kGradWarps = kGradThreads / 32;
constexpr int kGradSlots = 12;  // weight-gradient fragments (16 x 8 f32 sums) a warp holds

// Division of a non-negative int below 2^31 by a divisor fixed at launch:
// a multiply-high, an add and a shift (q = (umulhi(n, mul) + n) >> shift).
struct FastDiv {
  unsigned mul;
  int shift, d;
};
inline FastDiv fast_div(int d) {
  FastDiv f{1u, 0, d};
  while ((1LL << f.shift) < d) ++f.shift;
  f.mul = unsigned((((1ULL << 32) * ((1ULL << f.shift) - unsigned(d))) / unsigned(d) + 1) & 0xffffffffULL);
  return f;
}
__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return int((__umulhi(unsigned(n), f.mul) + unsigned(n)) >> f.shift);
}

// Everything the bf16 gradient kernel needs: shapes, the plan and the shared
// memory layout, worked out once on the host.
struct GradPlan {
  const bf16* x;         // (B, H, W, C)
  const float* offsets;  // (B, Ho, Wo, 2 * taps)
  const float* mask;     // (B, Ho, Wo, taps) or null
  const bf16* weight;    // (C_out, c_g, kh, kw)
  const bf16* grad;      // (B, Ho, Wo, C_out)
  float* dx;             // (B, H, W, C) f32, zeroed; null: no dx
  float* doff;           // (B, Ho, Wo, 2 * taps), zeroed; null: none
  float* dmask;          // (B, Ho, Wo, taps), zeroed; null: none
  float* part;           // (splits, C_out, c_g, kh, kw); null: no weight gradient
  int b, h, w, c, ho, wo, c_out, kh, kw, taps, stride, pad, c_g, o_g, window;
  int th, tw, gc, tpb, splits;  // the plan: the tile, groups a chunk, tiles a block, tile ranges
  int m, pt, cc, co, kp, ogp, nq, chunks, tiles_y, tiles_x, tiles;
  int wr, wc, npix, win_px, gcs, row_c, row_g, row_w, scan_per;  // the window; row strides (elements)
  int dw_mt, dw_nt, dw_units;  // weight-gradient fragments: (tap, channel) and output tiles a group; the chunk's
  int off_stage, off_list, off_cs, off_gcol, off_cols, off_g, off_w, off_win, smem;  // byte offsets; the total
  int g_async;  // grad_out's rows come in 16-byte cp.async pieces (o_g % 8 == 0, aligned)
  FastDiv by_taps, by_tw, by_wc, by_nq, by_cg, by_ntg, by_per, by_scan, by_dwnt, by_dwmt, by_kw, by_tx, by_txy;
  int lg_nq;  // log2(nq)
};

// The shared memory layout; ops/deform_conv.py `backward_shared_bytes`
// computes the same sizes.
inline void lay_out_grad(GradPlan& p) {
  p.taps = p.kh * p.kw;
  p.m = p.th * p.tw;
  p.pt = p.m * p.taps;
  p.cc = p.gc * p.c_g;
  p.co = p.gc * p.o_g;
  p.nq = p.cc / 8;
  p.kp = round_up(p.taps * p.c_g, 16);
  p.ogp = round_up(p.o_g, 8);
  p.wr = (p.th - 1) * p.stride + p.kh + 2 * p.window + 1;
  p.wc = (p.tw - 1) * p.stride + p.kw + 2 * p.window + 1;
  p.npix = p.window > 0 ? p.wr * p.wc : 0;
  p.scan_per = (p.npix + kGradThreads - 1) / kGradThreads;  // counts a thread scans
  p.win_px = p.cc;                           // bf16 a window pixel
  p.gcs = p.cc + 4;                          // f32 a (position, tap)'s grad_col
  p.row_c = p.gc * p.kp + 8;                 // (row / 8) odd: ldmatrix's eight rows fall in distinct banks
  p.row_g = round_up(p.gc * p.ogp, 16) + 8;
  p.row_w = round_up(p.ogp, 16) + 8;
  p.dw_mt = p.kp / 16;
  p.dw_nt = p.ogp / 8;
  p.dw_units = p.gc * p.dw_mt * p.dw_nt;
  int off = p.pt * 16;  // the table: int4 a (position, tap)
  p.off_stage = off;
  off += round_up(p.pt * 12, 16);  // the offsets and the mask, as copied
  p.off_list = off;
  off += p.window > 0 ? p.pt * 32 : 0;  // the dx gather's lists: (grad_col offset, weight) a corner
  p.off_cs = off;
  off += p.window > 0 ? round_up((2 * (p.npix + 1) + 2 * kGradWarps) * 4, 16) : 0;  // two tiles' counts; the warps'
  p.off_gcol = off;
  off += p.pt * p.gcs * 4;
  p.off_cols = off;
  off += p.m * p.row_c * 2;
  p.off_g = off;
  off += 2 * p.m * p.row_g * 2;
  p.off_w = off;
  off += p.gc * p.kp * p.row_w * 2;
  p.off_win = off;
  off += 2 * p.npix * p.win_px * 2;
  p.smem = off;
  p.by_taps = fast_div(p.taps);
  p.by_tw = fast_div(p.tw);
  p.by_wc = fast_div(p.wc);
  p.by_nq = fast_div(p.nq > 0 ? p.nq : 1);
  p.by_cg = fast_div(p.c_g);
  p.by_ntg = fast_div(p.kp / 8);
  p.by_per = fast_div((p.mask != nullptr ? 3 : 2) * p.taps);
  p.by_scan = fast_div(p.scan_per > 0 ? p.scan_per : 1);
  p.by_dwnt = fast_div(p.dw_nt);
  p.by_dwmt = fast_div(p.dw_mt);
  p.by_kw = fast_div(p.kw);
  for (p.lg_nq = 0; (2 << p.lg_nq) <= p.nq; ++p.lg_nq) {
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void ldmatrix_x1(unsigned addr, unsigned& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r0) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                                  unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned addr, unsigned& r0, unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// A clamp slope (0, 1/2 or 1) as 0, 1, 2, and back.
__device__ __forceinline__ int slope_code(float g) { return int(g * 2.0f); }
__device__ __forceinline__ float slope_of(int code) { return float(code) * 0.5f; }

struct GradTile {
  int b, i0, j0, wy0, wx0;
};

__device__ __forceinline__ GradTile grad_tile(const GradPlan& a, int tile) {
  GradTile t;
  t.b = tile / a.by_txy;
  const int r = tile - t.b * a.tiles_y * a.tiles_x;
  const int ty = r / a.by_tx;
  t.i0 = ty * a.th;
  t.j0 = (r - ty * a.tiles_x) * a.tw;
  t.wy0 = t.i0 * a.stride - a.pad - a.window;
  t.wx0 = t.j0 * a.stride - a.pad - a.window;
  return t;
}

// Output position p of a tile: its row and column.
__device__ __forceinline__ void tile_pos(const GradPlan& a, const GradTile& tt, int p, int& i, int& j) {
  const int pi = p / a.by_tw;
  i = tt.i0 + pi;
  j = tt.j0 + p - pi * a.tw;
}

// Copies one tile's inputs into shared memory with cp.async: the window of
// x (the chunk's channels, zeros outside the image), the offsets and mask of
// its positions, and its rows of grad_out (the chunk's outputs, zeros past
// the output's edge) when they come in 16-byte pieces.
template <bool kWindow>
__device__ void grad_issue(const GradPlan& a, const GradTile& tt, int chunk, bf16* win, float* stage, bf16* gb) {
  if (kWindow) {
    const bf16* xc = a.x + size_t(tt.b) * a.h * a.w * a.c + size_t(chunk) * a.cc;
    for (int e = threadIdx.x; e < a.npix * a.nq; e += kGradThreads) {
      const int pix = e / a.by_nq, q = e - pix * a.nq;
      const int wy = pix / a.by_wc;
      const int y = tt.wy0 + wy, xx = tt.wx0 + pix - wy * a.wc;
      const bool inside = y >= 0 && y < a.h && xx >= 0 && xx < a.w;
      cp_async16(win + pix * a.win_px + q * 8, inside ? xc + (size_t(y) * a.w + xx) * a.c + q * 8 : a.x, inside);
    }
  }
  const int per = a.by_per.d;  // floats a position: the offsets, then the mask
  for (int e = threadIdx.x; e < a.m * per; e += kGradThreads) {
    const int p = e / a.by_per, k = e - p * per;
    int i, j;
    tile_pos(a, tt, p, i, j);
    if (i >= a.ho || j >= a.wo) continue;
    const size_t at = (size_t(tt.b) * a.ho + i) * a.wo + j;
    if (k < 2 * a.taps) cp_async4(stage + p * 2 * a.taps + k, a.offsets + at * 2 * a.taps + k);
    else cp_async4(stage + 2 * a.pt + p * a.taps + k - 2 * a.taps, a.mask + at * a.taps + k - 2 * a.taps);
  }
  if (a.g_async) {
    const int nq = a.co / 8;
    for (int e = threadIdx.x; e < a.m * nq; e += kGradThreads) {
      const int p = e / nq, q = e - p * nq;
      int i, j;
      tile_pos(a, tt, p, i, j);
      const bool inside = i < a.ho && j < a.wo;
      const bf16* src = a.grad + ((size_t(tt.b) * a.ho + i) * a.wo + j) * a.c_out + size_t(chunk) * a.co + q * 8;
      cp_async16(gb + p * a.row_g + q * 8, inside ? src : a.grad, inside);
    }
  }
}

// Where window pixel `pix`'s list starts: the counts were scanned a run of
// `scan_per` pixels a thread, then within each warp, so at its scanned count
// plus the base of the warp that scanned it, the sum of the warps' totals
// before it.
__device__ __forceinline__ int warp_base(const GradPlan& a, const int (&wbase)[kGradWarps], int pix) {
  const int w = (pix / a.by_scan) >> 5;
  int base = 0;
#pragma unroll
  for (int k = 1; k < kGradWarps; ++k) base = w == k ? wbase[k] : base;  // static indices: wbase stays in registers
  return base;
}

// The bf16 gradient. A block takes one chunk of `gc` whole groups and walks
// the tiles [split * tpb, (split + 1) * tpb) of TH x TW output positions,
// keeping its weight-gradient sums in registers. Per tile, between barriers:
//   T  the (position, tap) table from the staged offsets (window pixel of the
//      low corner, fractions, clamp codes, rounded mask; -1: no sample), and
//      each window pixel's count of the corners that land on it;
//   B1 the counts are scanned (a run a thread, then within each warp);
//      grad_col = grad_out . W_g on the tensor cores, into shared memory in
//      f32; the next tile's copies go out;
//   B2 each corner enters its pixel's list with its grad_col row and its
//      bilinear weight (times the mask): the lists, laid end to end, are the
//      corners sorted by pixel; each (position, tap, 8 channels)
//      reads its four corners from the window once: the sample, rounded and
//      masked as K7 rounds it, goes to the columns, and the channel sums of
//      grad_s times each corner give the offsets' gradient (the mask's from
//      the sample), summed over the chunk with shuffles and written once a
//      (position, tap);
//   C  dW += columns^T . grad_out on the tensor cores; the lists are cut
//      into equal runs, one a thread and 8 channels, and each run's sums go
//      to dx with two 16-byte atomics wherever its pixel changes.
// At D = 0 there is no window: corners come from device memory and dx takes
// each sample's shares with 16-byte atomics in B2.
template <bool kWindow>
__global__ void __launch_bounds__(kGradThreads, 2) deform_grad_bf16_kernel(const GradPlan a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* table = reinterpret_cast<int4*>(smem);
  float* stage = reinterpret_cast<float*>(smem + a.off_stage);
  int2* list = reinterpret_cast<int2*>(smem + a.off_list);
  int* cs = reinterpret_cast<int*>(smem + a.off_cs);
  int* wsum = cs + 2 * (a.npix + 1);  // the warps' totals of the counts
  int* total = wsum + kGradWarps;     // the lists' length, for the gather
  float* gcol = reinterpret_cast<float*>(smem + a.off_gcol);
  bf16* cols = reinterpret_cast<bf16*>(smem + a.off_cols);
  bf16* gbuf = reinterpret_cast<bf16*>(smem + a.off_g);
  bf16* sw = reinterpret_cast<bf16*>(smem + a.off_w);
  bf16* win = reinterpret_cast<bf16*>(smem + a.off_win);

  const int chunk = blockIdx.x % a.chunks;
  const int split = blockIdx.x / a.chunks;
  const int first = split * a.tpb;
  const int last = min(first + a.tpb, a.tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool masked = a.mask != nullptr;
  const bool want_dw = a.part != nullptr;
  const bool want_grad = a.dx != nullptr || a.doff != nullptr || a.dmask != nullptr;
  const bool gather = kWindow && a.dx != nullptr;
  const int g_elems = a.m * a.row_g;
  const int win_elems = a.npix * a.win_px;

  // zeros once: the columns' and grad_out's padding, W, both tiles' counts
  for (int e = threadIdx.x; e < (a.off_win - a.off_cols) / 16; e += kGradThreads)
    reinterpret_cast<uint4*>(smem + a.off_cols)[e] = make_uint4(0, 0, 0, 0);
  if (kWindow)
    for (int e = threadIdx.x; e < 2 * (a.npix + 1); e += kGradThreads) cs[e] = 0;
  __syncthreads();
  // the chunk's weights as W_g[(tap, channel)][output], read in their own order
  {
    const int n = a.co * a.c_g * a.taps;
    const bf16* src = a.weight + size_t(chunk) * n;
    for (int e = threadIdx.x; e < n; e += kGradThreads) {
      const int o = e / (a.c_g * a.taps);
      const int r = e - o * a.c_g * a.taps;
      const int c = r / a.by_taps, t = r - c * a.taps;
      const int g = o / a.o_g;
      sw[(g * a.kp + t * a.c_g + c) * a.row_w + o - g * a.o_g] = src[e];
    }
  }
  if (first < last) {
    grad_issue<kWindow>(a, grad_tile(a, first), chunk, win, stage, gbuf);
    cp_async_commit();
  }

  float dw[kGradSlots][4];
#pragma unroll
  for (int s = 0; s < kGradSlots; ++s) dw[s][0] = dw[s][1] = dw[s][2] = dw[s][3] = 0.0f;

  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const GradTile tt = grad_tile(a, tile);
    const int cur = it & 1;
    bf16* gb = gbuf + cur * g_elems;
    const bf16* wb = win + cur * win_elems;
    int* cnt = cs + cur * (a.npix + 1);
    cp_async_wait<0>();
    __syncthreads();  // this tile's copies are in; the last tile's phase C is done

    // T: the table, and the corners' counts a window pixel
    for (int e = threadIdx.x; e < a.pt; e += kGradThreads) {
      const int p = e / a.by_taps, t = e - p * a.taps;
      int i, j;
      tile_pos(a, tt, p, i, j);
      int4 ent = make_int4(-1, 0, 0, 0);
      if (i < a.ho && j < a.wo) {
        const int ty = t / a.by_kw;
        const Corner q = corner_at(stage[2 * e], stage[2 * e + 1], ty, t - ty * a.kw, i * a.stride - a.pad,
                                   j * a.stride - a.pad, a.kh, a.kw, a.h, a.w, a.window);
        if (q.valid) {
          if (kWindow) {
            const int base = (q.y0 - tt.wy0) * a.wc + (q.x0 - tt.wx0);  // the clamp keeps all four corners inside
            const int code = slope_code(q.gy) | slope_code(q.gx) << 2 | int(q.hy) << 4 | int(q.hx) << 5;
            ent.x = base | code << 24;
            if (gather) {
              atomicAdd(cnt + base, 1);
              atomicAdd(cnt + base + 1, 1);
              atomicAdd(cnt + base + a.wc, 1);
              atomicAdd(cnt + base + a.wc + 1, 1);
            }
          } else {
            ent.x = (q.y0 + 1) | (q.x0 + 1) << 16;  // -1 <= y0 < H, -1 <= x0 < W
          }
          ent.y = __float_as_int(q.ly);
          ent.z = __float_as_int(q.lx);
          ent.w = __float_as_int(masked ? round_to<bf16>(stage[2 * a.pt + e]) : 1.0f);
        }
      }
      table[e] = ent;
    }
    if (!a.g_async) {
      for (int e = threadIdx.x; e < a.m * a.co; e += kGradThreads) {
        const int p = e / a.co, k = e - p * a.co;
        int i, j;
        tile_pos(a, tt, p, i, j);
        const int g = k / a.o_g;
        gb[p * a.row_g + g * a.ogp + k - g * a.o_g] =
            i < a.ho && j < a.wo ? a.grad[((size_t(tt.b) * a.ho + i) * a.wo + j) * a.c_out + size_t(chunk) * a.co + k]
                                 : __float2bfloat16_rn(0.0f);
      }
    }
    __syncthreads();  // the table, counts and grad_out are in; the staged offsets are free

    // B1: the counts scanned; grad_col on the tensor cores; the next tile's copies
    if (gather) {
      int* other = cs + (cur ^ 1) * (a.npix + 1);
      for (int e = threadIdx.x; e <= a.npix; e += kGradThreads) other[e] = 0;
      const int lo = min(int(threadIdx.x) * a.scan_per, a.npix), hi = min(lo + a.scan_per, a.npix);
      int sum = 0;
      for (int k = lo; k < hi; ++k) sum += cnt[k];
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      int run = incl - sum;
      for (int k = lo; k < hi; ++k) {
        const int c = cnt[k];
        cnt[k] = run;
        run += c;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    if (want_grad) {
      // a warp takes a run of (16 positions, group, 8 (tap, channel)) units,
      // two at a time, walking them in order so that only the first needs
      // divisions
      const int nt_g = a.by_ntg.d;  // n-tiles of (tap, channel) a group
      const int units = (a.m / 16) * a.gc * nt_g;
      const int per_warp = (units + kGradWarps - 1) / kGradWarps;
      const int u0 = warp * per_warp, u1 = min(u0 + per_warp, units);
      int r = u0 / a.by_ntg;
      int nt = u0 - r * nt_g;
      int mt = r / a.gc;
      int g = r - mt * a.gc;
      for (int u = u0; u < u1; u += 2) {
        int un[2][3];  // (mt, g, nt) of the two units
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          un[v][0] = mt, un[v][1] = g, un[v][2] = nt;
          if (++nt == nt_g) {
            nt = 0;
            if (++g == a.gc) {
              g = 0;
              ++mt;
            }
          }
        }
        const bool two = u + 1 < u1;
        float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v == 1 && !two) break;
          const bf16* arow = gb + (un[v][0] * 16) * a.row_g + un[v][1] * a.ogp;
          const unsigned a_addr = smem_addr(arow + ((lane & 7) + ((lane >> 3) & 1) * 8) * a.row_g + (lane >> 4) * 8);
          const unsigned b_addr =
              smem_addr(sw + (un[v][1] * a.kp + un[v][2] * 8 + (lane & 7)) * a.row_w + ((lane >> 3) & 1) * 8);
          int k = 0;
#pragma unroll 1
          for (; k + 16 <= a.ogp; k += 16) {
            unsigned a0, a1, a2, a3, b0, b1;
            ldmatrix_x4(a_addr + k * 2, a0, a1, a2, a3);
            ldmatrix_x2(b_addr + k * 2, b0, b1);
            mma_bf16(acc[v], a0, a1, a2, a3, b0, b1);
          }
          if (k < a.ogp) {  // o_g padded to 8, not 16: one k8 step
            unsigned a0, a1, b0;
            ldmatrix_x2(smem_addr(arow + (lane & 15) * a.row_g + k), a0, a1);
            ldmatrix_x1(b_addr + k * 2, b0);
            mma_bf16_k8(acc[v], a0, a1, b0);
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v == 1 && !two) break;
          const int n = un[v][2] * 8 + (lane & 3) * 2;
          const int t = n / a.by_cg;
          if (t < a.taps) {
            float* dst = gcol + ((un[v][0] * 16 + (lane >> 2)) * a.taps + t) * a.gcs + un[v][1] * a.c_g + n - t * a.c_g;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[v][0], acc[v][1]);
            *reinterpret_cast<float2*>(dst + 8 * a.taps * a.gcs) = make_float2(acc[v][2], acc[v][3]);
          }
        }
      }
    }
    if (tile + 1 < last) {
      grad_issue<kWindow>(a, grad_tile(a, tile + 1), chunk, win + (cur ^ 1) * win_elems, stage,
                          gbuf + (cur ^ 1) * g_elems);
      cp_async_commit();
    }
    __syncthreads();  // the scanned counts and grad_col are in

    // B2: the lists; a pass over (position, tap, 8 channels)
    int wbase[kGradWarps];  // where each warp's run of the lists starts
    if (gather) {
      int run = 0;
#pragma unroll
      for (int k = 0; k < kGradWarps; ++k) {
        wbase[k] = run;
        run += wsum[k];
      }
      if (threadIdx.x == 0) *total = run;
      for (int e = threadIdx.x; e < a.pt; e += kGradThreads) {
        const int4 ent = table[e];
        if (ent.x < 0) continue;
        const int base = ent.x & 0xffffff;
        const float ly = __int_as_float(ent.y), lx = __int_as_float(ent.z);
        const float hy = 1.0f - ly, hx = 1.0f - lx;
        const float mk = __int_as_float(ent.w);
        const int pk[4] = {base, base + 1, base + a.wc, base + a.wc + 1};
        const float wk[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pos = atomicAdd(cnt + pk[k], 1) + warp_base(a, wbase, pk[k]);
          list[pos] = make_int2(e * a.gcs | pk[k] << 20, __float_as_int(masked ? wk[k] * mk : wk[k]));
        }
      }
    }
    {
      const int q = threadIdx.x & (a.nq - 1);
      const int step = kGradThreads >> a.lg_nq;
      const int e_in = threadIdx.x >> a.lg_nq;
      const bf16* xsrc = a.x + size_t(tt.b) * a.h * a.w * a.c + size_t(chunk) * a.cc + q * 8;
      const int g_lo = (q * 8) / a.by_cg, g_hi = (q * 8 + 4) / a.by_cg;
      const int col_lo = g_lo * a.kp + q * 8 - g_lo * a.c_g;
      const int col_hi = g_hi * a.kp + q * 8 + 4 - g_hi * a.c_g;
      const bool whole = (a.c_g & 7) == 0;
      for (int e0 = 0; e0 < a.pt; e0 += step) {
        const int e = e0 + e_in;
        float sy = 0.0f, sx = 0.0f, sm = 0.0f;
        int4 ent = make_int4(-1, 0, 0, 0);
        if (e < a.pt) ent = table[e];
        const int p = e / a.by_taps, t = e - p * a.taps;
        uint4 s = make_uint4(0, 0, 0, 0);
        if (ent.x >= 0) {
          const float ly = __int_as_float(ent.y), lx = __int_as_float(ent.z), mk = __int_as_float(ent.w);
          const float hy = 1.0f - ly, hx = 1.0f - lx;
          const float4 wq = make_float4(hy * hx, hy * lx, ly * hx, ly * lx);
          uint4 c00, c01, c10, c11;
          int y0 = 0, x0 = 0;
          if (kWindow) {
            const bf16* s0 = wb + (ent.x & 0xffffff) * a.win_px + q * 8;
            c00 = *reinterpret_cast<const uint4*>(s0);
            c01 = *reinterpret_cast<const uint4*>(s0 + a.win_px);
            c10 = *reinterpret_cast<const uint4*>(s0 + a.wc * a.win_px);
            c11 = *reinterpret_cast<const uint4*>(s0 + (a.wc + 1) * a.win_px);
          } else {
            y0 = (ent.x & 0xffff) - 1;
            x0 = (ent.x >> 16) - 1;
            const bool y0in = y0 >= 0, y1in = y0 + 1 < a.h, x0in = x0 >= 0, x1in = x0 + 1 < a.w;
            const uint4 z = make_uint4(0, 0, 0, 0);
            const bf16* s0 = xsrc + (1LL * y0 * a.w + x0) * a.c;
            c00 = y0in && x0in ? __ldg(reinterpret_cast<const uint4*>(s0)) : z;
            c01 = y0in && x1in ? __ldg(reinterpret_cast<const uint4*>(s0 + a.c)) : z;
            c10 = y1in && x0in ? __ldg(reinterpret_cast<const uint4*>(s0 + size_t(a.w) * a.c)) : z;
            c11 = y1in && x1in ? __ldg(reinterpret_cast<const uint4*>(s0 + size_t(a.w + 1) * a.c)) : z;
          }
          const unsigned* p00 = reinterpret_cast<const unsigned*>(&c00);
          const unsigned* p01 = reinterpret_cast<const unsigned*>(&c01);
          const unsigned* p10 = reinterpret_cast<const unsigned*>(&c10);
          const unsigned* p11 = reinterpret_cast<const unsigned*>(&c11);
          float gv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          if (want_grad) {
            const float4 ga = *reinterpret_cast<const float4*>(gcol + e * a.gcs + q * 8);
            const float4 gz = *reinterpret_cast<const float4*>(gcol + e * a.gcs + q * 8 + 4);
            gv[0] = ga.x, gv[1] = ga.y, gv[2] = ga.z, gv[3] = ga.w, gv[4] = gz.x, gv[5] = gz.y, gv[6] = gz.z, gv[7] = gz.w;
          }
          // the samples, and the channel sums of grad_s times each corner
          float colv[8], s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const unsigned w00 = p00[u >> 1], w01 = p01[u >> 1], w10 = p10[u >> 1], w11 = p11[u >> 1];
            const bool odd = u & 1;
            const float v00 = odd ? hi_bf16(w00) : lo_bf16(w00), v01 = odd ? hi_bf16(w01) : lo_bf16(w01);
            const float v10 = odd ? hi_bf16(w10) : lo_bf16(w10), v11 = odd ? hi_bf16(w11) : lo_bf16(w11);
            const float sb = round_to<bf16>(blend(wq, v00, v01, v10, v11));  // the forward's sample
            colv[u] = masked ? __fmul_rn(sb, mk) : sb;
            const float gs = masked ? gv[u] * mk : gv[u];
            s00 = fmaf(gs, v00, s00);
            s01 = fmaf(gs, v01, s01);
            s10 = fmaf(gs, v10, s10);
            s11 = fmaf(gs, v11, s11);
            if (masked) sm = fmaf(gv[u], sb, sm);
          }
          s = make_uint4(pack_bf16(colv[0], colv[1]), pack_bf16(colv[2], colv[3]), pack_bf16(colv[4], colv[5]),
                         pack_bf16(colv[6], colv[7]));
          // d/d(ly) = hx (hy' v10 - v00) + lx (hy' v11 - v01), d/d(lx) alike, summed over the channels
          const int code = ent.x >> 24;
          const float ky = kWindow ? float((code >> 4) & 1) : 1.0f, kx = kWindow ? float((code >> 5) & 1) : 1.0f;
          sy = hx * (ky * s10 - s00) + lx * (ky * s11 - s01);
          sx = hy * (kx * s01 - s00) + ly * (kx * s11 - s10);
          if (!kWindow && a.dx != nullptr) {  // D = 0: each corner's share straight to dx
            const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int y = y0 + (k >> 1), xx = x0 + (k & 1);
              if (y < 0 || y >= a.h || xx < 0 || xx >= a.w) continue;
              const float f = masked ? wk[k] * mk : wk[k];
              float* d = a.dx + ((size_t(tt.b) * a.h + y) * a.w + xx) * a.c + size_t(chunk) * a.cc + q * 8;
              atomicAdd(reinterpret_cast<float4*>(d), make_float4(f * gv[0], f * gv[1], f * gv[2], f * gv[3]));
              atomicAdd(reinterpret_cast<float4*>(d + 4), make_float4(f * gv[4], f * gv[5], f * gv[6], f * gv[7]));
            }
          }
        }
        if (want_dw && e < a.pt) {  // an invalid sample's columns are zeros
          bf16* row = cols + p * a.row_c + t * a.c_g;
          if (whole) {
            *reinterpret_cast<uint4*>(row + col_lo) = s;
          } else {
            *reinterpret_cast<uint2*>(row + col_lo) = make_uint2(s.x, s.y);
            *reinterpret_cast<uint2*>(row + col_hi) = make_uint2(s.z, s.w);
          }
        }
        if (a.doff == nullptr && a.dmask == nullptr) continue;
        for (int d = 1; d < a.nq; d <<= 1) {  // the sums over the chunk's channels
          sy += __shfl_xor_sync(0xffffffffu, sy, d);
          sx += __shfl_xor_sync(0xffffffffu, sx, d);
          sm += __shfl_xor_sync(0xffffffffu, sm, d);
        }
        if (q != 0 || ent.x < 0) continue;
        int i, j;
        tile_pos(a, tt, p, i, j);
        const size_t at = (size_t(tt.b) * a.ho + i) * a.wo + j;
        const int code = ent.x >> 24;
        if (a.doff != nullptr) {
          const float2 v = kWindow ? make_float2(sy * slope_of(code & 3), sx * slope_of((code >> 2) & 3))
                                   : make_float2(sy, sx);
          float2* d = reinterpret_cast<float2*>(a.doff + (at * a.taps + t) * 2);
          if (a.chunks == 1) *d = v;
          else atomicAdd(d, v);
        }
        if (a.dmask != nullptr) {
          float* d = a.dmask + at * a.taps + t;
          if (a.chunks == 1) *d = sm;
          else atomicAdd(d, sm);
        }
      }
    }
    __syncthreads();  // the columns and the lists are in

    // C: dW += columns^T . grad_out; dx gathered a window pixel at a time
    if (want_dw) {
#pragma unroll
      for (int s = 0; s < kGradSlots; ++s) {
        const int u = warp + s * kGradWarps;
        if (u >= a.dw_units) break;
        const int r = u / a.by_dwnt, nt = u - r * a.dw_nt;
        const int g = r / a.by_dwmt, mt = r - g * a.dw_mt;
        const unsigned a_addr = smem_addr(cols + (((lane >> 4) & 1) * 8 + (lane & 7)) * a.row_c + g * a.kp + mt * 16 +
                                          ((lane >> 3) & 1) * 8);
        const unsigned b_addr = smem_addr(gb + (((lane >> 3) & 1) * 8 + (lane & 7)) * a.row_g + g * a.ogp + nt * 8);
#pragma unroll 1
        for (int k = 0; k < a.m; k += 16) {
          unsigned a0, a1, a2, a3, b0, b1;
          ldmatrix_x4_trans(a_addr + k * a.row_c * 2, a0, a1, a2, a3);
          ldmatrix_x2_trans(b_addr + k * a.row_g * 2, b0, b1);
          mma_bf16(dw[s], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    if (gather) {
      // the lists in equal runs, one a thread and 8 channels: the sums go to
      // dx wherever the run's pixel changes, and at its end
      const int n = *total;
      const int per = (n + (kGradThreads >> a.lg_nq) - 1) / (kGradThreads >> a.lg_nq);
      const int q8 = (threadIdx.x & (a.nq - 1)) * 8;
      const int k0 = (threadIdx.x >> a.lg_nq) * per, k1 = min(k0 + per, n);
      float* dx_img = a.dx + size_t(tt.b) * a.h * a.w * a.c + size_t(chunk) * a.cc + q8;
      int pix = -1;
      float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s1 = s0;
      for (int k = k0; k <= k1; ++k) {
        const int2 v = k < k1 ? list[k] : make_int2(-1, 0);
        if ((v.x >> 20) != pix) {
          if (pix >= 0) {
            const int wy = pix / a.by_wc;
            const int y = tt.wy0 + wy, xx = tt.wx0 + pix - wy * a.wc;
            if (y >= 0 && y < a.h && xx >= 0 && xx < a.w) {
              float* d = dx_img + (size_t(y) * a.w + xx) * a.c;
              atomicAdd(reinterpret_cast<float4*>(d), s0);
              atomicAdd(reinterpret_cast<float4*>(d + 4), s1);
            }
          }
          pix = v.x >> 20;
          s0 = s1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        if (k == k1) break;
        const float* g = gcol + (v.x & 0xfffff) + q8;
        const float4 g0 = *reinterpret_cast<const float4*>(g), g1 = *reinterpret_cast<const float4*>(g + 4);
        const float w = __int_as_float(v.y);
        s0 = make_float4(fmaf(w, g0.x, s0.x), fmaf(w, g0.y, s0.y), fmaf(w, g0.z, s0.z), fmaf(w, g0.w, s0.w));
        s1 = make_float4(fmaf(w, g1.x, s1.x), fmaf(w, g1.y, s1.y), fmaf(w, g1.z, s1.z), fmaf(w, g1.w, s1.w));
      }
    }
  }

  if (!want_dw) return;
  float* out = a.part + size_t(split) * a.c_out * a.c_g * a.taps;
#pragma unroll
  for (int s = 0; s < kGradSlots; ++s) {
    const int u = warp + s * kGradWarps;
    if (u >= a.dw_units) break;
    const int r = u / a.by_dwnt, nt = u - r * a.dw_nt;
    const int g = r / a.by_dwmt, mt = r - g * a.dw_mt;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = mt * 16 + (lane >> 2) + (k >> 1) * 8;  // tap * c_g + channel
      const int o = nt * 8 + (lane & 3) * 2 + (k & 1);
      if (row >= a.taps * a.c_g || o >= a.o_g) continue;
      const int t = row / a.by_cg, c = row - t * a.c_g;
      out[((size_t(chunk) * a.co + g * a.o_g + o) * a.c_g + c) * a.taps + t] = dw[s][k];
    }
  }
}

__global__ void deform_grad_cast_kernel(const float* acc, __nv_bfloat16* out, long long size) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < size; i += 256LL * gridDim.x)
    out[i] = __float2bfloat16_rn(acc[i]);
}

template <bool kWindow>
int launch_grad_bf16_kernel(const GradPlan& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(deform_grad_bf16_kernel<kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return int(err);
  deform_grad_bf16_kernel<kWindow><<<unsigned(a.chunks * a.splits), kGradThreads, a.smem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch_grad_bf16(GradPlan a, void* dx_out, void* dweight, cudaStream_t stream) {
  int err = a.window > 0 ? launch_grad_bf16_kernel<true>(a, stream) : launch_grad_bf16_kernel<false>(a, stream);
  if (err) return err;
  if (a.part != nullptr &&
      (err = launch_weight_sum<bf16>(a.part, dweight, a.splits, a.c_out * a.c_g * a.taps, stream)))
    return err;
  if (dx_out != nullptr) {
    const long long size = 1LL * a.b * a.h * a.w * a.c;
    const long long blocks = (size + 255) / 256;
    deform_grad_cast_kernel<<<unsigned(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        a.dx, static_cast<bf16*>(dx_out), size);
    return int(cudaGetLastError());
  }
  return int(cudaSuccess);
}

// ---------------------------------------------------------------------------
// The dense route: a layer of one group too wide for the grouped routes' plans
// (the single-stage heads' 256 -> 256 convolutions: one group's weights are
// 256 x 2304, its weight gradient 256 x 2304 sums). A block takes a tile of
// kDenseTile output positions of one image and walks the input channels
// kDenseCC at a time, the partial sums staying in registers: the forward
// holds kDenseOC outputs of the tile (blocks over the outputs sample the
// tile again), K7b's data pass a chunk's grad_col (the outputs walked
// kDenseOC at a time) and its weight pass kDenseOC x kDenseCC x taps
// weight-gradient sums over a range of tiles, written as a partial that
// `deform_grad_weight_sum_kernel` adds up in order. Samples blend as the
// other routes' (__fmul_rn / __fadd_rn, the plain version's order) and round
// to x's dtype; products on the CUDA cores in f32. v1 layers (no mask).

constexpr int kDenseTile = 32;  // output positions a block
constexpr int kDenseCC = 16;    // input channels a step
constexpr int kDenseOC = 64;    // output channels a block (forward, weight pass) or a step (data pass)
constexpr int kDenseRows = kDenseTile * kDenseOC / kThreads;  // outputs a thread sums in the forward

struct DenseArgs {
  const void* x;         // (B, H, W, C)
  const float* offsets;  // (B, Ho, Wo, 2 * taps)
  const void* weight;    // (C_out, C, kh, kw)
  const void* grad;      // (B, Ho, Wo, C_out): the forward's output or K7b's grad_out
  void* out;             // the forward's output
  float* dx;             // (B, H, W, C) f32, zeroed; null: none
  float* doff;           // (B, Ho, Wo, 2 * taps) f32, zeroed; null: none
  float* part;           // (splits, C_out, C, kh, kw) f32; null: no weight gradient
  int h, w, c, ho, wo, c_out, kh, kw, taps, stride, pad, window, tiles, splits, per_split;
};

// Corner indices (-1 outside the image) and bilinear weights of the
// (position, tap) pairs of a tile of one image, into shared memory.
__device__ __forceinline__ void dense_corners(const DenseArgs& a, int b, int p0, int4* corner, float4* cweight) {
  const int hw_out = a.ho * a.wo;
  for (int e = threadIdx.x; e < kDenseTile * a.taps; e += blockDim.x) {
    const int p = e / a.taps;
    const int t = e - p * a.taps;
    const int pos = p0 + p;
    int4 q = make_int4(-1, -1, -1, -1);
    float4 wq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (pos < hw_out) {
      const int i = pos / a.wo;
      const int j = pos - i * a.wo;
      const Corner cq = corner_of(a.offsets, b * hw_out + pos, t, a.taps, a.kw, i * a.stride - a.pad,
                                  j * a.stride - a.pad, a.h, a.w, a.window);
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
  }
}

// The samples of input channels c0 .. c0 + kDenseCC of the tile, rounded to
// T, as cols[p][t][cc] (0 past C).
template <typename T>
__device__ __forceinline__ void dense_samples(const DenseArgs& a, const T* x, int c0, const int4* corner,
                                              const float4* cweight, float* cols) {
  const int n = kDenseTile * a.taps * kDenseCC;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k = e / kDenseCC;
    const int c = c0 + (e - k * kDenseCC);
    float s = 0.0f;
    if (c < a.c) {
      const int4 q = corner[k];
      const float4 wq = cweight[k];
      const float v0 = q.x >= 0 ? to_float(x[size_t(q.x) * a.c + c]) : 0.0f;
      const float v1 = q.y >= 0 ? to_float(x[size_t(q.y) * a.c + c]) : 0.0f;
      const float v2 = q.z >= 0 ? to_float(x[size_t(q.z) * a.c + c]) : 0.0f;
      const float v3 = q.w >= 0 ? to_float(x[size_t(q.w) * a.c + c]) : 0.0f;
      s = __fmul_rn(wq.x, v0);
      s = __fadd_rn(s, __fmul_rn(wq.y, v1));
      s = __fadd_rn(s, __fmul_rn(wq.z, v2));
      s = __fadd_rn(s, __fmul_rn(wq.w, v3));
      s = round_to<T>(s);
    }
    cols[e] = s;
  }
}

inline size_t dense_forward_bytes(int taps) {
  return size_t(kDenseTile) * taps * (16 + 16 + 4 * kDenseCC) + size_t(taps) * kDenseCC * kDenseOC * 4;
}

// K7, dense: grid (B x tiles, output blocks of kDenseOC).
template <typename T>
__global__ void __launch_bounds__(kThreads) deform_dense_kernel(DenseArgs a) {
  extern __shared__ float4 smem4[];
  const int pt = kDenseTile * a.taps;
  int4* corner = reinterpret_cast<int4*>(smem4);
  float4* cweight = smem4 + pt;
  float* cols = reinterpret_cast<float*>(smem4 + 2 * pt);  // [p][t][cc]
  float* wts = cols + pt * kDenseCC;                         // [t][cc][o]
  const int b = blockIdx.x / a.tiles;
  const int p0 = (blockIdx.x - b * a.tiles) * kDenseTile;
  const int o0 = blockIdx.y * kDenseOC;
  const int hw_out = a.ho * a.wo;
  const T* x = static_cast<const T*>(a.x) + size_t(b) * a.h * a.w * a.c;
  const T* weight = static_cast<const T*>(a.weight);
  dense_corners(a, b, p0, corner, cweight);

  // this thread's output o, at positions pr, pr + kStep, ...
  constexpr int kStep = kThreads / kDenseOC;
  const int o = threadIdx.x % kDenseOC;
  const int pr = threadIdx.x / kDenseOC;
  float acc[kDenseRows];
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) acc[r] = 0.0f;
  const int nw = a.taps * kDenseCC * kDenseOC;
  for (int c0 = 0; c0 < a.c; c0 += kDenseCC) {
    __syncthreads();  // the corners are in; the last step's products are done with cols and wts
    dense_samples<T>(a, x, c0, corner, cweight, cols);
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int oo = e % kDenseOC;
      const int tc = e / kDenseOC;
      const int cc = tc % kDenseCC;
      const int t = tc / kDenseCC;
      const int c = c0 + cc;
      wts[e] = c < a.c && o0 + oo < a.c_out ? to_float(weight[(size_t(o0 + oo) * a.c + c) * a.taps + t]) : 0.0f;
    }
    __syncthreads();
    for (int tc = 0; tc < a.taps * kDenseCC; ++tc) {
      const float wv = wts[tc * kDenseOC + o];
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r) acc[r] = acc[r] + cols[(pr + r * kStep) * a.taps * kDenseCC + tc] * wv;
    }
  }
  T* out = static_cast<T*>(a.out);
  if (o0 + o >= a.c_out) return;
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    const int pos = p0 + pr + r * kStep;
    if (pos < hw_out) out[(size_t(b) * hw_out + pos) * a.c_out + o0 + o] = from_float<T>(acc[r]);
  }
}

constexpr int kDenseCols = kDenseTile * 9 * kDenseCC / kThreads;  // grad_col sums a thread holds (3 x 3 taps)

inline size_t dense_data_bytes(int taps) {
  return (size_t(kDenseTile) * kDenseOC + size_t(kDenseOC) * taps * kDenseCC + size_t(kDenseTile) * taps * kDenseCC) * 4;
}

// K7b's data pass, dense: grid (B x tiles, input chunks of kDenseCC). grad_col
// of the chunk's channels (the outputs walked kDenseOC at a time), then a
// thread a (position, tap): the offsets' gradient summed over the chunk's
// channels (one atomic a chunk) and dx's four shares a channel (atomics).
template <typename T>
__global__ void __launch_bounds__(kThreads) deform_dense_data_kernel(DenseArgs a) {
  extern __shared__ float4 smem4[];
  float* gt = reinterpret_cast<float*>(smem4);  // [p][o]: the tile's grad_out rows, kDenseOC of them
  float* wt = gt + kDenseTile * kDenseOC;        // [o][t][cc]
  float* gcol = wt + kDenseOC * a.taps * kDenseCC;  // [p][t][cc]
  const int b = blockIdx.x / a.tiles;
  const int p0 = (blockIdx.x - b * a.tiles) * kDenseTile;
  const int c0 = blockIdx.y * kDenseCC;
  const int hw_out = a.ho * a.wo;
  const int tcn = a.taps * kDenseCC;
  const T* grad = static_cast<const T*>(a.grad);
  const T* weight = static_cast<const T*>(a.weight);
  float acc[kDenseCols];
#pragma unroll
  for (int k = 0; k < kDenseCols; ++k) acc[k] = 0.0f;
  for (int o0 = 0; o0 < a.c_out; o0 += kDenseOC) {
    __syncthreads();
    for (int e = threadIdx.x; e < kDenseTile * kDenseOC; e += blockDim.x) {
      const int p = e / kDenseOC, o = o0 + e % kDenseOC, pos = p0 + p;
      gt[e] = pos < hw_out && o < a.c_out ? to_float(grad[(size_t(b) * hw_out + pos) * a.c_out + o]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kDenseOC * tcn; e += blockDim.x) {
      const int oo = e / tcn, tc = e - oo * tcn, t = tc / kDenseCC, c = c0 + tc % kDenseCC, o = o0 + oo;
      wt[e] = o < a.c_out && c < a.c ? to_float(weight[(size_t(o) * a.c + c) * a.taps + t]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDenseCols; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int p = e / tcn, tc = e - p * tcn;
      float s = acc[k];
      for (int oo = 0; oo < kDenseOC; ++oo) s = s + gt[p * kDenseOC + oo] * wt[oo * tcn + tc];
      acc[k] = s;
    }
  }
#pragma unroll
  for (int k = 0; k < kDenseCols; ++k) gcol[threadIdx.x + k * kThreads] = acc[k];
  __syncthreads();

  const T* x = static_cast<const T*>(a.x) + size_t(b) * a.h * a.w * a.c;
  float* dx = a.dx == nullptr ? nullptr : a.dx + size_t(b) * a.h * a.w * a.c;
  for (int e = threadIdx.x; e < kDenseTile * a.taps; e += blockDim.x) {
    const int p = e / a.taps, t = e - p * a.taps, pos = p0 + p;
    if (pos >= hw_out) continue;
    const int i = pos / a.wo, j = pos - i * a.wo, at = b * hw_out + pos;
    const Corner q = corner_of(a.offsets, at, t, a.taps, a.kw, i * a.stride - a.pad, j * a.stride - a.pad, a.h,
                               a.w, a.window);
    if (!q.valid) continue;
    const bool y0in = q.y0 >= 0 && q.y0 < a.h, y1in = q.y0 + 1 >= 0 && q.y0 + 1 < a.h;
    const bool x0in = q.x0 >= 0 && q.x0 < a.w, x1in = q.x0 + 1 >= 0 && q.x0 + 1 < a.w;
    const int i00 = y0in && x0in ? q.y0 * a.w + q.x0 : -1;
    const int i01 = y0in && x1in ? q.y0 * a.w + q.x0 + 1 : -1;
    const int i10 = y1in && x0in ? (q.y0 + 1) * a.w + q.x0 : -1;
    const int i11 = y1in && x1in ? (q.y0 + 1) * a.w + q.x0 + 1 : -1;
    const float hy = 1.0f - q.ly, hx = 1.0f - q.lx;
    float d_ly = 0.0f, d_lx = 0.0f;
    for (int cc = 0; cc < kDenseCC; ++cc) {
      const int c = c0 + cc;
      if (c >= a.c) break;
      const float g = gcol[(p * a.taps + t) * kDenseCC + cc];
      const float v00 = i00 >= 0 ? to_float(x[size_t(i00) * a.c + c]) : 0.0f;
      const float v01 = i01 >= 0 ? to_float(x[size_t(i01) * a.c + c]) : 0.0f;
      const float v10 = i10 >= 0 ? to_float(x[size_t(i10) * a.c + c]) : 0.0f;
      const float v11 = i11 >= 0 ? to_float(x[size_t(i11) * a.c + c]) : 0.0f;
      d_ly += g * (hx * (q.hy * v10 - v00) + q.lx * (q.hy * v11 - v01));
      d_lx += g * (hy * (q.hx * v01 - v00) + q.ly * (q.hx * v11 - v10));
      if (dx != nullptr) {
        if (i00 >= 0) atomicAdd(dx + size_t(i00) * a.c + c, q.w.x * g);
        if (i01 >= 0) atomicAdd(dx + size_t(i01) * a.c + c, q.w.y * g);
        if (i10 >= 0) atomicAdd(dx + size_t(i10) * a.c + c, q.w.z * g);
        if (i11 >= 0) atomicAdd(dx + size_t(i11) * a.c + c, q.w.w * g);
      }
    }
    if (a.doff != nullptr) {
      atomicAdd(a.doff + size_t(at) * 2 * a.taps + 2 * t, d_ly * q.gy);
      atomicAdd(a.doff + size_t(at) * 2 * a.taps + 2 * t + 1, d_lx * q.gx);
    }
  }
}

constexpr int kDenseSums = kDenseOC * 9 * kDenseCC / kThreads;  // weight-gradient sums a thread holds (3 x 3)

inline size_t dense_weight_bytes(int taps) {
  return size_t(kDenseTile) * taps * (16 + 16 + 4 * kDenseCC) + size_t(kDenseTile) * kDenseOC * 4;
}

// K7b's weight pass, dense: grid (output blocks of kDenseOC, input chunks of
// kDenseCC, splits). Each block sums grad_out^T . cols over its range of
// tiles (a tile: kDenseTile positions of one image) and writes a partial.
template <typename T>
__global__ void __launch_bounds__(kThreads) deform_dense_weight_kernel(DenseArgs a) {
  extern __shared__ float4 smem4[];
  const int pt = kDenseTile * a.taps;
  int4* corner = reinterpret_cast<int4*>(smem4);
  float4* cweight = smem4 + pt;
  float* cols = reinterpret_cast<float*>(smem4 + 2 * pt);  // [p][t][cc]
  float* gt = cols + pt * kDenseCC;                          // [p][o]
  const int o0 = blockIdx.x * kDenseOC;
  const int c0 = blockIdx.y * kDenseCC;
  const int hw_out = a.ho * a.wo;
  const int tcn = a.taps * kDenseCC;
  const T* grad = static_cast<const T*>(a.grad);
  float acc[kDenseSums];
#pragma unroll
  for (int k = 0; k < kDenseSums; ++k) acc[k] = 0.0f;
  // a.tiles: the tiles of all images, kDenseTile positions of one image each
  const int per_image = (hw_out + kDenseTile - 1) / kDenseTile;
  const int first = blockIdx.z * a.per_split;
  const int last = min(first + a.per_split, a.tiles);
  for (int tile = first; tile < last; ++tile) {
    const int b = tile / per_image;
    const int p0 = (tile - b * per_image) * kDenseTile;
    __syncthreads();  // the last tile's products are done with cols and gt
    dense_corners(a, b, p0, corner, cweight);
    for (int e = threadIdx.x; e < kDenseTile * kDenseOC; e += blockDim.x) {
      const int p = e / kDenseOC, o = o0 + e % kDenseOC, pos = p0 + p;
      gt[e] = pos < hw_out && o < a.c_out ? to_float(grad[(size_t(b) * hw_out + pos) * a.c_out + o]) : 0.0f;
    }
    __syncthreads();
    dense_samples<T>(a, static_cast<const T*>(a.x) + size_t(b) * a.h * a.w * a.c, c0, corner, cweight, cols);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDenseSums; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int oo = e / tcn, tc = e - oo * tcn;
      float s = acc[k];
      for (int p = 0; p < kDenseTile; ++p) s = s + gt[p * kDenseOC + oo] * cols[p * tcn + tc];
      acc[k] = s;
    }
  }
  float* out = a.part + size_t(blockIdx.z) * a.c_out * a.c * a.taps;
#pragma unroll
  for (int k = 0; k < kDenseSums; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int oo = e / tcn, tc = e - oo * tcn, t = tc / kDenseCC, c = c0 + tc % kDenseCC;
    if (o0 + oo < a.c_out && c < a.c) out[(size_t(o0 + oo) * a.c + c) * a.taps + t] = acc[k];
  }
}

template <typename T>
int launch_dense_forward(DenseArgs a, int b, cudaStream_t stream) {
  const size_t smem = dense_forward_bytes(a.taps);
  cudaError_t err = cudaFuncSetAttribute(deform_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(b * a.tiles), unsigned((a.c_out + kDenseOC - 1) / kDenseOC));
  deform_dense_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dense_backward(DenseArgs a, int b, void* dx_out, void* dweight, cudaStream_t stream) {
  cudaError_t err;
  if (a.dx != nullptr || a.doff != nullptr) {
    const size_t smem = dense_data_bytes(a.taps);
    err = cudaFuncSetAttribute(deform_dense_data_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    const dim3 grid(unsigned(b * a.tiles), unsigned((a.c + kDenseCC - 1) / kDenseCC));
    deform_dense_data_kernel<T><<<grid, kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (a.part != nullptr) {
    const size_t smem = dense_weight_bytes(a.taps);
    err = cudaFuncSetAttribute(deform_dense_weight_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    DenseArgs wa = a;
    wa.tiles = b * a.tiles;  // the weight pass walks the tiles of all images
    wa.per_split = (wa.tiles + a.splits - 1) / a.splits;
    const dim3 grid(unsigned((a.c_out + kDenseOC - 1) / kDenseOC), unsigned((a.c + kDenseCC - 1) / kDenseCC),
                    unsigned(a.splits));
    deform_dense_weight_kernel<T><<<grid, kThreads, smem, stream>>>(wa);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    if ((err = cudaError_t(launch_weight_sum<T>(a.part, dweight, a.splits, a.c_out * a.c * a.taps, stream))))
      return int(err);
  }
  if (dx_out != nullptr) {
    const long long size = 1LL * b * a.h * a.w * a.c;
    const long long blocks = (size + 255) / 256;
    deform_grad_cast_kernel<<<unsigned(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        a.dx, static_cast<bf16*>(dx_out), size);
    return int(cudaGetLastError());
  }
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

// dtype 0: f32, 1: bf16 (x, weight and out). The weight is (C_out, c_g, kh,
// kw) for f32 and (C_out, kh, kw, c_g) for bf16. offsets and mask f32; mask
// may be null (v1). window: D (0: no clamp). th, tw, cc, nch, smem: the bf16
// route's launch plan (ops/deform_conv.py `launch_plan`; the f32 route
// ignores them). dense 1 takes the dense route (one group, 3 x 3, no mask),
// in either dtype, with the weight (C_out, C, kh, kw). The f32 route plans
// for itself: it takes the dense route too where the layer may take it and
// its own block's layout (`shared_layout`) does not fit.
int bags_deform_conv_forward(int dtype, const void* x, const float* offsets, const float* mask,
                             const void* weight, void* out, int b, int h, int w, int c, int ho,
                             int wo, int c_out, int kh, int kw, int stride, int pad, int groups,
                             int window, int dense, int th, int tw, int cc, int nch, int smem,
                             cudaStream_t stream) {
  if (groups <= 0 || c % groups || c_out % groups) return int(cudaErrorInvalidValue);
  const bool dense_ok = groups == 1 && kh * kw == 9 && mask == nullptr;
  if (dtype == 0 && dense_ok && shared_layout(kh * kw, c, c_out, 1, sizeof(float)) > kMaxShared) dense = 1;
  if (dense) {
    if (!dense_ok || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
    DenseArgs a{x, offsets, weight, nullptr, out, nullptr, nullptr, nullptr, h, w, c, ho, wo, c_out, kh, kw, kh * kw,
                stride, pad, window, (ho * wo + kDenseTile - 1) / kDenseTile, 0, 0};
    return dtype == 0 ? launch_dense_forward<float>(a, b, stream) : launch_dense_forward<bf16>(a, b, stream);
  }
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

// K7b. dtype 0: f32 x, weight and grad; 1: bf16. The weight is (C_out, c_g,
// kh, kw) in both. Each output pointer may be null, and then that gradient
// is not computed: dx_acc, (B, H, W, C) f32, zeroed here, receives dx (and
// dx_out, when not null, dx rounded to bf16); doff (B, Ho, Wo, 2 * taps) and
// dmask (B, Ho, Wo, taps), f32, zeroed here; part (splits, C_out, c_g, kh,
// kw) f32 scratch and dweight, in x's dtype, the weight's (both or neither).
// p0..p5, the plan, checked here: bf16, th, tw, groups a chunk, tiles a
// block, splits, shared memory bytes (ops/deform_conv.py `backward_plan`);
// f32, tp, gpc, oc, splits, and the two passes' shared memory bytes
// (`backward_plan_f32`). dense 1 takes the dense route (one group, 3 x 3,
// no mask) in either dtype, with p0 the weight pass's splits.
int bags_deform_conv_backward(int dtype, const void* x, const float* offsets, const float* mask,
                              const void* weight, const void* grad, float* dx_acc, void* dx_out, float* doff,
                              float* dmask, float* part, void* dweight, int b, int h, int w, int c, int ho,
                              int wo, int c_out, int kh, int kw, int stride, int pad, int groups, int window,
                              int dense, int p0, int p1, int p2, int p3, int p4, int p5, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  if (groups <= 0 || c % groups || c_out % groups || b <= 0 || ho <= 0 || wo <= 0) return int(cudaErrorInvalidValue);
  const long long n = 1LL * b * ho * wo;
  if (n > 0x7fffffffLL || 1LL * b * h * w > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if ((dmask != nullptr && mask == nullptr) || ((part == nullptr) != (dweight == nullptr)) ||
      (dx_out != nullptr && (dx_acc == nullptr || dtype != 1)))
    return int(cudaErrorInvalidValue);
  const int taps = kh * kw;
  GradArgs f{};
  GradPlan a{};
  DenseArgs d{};
  if (dense) {
    if (groups != 1 || taps != 9 || mask != nullptr || p0 <= 0) return int(cudaErrorInvalidValue);
    d = DenseArgs{x, offsets, weight, grad, nullptr, dx_acc, doff, part, h, w, c, ho, wo, c_out, kh, kw, taps,
                  stride, pad, window, (ho * wo + kDenseTile - 1) / kDenseTile, p0, 0};
  } else if (dtype == 0) {
    // the plan must be one these kernels run, and the wrapper's shared memory theirs
    f.x = static_cast<const float*>(x), f.offsets = offsets, f.mask = mask;
    f.weight = static_cast<const float*>(weight), f.grad = static_cast<const float*>(grad);
    f.dx = dx_acc, f.doff = doff, f.dmask = dmask, f.part = part, f.n = int(n);
    f.h = h, f.w = w, f.c = c, f.ho = ho, f.wo = wo, f.c_out = c_out, f.kh = kh, f.kw = kw, f.taps = taps;
    f.stride = stride, f.pad = pad, f.c_g = c / groups, f.o_g = c_out / groups, f.window = window;
    f.tp = p0, f.gpc = p1, f.oc = p2, f.splits = p3;
    const bool whole = f.oc % f.o_g == 0 && groups % (f.oc / f.o_g) == 0;
    if (f.tp <= 0 || f.gpc <= 0 || groups % f.gpc || c % 4 || f.c_g % 4 || f.oc <= 0 ||
        !(whole || f.o_g % f.oc == 0) || f.oc * taps * f.c_g > kGradThreads * kGradAcc || f.splits <= 0)
      return int(cudaErrorInvalidValue);
    if (grad_data_bytes(f) != p4 || grad_weight_bytes(f) != p5 || size_t(p4) > kMaxShared || size_t(p5) > kMaxShared)
      return int(cudaErrorInvalidValue);
    f.tiles = int((n + f.tp - 1) / f.tp);
    f.per_split = (f.tiles + f.splits - 1) / f.splits;
    if ((f.tiles + f.per_split - 1) / f.per_split != f.splits) return int(cudaErrorInvalidValue);
  } else {
    a.x = static_cast<const bf16*>(x), a.offsets = offsets, a.mask = mask;
    a.weight = static_cast<const bf16*>(weight), a.grad = static_cast<const bf16*>(grad);
    a.dx = dx_acc, a.doff = doff, a.dmask = dmask, a.part = part;
    a.b = b, a.h = h, a.w = w, a.c = c, a.ho = ho, a.wo = wo, a.c_out = c_out, a.kh = kh, a.kw = kw;
    a.stride = stride, a.pad = pad, a.c_g = c / groups, a.o_g = c_out / groups, a.window = window;
    a.th = p0, a.tw = p1, a.gc = p2, a.tpb = p3, a.splits = p4;
    if (a.th <= 0 || a.tw <= 0 || a.gc <= 0 || a.tpb <= 0 || groups % a.gc || a.c_g % 4 || (a.th * a.tw) % 16)
      return int(cudaErrorInvalidValue);
    lay_out_grad(a);
    if (a.cc % 8 || a.nq > 32 || (a.nq & (a.nq - 1)) || a.smem != p5 || size_t(p5) > kMaxShared ||
        a.dw_units > kGradWarps * kGradSlots || (window == 0 && (h >= 32767 || w >= 32767)) ||
        a.npix >= 2048 || a.pt * a.gcs >= (1 << 20))  // a list entry packs the pixel and the grad_col row
      return int(cudaErrorInvalidValue);
    a.chunks = groups / a.gc;
    a.tiles_y = (ho + a.th - 1) / a.th;
    a.tiles_x = (wo + a.tw - 1) / a.tw;
    a.tiles = b * a.tiles_y * a.tiles_x;
    a.by_tx = fast_div(a.tiles_x);
    a.by_txy = fast_div(a.tiles_y * a.tiles_x);
    if ((a.tiles + a.tpb - 1) / a.tpb != a.splits || 1LL * a.chunks * a.splits > 0x7fffffffLL)
      return int(cudaErrorInvalidValue);
    a.g_async = a.o_g % 8 == 0 && reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  }
  cudaError_t err;
  if (dx_acc != nullptr &&
      (err = cudaMemsetAsync(dx_acc, 0, size_t(b) * h * w * c * sizeof(float), stream)) != cudaSuccess)
    return int(err);
  if (doff != nullptr && (err = cudaMemsetAsync(doff, 0, size_t(n) * 2 * taps * sizeof(float), stream)) != cudaSuccess)
    return int(err);
  if (dmask != nullptr && (err = cudaMemsetAsync(dmask, 0, size_t(n) * taps * sizeof(float), stream)) != cudaSuccess)
    return int(err);
  if (dense)
    return dtype == 0 ? launch_dense_backward<float>(d, b, nullptr, dweight, stream)
                      : launch_dense_backward<bf16>(d, b, dx_out, dweight, stream);
  return dtype == 0 ? launch_grad_f32(f, dweight, stream) : launch_grad_bf16(a, dx_out, dweight, stream);
}

}  // extern "C"

BAGS_PACKED(bags_deform_conv_forward)
BAGS_PACKED(bags_deform_conv_backward)
