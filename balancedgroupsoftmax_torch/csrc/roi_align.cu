// Multi-level RoIAlign: K2 `bags_roi_align_forward` and its gradient, K2b
// `bags_roi_align_backward`.
//
// Replaces (JAX package pallas/roi_align.py):
//   K2  multilevel_roi_align_pallas (:511, via _forward :334, _kernel :108,
//       _compute_one_roi :218) -- TPU Pallas.
//   K2b its custom_vjp backward (:510-537, _bwd :700), which the TPU ran as
//       the XLA "dense2" contraction _bwd_dense (:569), no Pallas kernel.
//
// Semantics (ops/roi_align.py roi_align :67 and multilevel_roi_align_reference
// :113): each roi is pooled on the FPN level the caller routed it to
// (map_roi_levels, finest_scale 56); the roi spans [x1 * scale, (x2 + 1) * scale)
// and each of the S x S bins averages sample_num^2 bilinear samples at
// (i + 0.5) / sample_num offsets, with the reference CUDA kernel's boundary
// rules: a sample outside [-1, size] contributes 0, coordinates clamp at 0 and
// the last row / column collapses. Output (B, R, S, S, C) in the feature dtype,
// accumulated in f32 as the Pallas kernel does.
//
// Design: one thread per output element (b, r, ph, pw, c) with the channel
// fastest, so a warp reads 32 neighbouring channels of one NHWC pixel -- the
// features must be channels-last. Each thread recomputes its roi's bin
// geometry (a few flops) and gathers its 4 x sample_num^2 corner values.
//
// What bounds it on an H100: memory. The output is written once, 2 bytes (bf16)
// or 4 (f32) per element; the reads are 16 scattered-but-coalesced corner loads
// per element, mostly served by L1/L2 since neighbouring bins of one roi share
// pixels. The least traffic is one read of the pixels the rois touch and one
// write of the output.
//
// K2b computes the transpose: every sample adds w * g / sample_num^2 to the
// four corners it read, w the bilinear weight, with K2's sample positions,
// clamping and out-of-range rule. The TPU had no scatter worth the name and
// contracted dense (roi x level extent) interpolation matrices on the MXU
// instead; on the card the scatter is cheap, so one thread per (roi, bin,
// channel), channel fastest, atomically adds its samples' shares into one f32
// buffer that holds the whole pyramid level after level (each level
// (B, H_l, W_l, C), so a level of it is the gradient itself). A warp's 32
// atomics hit 32 neighbouring floats. The wrapper zeroes the buffer and casts
// each level to the feature dtype. Atomics change the order of the sums from
// run to run, so results agree with the plain version to rounding, not bits.
// What bounds it: memory -- one read of the gradient and one write of the
// pyramid's gradient at the least; the atomics' read-modify-write of L2 in
// practice.
//
// Built with -fmad=false so the coordinate and weight arithmetic rounds as the
// plain PyTorch version's separate multiplies and adds do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Pyramid {
  const void* data[kMaxLevels];  // (B, H_l, W_l, C) each
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];
  int64_t offset[kMaxLevels];  // K2b: where level l starts in the f32 buffer
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The bilinear corners and weights of one sample, with K2's rules; false
// when the sample lies outside [-1, size] and contributes nothing.
struct Corners {
  int y_low, x_low, y_high, x_high;
  float hy, hx, ly, lx;
};

__device__ __forceinline__ bool corners(int h, int w, float y, float x, Corners& q) {
  if (y < -1.0f || y > float(h) || x < -1.0f || x > float(w)) return false;
  y = fmaxf(y, 0.0f);
  x = fmaxf(x, 0.0f);
  q.y_low = int(floorf(y));
  q.x_low = int(floorf(x));
  if (q.y_low >= h - 1) {
    q.y_low = q.y_high = h - 1;
    y = float(q.y_low);
  } else {
    q.y_high = q.y_low + 1;
  }
  if (q.x_low >= w - 1) {
    q.x_low = q.x_high = w - 1;
    x = float(q.x_low);
  } else {
    q.x_high = q.x_low + 1;
  }
  q.ly = y - float(q.y_low);
  q.lx = x - float(q.x_low);
  q.hy = 1.0f - q.ly;
  q.hx = 1.0f - q.lx;
  return true;
}

// one bilinear sample of channel c at (y, x) on an (h, w, C) map
template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ f, int h, int w, int64_t c_stride,
                                          int c, float y, float x) {
  Corners q;
  if (!corners(h, w, y, x, q)) return 0.0f;
  const float v00 = to_float(f[(int64_t(q.y_low) * w + q.x_low) * c_stride + c]);
  const float v01 = to_float(f[(int64_t(q.y_low) * w + q.x_high) * c_stride + c]);
  const float v10 = to_float(f[(int64_t(q.y_high) * w + q.x_low) * c_stride + c]);
  const float v11 = to_float(f[(int64_t(q.y_high) * w + q.x_high) * c_stride + c]);
  return q.hy * q.hx * v00 + q.hy * q.lx * v01 + q.ly * q.hx * v10 + q.ly * q.lx * v11;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Pyramid p, const float* __restrict__ rois, const int32_t* __restrict__ levels,
                 T* __restrict__ out, int num_rois, int channels, int out_size, int sample_num,
                 int64_t total) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = int(t % channels);
  int64_t rest = t / channels;
  const int pw = int(rest % out_size);
  rest /= out_size;
  const int ph = int(rest % out_size);
  const int64_t br = rest / out_size;  // b * num_rois + r
  const int64_t b = br / num_rois;

  const int lvl = levels[br];
  const int h = p.height[lvl];
  const int w = p.width[lvl];
  const float scale = p.scale[lvl];
  const T* f = static_cast<const T*>(p.data[lvl]) + b * h * w * int64_t(channels);

  const float* roi = rois + br * 4;
  const float start_w = roi[0] * scale;
  const float start_h = roi[1] * scale;
  const float end_w = (roi[2] + 1.0f) * scale;
  const float end_h = (roi[3] + 1.0f) * scale;
  const float bin_w = fmaxf(end_w - start_w, 0.0f) / float(out_size);
  const float bin_h = fmaxf(end_h - start_h, 0.0f) / float(out_size);

  float acc = 0.0f;
  for (int iy = 0; iy < sample_num; ++iy) {
    const float pos_y = float(ph) + (float(iy) + 0.5f) / float(sample_num);
    const float y = start_h + bin_h * pos_y;
    for (int ix = 0; ix < sample_num; ++ix) {
      const float pos_x = float(pw) + (float(ix) + 0.5f) / float(sample_num);
      const float x = start_w + bin_w * pos_x;
      acc += bilinear(f, h, w, channels, c, y, x);
    }
  }
  store(out + t, acc / float(sample_num * sample_num));
}

// K2b: out is the f32 pyramid buffer, level l at offset[l] elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_kernel(Pyramid p, const float* __restrict__ rois, const int32_t* __restrict__ levels,
                          const T* __restrict__ grad, float* __restrict__ out, int num_rois,
                          int channels, int out_size, int sample_num, int64_t total) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = int(t % channels);
  int64_t rest = t / channels;
  const int pw = int(rest % out_size);
  rest /= out_size;
  const int ph = int(rest % out_size);
  const int64_t br = rest / out_size;
  const int64_t b = br / num_rois;

  const int lvl = levels[br];
  const int h = p.height[lvl];
  const int w = p.width[lvl];
  const float scale = p.scale[lvl];
  float* f = out + p.offset[lvl] + b * h * w * int64_t(channels) + c;

  const float* roi = rois + br * 4;
  const float start_w = roi[0] * scale;
  const float start_h = roi[1] * scale;
  const float end_w = (roi[2] + 1.0f) * scale;
  const float end_h = (roi[3] + 1.0f) * scale;
  const float bin_w = fmaxf(end_w - start_w, 0.0f) / float(out_size);
  const float bin_h = fmaxf(end_h - start_h, 0.0f) / float(out_size);
  const float g = to_float(grad[t]) / float(sample_num * sample_num);

  for (int iy = 0; iy < sample_num; ++iy) {
    const float y = start_h + bin_h * (float(ph) + (float(iy) + 0.5f) / float(sample_num));
    for (int ix = 0; ix < sample_num; ++ix) {
      const float x = start_w + bin_w * (float(pw) + (float(ix) + 0.5f) / float(sample_num));
      Corners q;
      if (!corners(h, w, y, x, q)) continue;
      atomicAdd(f + (int64_t(q.y_low) * w + q.x_low) * channels, q.hy * q.hx * g);
      atomicAdd(f + (int64_t(q.y_low) * w + q.x_high) * channels, q.hy * q.lx * g);
      atomicAdd(f + (int64_t(q.y_high) * w + q.x_low) * channels, q.ly * q.hx * g);
      atomicAdd(f + (int64_t(q.y_high) * w + q.x_high) * channels, q.ly * q.lx * g);
    }
  }
}

template <typename T>
int launch(const Pyramid& p, const float* rois, const int32_t* levels, void* out, int batch,
           int num_rois, int channels, int out_size, int sample_num, cudaStream_t stream) {
  const int64_t total = int64_t(batch) * num_rois * out_size * out_size * channels;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  roi_align_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(
      p, rois, levels, static_cast<T*>(out), num_rois, channels, out_size, sample_num, total);
  return int(cudaGetLastError());
}

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

template <typename T>
int launch_backward(const Pyramid& p, const float* rois,
                    const int32_t* levels, const void* grad, float* out, int batch,
                    int num_rois, int channels, int out_size, int sample_num,
                    cudaStream_t stream) {
  const int64_t total = int64_t(batch) * num_rois * out_size * out_size * channels;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  roi_align_backward_kernel<T><<<unsigned(blocks), kThreads, 0, stream>>>(
      p, rois, levels, static_cast<const T*>(grad), out, num_rois, channels, out_size, sample_num,
      total);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: f32 features and output; 1: bf16. feats/heights/widths/scales are
// host arrays of num_levels entries; rois (B, R, 4) f32, levels (B, R) i32,
// out (B, R, S, S, C).
int bags_roi_align_forward(int dtype, int num_levels, const void* const* feats,
                           const int* heights, const int* widths, const float* scales,
                           const float* rois, const int32_t* levels, void* out, int batch,
                           int num_rois, int channels, int out_size, int sample_num,
                           cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) return int(cudaErrorInvalidValue);
  const Pyramid p = make_pyramid(num_levels, feats, heights, widths, scales);
  if (dtype == 0)
    return launch<float>(p, rois, levels, out, batch, num_rois, channels, out_size, sample_num,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, rois, levels, out, batch, num_rois, channels, out_size,
                                 sample_num, stream);
  return int(cudaErrorInvalidValue);
}

// K2b. dtype 0: f32 gradient; 1: bf16. heights/widths/scales are host arrays
// of num_levels entries; out is an f32 buffer the caller has zeroed that holds
// level after level, each (B, H_l, W_l, C); grad (B, R, S, S, C); rois
// (B, R, 4) f32, levels (B, R) i32.
int bags_roi_align_backward(int dtype, int num_levels, const int* heights, const int* widths,
                            const float* scales, const float* rois,
                            const int32_t* levels, const void* grad, float* out, int batch,
                            int num_rois, int channels, int out_size, int sample_num,
                            cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) return int(cudaErrorInvalidValue);
  Pyramid p = make_pyramid(num_levels, nullptr, heights, widths, scales);
  int64_t at = 0;
  for (int l = 0; l < num_levels; ++l) {
    p.offset[l] = at;
    at += int64_t(batch) * heights[l] * widths[l] * channels;
  }
  if (dtype == 0)
    return launch_backward<float>(p, rois, levels, grad, out, batch, num_rois, channels,
                                  out_size, sample_num, stream);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(p, rois, levels, grad, out, batch, num_rois,
                                          channels, out_size, sample_num, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
