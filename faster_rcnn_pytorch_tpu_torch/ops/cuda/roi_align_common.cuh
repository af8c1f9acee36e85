// What the MultiScaleRoIAlign kernels share (roi_align.cu: the forward and
// the backward; roi_align_slots.cu: the slot-lattice forward): the four
// levels' maps and shapes, float32 loads and stores of float32 or bfloat16
// elements, the sample geometry of one axis (7x7 bins, 2x2 samples,
// aligned=False), and the forwards' block-per-roi skeleton (pool_roi): the
// roi's sample geometry computed once per block in shared memory, the
// corners read from the level map, the outputs stored contiguously. The two
// forwards differ only in their corners and their per-sample arithmetic.
//
// Every float operation is an explicit __f*_rn intrinsic, so nvcc contracts
// nothing into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace roi_align_common {

constexpr int kPooled = 7;
constexpr int kRatio = 2;
constexpr int kLevels = 4;
constexpr int kSamples = kPooled * kRatio;  // per axis
constexpr int kBins = kPooled * kPooled;

struct Levels {
  const void* feat[kLevels];
  int height[kLevels];
  int width[kLevels];
  float scale[kLevels];
};

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

struct AxisSample {
  int lo, hi;
  float w_lo, w_hi;
};

// The two samples of bin `bin` along one axis (the plain version's
// _axis_samples, operation for operation).
__device__ __forceinline__ void axis_samples(float lo_edge, float hi_edge, float scale,
                                             int size, int bin, AxisSample* s) {
  const float start = __fmul_rn(lo_edge, scale);
  const float extent = fmaxf(__fsub_rn(__fmul_rn(hi_edge, scale), start), 1.0f);
  const float bin_size = __fdiv_rn(extent, static_cast<float>(kPooled));
  const float base = __fmul_rn(static_cast<float>(bin), bin_size);
#pragma unroll
  for (int sub = 0; sub < kRatio; ++sub) {
    const float off = __fdiv_rn(__fmul_rn(static_cast<float>(sub) + 0.5f, bin_size),
                                static_cast<float>(kRatio));
    const float coord = __fadd_rn(start, __fadd_rn(base, off));
    const bool valid = coord >= -1.0f && coord <= static_cast<float>(size);
    // Clamping above at size changes nothing (such a sample is invalid and
    // collapses either way) but keeps the int conversion in range.
    float c = fminf(fmaxf(coord, 0.0f), static_cast<float>(size));
    int low = static_cast<int>(floorf(c));
    int high = low + 1;
    if (low >= size - 1) {
      low = size - 1;
      high = low;
      c = static_cast<float>(low);
    }
    const float frac = __fsub_rn(c, static_cast<float>(low));
    s[sub].lo = low;
    s[sub].hi = high;
    s[sub].w_lo = valid ? __fsub_rn(1.0f, frac) : 0.0f;
    s[sub].w_hi = valid ? frac : 0.0f;
  }
}

// Level field l of a kernel argument, without indexing the argument by a
// runtime value (which copies it to the stack).
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[kLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// A sample's two corner cells as offsets in a channel plane of the level
// map (the row's times the map's width for y), and their weights.
struct __align__(16) SamplePair {
  int off0, off1;
  float w0, w1;
};

// The forwards' block: 256 threads take one roi and kGroupChannels of its
// channels (grid.y splits the channels).
constexpr int kForwardThreads = 256;
constexpr int kGroupChannels = 64;

// The forwards' block: roi blockIdx.x, channels kGroupChannels * blockIdx.y
// onwards, kForwardThreads threads. Arith supplies the per-axis corners,
//   corners(lo_edge, hi_edge, scale, size, k, &cell0, &cell1, &w0, &w1) for sample k,
// the per-sample arithmetic on the sample's four corner values,
//   sample(wy0, wy1, wx0, wx1, v00, v01, v10, v11),
// and finish(acc) on the bin's sum of its samples, added in (0,0), (0,1),
// (1,0), (1,1) order. out is [num_rois, C, 7, 7].
//
// Threads 0..27 compute the 14 + 14 samples' corners once, into shared
// memory. Then the block walks its channels' C x 7 x 7 outputs with pw
// fastest: a warp's stores are contiguous, and its 16 corner reads of a
// sample fall on the few rows of one channel plane that the roi's bins
// cover, which L1 keeps for the block's other reads of the same cells.
template <typename T, typename Arith>
__device__ __forceinline__ void pool_roi(const Levels& levels, const float* __restrict__ rois,
                                         const int32_t* __restrict__ level, int rois_per_image,
                                         int channels, T* __restrict__ out, const Arith& arith) {
  __shared__ SamplePair pairs[2][kSamples];
  const int64_t r = blockIdx.x;
  const int64_t b = r / rois_per_image;
  const int l = level[r];
  const int h = pick(levels.height, l);
  const int w = pick(levels.width, l);
  const int t = threadIdx.x;
  if (t < 2 * kSamples) {
    const int axis = t / kSamples, k = t % kSamples;
    const float* roi = rois + r * 4;
    int cell0, cell1;
    float w0, w1;
    arith.corners(roi[axis ? 0 : 1], roi[axis ? 2 : 3], pick(levels.scale, l), axis ? w : h, k,
                  &cell0, &cell1, &w0, &w1);
    const int stride = axis ? 1 : w;
    pairs[axis][k] = {cell0 * stride, cell1 * stride, w0, w1};
  }
  __syncthreads();

  const int c_begin = kGroupChannels * blockIdx.y;
  const int n_out = min(kGroupChannels, channels - c_begin) * kBins;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const T* feat = static_cast<const T*>(pick(levels.feat, l)) + (b * channels + c_begin) * plane;
  T* dst = out + (r * channels + c_begin) * kBins;
  for (int j = t; j < n_out; j += blockDim.x) {
    const int c = j / kBins, bin = j % kBins;
    const int ph = bin / kPooled, pw = bin % kPooled;
    const T* v = feat + c * plane;
    float acc = 0.0f;
#pragma unroll
    for (int iy = 0; iy < kRatio; ++iy) {
      const SamplePair y = pairs[0][ph * kRatio + iy];
#pragma unroll
      for (int ix = 0; ix < kRatio; ++ix) {
        const SamplePair x = pairs[1][pw * kRatio + ix];
        const float s = arith.sample(y.w0, y.w1, x.w0, x.w1, load_f32(v, y.off0 + x.off0),
                                     load_f32(v, y.off0 + x.off1), load_f32(v, y.off1 + x.off0),
                                     load_f32(v, y.off1 + x.off1));
        acc = (iy == 0 && ix == 0) ? s : __fadd_rn(acc, s);
      }
    }
    store(arith.finish(acc), dst + j);
  }
}

}  // namespace roi_align_common
