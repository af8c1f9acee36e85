// What roi_align.cu (the MultiScaleRoIAlign forward and backward kernels)
// and roi_align_slots.cu share: the four levels' maps and shapes, float32
// loads and stores of float32 or bfloat16 elements, and the sample geometry
// of one axis (7x7 bins, 2x2 samples, aligned=False). Every float operation
// is an explicit __f*_rn intrinsic, so nvcc contracts nothing into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace roi_align_common {

constexpr int kPooled = 7;
constexpr int kRatio = 2;
constexpr int kLevels = 4;

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

}  // namespace roi_align_common
