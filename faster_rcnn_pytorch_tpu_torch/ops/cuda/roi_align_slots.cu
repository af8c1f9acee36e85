// MultiScaleRoIAlign forward (7x7 bins, 2x2 samples, aligned=False) over the
// FPN levels P2..P5 in the slot-lattice kernel's order of operations, for
// Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_align_kernel.py
// (_kernel, launched by multiscale_roi_align_pallas), the round-1 variant of
// the FPN align that no configuration of either package runs (the FPN head
// uses roi_align.cu's kernel). It computes the same function as roi_align.cu
// with the Pallas kernel's arithmetic, not its TPU layout: the Pallas kernel
// runs one grid over all rois per level (zero blocks for rois of other
// levels), DMAs 32x72 windows on a lattice of 8-aligned slots into VMEM and
// contracts them with per-slot weight rows on the MXU. None of that is
// carried over. Here one block takes one roi: its first 28 threads compute the
// 14 y and 14 x samples' two-cell windows and weights into shared memory, then
// the block's threads walk the roi's C x 7 x 7 outputs (pw fastest, so a
// warp's stores are contiguous) and read the 16 cells of each output's 4
// samples straight from the roi's level map (NCHW).
//
// Semantics (bit-exact with the plain twin
// ops/roi_align.py::multiscale_roi_align_slots_reference):
//   * the sample coordinates are roi_align.cu's (start + (p*bin + (sub + 0.5)*bin / 2));
//   * _corner_starts_weights: a sample outside [-1, size] has zero weights, a
//     coordinate clamps at 0, and low >= size-1 collapses: the two-cell window
//     starts one cell lower, at size-2, with the weight in its second slot;
//   * each axis weight is divided by the sampling ratio (2) before the products;
//   * separable: t(y) = wx0*v[y, x0] + wx1*v[y, x0+1] for the window's two rows,
//     then s = wy0*t(y0) + wy1*t(y0+1);
//   * the bin's samples add as ((s00 + s01) + s10) + s11, with no final /4.
// Every float operation is an explicit __f*_rn intrinsic, so nvcc contracts
// nothing into an FMA. Level maps must be at least 2x2 (the window start
// size-2 must be a cell); the wrapper checks it.
//
// What bounds it on an H100: bytes, as roi_align.cu: at FPN predict (B 2,
// 1000 rois per image, C 256, float32) it writes 100 MB and reads the rois'
// footprints. The per-roi geometry is computed once per block instead of once
// per output, but the loads of a warp still walk one channel plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_align_common.cuh"

using namespace roi_align_common;

namespace {

constexpr int kSamples = kPooled * kRatio;  // per axis
constexpr int kThreads = 256;

// Sample k (bin k / 2, sub-sample k % 2) along one axis as the JAX package's
// _corner_starts_weights has it: the start of its two-cell window and the
// window's two weights, each divided by the ratio. A collapsed sample
// (axis_samples' lo == hi, the last cell, its high weight 0) takes the
// window one cell lower, with its weight in the second slot.
__device__ __forceinline__ void corner_window(float lo_edge, float hi_edge, float scale,
                                              int size, int k, int* start, float* w0,
                                              float* w1) {
  AxisSample s[kRatio];
  axis_samples(lo_edge, hi_edge, scale, size, k / kRatio, s);
  const AxisSample& a = s[k % kRatio];
  const bool collapse = a.lo == a.hi;
  *start = collapse ? a.lo - 1 : a.lo;
  *w0 = __fdiv_rn(collapse ? 0.0f : a.w_lo, static_cast<float>(kRatio));
  *w1 = __fdiv_rn(collapse ? a.w_lo : a.w_hi, static_cast<float>(kRatio));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_slots_kernel(Levels levels, const float* __restrict__ rois,
                           const int32_t* __restrict__ level, int rois_per_image,
                           int channels, T* __restrict__ out) {
  __shared__ int ys[kSamples], xs[kSamples];
  __shared__ float wy0[kSamples], wy1[kSamples], wx0[kSamples], wx1[kSamples];
  const int64_t r = blockIdx.x;
  const int64_t b = r / rois_per_image;
  const int l = level[r];
  const int h = levels.height[l];
  const int w = levels.width[l];
  const float* roi = rois + r * 4;
  const int t = threadIdx.x;
  if (t < kSamples) {
    corner_window(roi[1], roi[3], levels.scale[l], h, t, &ys[t], &wy0[t], &wy1[t]);
  } else if (t < 2 * kSamples) {
    const int k = t - kSamples;
    corner_window(roi[0], roi[2], levels.scale[l], w, k, &xs[k], &wx0[k], &wx1[k]);
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(levels.feat[l]);
  T* dst = out + r * channels * kPooled * kPooled;
  for (int idx = t; idx < channels * kPooled * kPooled; idx += kThreads) {
    const int pw = idx % kPooled;
    const int ph = (idx / kPooled) % kPooled;
    const int c = idx / (kPooled * kPooled);
    const T* plane = feat + (b * channels + c) * static_cast<int64_t>(h) * w;
    float acc = 0.0f;
#pragma unroll
    for (int iy = 0; iy < kRatio; ++iy) {
#pragma unroll
      for (int ix = 0; ix < kRatio; ++ix) {
        const int i = ph * kRatio + iy;
        const int j = pw * kRatio + ix;
        const int64_t row0 = static_cast<int64_t>(ys[i]) * w + xs[j];
        const int64_t row1 = row0 + w;
        const float t0 = __fadd_rn(__fmul_rn(wx0[j], load_f32(plane, row0)),
                                   __fmul_rn(wx1[j], load_f32(plane, row0 + 1)));
        const float t1 = __fadd_rn(__fmul_rn(wx0[j], load_f32(plane, row1)),
                                   __fmul_rn(wx1[j], load_f32(plane, row1 + 1)));
        const float s = __fadd_rn(__fmul_rn(wy0[i], t0), __fmul_rn(wy1[i], t1));
        acc = (iy == 0 && ix == 0) ? s : __fadd_rn(acc, s);
      }
    }
    store(acc, dst + idx);
  }
}

}  // namespace

// Plain C++ entry point (no PyTorch headers here); the binding in
// binding.cpp checks the tensors and calls it on PyTorch's current stream.
// feats, heights, widths and scales are host arrays of the four levels;
// out is [num_rois, C, 7, 7] in the features' dtype. Returns the launch's
// cudaError_t.
int roi_align_slots_forward_launch(const void* const* feats, const int* heights,
                                   const int* widths, const float* scales, bool is_bf16,
                                   const float* rois, const int32_t* level, int num_rois,
                                   int rois_per_image, int channels, void* out,
                                   void* stream) {
  Levels levels;
  for (int i = 0; i < kLevels; ++i) {
    levels.feat[i] = feats[i];
    levels.height[i] = heights[i];
    levels.width[i] = widths[i];
    levels.scale[i] = scales[i];
  }
  if (num_rois == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_slots_kernel<__nv_bfloat16><<<num_rois, kThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_slots_kernel<float><<<num_rois, kThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
