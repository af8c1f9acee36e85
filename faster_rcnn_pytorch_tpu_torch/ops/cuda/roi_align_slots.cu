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
// carried over. It runs roi_align.cu's forward skeleton (pool_roi in
// roi_align_common.cuh: a block per roi and 64 channels, the roi's sample
// geometry once in shared memory, contiguous stores); only the corners and
// the per-sample arithmetic are its own.
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
// What bounds it on an H100: bytes, as roi_align.cu's forward: at FPN predict
// (B 2, 1000 rois per image, C 256, float32) it writes 100 MB and reads the
// rois' footprints, 16 corner reads an output that the skeleton serves from
// L1 (a block per roi and 64 channels, pw fastest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_align_common.cuh"

using namespace roi_align_common;

namespace {

// The slot-lattice arithmetic: sample k's two-cell window (start, start + 1)
// as the JAX package's _corner_starts_weights has it, weights divided by the
// ratio; a collapsed sample (axis_samples' lo == hi, the last cell, its high
// weight 0) takes the window one cell lower, with its weight in the second
// cell. Per sample x first, then y; no final division.
struct SlotOrder {
  __device__ __forceinline__ void corners(float lo_edge, float hi_edge, float scale, int size,
                                          int k, int* cell0, int* cell1, float* w0,
                                          float* w1) const {
    AxisSample s[kRatio];
    axis_samples(lo_edge, hi_edge, scale, size, k / kRatio, s);
    const AxisSample a = k % kRatio ? s[1] : s[0];
    const bool collapse = a.lo == a.hi;
    *cell0 = collapse ? a.lo - 1 : a.lo;
    *cell1 = *cell0 + 1;
    *w0 = __fdiv_rn(collapse ? 0.0f : a.w_lo, static_cast<float>(kRatio));
    *w1 = __fdiv_rn(collapse ? a.w_lo : a.w_hi, static_cast<float>(kRatio));
  }
  __device__ __forceinline__ float sample(float wy0, float wy1, float wx0, float wx1, float v00,
                                          float v01, float v10, float v11) const {
    const float t0 = __fadd_rn(__fmul_rn(wx0, v00), __fmul_rn(wx1, v01));
    const float t1 = __fadd_rn(__fmul_rn(wx0, v10), __fmul_rn(wx1, v11));
    return __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1));
  }
  __device__ __forceinline__ float finish(float acc) const { return acc; }
};

template <typename T>
__global__ void __launch_bounds__(kForwardThreads)
    roi_align_slots_kernel(Levels levels, const float* __restrict__ rois,
                           const int32_t* __restrict__ level, int rois_per_image,
                           int channels, T* __restrict__ out) {
  pool_roi(levels, rois, level, rois_per_image, channels, out, SlotOrder());
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
  const dim3 grid(num_rois, (channels + kGroupChannels - 1) / kGroupChannels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_slots_kernel<__nv_bfloat16><<<grid, kForwardThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_slots_kernel<float><<<grid, kForwardThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
