// MultiScaleRoIAlign forward (7x7 bins, 2x2 samples, aligned=False) over the
// FPN levels P2..P5, and its features-gradient, for Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_window_kernel.py
// (_kernel, launched by roi_window_align). It computes the same function, not
// the TPU layout: the Pallas kernel DMAs one fixed (win_y, win_x, C) window per
// roi from a level-stacked buffer into VMEM and contracts it with folded
// per-bin weight rows on the MXU; rois whose footprint overflows the window
// come back with fits=False and are re-pooled by the caller's corner gather.
// Here there is no window to fit: every output element (b, r, c, ph, pw) is one
// thread that reads the 16 corner values of its bin's four samples straight
// from its roi's level map (NCHW, L2 or device memory), so every roi is exact
// whatever its size, and there is no fits mask and no fallback.
//
// Semantics (bit-exact with the plain twin
// ops/roi_align.py::multiscale_roi_align_reference; torchvision aligned=False):
//   * the level is an input ([B, n] int32, fpn_level_assignment in torch), so
//     kernel and plain version agree on it by construction;
//   * at scale s = 1/stride: start = x1*s, extent = max(x2*s - x1*s, 1),
//     bin = extent / 7, samples at start + (ph*bin + (sub + 0.5)*bin / 2);
//   * a sample outside [-1, size] has zero weights; a coordinate clamps at 0;
//     low >= size-1 collapses onto the last cell (frac 0);
//   * per sample w_ll*v_ll + w_lh*v_lh + w_hl*v_hl + w_hh*v_hh with
//     w = wy*wx, samples added in (0,0), (0,1), (1,0), (1,1) order, times 1/4.
// Every float operation is an explicit __f*_rn intrinsic, so nvcc contracts
// nothing into an FMA and the rounding is the plain version's, one per op.
// bfloat16 maps are read through __bfloat162float and the float32 result is
// written with __float2bfloat16_rn (round to nearest even, as .to(bfloat16)).
//
// What bounds it on an H100: bytes. At predict (B 2, 1000 rois per image,
// C 256, float32) it writes 100 MB and reads at most the 183 MB of P2..P5
// (only the footprints of the rois: far less); its ~1.2 GFLOP are negligible
// against 3.35 TB/s. One thread per output with pw fastest makes a warp's
// stores contiguous, but its loads walk one channel plane at a time, 7 cells
// of one row per bin row. Faster designs (an NHWC copy of the levels so a warp
// reads 32 channels of one cell; one block per roi with its footprint staged
// in shared memory) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLevels = 4;
constexpr int kPooled = 7;
constexpr int kRatio = 2;

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

template <typename T>
__global__ void roi_align_fwd_kernel(Levels levels, const float* __restrict__ rois,
                                     const int32_t* __restrict__ level,
                                     int rois_per_image, int channels, int64_t total,
                                     T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int pw = static_cast<int>(idx % kPooled);
    const int ph = static_cast<int>((idx / kPooled) % kPooled);
    const int c = static_cast<int>((idx / (kPooled * kPooled)) % channels);
    const int64_t r = idx / (static_cast<int64_t>(kPooled) * kPooled * channels);
    const int64_t b = r / rois_per_image;

    const int l = level[r];
    const int h = levels.height[l];
    const int w = levels.width[l];
    const float scale = levels.scale[l];
    const float* roi = rois + r * 4;
    AxisSample ys[kRatio], xs[kRatio];
    axis_samples(roi[1], roi[3], scale, h, ph, ys);
    axis_samples(roi[0], roi[2], scale, w, pw, xs);

    const T* plane = static_cast<const T*>(levels.feat[l]) +
                     (b * channels + c) * static_cast<int64_t>(h) * w;
    float acc = 0.0f;
#pragma unroll
    for (int iy = 0; iy < kRatio; ++iy) {
#pragma unroll
      for (int ix = 0; ix < kRatio; ++ix) {
        const AxisSample& y = ys[iy];
        const AxisSample& x = xs[ix];
        float val = __fmul_rn(__fmul_rn(y.w_lo, x.w_lo), load_f32(plane, y.lo * w + x.lo));
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(y.w_lo, x.w_hi), load_f32(plane, y.lo * w + x.hi)));
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(y.w_hi, x.w_lo), load_f32(plane, y.hi * w + x.lo)));
        val = __fadd_rn(val, __fmul_rn(__fmul_rn(y.w_hi, x.w_hi), load_f32(plane, y.hi * w + x.hi)));
        acc = (iy == 0 && ix == 0) ? val : __fadd_rn(acc, val);
      }
    }
    store(__fmul_rn(acc, 1.0f / (kRatio * kRatio)), out + idx);
  }
}

// MultiScaleRoIAlign backward: the features-gradient.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_window_kernel.py
// (_bwd_kernel, launched by roi_window_align_bwd from _msra_bwd_impl in
// faster_rcnn_pytorch_tpu/ops/roi_align.py). The Pallas kernel expands each
// roi's [7, 7, C] gradient through its window's weight rows on the MXU and
// read-modify-writes the window of a level-stacked VMEM buffer under a DMA
// semaphore protocol (rois sorted and interleaved so that neighbours do not
// collide); rois that overflow the window get zero weights there and their
// gradient from a compacted dense-matmul VJP added by the caller. None of that
// is carried over. Here every upstream element (b, r, c, ph, pw) is one thread
// that recomputes its bin's samples with axis_samples (the forward's, above)
// and atomicAdds g * 0.25 * wy * wx at each corner of non-zero weight into a
// zeroed float32 NCHW map of the roi's level:
//
//   dfeat_l[b, c, y, x] = sum over (r in image b at level l, ph, pw, sample,
//                         corner at (y, x)) of (g[r, c, ph, pw] * 0.25) * (wy * wx)
//
// so the adjoint is exact for every roi, whatever its size or position. A
// collapsed low cell (low >= size - 1) has lo == hi with frac 0: its high
// corner's weight is 0 and adds nothing, as the forward reads it with weight 0.
// A sample outside [-1, size] has zero weights, so a roi wholly outside the
// canvas adds nothing. The products are __fmul_rn in the plain twin's order
// (ops/roi_align.py::backward_scatter_terms); bfloat16 gradients are widened
// with __bfloat162float, and the wrapper casts the maps to the features' dtype
// afterwards. Atomics add in an order that changes from run to run: the result
// is bit-exact against the plain version only where every order gives the same
// float32 sum (dyadic weights and integer gradients).
//
// What bounds it on an H100: bytes. At the FPN train shape (B 2, 512 rois per
// image, C 256) it reads the 51.4 MB float32 gradient once, coalesced (threads
// walk the contiguous [B, n, C, 7, 7] layout), and adds into 183 MB of level
// maps, which the wrapper zeroes with a memset. The atomics land in one channel
// plane per 49 threads, so a warp's adds scatter over a few rows of one plane:
// they resolve in L2 for the rois' footprints but each is a 4-byte
// transaction. Faster designs (one block per roi with its footprint
// accumulated in shared memory, NHWC maps so a warp adds 32 channels of one
// cell) are later work.
struct GradLevels {
  float* grad[kLevels];
  int height[kLevels];
  int width[kLevels];
  float scale[kLevels];
};

__device__ __forceinline__ void add_corner(float* plane, int cell, float weight, float gq) {
  if (weight != 0.0f) atomicAdd(plane + cell, __fmul_rn(gq, weight));
}

template <typename G>
__global__ void roi_align_bwd_kernel(GradLevels levels, const G* __restrict__ grad,
                                     const float* __restrict__ rois,
                                     const int32_t* __restrict__ level,
                                     int rois_per_image, int channels, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int pw = static_cast<int>(idx % kPooled);
    const int ph = static_cast<int>((idx / kPooled) % kPooled);
    const int c = static_cast<int>((idx / (kPooled * kPooled)) % channels);
    const int64_t r = idx / (static_cast<int64_t>(kPooled) * kPooled * channels);
    const int64_t b = r / rois_per_image;

    const int l = level[r];
    const int h = levels.height[l];
    const int w = levels.width[l];
    const float* roi = rois + r * 4;
    AxisSample ys[kRatio], xs[kRatio];
    axis_samples(roi[1], roi[3], levels.scale[l], h, ph, ys);
    axis_samples(roi[0], roi[2], levels.scale[l], w, pw, xs);

    float* plane = levels.grad[l] + (b * channels + c) * static_cast<int64_t>(h) * w;
    const float gq = __fmul_rn(load_f32(grad, idx), 1.0f / (kRatio * kRatio));
#pragma unroll
    for (int iy = 0; iy < kRatio; ++iy) {
#pragma unroll
      for (int ix = 0; ix < kRatio; ++ix) {
        const AxisSample& y = ys[iy];
        const AxisSample& x = xs[ix];
        add_corner(plane, y.lo * w + x.lo, __fmul_rn(y.w_lo, x.w_lo), gq);
        add_corner(plane, y.lo * w + x.hi, __fmul_rn(y.w_lo, x.w_hi), gq);
        add_corner(plane, y.hi * w + x.lo, __fmul_rn(y.w_hi, x.w_lo), gq);
        add_corner(plane, y.hi * w + x.hi, __fmul_rn(y.w_hi, x.w_hi), gq);
      }
    }
  }
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors and calls them on PyTorch's current
// stream. feats (or dfeats), heights, widths and scales are host arrays of the
// four levels. Each returns the launch's cudaError_t.
int roi_align_forward_launch(const void* const* feats, const int* heights, const int* widths,
                             const float* scales, bool is_bf16, const float* rois,
                             const int32_t* level, int num_rois, int rois_per_image,
                             int channels, void* out, void* stream) {
  Levels levels;
  for (int i = 0; i < kLevels; ++i) {
    levels.feat[i] = feats[i];
    levels.height[i] = heights[i];
    levels.width[i] = widths[i];
    levels.scale[i] = scales[i];
  }
  const int64_t total = static_cast<int64_t>(num_rois) * channels * kPooled * kPooled;
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, total,
        static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, total, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int roi_align_backward_launch(const void* grad, bool grad_is_bf16, float* const* dfeats,
                              const int* heights, const int* widths, const float* scales,
                              const float* rois, const int32_t* level, int num_rois,
                              int rois_per_image, int channels, void* stream) {
  GradLevels levels;
  for (int i = 0; i < kLevels; ++i) {
    levels.grad[i] = dfeats[i];
    levels.height[i] = heights[i];
    levels.width[i] = widths[i];
    levels.scale[i] = scales[i];
  }
  const int64_t total = static_cast<int64_t>(num_rois) * channels * kPooled * kPooled;
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_is_bf16) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        levels, static_cast<const __nv_bfloat16*>(grad), rois, level, rois_per_image,
        channels, total);
  } else {
    roi_align_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        levels, static_cast<const float*>(grad), rois, level, rois_per_image, channels, total);
  }
  return static_cast<int>(cudaGetLastError());
}
