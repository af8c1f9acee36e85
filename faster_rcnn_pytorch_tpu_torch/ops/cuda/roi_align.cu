// MultiScaleRoIAlign forward (7x7 bins, 2x2 samples, aligned=False) over the
// FPN levels P2..P5, and its features-gradient, for Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_window_kernel.py
// (_kernel, launched by roi_window_align). It computes the same function, not
// the TPU layout: the Pallas kernel DMAs one fixed (win_y, win_x, C) window per
// roi from a level-stacked buffer into VMEM and contracts it with folded
// per-bin weight rows on the MXU; rois whose footprint overflows the window
// come back with fits=False and are re-pooled by the caller's corner gather.
// Here the window is the roi's footprint, which always fits: the distinct
// cells that its 14 y and 14 x samples touch, at most 28 rows by 28 columns
// whatever the roi's size or position, so every roi is exact, with no fits
// mask and no fallback.
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
// C 256, float32) it writes 100 MB and needs the 132 MB of map cells that
// some roi weighs; its 16 corner reads per output (401M a call) and each
// output's sample geometry (three IEEE divisions an axis) are what cost. The
// design (pool_roi in roi_align_common.cuh): one block per roi and 64
// channels computes the roi's 14 + 14 samples once in shared memory, then
// walks the outputs with pw fastest, so the block's reads of one channel's
// footprint come from L1 after the first and its stores are contiguous.
// Copying each chunk's footprint into shared memory first (cp.async,
// double-buffered) measured slower (PERF.md): a block waited on its slowest
// copy before it could compute, where L1 lets each warp go on as its own
// loads land.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_align_common.cuh"

using namespace roi_align_common;

namespace {

// The forward's arithmetic: corners (lo, hi) of axis_samples, each sample's
// four products in the plain version's order, the bin's mean by * 1/4.
struct CornerOrder {
  __device__ __forceinline__ void corners(float lo_edge, float hi_edge, float scale, int size,
                                          int k, int* cell0, int* cell1, float* w0,
                                          float* w1) const {
    AxisSample s[kRatio];
    axis_samples(lo_edge, hi_edge, scale, size, k / kRatio, s);
    const AxisSample a = k % kRatio ? s[1] : s[0];
    *cell0 = a.lo;
    *cell1 = a.hi;
    *w0 = a.w_lo;
    *w1 = a.w_hi;
  }
  __device__ __forceinline__ float sample(float wy0, float wy1, float wx0, float wx1, float v00,
                                          float v01, float v10, float v11) const {
    float val = __fmul_rn(__fmul_rn(wy0, wx0), v00);
    val = __fadd_rn(val, __fmul_rn(__fmul_rn(wy0, wx1), v01));
    val = __fadd_rn(val, __fmul_rn(__fmul_rn(wy1, wx0), v10));
    return __fadd_rn(val, __fmul_rn(__fmul_rn(wy1, wx1), v11));
  }
  __device__ __forceinline__ float finish(float acc) const {
    return __fmul_rn(acc, 1.0f / (kRatio * kRatio));
  }
};

template <typename T>
__global__ void __launch_bounds__(kForwardThreads)
    roi_align_fwd_kernel(Levels levels, const float* __restrict__ rois,
                         const int32_t* __restrict__ level, int rois_per_image, int channels,
                         T* __restrict__ out) {
  pool_roi(levels, rois, level, rois_per_image, channels, out, CornerOrder());
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
// is carried over. It computes, for every roi whatever its size or position,
//
//   dfeat_l[b, c, y, x] = sum over (r in image b at level l, ph, pw, sample,
//                         corner at (y, x)) of (g[r, c, ph, pw] * 0.25) * (wy * wx)
//
// into zeroed float32 NCHW maps, with the forward's geometry. A corner of
// weight 0 (a sample outside [-1, size], a collapsed high cell, a sample on a
// cell edge) adds nothing and is left out. The products are __fmul_rn in the
// plain twin's order (ops/roi_align.py::backward_scatter_terms); bfloat16
// gradients are widened with __bfloat162float, and the wrapper casts the maps
// to the features' dtype afterwards. The terms of one cell are summed in a
// register, then added to the map atomically: the sums run in another order
// than the plain version's, and that order changes from run to run where rois
// overlap, so the result is bit-exact against the plain version only where
// every order gives the same float32 sum (dyadic weights, integer gradients).
//
// What bounds it on an H100: bytes. At the FPN train shape (B 2, 520 rois per
// image, C 256) it reads the 52 MB float32 gradient once and adds into 183 MB
// of level maps, which the wrapper zeroes. One thread per upstream element
// with 16 atomicAdds each made that 213M 4-byte atomics, each its own L2
// transaction (a warp's scatter over a few rows of one plane), 30x the bound.
// The design: one block per roi and 32 channels loads the chunk's g * 0.25
// (contiguous, coalesced) and lists the roi's footprint in shared memory, each
// footprint cell's corners listed by cell. A warp then sums one cell's terms
// (its y corners times its x corners) for the 32 channels, one lane each, in
// registers, and the block adds each cell's sum to the map once, through
// shared memory, so that a warp's adds land on consecutive cells of a row and
// coalesce. At the train shape that is 34M adds instead of 213M, and no
// shared-memory atomics. The time divides between the per-roi setup, the
// sums, the adds and the wrapper's memset of the maps.

constexpr int kCorners = 2 * kSamples;  // per axis: two cells per sample

// One axis of a roi's footprint: the distinct cells its corners touch.
struct AxisFootprint {
  int cell[kCorners];       // ascending
  int start[kCorners + 1];  // rank of each cell's first corner; start[n] = kept corners
  int n;
};

// Builds one axis's footprint in one warp, all 32 lanes together: lane
// i < 28 holds corner i (the (i % 2)-th cell of sample i / 2, so of bin
// i / 4), a cell < 0 (and lanes 28..31 pass -1) marks a corner left out.
// Writes fp; returns in each lane its corner's rank among the kept corners
// ordered by (cell, i).
__device__ __forceinline__ int build_axis(int cell, AxisFootprint& fp) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const bool kept = cell >= 0;
  const unsigned kept_mask = __ballot_sync(kAll, kept);
  // Every lane reaches each *_sync call (none behind a && or a branch).
  const unsigned same = __match_any_sync(kAll, cell);
  const bool first = kept && __ffs(same) - 1 == lane;
  const unsigned firsts = __ballot_sync(kAll, first);
  int slot = 0, rank = 0;
#pragma unroll
  for (int m = 0; m < kCorners; ++m) {
    const int cm = __shfl_sync(kAll, cell, m);
    slot += ((firsts >> m) & 1) && cm < cell;
    rank += ((kept_mask >> m) & 1) && (cm < cell || (cm == cell && m < lane));
  }
  if (first) {
    fp.cell[slot] = cell;
    fp.start[slot] = rank;
  }
  if (lane == 0) {
    fp.n = __popc(firsts);
    fp.start[__popc(firsts)] = __popc(kept_mask);
  }
  return rank;
}

struct GradLevels {
  float* grad[kLevels];
  int height[kLevels];
  int width[kLevels];
  float scale[kLevels];
};

constexpr int kBwdChannels = 32;  // a warp's lanes
constexpr int kBwdThreads = 256;
constexpr int kCellBatch = 64;

template <typename G>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_bwd_kernel(GradLevels levels, const G* __restrict__ grad,
                         const float* __restrict__ rois, const int32_t* __restrict__ level,
                         int rois_per_image, int channels) {
  __shared__ AxisFootprint fp[2];
  __shared__ float gq[kBwdChannels * kBins];
  // The kept corners of each axis in footprint order: weight and bin.
  __shared__ float sorted_w[2][kCorners];
  __shared__ int sorted_bin[2][kCorners];
  // A batch of footprint cells' sums per channel (odd pitch: conflict-free
  // both ways), and each cell's offset in the map.
  __shared__ float sums[kBwdChannels][kCellBatch + 1];
  __shared__ int cell_offset[kCellBatch];

  const int64_t r = blockIdx.x;
  const int64_t b = r / rois_per_image;
  const int c0 = kBwdChannels * blockIdx.y;
  const int count = min(kBwdChannels, channels - c0);
  const int l = level[r];
  const int h = pick(levels.height, l);
  const int w = pick(levels.width, l);
  const int t = threadIdx.x;
  if (t < 32) {  // warp 0: both axes' footprints, corners of weight 0 left out
    const float* roi = rois + r * 4;
    const int k = min(t / 2, kSamples - 1);
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      AxisSample s[kRatio];
      axis_samples(roi[axis ? 0 : 1], roi[axis ? 2 : 3], pick(levels.scale, l), axis ? w : h,
                   k / kRatio, s);
      const AxisSample a = k % kRatio ? s[1] : s[0];
      const float weight = t % 2 ? a.w_hi : a.w_lo;
      const bool kept = t < kCorners && weight != 0.0f;
      const int rank = build_axis(kept ? (t % 2 ? a.hi : a.lo) : -1, fp[axis]);
      if (kept) {
        sorted_w[axis][rank] = weight;
        sorted_bin[axis][rank] = t / (2 * kRatio);
      }
    }
  } else {  // the other warps: the chunk's g * 0.25
    const G* g = grad + (r * channels + c0) * kBins;
    for (int i = t - 32; i < count * kBins; i += blockDim.x - 32) {
      gq[i] = __fmul_rn(load_f32(g, i), 1.0f / (kRatio * kRatio));
    }
  }
  __syncthreads();

  // The footprint's cells in batches: each warp sums whole cells, its lanes
  // the chunk's channels (the same corners, so no lane waits on another; gq
  // at stride 49 puts the lanes' reads in 32 banks), into sums; then the
  // block adds the batch to the map, a warp's lanes on consecutive cells.
  const int rows = fp[0].n, cols = fp[1].n;
  const int n_cells = rows * cols;
  const int lane = t % 32, warp = t / 32;
  float* const plane = pick(levels.grad, l) + (b * channels + c0) * static_cast<int64_t>(h) * w;
  for (int first = 0; first < n_cells; first += kCellBatch) {
    const int n_batch = min(kCellBatch, n_cells - first);
    for (int j = warp; j < n_batch; j += kBwdThreads / 32) {
      const int ry = (first + j) / cols, rx = (first + j) % cols;
      float acc = 0.0f;
      if (lane < count) {
        const float* gc = gq + lane * kBins;
        for (int a = fp[0].start[ry]; a < fp[0].start[ry + 1]; ++a) {
          const float wy = sorted_w[0][a];
          const float* grow = gc + sorted_bin[0][a] * kPooled;
          for (int x = fp[1].start[rx]; x < fp[1].start[rx + 1]; ++x) {
            acc = __fadd_rn(acc, __fmul_rn(grow[sorted_bin[1][x]], __fmul_rn(wy, sorted_w[1][x])));
          }
        }
      }
      sums[lane][j] = acc;
      if (lane == 0) cell_offset[j] = fp[0].cell[ry] * w + fp[1].cell[rx];
    }
    __syncthreads();
    for (int i = t; i < count * kCellBatch; i += kBwdThreads) {
      const int j = i % kCellBatch, c = i / kCellBatch;
      // Adding +-0 leaves every float32 map value's bits as they are.
      if (j < n_batch && sums[c][j] != 0.0f) {
        atomicAdd(plane + c * static_cast<int64_t>(h) * w + cell_offset[j], sums[c][j]);
      }
    }
    __syncthreads();
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
  if (num_rois == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(num_rois, (channels + kGroupChannels - 1) / kGroupChannels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, kForwardThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_fwd_kernel<float><<<grid, kForwardThreads, 0, s>>>(
        levels, rois, level, rois_per_image, channels, static_cast<float*>(out));
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
  if (num_rois == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(num_rois, (channels + kBwdChannels - 1) / kBwdChannels);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_is_bf16) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, s>>>(
        levels, static_cast<const __nv_bfloat16*>(grad), rois, level, rois_per_image, channels);
  } else {
    roi_align_bwd_kernel<float><<<grid, kBwdThreads, 0, s>>>(
        levels, static_cast<const float*>(grad), rois, level, rois_per_image, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
