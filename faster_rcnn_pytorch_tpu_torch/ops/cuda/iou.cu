// Pairwise IoU of two box sets for Hopper, sm_90a, in two modes that share
// one arithmetic:
//
//   matrix: [n, 4] x [m, 4] -> [n, m] float32, the TPU kernel's function,
//           with an optional column mask (a masked column is -1);
//   match:  [B, n, 4] x [B, m, 4] with both masks -> each row's max [B, n]
//           float32 and the smallest column index that reaches it [B, n]
//           int64, which is all frcnn_targets reads of the matrix. The matrix
//           never reaches device memory.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/iou_kernel.py
// (_iou_kernel, launched by pairwise_iou_pallas). It computes the same
// function, not the TPU layout: the Pallas kernel takes B pre-transposed to
// [4, m] lane rows, pads both sets to 512-row blocks and evaluates one
// (block_n, block_m) VMEM tile per grid step. None of that is carried over.
//
// Semantics (bit-exact with the plain twins in ops/boxes.py,
// pairwise_iou_reference and iou_match_reference):
//   inter = max(min(ax2, bx2) - max(ax1, bx1), 0) * max(min(ay2, by2) - max(ay1, by1), 0)
//   union = ((area_a + area_b) - inter) + eps, area = (x2 - x1) * (y2 - y1)
//   union = max(union, 1e-12) when eps == 0 (the kernel's union_floor)
//   iou   = inter / union
// Every float operation is an explicit __f*_rn intrinsic: nvcc contracts
// a*b + c into an FMA by default, and area_a + (bx2 - bx1) * (by2 - by1)
// would then round once where the twin rounds twice. The row max follows
// torch.max(dim): a NaN beats any number, and ties go to the lower index.
//
// What bounds it on an H100. Matrix: bytes; at the dense legacy train shape
// (2512 candidates x 512 gt slots) it writes 5.1 MB, about 1.5 us at
// 3.35 TB/s. A thread owns 4 adjacent columns: it loads their boxes into
// registers once, computes their areas once, and then walks rows, reading
// each row's box as one float4 (the row's threads read the same 16 bytes)
// and writing its 4 results as one 16-byte store, so a warp stores 512
// contiguous bytes. Blocks are sized by m and the grid by the card's SMs.
// Match: operations (13 a pair; 1.6e7 a legacy step, about 0.5 us at
// 67 TFLOP/s float32), its bytes (boxes, masks and 12 B a row out) are
// 0.16 MB. A block stages one image's m boxes, areas and mask in shared
// memory; a warp walks one row at a time, each lane over every 32nd column,
// and the lanes' (value, index) pairs meet in five shuffles.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // adjacent columns a thread owns in matrix mode

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b, float area_b, float eps,
                                        float union_floor) {
  const float lo_x = fmaxf(a.x, b.x), lo_y = fmaxf(a.y, b.y);
  const float hi_x = fminf(a.z, b.z), hi_y = fminf(a.w, b.w);
  const float inter =
      __fmul_rn(fmaxf(__fsub_rn(hi_x, lo_x), 0.0f), fmaxf(__fsub_rn(hi_y, lo_y), 0.0f));
  float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), eps);
  if (union_floor > 0.0f) uni = fmaxf(uni, union_floor);
  return __fdiv_rn(inter, uni);
}

// torch.max(dim)'s order: (v, j) replaces (best, best_j).
__device__ __forceinline__ bool better(float v, int j, float best, int best_j) {
  const bool v_nan = v != v, best_nan = best != best;
  if (v_nan != best_nan) return v_nan;
  if (v_nan || v == best) return j < best_j;
  return v > best;
}

__global__ void __launch_bounds__(kThreads)
    iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b, int n, int m,
                      float eps, float union_floor, const bool* __restrict__ col_mask,
                      bool vector_store, float* __restrict__ out) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCols;
  if (c0 >= m) return;
  float4 bb[kCols];
  float area_b[kCols];
  bool col_ok[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int j = min(c0 + q, m - 1);
    bb[q] = b[j];
    area_b[q] = box_area(bb[q]);
    col_ok[q] = col_mask == nullptr || col_mask[j];
  }
  const bool whole = vector_store && c0 + kCols <= m;
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < n; i += gridDim.y * blockDim.y) {
    const float4 box = a[i];
    const float area_a = box_area(box);
    float v[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      v[q] = col_ok[q] ? iou_of(box, area_a, bb[q], area_b[q], eps, union_floor) : -1.0f;
    }
    float* dst = out + static_cast<int64_t>(i) * m + c0;
    if (whole) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (c0 + q < m) dst[q] = v[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    iou_match_kernel(const float4* __restrict__ a, const float4* __restrict__ b, int n, int m,
                     float eps, float union_floor, const bool* __restrict__ row_mask,
                     const bool* __restrict__ col_mask, float* __restrict__ best_val,
                     int64_t* __restrict__ best_idx) {
  extern __shared__ float4 smem[];
  float4* sb = smem;
  float* sarea = reinterpret_cast<float*>(sb + m);
  bool* svalid = reinterpret_cast<bool*>(sarea + m);
  const int64_t img = blockIdx.y;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float4 box = b[img * m + k];
    sb[k] = box;
    sarea[k] = box_area(box);
    svalid[k] = col_mask[img * m + k];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  // r is the same for the 32 lanes of a warp, so every lane reaches each shuffle.
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < n; r += gridDim.x * kWarps) {
    const int64_t row = img * n + r;
    float best = -1.0f;
    int best_j = 0;
    if (row_mask[row]) {
      const float4 box = a[row];
      const float area_a = box_area(box);
      best = __int_as_float(0xff800000);  // -inf: any IoU or -1 replaces it
      best_j = m;
      for (int j = lane; j < m; j += 32) {
        const float v = svalid[j] ? iou_of(box, area_a, sb[j], sarea[j], eps, union_floor) : -1.0f;
        if (better(v, j, best, best_j)) {
          best = v;
          best_j = j;
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, best, offset);
        const int j = __shfl_xor_sync(0xffffffffu, best_j, offset);
        if (better(v, j, best, best_j)) {
          best = v;
          best_j = j;
        }
      }
    }
    if (lane == 0) {
      best_val[row] = best;
      best_idx[row] = best_j;
    }
  }
}

__global__ void empty_kernel() {}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs and calls them on PyTorch's current stream.
// Boxes are contiguous float32 and 16-byte aligned, masks contiguous bool
// (nullptr: no column mask in matrix mode). Each returns the launch's
// cudaError_t.

// a [n, 4], b [m, 4], col_mask [m] or nullptr -> out [n, m].
int pairwise_iou_launch(const float* a, const float* b, int n, int m, float eps,
                        float union_floor, const bool* col_mask, float* out, void* stream) {
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const int col_threads = (m + kCols - 1) / kCols;
  const int bx = std::min(kThreads, (col_threads + 31) / 32 * 32);
  const int by = kThreads / bx;
  const int gx = (col_threads + bx - 1) / bx;
  // About four blocks per SM: each thread then walks several rows with its
  // 4 columns' boxes held in registers.
  const int gy = std::max(1, std::min((n + by - 1) / by, 4 * sm_count() / gx));
  const bool vector_store = m % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  iou_matrix_kernel<<<dim3(gx, gy), dim3(bx, by), 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b), n, m, eps,
      union_floor, col_mask, vector_store, out);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a match-mode block takes for m columns.
int iou_match_shared_bytes(int m) {
  return m * static_cast<int>(sizeof(float4) + sizeof(float) + sizeof(bool));
}

// a [batch, n, 4], b [batch, m, 4], row_mask [batch, n], col_mask [batch, m]
// -> best_val, best_idx [batch, n].
int iou_match_launch(const float* a, const float* b, int batch, int n, int m, float eps,
                     float union_floor, const bool* row_mask, const bool* col_mask,
                     float* best_val, int64_t* best_idx, void* stream) {
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int shared = iou_match_shared_bytes(m);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        iou_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // About four blocks per SM over the whole batch, each warp then taking a
  // few rows: the staging of an image's boxes is spread over many rows.
  const int gx = std::max(1, std::min((n + kWarps - 1) / kWarps, 4 * sm_count() / batch));
  iou_match_kernel<<<dim3(gx, batch), kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b), n, m, eps,
      union_floor, row_mask, col_mask, best_val, best_idx);
  return static_cast<int>(cudaGetLastError());
}

// One empty block: the launch floor that the IoU kernels' times sit on.
int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
