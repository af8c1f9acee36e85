// Pairwise IoU of two box sets, [n, 4] x [m, 4] -> [n, m] float32, for
// Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/iou_kernel.py
// (_iou_kernel, launched by pairwise_iou_pallas). It computes the same
// function, not the TPU layout: the Pallas kernel takes B pre-transposed to
// [4, m] lane rows, pads both sets to 512-row blocks and evaluates one
// (block_n, block_m) VMEM tile per grid step. None of that is carried over.
// Here every output element (i, j) is one thread: a block stages its 32
// columns of b in shared memory, each thread reads its row of a (a warp reads
// one box, broadcast) and the warp's 32 stores of one row are contiguous.
//
// Semantics (bit-exact with the plain twin ops/boxes.py::pairwise_iou_reference):
//   inter = max(min(ax2, bx2) - max(ax1, bx1), 0) * max(min(ay2, by2) - max(ay1, by1), 0)
//   union = ((area_a + area_b) - inter) + eps, area = (x2 - x1) * (y2 - y1)
//   union = max(union, 1e-12) when eps == 0 (the kernel's union_floor)
//   iou   = inter / union
// Every float operation is an explicit __f*_rn intrinsic: nvcc contracts
// a*b + c into an FMA by default, and area_a + (bx2 - bx1) * (by2 - by1)
// would then round once where the twin rounds twice.
//
// What bounds it on an H100: bytes. At the dense legacy train shape
// (2512 candidates x 512 gt slots) it writes 5.1 MB and reads 48 KB, about
// 1.5 us at 3.35 TB/s, so one launch costs its launch overhead; its 15
// operations per output are negligible.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;  // columns (b boxes) of a block: one warp wide
constexpr int kRowThreads = 8;
constexpr int kRows = 64;  // rows of a block: each thread takes kRows / kRowThreads

__global__ void pairwise_iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                    int n, int m, float eps, float union_floor,
                                    float* __restrict__ out) {
  __shared__ float sb[kCols][4];
  const int col0 = blockIdx.x * kCols;
  const int t = threadIdx.y * kCols + threadIdx.x;
  if (t < kCols * 4) {
    const int j = col0 + t / 4;
    sb[t / 4][t % 4] = j < m ? b[static_cast<int64_t>(j) * 4 + t % 4] : 0.0f;
  }
  __syncthreads();
  const int j = col0 + threadIdx.x;
  if (j >= m) return;
  const float bx1 = sb[threadIdx.x][0], by1 = sb[threadIdx.x][1];
  const float bx2 = sb[threadIdx.x][2], by2 = sb[threadIdx.x][3];
  const float area_b = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
  const int row_end = min(n, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int i = blockIdx.y * kRows + threadIdx.y; i < row_end; i += kRowThreads) {
    const float* box = a + static_cast<int64_t>(i) * 4;
    const float ax1 = box[0], ay1 = box[1], ax2 = box[2], ay2 = box[3];
    const float lo_x = fmaxf(ax1, bx1), lo_y = fmaxf(ay1, by1);
    const float hi_x = fminf(ax2, bx2), hi_y = fminf(ay2, by2);
    const float inter =
        __fmul_rn(fmaxf(__fsub_rn(hi_x, lo_x), 0.0f), fmaxf(__fsub_rn(hi_y, lo_y), 0.0f));
    const float area_a = __fmul_rn(__fsub_rn(ax2, ax1), __fsub_rn(ay2, ay1));
    float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), eps);
    if (union_floor > 0.0f) uni = fmaxf(uni, union_floor);
    out[static_cast<int64_t>(i) * m + j] = __fdiv_rn(inter, uni);
  }
}

}  // namespace

// Plain C++ entry point (no PyTorch headers here); the binding in
// binding.cpp checks the tensors and calls it on PyTorch's current stream.
// a [n, 4], b [m, 4] and out [n, m] are contiguous float32. Returns the
// launch's cudaError_t.
int pairwise_iou_launch(const float* a, const float* b, int n, int m, float eps,
                        float union_floor, float* out, void* stream) {
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kCols, kRowThreads);
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  pairwise_iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, m, eps, union_floor, out);
  return static_cast<int>(cudaGetLastError());
}
