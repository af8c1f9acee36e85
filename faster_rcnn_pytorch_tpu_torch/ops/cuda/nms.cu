// Segmented exact greedy NMS for Hopper, sm_90a: one launch suppresses every
// segment of a batch with no host synchronisation.
//
//   boxes [S, n, 4] float32, each segment sorted by descending score;
//   valid [S, n] bool (an invalid entry is never kept and suppresses nothing)
//   -> keep [S, post_k] int32: the positions of the first post_k kept boxes
//      in greedy (ascending position) order, -1 padded;
//      count [S] int32: how many of them there are.
//
// There is no Pallas kernel behind it: the JAX package's NMS
// (faster_rcnn_pytorch_tpu/ops/nms.py, nms) is a lax.while_loop over tiles
// that XLA keeps on the device. The port's plain version
// (ops/nms.py::nms_segments_reference) walks the same tiles with host
// synchronisations. This kernel computes the same function: box i is kept iff
// it is valid and no kept j < i has iou(j, i) > iou_threshold.
//
// The IoU is ops/boxes.py::box_iou's, in its order of operations:
//   inter = clamp(min(x2) - max(x1), 0) * clamp(min(y2) - max(y1), 0)
//   union = (area_a + area_b) - inter, area = (x2 - x1) * (y2 - y1)
//   iou   = inter / clamp(union, 1e-12)
// in __f*_rn intrinsics (nvcc would contract a*b + c into an FMA) with an
// IEEE division, and with torch's NaN-propagating maximum, minimum and clamp.
// The formula is symmetric bit for bit (IEEE addition and multiplication
// commute), so a box tested against a kept one gives the plain version's
// iou(candidate, kept) as well as its in-tile iou(kept, candidate). The
// threshold is compared in float32, as torch compares a float32 tensor with
// a Python scalar.
//
// Design: a block per segment walks tiles of 64 sorted boxes. The boxes kept
// so far (at most post_k: 2000 x 20 B = 40 KB at the train proposals) live in
// shared memory. For each tile: (1) each warp tests one candidate at a time
// against the kept list, 32 kept boxes per step, and stops at the first hit;
// (2) the survivors' 64 x 64 upper-triangular overlap mask is built, one
// uint64 a row, from two ballots per row; (3) one thread resolves the greedy
// order inside the tile with bit operations (the lowest surviving bit is the
// next kept box; its row clears the boxes it suppresses) and appends the kept
// boxes to the shared list and their positions to keep. The block stops at
// post_k kept boxes; empty tiles cost their 64 flag reads.
//
// What bounds it on an H100: operations, 14 a tested pair, which the data
// decides (a suppressed box stops at its first hit, a kept one meets every
// box kept before it); the bytes (16 B a box, 1 B a flag, 4 B an output) are
// under a megabyte at every call site. One block per segment leaves most SMs
// idle where there are few segments (the proposals: one per image), and the
// greedy order is serial within a segment; making that faster is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum / clamp: a NaN operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr, as ops/boxes.py::box_iou computes the IoU.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 0.0f);
  const float h = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void __launch_bounds__(kThreads)
    nms_segments_kernel(const float4* __restrict__ boxes, const bool* __restrict__ valid, int n,
                        float thr, int post_k, int32_t* __restrict__ keep,
                        int32_t* __restrict__ count) {
  extern __shared__ float4 smem[];
  float4* kept = smem;                                              // [post_k]
  float4* tile = kept + post_k;                                     // [kTile]
  uint64_t* rows = reinterpret_cast<uint64_t*>(tile + kTile);       // [kTile]
  float* tile_area = reinterpret_cast<float*>(rows + kTile);        // [kTile]
  float* kept_area = tile_area + kTile;                             // [post_k]
  __shared__ unsigned long long s_cand, s_hit;
  __shared__ int s_kept;

  const int64_t seg = blockIdx.x;
  boxes += seg * n;
  valid += seg * n;
  keep += seg * post_k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    s_hit = 0;
    s_kept = 0;
  }
  int n_kept = 0;  // block-uniform: read back from s_kept after each tile
  for (int t0 = 0; t0 < n && n_kept < post_k; t0 += kTile) {
    if (threadIdx.x < kTile) {
      const int j = t0 + threadIdx.x;
      const bool ok = j < n && valid[j];
      const float4 b = ok ? boxes[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      tile[threadIdx.x] = b;
      tile_area[threadIdx.x] = box_area(b);
      const unsigned bits = __ballot_sync(kFull, ok);
      if (lane == 0) reinterpret_cast<unsigned*>(&s_cand)[warp] = bits;
    }
    __syncthreads();
    const uint64_t cand = s_cand;
    if (cand == 0) {
      __syncthreads();  // s_cand is rewritten by the next tile
      continue;
    }

    // (1) Against the boxes kept in earlier tiles: a warp per candidate.
    for (int c = warp; c < kTile; c += kWarps) {
      if (!((cand >> c) & 1)) continue;
      const float4 b = tile[c];
      const float area = tile_area[c];
      for (int k0 = 0; k0 < n_kept; k0 += 32) {
        const int k = k0 + lane;
        const bool hit = k < n_kept && overlaps(b, area, kept[k], kept_area[k], thr);
        if (__any_sync(kFull, hit)) {
          if (lane == 0) atomicOr(&s_hit, 1ull << c);
          break;
        }
      }
    }
    __syncthreads();
    const uint64_t alive = cand & ~static_cast<uint64_t>(s_hit);

    // (2) The survivors' overlaps inside the tile: row r holds the later
    // boxes that r suppresses if it is kept.
    for (int r = warp; r < kTile; r += kWarps) {
      if (!((alive >> r) & 1)) continue;
      const float4 b = tile[r];
      const float area = tile_area[r];
      const int lo = lane, hi = lane + 32;
      const bool o_lo = lo > r && ((alive >> lo) & 1) &&
                        overlaps(b, area, tile[lo], tile_area[lo], thr);
      const bool o_hi = hi > r && ((alive >> hi) & 1) &&
                        overlaps(b, area, tile[hi], tile_area[hi], thr);
      const unsigned m_lo = __ballot_sync(kFull, o_lo), m_hi = __ballot_sync(kFull, o_hi);
      if (lane == 0) rows[r] = (static_cast<uint64_t>(m_hi) << 32) | m_lo;
    }
    __syncthreads();

    // (3) The greedy order inside the tile, then the appends.
    if (threadIdx.x == 0) {
      uint64_t rem = alive;
      int k = n_kept;
      while (rem != 0 && k < post_k) {
        const int r = __ffsll(static_cast<long long>(rem)) - 1;
        rem &= ~(1ull << r);
        rem &= ~rows[r];
        kept[k] = tile[r];
        kept_area[k] = tile_area[r];
        keep[k] = t0 + r;
        ++k;
      }
      s_kept = k;
      s_hit = 0;
    }
    __syncthreads();
    n_kept = s_kept;
  }
  for (int k = n_kept + threadIdx.x; k < post_k; k += kThreads) keep[k] = -1;
  if (threadIdx.x == 0) count[seg] = n_kept;
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs and calls them on PyTorch's current stream.

// Shared memory a block takes for post_k kept boxes.
int nms_segments_shared_bytes(int post_k) {
  return post_k * static_cast<int>(sizeof(float4) + sizeof(float)) +
         kTile * static_cast<int>(sizeof(float4) + sizeof(uint64_t) + sizeof(float));
}

// boxes [segments, n, 4] float32 (16-byte aligned), valid [segments, n] bool
// -> keep [segments, post_k] int32, count [segments] int32. Returns the
// launch's cudaError_t.
int nms_segments_launch(const float* boxes, const bool* valid, int segments, int n, float thr,
                        int post_k, int32_t* keep, int32_t* count, void* stream) {
  if (segments == 0) return static_cast<int>(cudaSuccess);
  const int shared = nms_segments_shared_bytes(post_k);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_segments_kernel<<<segments, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(boxes), valid, n, thr, post_k, keep, count);
  return static_cast<int>(cudaGetLastError());
}
