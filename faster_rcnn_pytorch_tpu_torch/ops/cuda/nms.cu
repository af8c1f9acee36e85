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
// What bounds it: not the bytes (16 B a box, 1 B a flag, 4 B an output: under
// a megabyte at every call site) and not the operations (14 a tested pair;
// 5.2 M pairs at the legacy train proposals are about 1 us at 67 TFLOP/s) but
// latency. The greedy order makes a segment's tiles of 64 sorted boxes
// strictly sequential (a tile is tested against every box kept before it),
// so a tile's time is a chain of dependent steps, and at the proposal sites
// (one or two segments of 2000-12000 boxes, up to 188 tiles) one block per
// segment left 130 of 132 SMs idle while 8 warps walked the candidates and
// one thread the greedy order.
//
// Design: a thread-block cluster of W CTAs per segment (ops/nms.py::nms_plan
// picks W: 16 or 8 where the segments leave SMs idle and each CTA's share of
// the kept list holds at least 32 boxes, else 1). Kept box k lives in CTA
// k mod W's shared memory, so a CTA holds ceil(post_k / W) boxes. Every CTA
// of the cluster walks the same tiles and keeps the same greedy state, and a
// tile costs one cluster barrier:
//   (a) every CTA loads the tile's flags (each warp ballots them itself; the
//       next tile's flags and boxes are loaded while this one is worked on)
//       and, if any is valid, the tile's boxes and their areas;
//   (b) every CTA tests every valid candidate against its share of the kept
//       list, the (candidate, kept) pairs spread over all 512 threads: a
//       thread takes one candidate and every G-th kept box of the share,
//       stops at its first hit and skips a candidate another thread of the
//       CTA has already hit; no CTA stops another, so a tile covers up to
//       64 x (kept so far) pairs against the greedy's first hits;
//   (c) the CTA's hits (one 64-bit word) are stored into its slot in every
//       CTA's hit words through distributed shared memory, then
//       cluster.sync(): each CTA now holds the tile's hits by every kept box;
//   (d) every CTA builds the survivors' 64 x 64 overlap mask (two ballots a
//       row) and one thread resolves the greedy order inside the tile with
//       bit operations (the lowest surviving bit is the next kept box; its
//       row clears the boxes it suppresses); the CTAs compute the same bits,
//       so none waits for another's result. Each CTA appends the new kept
//       boxes it owns to its share; CTA 0 writes their positions to keep.
// The hit words alternate between two sets by tile: a CTA reads tile t's set
// after the barrier and before it reaches tile t + 1's barrier, which every
// CTA must pass before it stores into tile t + 2's (the same set), so no set
// is cleared or read early. Every CTA stops at post_k kept boxes or the
// segment's end, so all pass the same barriers; a segment without a valid box
// passes only the first and the last, which keeps every CTA's shared memory
// alive until no other CTA can write into it. With W = 1 (the per-class sites: 182 segments
// fill the card; the offset pass) the cluster is one CTA.
//
// A pair with no intersection skips the division where thr >= 0: its IoU is
// 0 / union, which is 0 (or NaN where an area is), and exceeds no such thr.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxWidth = 16;
constexpr unsigned kFull = 0xffffffffu;
// The kernel's static shared words: s_hits, s_mine, s_taken.
constexpr int kStaticShared = (2 * kMaxWidth + 2) * static_cast<int>(sizeof(uint64_t));

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
  if (inter == 0.0f && thr >= 0.0f) return false;  // 0 / union is 0, or NaN: neither exceeds thr
  const float uni = nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ uint64_t below(int c) { return (1ull << c) - 1; }

__global__ void __launch_bounds__(kThreads)
    nms_segments_kernel(const float4* __restrict__ boxes, const bool* __restrict__ valid, int n,
                        float thr, int post_k, int share, int32_t* __restrict__ keep,
                        int32_t* __restrict__ count) {
  cg::cluster_group cluster = cg::this_cluster();
  const int width = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem[];
  float4* kept = smem;                                                // [share]
  float4* tile = kept + share;                                        // [kTile]
  uint64_t* rows = reinterpret_cast<uint64_t*>(tile + kTile);         // [kTile]
  float* kept_area = reinterpret_cast<float*>(rows + kTile);          // [share]
  float* tile_area = kept_area + share;                               // [kTile]
  unsigned char* cand_list = reinterpret_cast<unsigned char*>(tile_area + kTile);  // [kTile]
  // Each CTA's hits on a tile, by tile parity: CTA r writes slot [r] of every CTA.
  __shared__ uint64_t s_hits[2][kMaxWidth];
  __shared__ unsigned long long s_mine;  // this CTA's hits on the tile
  __shared__ uint64_t s_taken;           // the tile's newly kept boxes

  const int64_t seg = blockIdx.x / width;
  boxes += seg * n;
  valid += seg * n;
  keep += seg * post_k;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) s_mine = 0;
  cluster.sync();  // every CTA of the cluster runs before any writes into another

  // The first tile's flags and boxes; each tile then loads the next one's.
  bool f_lo = lane < n && valid[lane];
  bool f_hi = 32 + lane < n && valid[32 + lane];
  float4 f_box = tid < kTile && tid < n ? boxes[tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int n_kept = 0;  // cluster-uniform: every CTA resolves the same greedy order
  int parity = 0;
  for (int t0 = 0; t0 < n && n_kept < post_k; t0 += kTile) {
    const uint64_t cand =
        (static_cast<uint64_t>(__ballot_sync(kFull, f_hi)) << 32) | __ballot_sync(kFull, f_lo);
    const float4 raw = f_box;
    const int t1 = t0 + kTile;
    f_lo = t1 + lane < n && valid[t1 + lane];
    f_hi = t1 + 32 + lane < n && valid[t1 + 32 + lane];
    f_box = tid < kTile && t1 + tid < n ? boxes[t1 + tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (cand == 0) continue;  // cluster-uniform: the flags are the same everywhere

    // (a) the tile, and the list of its candidates' slots.
    if (tid < kTile) {
      const bool ok = (cand >> tid) & 1;
      const float4 b = ok ? raw : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      tile[tid] = b;
      tile_area[tid] = box_area(b);
      if (ok) cand_list[__popcll(cand & below(tid))] = static_cast<unsigned char>(tid);
    }
    __syncthreads();

    // (b) every candidate against this CTA's share of the kept list.
    const int mine = n_kept > rank ? (n_kept - rank - 1) / width + 1 : 0;
    const int n_cand = __popcll(cand);
    const int groups = kThreads / n_cand;
    if (mine > 0 && tid < groups * n_cand) {
      const int c = cand_list[tid % n_cand];
      const uint64_t bit = 1ull << c;
      const float4 b = tile[c];
      const float area = tile_area[c];
      const volatile unsigned long long* seen = &s_mine;
      for (int k = tid / n_cand; k < mine; k += groups) {
        if (*seen & bit) break;
        if (overlaps(b, area, kept[k], kept_area[k], thr)) {
          atomicOr(&s_mine, static_cast<unsigned long long>(bit));
          break;
        }
      }
    }
    __syncthreads();

    // (c) this CTA's hits into its slot of every CTA's words for the tile.
    if (tid < width) *cluster.map_shared_rank(&s_hits[parity][rank], tid) = s_mine;
    cluster.sync();

    // (d) the survivors' overlaps inside the tile: row r holds the later
    // boxes that r suppresses if it is kept.
    uint64_t hits = 0;
    for (int r = 0; r < width; ++r) hits |= s_hits[parity][r];
    const uint64_t alive = cand & ~hits;
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
    if (tid == 0) {
      s_mine = 0;  // read for (c) before the cluster barrier
      uint64_t rem = alive, taken = 0;
      for (int k = n_kept; rem != 0 && k < post_k; ++k) {
        const int r = __ffsll(static_cast<long long>(rem)) - 1;
        taken |= 1ull << r;
        rem &= ~(1ull << r);
        rem &= ~rows[r];
      }
      s_taken = taken;
    }
    __syncthreads();
    const uint64_t taken = s_taken;
    if (tid < kTile && ((taken >> tid) & 1)) {
      const int k = n_kept + __popcll(taken & below(tid));
      if (k % width == rank) {
        kept[k / width] = tile[tid];
        kept_area[k / width] = tile_area[tid];
      }
      if (rank == 0) keep[k] = t0 + tid;
    }
    n_kept += __popcll(taken);
    parity ^= 1;
  }
  if (rank == 0) {
    for (int k = n_kept + tid; k < post_k; k += kThreads) keep[k] = -1;
    if (tid == 0) count[seg] = n_kept;
  }
  cluster.sync();  // no CTA leaves while another may still write its shared memory
}

// Dynamic shared memory of a CTA holding `share` kept boxes (the layout at
// the top of nms_segments_kernel; ops/nms.py::nms_shared_bytes computes it).
int dynamic_shared_bytes(int share) {
  return share * static_cast<int>(sizeof(float4) + sizeof(float)) +
         kTile * static_cast<int>(sizeof(float4) + sizeof(uint64_t) + sizeof(float) + 1);
}

cudaLaunchConfig_t launch_config(int segments, int width, int shared, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(segments) * static_cast<unsigned>(width));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(shared);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(width);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for a cluster of `width` CTAs of `shared` bytes.
cudaError_t set_attributes(int width, int shared) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
  }
  if (width > 8) {
    return cudaFuncSetAttribute(nms_segments_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return cudaSuccess;
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs and calls them on PyTorch's current stream.

// Shared memory a CTA holding `share` kept boxes takes, its static words
// included.
int nms_segments_shared_bytes(int share) { return dynamic_shared_bytes(share) + kStaticShared; }

// How many clusters of `width` CTAs, each holding a share of `share` kept
// boxes, the current device can run at once (0 where it runs none), or a
// negative cudaError_t.
int nms_segments_max_active_clusters(int width, int share) {
  const int shared = dynamic_shared_bytes(share);
  cudaError_t err = set_attributes(width, shared);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, width, shared, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, nms_segments_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the query's error is not a launch's
    return -static_cast<int>(err);
  }
  return clusters;
}

// boxes [segments, n, 4] float32 (16-byte aligned), valid [segments, n] bool
// -> keep [segments, post_k] int32, count [segments] int32, with a cluster of
// `width` CTAs a segment, each holding `share` = ceil(post_k / width) kept
// boxes. Returns the launch's cudaError_t; a refused cluster launch is an
// error, never a fallback.
int nms_segments_launch(const float* boxes, const bool* valid, int segments, int n, float thr,
                        int post_k, int width, int32_t* keep, int32_t* count, void* stream) {
  if (segments == 0) return static_cast<int>(cudaSuccess);
  const int share = (post_k + width - 1) / width;
  const int shared = dynamic_shared_bytes(share);
  cudaError_t err = set_attributes(width, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(segments, width, shared, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, nms_segments_kernel, reinterpret_cast<const float4*>(boxes),
                           valid, n, thr, post_k, share, keep, count);
  const cudaError_t last = cudaGetLastError();  // read (and clear) it either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}
