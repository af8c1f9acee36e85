// The RPN's anchor assignment for a whole batch on Hopper, sm_90a: every
// anchor's best gt and the "allow low-quality matches" set, without the
// [G, A] IoU ever reaching device memory.
//
// It replaces no Pallas kernel. The JAX package computes this in XLA:
// faster_rcnn_pytorch_tpu/ops/boxes.py:157 (masked_iou_gt_major) and
// faster_rcnn_pytorch_tpu/models/targets.py:111-135 (max and argmax over each
// axis, the tie set or the per-gt argmax scatter). The port ran the same chain
// in eager ops, which at the FPN dense shape (640 gt slots, 268,569 anchors)
// writes and reads some ten [G, A] float32 temporaries of 687 MB an image;
// this kernel keeps each pair's IoU in registers and writes only [B, A].
//
// Semantics (bit-exact with ops/boxes.py::rpn_match_reference, per image):
//   iou[g, a] = masked_iou_gt_major(gt, gt_mask, anchors)[g, a], -1 where
//               gt_mask[g] or inside[a] is False:
//     iw = max(min(gx2, ax2) - max(gx1, ax1), 0), ih likewise in y
//     inter = iw * ih, union = ((area_g + area_a) - inter) + eps,
//     iou = inter / union
//   iou_max[a], iou_argmax[a]: max over g and its first index, as torch.max
//     (a NaN wins, equal values go to the lower index); an all -1 column
//     gives (-1, 0);
//   per_gt_max[g]: max over a; real[g] = gt_mask[g] && per_gt_max[g] > -1;
//   best_any[a] (ties): some real g has iou[g, a] == per_gt_max[g];
//   best_any[a] (argmax): a is the first argmax over a of some real g.
// Every float operation is an explicit __f*_rn intrinsic, in the twin's
// order: nvcc would otherwise contract area_g + (ax2 - ax1) * (ay2 - ay1)
// into one FMA that rounds once where the twin rounds twice.
//
// Design. Pass 1 runs a block per (tile of 1024 anchors, image); each thread
// holds 4 anchors in registers and walks the image's gt, staged in shared
// memory in chunks of kChunk (the --max_gt flag sets G, so a large G is
// staged in turns, never refused). It keeps each anchor's (max, first
// argmax) in registers, and reduces a 64-bit key per gt: the IoU's ordered
// bits (-0 mapped onto +0, so a tie at 0 does not split) in the high word,
// UINT32_MAX - anchor in the low word, so that the largest key names the max
// and its smallest anchor. A warp reduces the key with two __reduce_max_sync,
// the block in shared memory with one atomicMax a warp, the grid with one
// global atomicMax a gt a block. Pass 2 builds best_any: in ties mode it
// recomputes each pair's IoU with the same arithmetic and compares it as a
// float with the decoded per-gt max; in argmax mode a thread a gt sets the
// anchor its key names. The keys are reset by the wrapper in every call.
//
// What bounds it on an H100: operations. At the FPN dense shape (batch 2,
// 640 slots, 268,569 anchors) with every slot real there are 344 M pairs,
// about 14 float operations a pair and pass, two passes in ties mode: 9.6
// GFLOP, 0.14 ms at 67 TFLOP/s float32 (padded slots and outside anchors
// are skipped, so a scene's own bound is lower). Its bytes (the anchors,
// the gt, the inside mask and 13 B an anchor out: [B, A] float32 max,
// int64 argmax, bool set) are 11.8 MB, 3.5 us at 3.35 TB/s. A pair with no intersection (most pairs) skips the division:
// 0 / union is 0 with inter's sign for every positive union.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                      // anchors a thread holds
constexpr int kTile = kThreads * kPerThread;       // anchors a block holds
constexpr int kChunk = 1024;                       // gt boxes staged at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// masked_iou_gt_major's arithmetic for gt g and anchor b, in its order.
__device__ __forceinline__ float iou_gt_major(float4 g, float area_g, float4 b, float area_b,
                                              float eps) {
  const float iw = fmaxf(__fsub_rn(fminf(g.z, b.z), fmaxf(g.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(g.w, b.w), fmaxf(g.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(area_g, area_b), inter), eps);
  return inter == 0.0f && uni > 0.0f ? inter : __fdiv_rn(inter, uni);
}

// torch.max(dim)'s order: (v, j) replaces (best, best_j).
__device__ __forceinline__ bool better(float v, int j, float best, int best_j) {
  const bool v_nan = v != v, best_nan = best != best;
  if (v_nan != best_nan) return v_nan;
  if (v_nan || v == best) return j < best_j;
  return v > best;
}

// Monotone map of a float onto uint32: a NaN above every number (torch.max
// ranks it so), -0 onto +0. 0 is below every value it gives.
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t k) {
  if (k == 0xffffffffu) return __int_as_float(0x7fffffff);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The per-gt max decoded from its key; real where masked in and above -1.
__device__ __forceinline__ float key_max(unsigned long long key) {
  return from_ordered(static_cast<uint32_t>(key >> 32));
}

struct Anchors {
  float4 box[kPerThread];
  float area[kPerThread];
  bool in[kPerThread];
  bool any_in;
};

__device__ __forceinline__ Anchors load_anchors(const float4* __restrict__ anchors,
                                                const bool* __restrict__ inside, int a_count,
                                                int64_t img) {
  Anchors s;
  s.any_in = false;
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = base + k * kThreads;
    const bool ok = a < a_count;
    s.box[k] = ok ? anchors[a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s.area[k] = area_of(s.box[k]);
    s.in[k] = ok && inside[img * a_count + a];
    s.any_in |= s.in[k];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    anchor_match_pass1(const float4* __restrict__ anchors, int a_count,
                       const float4* __restrict__ gt, const bool* __restrict__ gt_mask, int g_count,
                       const bool* __restrict__ inside, float eps, float* __restrict__ iou_max,
                       int64_t* __restrict__ iou_argmax, unsigned long long* __restrict__ gt_key) {
  __shared__ float4 sgt[kChunk];
  __shared__ float sarea[kChunk];
  __shared__ bool smask[kChunk];
  __shared__ unsigned long long skey[kChunk];
  const int64_t img = blockIdx.y;
  const Anchors s = load_anchors(anchors, inside, a_count, img);
  const int base = blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x % 32;
  float best[kPerThread];
  int best_j[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    best[k] = -1.0f;  // an all -1 column: (-1, 0); a real gt's IoU is >= 0 or NaN
    best_j[k] = 0;
  }
  // Both are uniform over the warp / block: every lane reaches the reductions.
  const bool warp_in = __any_sync(kFull, s.any_in);
  const bool block_in = __syncthreads_or(s.any_in);
  for (int c0 = 0; c0 < g_count; c0 += kChunk) {
    const int n = min(kChunk, g_count - c0);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float4 g = gt[img * g_count + c0 + j];
      sgt[j] = g;
      sarea[j] = area_of(g);
      smask[j] = gt_mask[img * g_count + c0 + j];
      skey[j] = 0;
    }
    __syncthreads();
    if (block_in) {
      for (int j = 0; j < n; ++j) {
        if (!smask[j]) continue;  // a padded slot: -1 everywhere, never a max
        const float4 g = sgt[j];
        const float area_g = sarea[j];
        uint32_t hi = 0, lo = 0;
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (!s.in[k]) continue;
          const float v = iou_gt_major(g, area_g, s.box[k], s.area[k], eps);
          if (better(v, c0 + j, best[k], best_j[k])) {
            best[k] = v;
            best_j[k] = c0 + j;
          }
          const uint32_t h = ordered_bits(v);
          const uint32_t l = 0xffffffffu - static_cast<uint32_t>(base + k * kThreads);
          if (h > hi || (h == hi && l > lo)) {
            hi = h;
            lo = l;
          }
        }
        if (warp_in) {
          const uint32_t whi = __reduce_max_sync(kFull, hi);
          const uint32_t wlo = __reduce_max_sync(kFull, hi == whi ? lo : 0u);
          if (lane == 0 && whi != 0) {
            const unsigned long long key = (static_cast<unsigned long long>(whi) << 32) | wlo;
            if (skey[j] < key) atomicMax(&skey[j], key);
          }
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      if (skey[j] != 0) atomicMax(&gt_key[img * g_count + c0 + j], skey[j]);
    }
    __syncthreads();  // the next chunk overwrites the shared arrays
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = base + k * kThreads;
    if (a < a_count) {
      iou_max[img * a_count + a] = best[k];
      iou_argmax[img * a_count + a] = best_j[k];
    }
  }
}

// ties mode: best_any[a] = some real gt has iou[g, a] == per_gt_max[g].
__global__ void __launch_bounds__(kThreads)
    anchor_match_ties(const float4* __restrict__ anchors, int a_count,
                      const float4* __restrict__ gt, const bool* __restrict__ gt_mask, int g_count,
                      const bool* __restrict__ inside, float eps,
                      const unsigned long long* __restrict__ gt_key, bool* __restrict__ best_any) {
  __shared__ float4 sgt[kChunk];
  __shared__ float sarea[kChunk];
  __shared__ float smax[kChunk];
  __shared__ bool sreal[kChunk];
  const int64_t img = blockIdx.y;
  const Anchors s = load_anchors(anchors, inside, a_count, img);
  bool hit[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) hit[k] = false;
  const bool block_in = __syncthreads_or(s.any_in);
  for (int c0 = 0; c0 < g_count; c0 += kChunk) {
    const int n = min(kChunk, g_count - c0);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float4 g = gt[img * g_count + c0 + j];
      const float m = key_max(gt_key[img * g_count + c0 + j]);
      sgt[j] = g;
      sarea[j] = area_of(g);
      smax[j] = m;
      sreal[j] = gt_mask[img * g_count + c0 + j] && m > -1.0f;
    }
    __syncthreads();
    if (block_in) {
      for (int j = 0; j < n; ++j) {
        if (!sreal[j]) continue;
        const float4 g = sgt[j];
        const float area_g = sarea[j], m = smax[j];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (s.in[k] && !hit[k]) hit[k] = iou_gt_major(g, area_g, s.box[k], s.area[k], eps) == m;
        }
      }
    }
    __syncthreads();
  }
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = base + k * kThreads;
    if (a < a_count) best_any[img * a_count + a] = hit[k];
  }
}

// argmax mode: each real gt sets its first argmax anchor (best_any zeroed
// by the wrapper; several gt may write the same true).
__global__ void anchor_match_argmax(const bool* __restrict__ gt_mask, int64_t slots, int g_count,
                                    int a_count, const unsigned long long* __restrict__ gt_key,
                                    bool* __restrict__ best_any) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const unsigned long long key = gt_key[i];
  if (gt_mask[i] && key_max(key) > -1.0f) {
    const uint32_t a = 0xffffffffu - static_cast<uint32_t>(key & 0xffffffffu);
    best_any[(i / g_count) * a_count + a] = true;
  }
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs and the keys and calls them on PyTorch's
// current stream. Boxes are contiguous float32 and 16-byte aligned, masks
// contiguous bool.

// The key that every gt_key entry starts each call with: (-1, anchor 0), the
// max and first argmax of a row of -1.
int64_t anchor_match_initial_key() {
  return static_cast<int64_t>((0x407fffffull << 32) | 0xffffffffull);  // ordered_bits(-1.0f)
}

// anchors [a_count, 4], gt [batch, g_count, 4], gt_mask [batch, g_count],
// inside [batch, a_count] -> iou_max, iou_argmax, best_any [batch, a_count];
// gt_key [batch, g_count] set to anchor_match_initial_key(); best_any zeroed
// when !ties. Returns the first launch's cudaError_t that is not success.
int anchor_match_launch(const float* anchors, int a_count, const float* gt, const bool* gt_mask,
                        int batch, int g_count, const bool* inside, float eps, bool ties,
                        float* iou_max, int64_t* iou_argmax, unsigned long long* gt_key,
                        bool* best_any, void* stream_ptr) {
  if (batch == 0 || a_count == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((a_count + kTile - 1) / kTile, batch);
  const float4* a4 = reinterpret_cast<const float4*>(anchors);
  const float4* g4 = reinterpret_cast<const float4*>(gt);
  anchor_match_pass1<<<grid, kThreads, 0, stream>>>(a4, a_count, g4, gt_mask, g_count, inside,
                                                    eps, iou_max, iou_argmax, gt_key);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ties) {
    anchor_match_ties<<<grid, kThreads, 0, stream>>>(a4, a_count, g4, gt_mask, g_count, inside,
                                                     eps, gt_key, best_any);
  } else {
    const int64_t slots = static_cast<int64_t>(batch) * g_count;
    const int threads = 256;
    anchor_match_argmax<<<static_cast<unsigned>((slots + threads - 1) / threads), threads, 0,
                          stream>>>(gt_mask, slots, g_count, a_count, gt_key, best_any);
  }
  return static_cast<int>(cudaGetLastError());
}
