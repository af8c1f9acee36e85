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
//     (a NaN wins, equal values go to the lower index, -0 == +0); an all -1
//     column gives (-1, 0);
//   per_gt_max[g]: max over a; real[g] = gt_mask[g] && per_gt_max[g] > -1;
//   best_any[a] (ties): some real g has iou[g, a] == per_gt_max[g];
//   best_any[a] (argmax): a is the first argmax over a of some real g.
// Every float operation is an explicit __f*_rn intrinsic, in the twin's
// order: nvcc would otherwise contract area_g + (ax2 - ax1) * (ay2 - ay1)
// into one FMA that rounds once where the twin rounds twice. The binding
// refuses eps < 0, so a real gt's IoU is NaN, +-0 or positive: inter > 0
// needs both extents positive, and then the union is positive.
//
// Design. A block of 4 warps holds a tile of 128 anchors of one image in
// registers. ops/boxes.py::rpn_match_plan splits the gt axis over the
// grid's y dimension where the tiles alone leave the card short of blocks
// (legacy: 296 tiles an image at 800x1344), so pass 1 runs a block per
// (tile, gt share, image), last tile first (the FPN's coarse levels, whose
// tiles keep the most gt, lie at the end).
//   Culling. A block reduces the hull of its inside anchors (min x1, min y1,
// max x2, max y2) and their least area. A real gt that lies strictly beside
// the hull on one axis gives every inside anchor iw or ih of exactly +0 and
// so inter = +0; where (area_g + least area) + eps > 0 every union is
// positive too (the sum is monotone in the anchor's area), and the IoU is
// exactly +0. Such a gt is culled: not walked, and folded in once, into each
// anchor's (max, first argmax) as +0 at the first culled slot. Culling needs
// finite corners and areas and no -0 corner, on the gt and on every inside
// anchor of the tile; otherwise the pair takes the full path, as does every
// gt whose union may not be positive (zero-area and inverted gt with eps =
// 0, or a large negative area).
//   The survivors are compacted into shared memory in chunks of kChunk
// slots (the --max_gt flag sets G, so a large G is staged in turns, never
// refused). The plan's layout says how the warps share them: with few gt
// each warp holds 32 of the anchors and walks every survivor; from 256
// slots every warp holds all 128 (4 a lane) and walks a quarter of the
// survivors, so that a coarse FPN tile that keeps hundreds of gt is walked
// by four warps at once. Each lane keeps its anchors' (max, first argmax)
// (the warps of a tile's anchors are combined at the end); a warp reduces a
// 64-bit key a gt, the ordered bits of its positive or NaN IoUs in the high
// word, UINT32_MAX - anchor in the low word, so that the largest key names
// the max and its smallest anchor, with two __reduce_max_sync, the block's
// in shared memory, and one global atomicMax a gt a block the grid's
// (skipped where the key there is already larger). A gt whose IoUs are all
// +-0 raises no key: its max is 0 and, every inside anchor tying at 0, its
// first argmax is the image's first inside anchor, which pass 1 reduces
// into a word an image. With the gt split, each share writes its own (max,
// first argmax) of every anchor; pass 2 combines them in share order.
//   Pass 2. In ties mode, a block per (tile, image), it walks the real gt
// again with the same culling and compares each survivor's IoU, as a float,
// with the gt's decoded max (a culled gt whose max is 0 ties every inside
// anchor of the tile), and writes best_any whole. In argmax mode a thread a
// gt slot sets best_any at the anchor its key (or the first-anchor word)
// names. The only other launch of a call is one memset: the keys and the
// words, and in argmax mode best_any, which follows them.
//
// What bounds it on an H100. Operations on the pairs whose boxes intersect
// (14 float operations a pair, two passes in ties mode): at the FPN dense
// shape (batch 2, 640 slots, 268,569 anchors) 1.2 M of the 183 M pairs of a
// real gt and an anchor intersect, so the bytes bound it (anchors, gt,
// masks and 13 B an anchor out: [B, A] float32 max, int64 argmax, bool set;
// 11.8 MB, 3.5 us at 3.35 TB/s). What holds it back is the walk of the
// survivors that do not intersect either: a tile's hull is coarser than its
// anchors. A pair with no intersection skips the division: 0 / union is 0
// with inter's sign for every positive union.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                  // anchors a block holds: RPN_MATCH_TILE
constexpr int kChunk = 512;                 // gt slots tested, and survivors staged, at a time
constexpr int kRounds = kChunk / kThreads;  // slots a thread loads of a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;              // no anchor, no slot

// How a block's warps share a tile (ops/boxes.py::rpn_match_plan's
// per_lane): each warp holds kPerLane anchors a lane, a group of 32 *
// kPerLane in a row; the kPerLane warps of a group walk every kPerLane-th
// survivor. 1: a warp a quarter of the tile, walking every survivor (few
// survivors: the least registers); 4: every warp the whole tile, a
// quarter of the survivors each (many survivors: a quarter of the chain).
template <int kPerLane>
struct Layout {
  static_assert(kPerLane == 1 || kPerLane == 4, "a lane holds 1 or 4 anchors");
  static constexpr int kSpan = 32 * kPerLane;       // anchors of a group
  static constexpr int kGroups = kTile / kSpan;     // groups of a tile
  __device__ static int group() { return (threadIdx.x / 32) % kGroups; }
  __device__ static int rank() { return (threadIdx.x / 32) / kGroups; }
  // The tile position of this lane's k-th anchor.
  __device__ static int position(int k) { return group() * kSpan + k * 32 + threadIdx.x % 32; }
};

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

// Monotone map of a positive float or a NaN onto uint32, a NaN above every
// number (torch.max ranks it so); 0 is below every value it gives.
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  return v != v ? 0xffffffffu : __float_as_uint(v) | 0x80000000u;
}

// A gt's max over the inside anchors from its key, the largest (ordered
// bits, UINT32_MAX - anchor) of its positive or NaN IoUs. Every other IoU of
// a real gt is +-0 (see the head), so a key that no pair raised (0) means a
// max of 0, reached first at the image's first inside anchor.
__device__ __forceinline__ float key_max(unsigned long long key) {
  const uint32_t k = static_cast<uint32_t>(key >> 32);
  return key == 0 ? 0.0f : k == 0xffffffffu ? __int_as_float(0x7fffffff)
                                            : __uint_as_float(k & 0x7fffffffu);
}

__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ bool neg_zero(float x) { return __float_as_uint(x) == 0x80000000u; }

// A box whose IoU with a box strictly beside it is exactly +0 wherever the
// union is positive: finite corners and area, no -0 corner (so neither
// clamped width nor height can be -0).
__device__ __forceinline__ bool plain_box(float4 b, float area) {
  return finite(b.x) && finite(b.y) && finite(b.z) && finite(b.w) && finite(area) &&
         !neg_zero(b.x) && !neg_zero(b.y) && !neg_zero(b.z) && !neg_zero(b.w);
}

// The first anchor of the block's tile. The tiles run last to first: the
// FPN's coarse levels, whose tiles cull the fewest gt, lie at the end.
__device__ __forceinline__ int tile_start() { return (gridDim.x - 1 - blockIdx.x) * kTile; }

__device__ __forceinline__ float4 hull_of(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

// A block's tile: this lane's kPerLane anchors in registers; over the
// tile's inside anchors (the same in every thread) their hull (min x1, min
// y1, max x2, max y2), least area and first index, and whether a gt may be
// culled against them (none inside, or one not plain: no).
template <int kPerLane>
struct Tile {
  float4 box[kPerLane];
  float area[kPerLane];
  bool in[kPerLane];
  bool warp_in;  // some anchor of the warp is inside
  int first_in;  // kNone: no inside anchor
  bool cull;
  float4 hull;
  float min_area;
};

// Ends with __syncthreads(): shared writes made before the call are seen
// by every thread after it.
template <int kPerLane>
__device__ Tile<kPerLane> load_tile(const float4* __restrict__ anchors,
                                    const bool* __restrict__ inside, int a_count, int64_t img) {
  using L = Layout<kPerLane>;
  __shared__ float4 s_hull[kWarps];
  __shared__ float s_area[kWarps];
  __shared__ int s_first[kWarps];
  __shared__ int s_plain[kWarps];
  const float inf = __int_as_float(0x7f800000);
  Tile<kPerLane> t;
  float4 hull = make_float4(inf, inf, -inf, -inf);
  float min_area = inf;
  int first = kNone;
  bool plain = true, any_in = false;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int a = tile_start() + L::position(k);
    const bool ok = a < a_count;
    t.box[k] = ok ? anchors[a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    t.area[k] = area_of(t.box[k]);
    t.in[k] = ok && inside[img * a_count + a];
    if (t.in[k]) {
      hull = hull_of(hull, t.box[k]);
      min_area = fminf(min_area, t.area[k]);
      first = min(first, a);
      plain = plain && plain_box(t.box[k], t.area[k]);
      any_in = true;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hull = hull_of(hull, make_float4(__shfl_xor_sync(kFull, hull.x, o), __shfl_xor_sync(kFull, hull.y, o),
                                     __shfl_xor_sync(kFull, hull.z, o), __shfl_xor_sync(kFull, hull.w, o)));
    min_area = fminf(min_area, __shfl_xor_sync(kFull, min_area, o));
  }
  first = static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(first)));
  plain = __all_sync(kFull, plain);
  t.warp_in = __any_sync(kFull, any_in);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_hull[warp] = hull;
    s_area[warp] = min_area;
    s_first[warp] = first;
    s_plain[warp] = plain;
  }
  __syncthreads();
  t.hull = s_hull[0];
  t.min_area = s_area[0];
  t.first_in = s_first[0];
  plain = s_plain[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    t.hull = hull_of(t.hull, s_hull[w]);
    t.min_area = fminf(t.min_area, s_area[w]);
    t.first_in = min(t.first_in, s_first[w]);
    plain = plain && s_plain[w];
  }
  t.cull = plain && t.first_in != kNone;
  return t;
}

// gt g, with finite corners and area, lies strictly beside the tile's hull
// on some axis (every inside anchor's iw or ih is fmaxf(negative, 0) = +0),
// and every union is positive (((area_g + area) - 0) + eps is monotone in
// the area): its IoU with every inside anchor is +0.
template <int kPerLane>
__device__ __forceinline__ bool misses(const Tile<kPerLane>& t, float4 g, float area_g, float eps) {
  return t.cull && plain_box(g, area_g) &&
         (g.z < t.hull.x || t.hull.z < g.x || g.w < t.hull.y || t.hull.w < g.y) &&
         __fadd_rn(__fadd_rn(area_g, t.min_area), eps) > 0.0f;
}

// Appends the kept gt of a warp to the block's list (scount); returns the
// slot of this lane's (meaningful where keep).
__device__ __forceinline__ int append(bool keep, int* scount) {
  const unsigned kept = __ballot_sync(kFull, keep);
  const int lane = threadIdx.x % 32;
  int at = 0;
  if (lane == 0 && kept != 0) at = atomicAdd(scount, __popc(kept));
  return __shfl_sync(kFull, at, 0) + __popc(kept & ((1u << lane) - 1u));
}

// Pass 1, a block per (tile, gt share, image): each anchor's (max, first
// argmax) over the share's gt into max_out / argmax_out (unsplit: the
// outputs) or part_argmax ([split, B, A]), every real gt's key, and the
// image's first inside anchor (first_word[img]: UINT32_MAX - anchor).
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
    anchor_match_pass1(const float4* __restrict__ anchors, int a_count,
                       const float4* __restrict__ gt, const bool* __restrict__ gt_mask, int g_count,
                       int g_share, const bool* __restrict__ inside, float eps,
                       float* __restrict__ max_out, int64_t* __restrict__ argmax_out,
                       int* __restrict__ part_argmax, unsigned long long* __restrict__ gt_key,
                       unsigned long long* __restrict__ first_word) {
  using L = Layout<kPerLane>;
  __shared__ float4 sgt[kChunk];
  __shared__ float sarea[kChunk];
  __shared__ int sslot[kChunk];
  __shared__ unsigned long long skey[kChunk];
  __shared__ float swarp_best[kWarps][L::kSpan];
  __shared__ int swarp_best_j[kWarps][L::kSpan];
  __shared__ int scount, sculled;
  const int64_t img = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sculled = kNone;
  const Tile<kPerLane> t = load_tile<kPerLane>(anchors, inside, a_count, img);
  float best[kPerLane];
  int best_j[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    best[k] = -1.0f;  // an all -1 column: (-1, 0)
    best_j[k] = 0;
  }
  int culled = kNone;  // the first culled real slot: +0 for every inside anchor
  if (t.first_in != kNone) {  // uniform over the block
    if (blockIdx.y == 0 && threadIdx.x == 0) {
      const unsigned long long word = 0xffffffffu - static_cast<uint32_t>(t.first_in);
      if (__ldcg(first_word + img) < word) atomicMax(first_word + img, word);
    }
    const int g_begin = blockIdx.y * g_share;
    const int g_end = min(g_count, g_begin + g_share);
    for (int c0 = g_begin; c0 < g_end; c0 += kChunk) {
      const int n_slots = min(kChunk, g_end - c0);
      float4 box[kRounds];  // every load of the chunk issued before the first is used
      bool real[kRounds];
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        const int r = q * kThreads + threadIdx.x;
        real[q] = r < n_slots && gt_mask[img * g_count + c0 + r];
        box[q] = r < n_slots ? gt[img * g_count + c0 + r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (threadIdx.x == 0) scount = 0;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        if (q * kThreads >= n_slots) break;  // uniform over the block
        const int j = c0 + q * kThreads + threadIdx.x;
        const float area_g = area_of(box[q]);
        bool keep = false;
        if (real[q]) {
          if (misses(t, box[q], area_g, eps)) {
            culled = min(culled, j);
          } else {
            keep = true;
          }
        }
        const int at = append(keep, &scount);
        if (keep) {
          sgt[at] = box[q];
          sarea[at] = area_g;
          sslot[at] = j;
          skey[at] = 0;
        }
      }
      __syncthreads();
      const int n = scount;
      if (t.warp_in) {  // uniform over the warp: every lane reaches the reductions
        for (int i = L::rank(); i < n; i += kPerLane) {
          const float4 g = sgt[i];
          const float area_g = sarea[i];
          const int slot = sslot[i];
          uint32_t hi = 0, lo = 0;
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            if (!t.in[k]) continue;
            const float v = iou_gt_major(g, area_g, t.box[k], t.area[k], eps);
            if (better(v, slot, best[k], best_j[k])) {
              best[k] = v;
              best_j[k] = slot;
            }
            const uint32_t h = v > 0.0f || v != v ? ordered_bits(v) : 0u;  // +-0 needs no key
            const uint32_t l = 0xffffffffu - static_cast<uint32_t>(tile_start() + L::position(k));
            if (h > hi || (h == hi && l > lo)) {
              hi = h;
              lo = l;
            }
          }
          const uint32_t whi = __reduce_max_sync(kFull, hi);
          if (whi == 0) continue;
          const uint32_t wlo = __reduce_max_sync(kFull, hi == whi ? lo : 0u);
          if (lane == 0) {
            const unsigned long long key = (static_cast<unsigned long long>(whi) << 32) | wlo;
            if (skey[i] < key) atomicMax(&skey[i], key);
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const unsigned long long k = skey[i];
        unsigned long long* key = gt_key + img * g_count + sslot[i];
        if (k != 0 && __ldcg(key) < k) atomicMax(key, k);
      }
      // The next chunk's first __syncthreads() orders these reads before its writes.
    }
  }
  // Each warp's (max, first argmax) of its group, then each thread's anchor
  // over the warps of its group and the culled slots.
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    swarp_best[warp][k * 32 + lane] = best[k];
    swarp_best_j[warp][k * 32 + lane] = best_j[k];
  }
  culled = static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(culled)));
  if (lane == 0 && culled != kNone) atomicMin(&sculled, culled);
  __syncthreads();
  const int x = threadIdx.x, group = x / L::kSpan, at = x % L::kSpan;
  float v = swarp_best[group][at];
  int j = swarp_best_j[group][at];
#pragma unroll
  for (int r = 1; r < kPerLane; ++r) {
    const int w = group + r * L::kGroups;
    if (better(swarp_best[w][at], swarp_best_j[w][at], v, j)) {
      v = swarp_best[w][at];
      j = swarp_best_j[w][at];
    }
  }
  const int a = tile_start() + x;
  if (a < a_count && inside[img * a_count + a] && sculled != kNone && better(0.0f, sculled, v, j)) {
    v = 0.0f;
    j = sculled;
  }
  if (a < a_count) {
    const int64_t row = (static_cast<int64_t>(blockIdx.y) * gridDim.z + img) * a_count;
    max_out[row + a] = v;
    if (argmax_out != nullptr) {
      argmax_out[row + a] = j;
    } else {
      part_argmax[row + a] = j;
    }
  }
}

// The shares' (max, first argmax) of the anchor at `at` (img * A + a),
// combined in share order, into the outputs.
__device__ __forceinline__ void combine_shares(const float* __restrict__ part_max,
                                               const int* __restrict__ part_argmax, int split,
                                               int64_t plane, int64_t at,
                                               float* __restrict__ iou_max,
                                               int64_t* __restrict__ iou_argmax) {
  float best = part_max[at];
  int best_j = part_argmax[at];
  for (int s = 1; s < split; ++s) {
    const float v = part_max[s * plane + at];
    const int j = part_argmax[s * plane + at];
    if (better(v, j, best, best_j)) {
      best = v;
      best_j = j;
    }
  }
  iou_max[at] = best;
  iou_argmax[at] = best_j;
}

// ties mode, a block per (tile, image): best_any[a] = some real gt has
// iou[g, a] == per_gt_max[g]; combines the shares where split > 1.
template <int kPerLane>
__global__ void __launch_bounds__(kThreads)
    anchor_match_ties(const float4* __restrict__ anchors, int a_count,
                      const float4* __restrict__ gt, const bool* __restrict__ gt_mask, int g_count,
                      const bool* __restrict__ inside, float eps,
                      const unsigned long long* __restrict__ gt_key,
                      const float* __restrict__ part_max, const int* __restrict__ part_argmax,
                      int split, float* __restrict__ iou_max, int64_t* __restrict__ iou_argmax,
                      bool* __restrict__ best_any) {
  using L = Layout<kPerLane>;
  __shared__ float4 sgt[kChunk];
  __shared__ float sarea[kChunk];
  __shared__ float smax[kChunk];
  __shared__ bool shit[kTile];
  __shared__ int scount;
  const int64_t img = blockIdx.z;
  shit[threadIdx.x] = false;  // read after a __syncthreads()
  const Tile<kPerLane> t = load_tile<kPerLane>(anchors, inside, a_count, img);
  bool hit[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) hit[k] = false;
  bool zero_tie = false;  // a culled real gt whose max is 0 ties every inside anchor
  if (t.first_in != kNone) {  // uniform over the block
    for (int c0 = 0; c0 < g_count; c0 += kChunk) {
      const int n_slots = min(kChunk, g_count - c0);
      float4 box[kRounds];  // every load of the chunk issued before the first is used
      unsigned long long key[kRounds];
      bool real[kRounds];
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        const int r = q * kThreads + threadIdx.x;
        const bool ok = r < n_slots;
        real[q] = ok && gt_mask[img * g_count + c0 + r];
        key[q] = ok ? gt_key[img * g_count + c0 + r] : 0;
        box[q] = ok ? gt[img * g_count + c0 + r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (threadIdx.x == 0) scount = 0;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        if (q * kThreads >= n_slots) break;  // uniform over the block
        const float m = key_max(key[q]);
        const float area_g = area_of(box[q]);
        bool keep = false;
        if (real[q] && m > -1.0f) {  // real: the block's image has an inside anchor
          if (misses(t, box[q], area_g, eps)) {
            zero_tie |= m == 0.0f;
          } else {
            keep = true;
          }
        }
        const int at = append(keep, &scount);
        if (keep) {
          sgt[at] = box[q];
          sarea[at] = area_g;
          smax[at] = m;
        }
      }
      __syncthreads();
      const int n = scount;
      if (t.warp_in) {
        for (int i = L::rank(); i < n; i += kPerLane) {
          const float4 g = sgt[i];
          const float area_g = sarea[i], m = smax[i];
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            if (t.in[k] && !hit[k]) hit[k] = iou_gt_major(g, area_g, t.box[k], t.area[k], eps) == m;
          }
        }
      }
      __syncthreads();  // the next chunk overwrites the shared arrays
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (hit[k]) shit[L::position(k)] = true;
  }
  zero_tie = __syncthreads_or(zero_tie);
  const int a = tile_start() + threadIdx.x;
  if (a < a_count) {
    best_any[img * a_count + a] = inside[img * a_count + a] && (shit[threadIdx.x] || zero_tie);
    if (split > 1) {
      combine_shares(part_max, part_argmax, split, static_cast<int64_t>(gridDim.z) * a_count,
                     img * a_count + a, iou_max, iou_argmax);
    }
  }
}

// argmax mode, a thread a gt slot: best_any (zeroed with the keys) is set
// at each real gt's first argmax, its key's anchor or, where its max is 0,
// the image's first inside anchor (several gt may write the same true);
// where split > 1 a thread an anchor also combines the shares.
__global__ void __launch_bounds__(kThreads)
    anchor_match_argmax(const bool* __restrict__ gt_mask, int batch, int g_count, int a_count,
                        const unsigned long long* __restrict__ gt_key,
                        const unsigned long long* __restrict__ first_word,
                        const float* __restrict__ part_max, const int* __restrict__ part_argmax,
                        int split, float* __restrict__ iou_max, int64_t* __restrict__ iou_argmax,
                        bool* __restrict__ best_any) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < static_cast<int64_t>(batch) * g_count) {
    const int64_t img = i / g_count;
    const uint32_t first = static_cast<uint32_t>(first_word[img]);  // 0: no inside anchor
    const unsigned long long key = gt_key[i];
    if (first != 0 && gt_mask[i] && key_max(key) > -1.0f) {
      best_any[img * a_count + (0xffffffffu - (key == 0 ? first : static_cast<uint32_t>(key)))] = true;
    }
  }
  const int64_t plane = static_cast<int64_t>(batch) * a_count;
  if (split > 1 && i < plane) combine_shares(part_max, part_argmax, split, plane, i, iou_max, iou_argmax);
}

template <int kPerLane>
cudaError_t launch_passes(const float4* a4, int a_count, const float4* g4, const bool* gt_mask,
                          int batch, int g_count, int g_share, int split, const bool* inside,
                          float eps, bool ties, float* iou_max, int64_t* iou_argmax,
                          bool* best_any, unsigned long long* gt_key, float* part_max,
                          int* part_argmax, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((a_count + kTile - 1) / kTile);
  const bool unsplit = split == 1;
  unsigned long long* first_word = gt_key + static_cast<int64_t>(batch) * g_count;
  anchor_match_pass1<kPerLane><<<dim3(tiles, split, batch), kThreads, 0, stream>>>(
      a4, a_count, g4, gt_mask, g_count, g_share, inside, eps, unsplit ? iou_max : part_max,
      unsplit ? iou_argmax : nullptr, unsplit ? nullptr : part_argmax, gt_key, first_word);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (ties) {
    anchor_match_ties<kPerLane><<<dim3(tiles, 1, batch), kThreads, 0, stream>>>(
        a4, a_count, g4, gt_mask, g_count, inside, eps, gt_key, part_max, part_argmax, split,
        iou_max, iou_argmax, best_any);
  } else {
    int64_t threads = static_cast<int64_t>(batch) * g_count;
    if (!unsplit) threads = std::max(threads, static_cast<int64_t>(batch) * a_count);
    anchor_match_argmax<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                          stream>>>(gt_mask, batch, g_count, a_count, gt_key, first_word, part_max,
                                    part_argmax, split, iou_max, iou_argmax, best_any);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs, the keys and the shares' partials and
// calls them on PyTorch's current stream. Boxes are contiguous float32 and
// 16-byte aligned, masks contiguous bool.

// The anchors a block holds (ops/boxes.py::RPN_MATCH_TILE must agree).
int anchor_match_tile() { return kTile; }

// anchors [a_count, 4], gt [batch, g_count, 4], gt_mask [batch, g_count],
// inside [batch, a_count] -> iou_max, iou_argmax, best_any [batch, a_count];
// pass 1 takes g_share gt slots a block (split = ceil(g_count / g_share)
// shares) and per_lane anchors a lane (1 or 4: the plan's layout); gt_key
// [batch * (g_count + 1)] is scratch (zeroed here: the keys, then a word an
// image) and best_any must follow it in the same allocation (in argmax
// mode the same memset zeroes it); part_max and part_argmax [split, batch,
// a_count] are scratch too (unused where split == 1). Three launches: the
// memset, pass 1, pass 2. Returns the first cudaError_t that is not
// success.
int anchor_match_launch(const float* anchors, int a_count, const float* gt, const bool* gt_mask,
                        int batch, int g_count, int g_share, int per_lane, const bool* inside,
                        float eps, bool ties, float* iou_max, int64_t* iou_argmax, bool* best_any,
                        unsigned long long* gt_key, float* part_max, int* part_argmax,
                        void* stream_ptr) {
  if (batch == 0 || a_count == 0) return static_cast<int>(cudaSuccess);
  if (per_lane != 1 && per_lane != 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int split = (g_count + g_share - 1) / g_share;
  const size_t key_words = static_cast<size_t>(batch) * (g_count + 1);
  if (reinterpret_cast<void*>(gt_key + key_words) != static_cast<void*>(best_any)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t zeroed = sizeof(unsigned long long) * key_words +
                        (ties ? 0 : static_cast<size_t>(batch) * a_count);
  cudaError_t err = cudaMemsetAsync(gt_key, 0, zeroed, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* a4 = reinterpret_cast<const float4*>(anchors);
  const float4* g4 = reinterpret_cast<const float4*>(gt);
  err = per_lane == 4
            ? launch_passes<4>(a4, a_count, g4, gt_mask, batch, g_count, g_share, split, inside,
                               eps, ties, iou_max, iou_argmax, best_any, gt_key, part_max,
                               part_argmax, stream)
            : launch_passes<1>(a4, a_count, g4, gt_mask, batch, g_count, g_share, split, inside,
                               eps, ties, iou_max, iou_argmax, best_any, gt_key, part_max,
                               part_argmax, stream);
  return static_cast<int>(err);
}
