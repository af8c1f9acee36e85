// RoIPool forward (7x7 max pooling with integer bins) and its backward
// (further down) for Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py
// (_roi_pool_kernel, launched by _roi_pool_pallas_impl and
// _roi_pool_batch_pallas_impl). The Pallas kernel keeps one image's whole
// [h, w_pad, c] map resident in VMEM and walks the rois over it. The H100
// counterpart is a channel plane resident in shared memory: a block owns
// (image b, a chunk of channels, a chunk of rois), copies the chunk's
// channel planes (one contiguous run of the NCHW map) into shared memory
// with 16-byte cp.async, computes each roi's 7 + 7 bin bounds once into
// shared memory meanwhile, and then each thread takes one bin of one
// channel for a strided set of the chunk's rois, scanning the bin in shared
// memory. The launch plan (channels and rois per block, bytes of shared
// memory) comes from ops/roi_pool.py::forward_plan. A plane too large for
// shared memory takes the direct-read kernel (roi_pool_fwd_direct_kernel):
// a thread per output element scanning its bin straight from device memory.
//
// Semantics (bit-exact with the JAX package and the plain twin
// ops/roi_pool.py::roi_pool_reference):
//   * corners are round(x * spatial_scale), rounded half to even like
//     jnp.round (__float2int_rn, NOT roundf),
//   * extent = max(end - start + 1, 1),
//   * bin p covers [start + (p*e)//P, start + ((p+1)*e + P-1)//P), in integer
//     arithmetic, clipped to [0, size),
//   * value = max over the bin compared in float32, 0 for an empty bin,
//   * argmax = first max in row-major scan order as row * width + col,
//     -1 for an empty bin. One thread scans one bin in row-major order with a
//     strict >, so the first max wins as in the plain version.
//
// What bounds it on an H100: bytes. At the legacy predict shape (feats
// [1, 512, 50, 84], 300 rois) the kernel must read the 8.6 MB map and write
// the 30 MB float32 output; the train shape (2 images of 128 rois) adds a
// 25.7 MB int32 argmax. Staging makes the map a single read per roi chunk
// (re-reads of a plane by further roi chunks hit the 50 MB L2), the bins'
// repeated reads go to shared memory, and the writes are coalesced:
// out[r, c..c+cc, :, :] is one contiguous run. What it spends its time on
// is the scans (about 9 cells a bin at the predict shape, a compare and a
// select each), whose trip counts differ between the lanes of a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSharedBytes = 48 * 1024;  // above it: cudaFuncSetAttribute

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
// Forward: exact, v is one of the bf16 inputs or 0. Backward: the one
// rounding of the float32 sum, as .to(torch.bfloat16) of the float32 map.
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void bin_bounds(int start, int extent, int p, int pooled,
                                           int size, int* lo, int* hi) {
  // p * extent >= 0, so C's truncating division is the floor division of
  // the JAX package's _bin_bounds.
  const int l = (p * extent) / pooled + start;
  const int h = ((p + 1) * extent + pooled - 1) / pooled + start;
  *lo = min(max(l, 0), size);
  *hi = min(max(h, 0), size);
}

// The max of a bin of one channel plane (global or shared memory) and, with
// kArgmax, its position row * width + col: the first max in row-major order;
// (0, -1) for an empty bin.
template <typename T, bool kArgmax>
__device__ __forceinline__ void scan_bin(const T* plane, int width, int hs, int he, int ws,
                                         int we, float* value, int32_t* position) {
  float best = 0.0f;
  int32_t best_pos = -1;
  if (he > hs && we > ws) {
    best_pos = hs * width + ws;
    best = to_f32(plane[best_pos]);
    for (int y = hs; y < he; ++y) {
      const T* row = plane + y * width;
      for (int x = ws; x < we; ++x) {
        const float v = to_f32(row[x]);
        if (v > best) {  // strict: the first max in scan order wins
          best = v;
          if (kArgmax) best_pos = y * width + x;
        }
      }
    }
  }
  *value = best;
  *position = best_pos;
}

// A thread's share of a block's (roi, k) outputs, k in [0, K) the block's
// channels x bins: threads are split into `groups` groups of K threads (or
// one group, its threads looping over k in steps of blockDim, when
// K >= blockDim); thread (g, k) takes the rois g, g + groups, ... so its k,
// and everything derived from it, is fixed. Threads past the last whole
// group get no work.
struct Share {
  int groups, group, k_first;
};

__device__ __forceinline__ Share thread_share(int K) {
  const int t = threadIdx.x, n = blockDim.x;
  if (K >= n) return {1, 0, t};
  return {n / K, t / K, t % K};
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int round_up16(int bytes) { return (bytes + 15) & ~15; }

template <typename T, bool kArgmax>
__global__ void roi_pool_fwd_staged_kernel(const T* __restrict__ feat,
                                           const float* __restrict__ rois,
                                           int rois_per_image, int channels, int height,
                                           int width, int pooled, float spatial_scale,
                                           int chunk_channels, int chunk_rois,
                                           T* __restrict__ out, int32_t* __restrict__ argmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = height * width;
  const int roi_chunks = (rois_per_image + chunk_rois - 1) / chunk_rois;
  const int channel_chunks = (channels + chunk_channels - 1) / chunk_channels;
  // blockIdx.x = (b * channel_chunks + channel chunk) * roi_chunks + roi chunk,
  // the order of ops/roi_pool.py::LaunchPlan.blocks.
  const int roi_chunk = blockIdx.x % roi_chunks;
  const int channel_chunk = (blockIdx.x / roi_chunks) % channel_chunks;
  const int b = blockIdx.x / (roi_chunks * channel_chunks);
  const int c0 = channel_chunk * chunk_channels;
  const int nc = min(chunk_channels, channels - c0);
  const int r0 = roi_chunk * chunk_rois;
  const int nr = min(chunk_rois, rois_per_image - r0);

  // Shared memory: the nc planes, then per roi the packed (lo | hi << 16)
  // bounds of its P row bins and its P column bins.
  T* planes = reinterpret_cast<T*>(smem);
  uint32_t* geo = reinterpret_cast<uint32_t*>(
      smem + round_up16(chunk_channels * plane * static_cast<int>(sizeof(T))));

  // 1. The planes of channels c0 .. c0 + nc: one contiguous run of the map.
  const T* src = feat + (static_cast<int64_t>(b) * channels + c0) * plane;
  const int count = nc * plane;
  int head = 0;  // elements copied by cp.async
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = count * static_cast<int>(sizeof(T)) / 16;
    const char* s = reinterpret_cast<const char*>(src);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) cp_async16(smem + 16 * i, s + 16 * i);
    head = vecs * 16 / static_cast<int>(sizeof(T));
  }
  for (int i = head + threadIdx.x; i < count; i += blockDim.x) planes[i] = src[i];

  // 2. Meanwhile the chunk's bin bounds, each roi's rounding done once per
  //    axis and bin instead of once per output.
  const float* roi_base = rois + (static_cast<int64_t>(b) * rois_per_image + r0) * 4;
  for (int i = threadIdx.x; i < nr * 2 * pooled; i += blockDim.x) {
    const int p = i % pooled;
    const int axis = (i / pooled) & 1;  // 0: rows (y), 1: columns (x)
    const float* roi = roi_base + (i / (2 * pooled)) * 4;
    const int start = __float2int_rn(roi[1 - axis] * spatial_scale);
    const int end = __float2int_rn(roi[3 - axis] * spatial_scale);
    int lo, hi;
    bin_bounds(start, max(end - start + 1, 1), p, pooled, axis == 0 ? height : width, &lo,
               &hi);
    geo[i] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. Each thread's outputs: (roi, k) with k = bin * nc + channel fixed.
  //    Channel first: the lanes of a warp take one bin of neighbouring
  //    channels, whose scans run the same trip counts, before other bins.
  const int area = pooled * pooled;
  const int K = nc * area;
  const Share share = thread_share(K);
  if (share.group >= share.groups) return;  // no barrier follows
  const int64_t roi_stride = static_cast<int64_t>(channels) * area;
  const int64_t first_out = (static_cast<int64_t>(b) * rois_per_image + r0) * roi_stride +
                            static_cast<int64_t>(c0) * area;
  for (int k = share.k_first; k < K; k += blockDim.x) {
    const int bin = k / nc;
    const int cl = k - bin * nc;
    const int ph = bin / pooled;
    const int pw = bin - ph * pooled;
    const T* pl = planes + cl * plane;
    for (int r = share.group; r < nr; r += share.groups) {
      const uint32_t gy = geo[(2 * r) * pooled + ph];
      const uint32_t gx = geo[(2 * r + 1) * pooled + pw];
      float best;
      int32_t best_pos;
      scan_bin<T, kArgmax>(pl, width, static_cast<int>(gy & 0xffff), static_cast<int>(gy >> 16),
                           static_cast<int>(gx & 0xffff), static_cast<int>(gx >> 16), &best,
                           &best_pos);
      const int64_t o = first_out + r * roi_stride + cl * area + bin;
      from_f32(best, out + o);
      if (kArgmax) argmax[o] = best_pos;
    }
  }
}

// A thread per output element (roi, c, ph, pw), scanning its bin of the
// NCHW map straight from device memory: the route for a channel plane that
// does not fit in shared memory.
template <typename T, bool kArgmax>
__global__ void roi_pool_fwd_direct_kernel(const T* __restrict__ feat,
                                           const float* __restrict__ rois,
                                           int rois_per_image, int channels, int height,
                                           int width, int pooled, float spatial_scale,
                                           int64_t total, T* __restrict__ out,
                                           int32_t* __restrict__ argmax) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int pw = static_cast<int>(idx % pooled);
    const int ph = static_cast<int>((idx / pooled) % pooled);
    const int c = static_cast<int>((idx / (pooled * pooled)) % channels);
    const int64_t r = idx / (static_cast<int64_t>(pooled) * pooled * channels);
    const int64_t b = r / rois_per_image;

    const float* roi = rois + r * 4;
    const int sx = __float2int_rn(roi[0] * spatial_scale);
    const int sy = __float2int_rn(roi[1] * spatial_scale);
    const int ex = __float2int_rn(roi[2] * spatial_scale);
    const int ey = __float2int_rn(roi[3] * spatial_scale);
    int hs, he, ws, we;
    bin_bounds(sy, max(ey - sy + 1, 1), ph, pooled, height, &hs, &he);
    bin_bounds(sx, max(ex - sx + 1, 1), pw, pooled, width, &ws, &we);

    float best;
    int32_t best_pos;
    scan_bin<T, kArgmax>(feat + (b * channels + c) * static_cast<int64_t>(height) * width,
                         width, hs, he, ws, we, &best, &best_pos);
    from_f32(best, out + idx);
    if (kArgmax) argmax[idx] = best_pos;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// be asked for; the attribute is per device, so it is set on every such
// launch, a host call of about a microsecond).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Threads of a block whose outputs per roi are K: whole groups of K.
int block_threads(int K) { return K >= kThreads ? kThreads : (kThreads / K) * K; }

template <typename T, bool kArgmax>
cudaError_t launch(const void* feat, const float* rois, int num_rois, int rois_per_image,
                   int channels, int height, int width, int pooled, float spatial_scale,
                   int chunk_channels, int chunk_rois, int shared_bytes, void* out,
                   int32_t* argmax, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(num_rois) * channels * pooled * pooled;
  if (total == 0) return cudaSuccess;
  if (shared_bytes == 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
    roi_pool_fwd_direct_kernel<T, kArgmax><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(feat), rois, rois_per_image, channels, height, width, pooled,
        spatial_scale, total, static_cast<T*>(out), argmax);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_shared(roi_pool_fwd_staged_kernel<T, kArgmax>, shared_bytes);
  if (err != cudaSuccess) return err;
  const int images = num_rois / rois_per_image;
  const int grid = images * ((channels + chunk_channels - 1) / chunk_channels) *
                   ((rois_per_image + chunk_rois - 1) / chunk_rois);
  roi_pool_fwd_staged_kernel<T, kArgmax>
      <<<grid, block_threads(chunk_channels * pooled * pooled), shared_bytes, stream>>>(
          static_cast<const T*>(feat), rois, rois_per_image, channels, height, width, pooled,
          spatial_scale, chunk_channels, chunk_rois, static_cast<T*>(out), argmax);
  return cudaGetLastError();
}

// RoIPool backward: the features-gradient.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py
// (_roi_pool_bwd_kernel, launched by _roi_pool_bwd_pallas from the custom VJPs
// _roi_pool_bwd and _roi_pool_batch_bwd). The Pallas kernel walks one roi per
// sequential grid step and adds a one-hot window of the upstream gradient into
// an [h, w_pad, c] map resident in VMEM, then writes the map once. Here a
// block owns (image b, a chunk of channels, a band of rows) and keeps that
// part of the map in float32 in shared memory:
//
//   dfeat[b, c, y, x] = sum over (r in image b, ph, pw) with
//                       argmax[r, c, ph, pw] == y * w + x of g[r, c, ph, pw]
//
// It walks the image's rois in order, reads each roi's contiguous run of
// (channels x P*P) upstream gradients and argmaxes, and adds each one whose
// argmax row lies in its band into the shared plane with a shared-memory
// atomicAdd. Then it writes every cell of its band once, coalesced, in the
// features' dtype: no zeroed map in device memory, no global atomics, no
// cast afterwards. The band is the whole plane unless a float32 plane is
// larger than a block's shared memory (ops/roi_pool.py::backward_plan). Empty
// bins (argmax -1) add nothing. The argmax is the forward's row * w + col,
// not the TPU's row * w_pad + col. The sums are float32 whatever the
// gradient's dtype (bf16 is widened with __bfloat162float) and rounded once
// to the output dtype, as the JAX VJP casts its float32 map.
//
// What bounds it on an H100: bytes. At the legacy train shape (B 2, 128 rois
// per image, C 512, 7x7) the upstream gradient is 6.4 M elements (25.7 MB in
// f32) and the argmax another 25.7 MB, each read once, and the 17.2 MB map is
// written once. Shared-memory atomics add in an order that changes from run
// to run: the result is bit-exact against the plain version only where every
// order gives the same float32 sum (e.g. integer-valued gradients).
template <typename G, typename T>
__global__ void __launch_bounds__(kThreads, 8) roi_pool_bwd_kernel(const G* __restrict__ grad,
                                    const int32_t* __restrict__ argmax, int rois_per_image,
                                    int channels, int height, int width, int pooled,
                                    int chunk_channels, int band_rows, T* __restrict__ dfeat) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int bands = (height + band_rows - 1) / band_rows;
  const int channel_chunks = (channels + chunk_channels - 1) / chunk_channels;
  // blockIdx.x = (b * channel_chunks + channel chunk) * bands + band, the
  // order of ops/roi_pool.py::LaunchPlan.blocks.
  const int band = blockIdx.x % bands;
  const int channel_chunk = (blockIdx.x / bands) % channel_chunks;
  const int b = blockIdx.x / (bands * channel_chunks);
  const int c0 = channel_chunk * chunk_channels;
  const int nc = min(chunk_channels, channels - c0);
  const int row0 = band * band_rows;
  const int cells = min(band_rows, height - row0) * width;  // of one channel's band
  const int first = row0 * width;  // its first cell's row * w + col

  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const int area = pooled * pooled;
  const int K = nc * area;
  const Share share = thread_share(K);
  if (share.group < share.groups) {
    const int64_t roi_stride = static_cast<int64_t>(channels) * area;
    const int step = share.groups;
    for (int k = share.k_first; k < K; k += blockDim.x) {
      float* a = acc + (k / area) * cells;
      const int64_t base =
          static_cast<int64_t>(b) * rois_per_image * roi_stride + static_cast<int64_t>(c0) * area + k;
      int r = share.group;
      // Four rois' loads in flight before their adds.
      for (; r + 3 * step < rois_per_image; r += 4 * step) {
        int32_t pos[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int64_t o = base + (r + u * step) * roi_stride;
          pos[u] = argmax[o];
          v[u] = to_f32(grad[o]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned q = static_cast<unsigned>(pos[u] - first);  // -1 and other bands wrap
          if (q < static_cast<unsigned>(cells)) atomicAdd(a + q, v[u]);
        }
      }
      for (; r < rois_per_image; r += step) {
        const int64_t o = base + r * roi_stride;
        const unsigned q = static_cast<unsigned>(argmax[o] - first);
        if (q < static_cast<unsigned>(cells)) atomicAdd(a + q, to_f32(grad[o]));
      }
    }
  }
  __syncthreads();

  const int plane = height * width;
  T* dst = dfeat + (static_cast<int64_t>(b) * channels + c0) * plane + first;
  for (int cl = 0; cl < nc; ++cl) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      from_f32(acc[cl * cells + i], dst + static_cast<int64_t>(cl) * plane + i);
    }
  }
}

template <typename G, typename T>
cudaError_t launch_bwd(const void* grad, const int32_t* argmax, int images,
                       int rois_per_image, int channels, int height, int width, int pooled,
                       int chunk_channels, int band_rows, int shared_bytes, void* dfeat,
                       cudaStream_t stream) {
  if (static_cast<int64_t>(images) * channels * height * width == 0) return cudaSuccess;
  const cudaError_t err = allow_shared(roi_pool_bwd_kernel<G, T>, shared_bytes);
  if (err != cudaSuccess) return err;
  const int grid = images * ((channels + chunk_channels - 1) / chunk_channels) *
                   ((height + band_rows - 1) / band_rows);
  roi_pool_bwd_kernel<G, T>
      <<<grid, block_threads(chunk_channels * pooled * pooled), shared_bytes, stream>>>(
          static_cast<const G*>(grad), argmax, rois_per_image, channels, height, width,
          pooled, chunk_channels, band_rows, static_cast<T*>(dfeat));
  return cudaGetLastError();
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors and the plan and calls them on
// PyTorch's current stream. Each returns the launch's cudaError_t.
int roi_pool_backward_launch(const void* grad, bool grad_is_bf16, const int32_t* argmax,
                             int images, int rois_per_image, int channels, int height,
                             int width, int pooled, int chunk_channels, int band_rows,
                             int shared_bytes, void* dfeat, bool dfeat_is_bf16,
                             void* stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t (*launcher)(const void*, const int32_t*, int, int, int, int, int, int, int, int,
                          int, void*, cudaStream_t) = launch_bwd<float, float>;
  if (grad_is_bf16 && dfeat_is_bf16) {
    launcher = launch_bwd<bf16, bf16>;
  } else if (grad_is_bf16) {
    launcher = launch_bwd<bf16, float>;
  } else if (dfeat_is_bf16) {
    launcher = launch_bwd<float, bf16>;
  }
  return static_cast<int>(launcher(grad, argmax, images, rois_per_image, channels, height,
                                   width, pooled, chunk_channels, band_rows, shared_bytes,
                                   dfeat, static_cast<cudaStream_t>(stream)));
}

int roi_pool_forward_launch(const void* feat, bool feat_is_bf16, const float* rois,
                            int num_rois, int rois_per_image, int channels, int height,
                            int width, int pooled, float spatial_scale, int chunk_channels,
                            int chunk_rois, int shared_bytes, void* out, int32_t* argmax,
                            void* stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t (*launcher)(const void*, const float*, int, int, int, int, int, int, float, int,
                          int, int, void*, int32_t*, cudaStream_t) = launch<float, false>;
  if (feat_is_bf16 && argmax != nullptr) {
    launcher = launch<bf16, true>;
  } else if (feat_is_bf16) {
    launcher = launch<bf16, false>;
  } else if (argmax != nullptr) {
    launcher = launch<float, true>;
  }
  return static_cast<int>(launcher(feat, rois, num_rois, rois_per_image, channels, height,
                                   width, pooled, spatial_scale, chunk_channels, chunk_rois,
                                   shared_bytes, out, argmax,
                                   static_cast<cudaStream_t>(stream)));
}

const char* roi_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
