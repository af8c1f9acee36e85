// RoIPool forward (7x7 max pooling with integer bins) for Hopper, sm_90a.
//
// Replaces the TPU kernel faster_rcnn_pytorch_tpu/ops/pallas/roi_pool_kernel.py
// (_roi_pool_kernel, launched by _roi_pool_pallas_impl and
// _roi_pool_batch_pallas_impl). It computes the same function, not the TPU
// block layout: the Pallas kernel keeps one image's whole [h, w_pad, c] map
// resident in VMEM and walks one roi per grid step with 8-aligned windows;
// here every output element (roi, c, ph, pw) is one thread that scans its
// own bin of the NCHW map straight from device memory.
//
// Semantics (bit-exact with the JAX package and the plain twin
// ops/roi_pool.py::roi_pool_reference):
//   * corners are round(x * spatial_scale), rounded half to even like
//     jnp.round (rintf / __float2int_rn, NOT roundf),
//   * extent = max(end - start + 1, 1),
//   * bin p covers [start + (p*e)//P, start + ((p+1)*e + P-1)//P), in integer
//     arithmetic, clipped to [0, size),
//   * value = max over the bin compared in float32, 0 for an empty bin,
//   * argmax = first max in row-major scan order as row * width + col,
//     -1 for an empty bin.
//
// What bounds it on an H100: bytes. At the legacy predict shape (feats
// [1, 512, 50, 84], 300 rois) the map is 8.6 MB and sits in the 50 MB L2;
// each thread reads its bin (about (extent/7)^2 cells) and writes one value,
// so the kernel is bound by L2 reads and by the 30 MB f32 output write.
// Neighbouring threads take neighbouring bins of one channel row, so a
// warp's reads of one map row fall on neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
// Exact: v is one of the bf16 inputs, or 0.
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

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ feat,
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
    const int ext_w = max(ex - sx + 1, 1);
    const int ext_h = max(ey - sy + 1, 1);

    int hs, he, ws, we;
    bin_bounds(sy, ext_h, ph, pooled, height, &hs, &he);
    bin_bounds(sx, ext_w, pw, pooled, width, &ws, &we);

    float best = 0.0f;
    int32_t best_pos = -1;
    if (he > hs && we > ws) {
      const T* plane = feat + (b * channels + c) * static_cast<int64_t>(height) * width;
      best_pos = hs * width + ws;
      best = to_f32(plane[best_pos]);
      for (int y = hs; y < he; ++y) {
        for (int x = ws; x < we; ++x) {
          const int pos = y * width + x;
          const float v = to_f32(plane[pos]);
          if (v > best) {  // strict: the first max in scan order wins
            best = v;
            best_pos = pos;
          }
        }
      }
    }
    from_f32(best, out + idx);
    if (argmax != nullptr) argmax[idx] = best_pos;
  }
}

template <typename T>
cudaError_t launch(const void* feat, const float* rois, int num_rois,
                   int rois_per_image, int channels, int height, int width,
                   int pooled, float spatial_scale, void* out, int32_t* argmax,
                   cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(num_rois) * channels * pooled * pooled;
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
  roi_pool_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), rois, rois_per_image, channels, height, width,
      pooled, spatial_scale, total, static_cast<T*>(out), argmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C++ entry point (no PyTorch headers here, so nvcc stays fast); the
// binding in roi_pool_binding.cpp checks the tensors and calls it on
// PyTorch's current stream. Returns the launch's cudaError_t.
int roi_pool_forward_launch(const void* feat, bool feat_is_bf16, const float* rois,
                            int num_rois, int rois_per_image, int channels,
                            int height, int width, int pooled, float spatial_scale,
                            void* out, int32_t* argmax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      feat_is_bf16
          ? launch<__nv_bfloat16>(feat, rois, num_rois, rois_per_image, channels,
                                  height, width, pooled, spatial_scale, out, argmax, s)
          : launch<float>(feat, rois, num_rois, rois_per_image, channels, height,
                          width, pooled, spatial_scale, out, argmax, s);
  return static_cast<int>(err);
}

const char* roi_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
