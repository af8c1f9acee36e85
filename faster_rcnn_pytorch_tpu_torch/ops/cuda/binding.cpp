// PyTorch binding of the kernels in roi_pool.cu and roi_align.cu. The only
// source that includes PyTorch's headers; it checks the tensors the Python
// wrappers allocated and launches on the current CUDA stream.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>
#include <vector>

int roi_pool_forward_launch(const void* feat, bool feat_is_bf16, const float* rois,
                            int num_rois, int rois_per_image, int channels,
                            int height, int width, int pooled, float spatial_scale,
                            void* out, int32_t* argmax, void* stream);
int roi_pool_backward_launch(const void* grad, bool grad_is_bf16, const int32_t* argmax,
                             int num_rois, int rois_per_image, int channels,
                             int height, int width, int pooled, float* dfeat,
                             void* stream);
const char* roi_pool_error_string(int err);
int roi_align_forward_launch(const void* const* feats, const int* heights, const int* widths,
                             const float* scales, bool is_bf16, const float* rois,
                             const int32_t* level, int num_rois, int rois_per_image,
                             int channels, void* out, void* stream);
int roi_align_backward_launch(const void* grad, bool grad_is_bf16, float* const* dfeats,
                              const int* heights, const int* widths, const float* scales,
                              const float* rois, const int32_t* level, int num_rois,
                              int rois_per_image, int channels, void* stream);

static constexpr float kAlignScales[4] = {1.0f / 4, 1.0f / 8, 1.0f / 16, 1.0f / 32};

// features [B, C, H, W] f32/bf16, rois [B, n, 4] f32 (all contiguous, one
// device) -> fills out [B*n, C, P, P] (features' dtype) and, unless it is
// empty, argmax [B*n, C, P, P] int32.
void roi_pool_forward(const at::Tensor& features, const at::Tensor& rois,
                      double spatial_scale, int64_t pooled, at::Tensor& out,
                      at::Tensor& argmax) {
  TORCH_CHECK(features.is_cuda() && rois.is_cuda() && out.is_cuda(),
              "roi_pool_forward: tensors must be on a CUDA device");
  TORCH_CHECK(features.dim() == 4, "features must be [B, C, H, W]");
  TORCH_CHECK(rois.dim() == 3 && rois.size(2) == 4 && rois.size(0) == features.size(0),
              "rois must be [B, n, 4] with the features' batch");
  TORCH_CHECK(features.scalar_type() == at::kFloat ||
                  features.scalar_type() == at::kBFloat16,
              "features must be float32 or bfloat16");
  TORCH_CHECK(rois.scalar_type() == at::kFloat, "rois must be float32");
  TORCH_CHECK(features.is_contiguous() && rois.is_contiguous() && out.is_contiguous(),
              "roi_pool_forward: tensors must be contiguous");
  TORCH_CHECK(rois.get_device() == features.get_device() &&
                  out.get_device() == features.get_device(),
              "roi_pool_forward: tensors must share one device");
  const int64_t b = features.size(0), c = features.size(1);
  const int64_t n = rois.size(1);
  TORCH_CHECK(out.scalar_type() == features.scalar_type() &&
                  out.sizes() == at::IntArrayRef({b * n, c, pooled, pooled}),
              "out must be [B*n, C, P, P] in the features' dtype");
  int32_t* argmax_ptr = nullptr;
  if (argmax.numel() > 0) {
    TORCH_CHECK(argmax.is_cuda() && argmax.get_device() == features.get_device() &&
                    argmax.scalar_type() == at::kInt && argmax.is_contiguous() &&
                    argmax.sizes() == out.sizes(),
                "argmax must be a contiguous int32 tensor shaped like out");
    argmax_ptr = argmax.data_ptr<int32_t>();
  }
  const c10::cuda::CUDAGuard guard(features.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int err = roi_pool_forward_launch(
      features.data_ptr(), features.scalar_type() == at::kBFloat16,
      rois.data_ptr<float>(), static_cast<int>(b * n), static_cast<int>(n),
      static_cast<int>(c), static_cast<int>(features.size(2)),
      static_cast<int>(features.size(3)), static_cast<int>(pooled),
      static_cast<float>(spatial_scale), out.data_ptr(), argmax_ptr,
      static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_pool_forward launch failed: ", roi_pool_error_string(err));
}

// grad [B, n, C, P, P] f32/bf16 and argmax [B, n, C, P, P] int32 (contiguous)
// -> atomically adds into dfeat [B, C, H, W] float32, which the caller zeroed.
void roi_pool_backward(const at::Tensor& grad, const at::Tensor& argmax,
                       at::Tensor& dfeat) {
  TORCH_CHECK(grad.is_cuda() && argmax.is_cuda() && dfeat.is_cuda(),
              "roi_pool_backward: tensors must be on a CUDA device");
  TORCH_CHECK(grad.dim() == 5 && grad.size(3) == grad.size(4),
              "grad must be [B, n, C, P, P]");
  TORCH_CHECK(grad.scalar_type() == at::kFloat || grad.scalar_type() == at::kBFloat16,
              "grad must be float32 or bfloat16");
  TORCH_CHECK(argmax.scalar_type() == at::kInt && argmax.sizes() == grad.sizes(),
              "argmax must be int32 shaped like grad");
  TORCH_CHECK(dfeat.scalar_type() == at::kFloat && dfeat.dim() == 4 &&
                  dfeat.size(0) == grad.size(0) && dfeat.size(1) == grad.size(2),
              "dfeat must be float32 [B, C, H, W] matching grad");
  TORCH_CHECK(grad.is_contiguous() && argmax.is_contiguous() && dfeat.is_contiguous(),
              "roi_pool_backward: tensors must be contiguous");
  TORCH_CHECK(argmax.get_device() == grad.get_device() &&
                  dfeat.get_device() == grad.get_device(),
              "roi_pool_backward: tensors must share one device");
  const int64_t b = grad.size(0), n = grad.size(1), c = grad.size(2);
  const c10::cuda::CUDAGuard guard(grad.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int err = roi_pool_backward_launch(
      grad.data_ptr(), grad.scalar_type() == at::kBFloat16, argmax.data_ptr<int32_t>(),
      static_cast<int>(b * n), static_cast<int>(n), static_cast<int>(c),
      static_cast<int>(dfeat.size(2)), static_cast<int>(dfeat.size(3)),
      static_cast<int>(grad.size(3)), dfeat.data_ptr<float>(), static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_pool_backward launch failed: ", roi_pool_error_string(err));
}

// features: the four levels P2..P5, each [B, C, h, w] f32/bf16 (one dtype);
// rois [B, n, 4] f32 canvas pixels; level [B, n] int32 in [0, 4) (all
// contiguous, one device) -> fills out [B, n, C, 7, 7] (features' dtype).
void roi_align_forward(const std::vector<at::Tensor>& features, const at::Tensor& rois,
                       const at::Tensor& level, at::Tensor& out) {
  TORCH_CHECK(features.size() == 4, "roi_align_forward: want the four levels P2..P5");
  const at::Tensor& f0 = features[0];
  TORCH_CHECK(f0.scalar_type() == at::kFloat || f0.scalar_type() == at::kBFloat16,
              "features must be float32 or bfloat16");
  const int64_t b = f0.size(0), c = f0.size(1);
  const void* ptrs[4];
  int heights[4], widths[4];
  for (int i = 0; i < 4; ++i) {
    const at::Tensor& f = features[i];
    TORCH_CHECK(f.is_cuda() && f.get_device() == f0.get_device() && f.dim() == 4 &&
                    f.size(0) == b && f.size(1) == c && f.scalar_type() == f0.scalar_type() &&
                    f.is_contiguous(),
                "levels must be contiguous [B, C, h, w] tensors of one dtype on one device");
    ptrs[i] = f.data_ptr();
    heights[i] = static_cast<int>(f.size(2));
    widths[i] = static_cast<int>(f.size(3));
  }
  TORCH_CHECK(rois.is_cuda() && level.is_cuda() && out.is_cuda(),
              "roi_align_forward: tensors must be on a CUDA device");
  TORCH_CHECK(rois.get_device() == f0.get_device() && level.get_device() == f0.get_device() &&
                  out.get_device() == f0.get_device(),
              "roi_align_forward: tensors must share one device");
  TORCH_CHECK(rois.scalar_type() == at::kFloat && rois.dim() == 3 && rois.size(0) == b &&
                  rois.size(2) == 4 && rois.is_contiguous(),
              "rois must be contiguous float32 [B, n, 4]");
  const int64_t n = rois.size(1);
  TORCH_CHECK(level.scalar_type() == at::kInt && level.dim() == 2 && level.size(0) == b &&
                  level.size(1) == n && level.is_contiguous(),
              "level must be contiguous int32 [B, n]");
  TORCH_CHECK(out.scalar_type() == f0.scalar_type() && out.is_contiguous() &&
                  out.sizes() == at::IntArrayRef({b, n, c, 7, 7}),
              "out must be [B, n, C, 7, 7] in the features' dtype");
  const c10::cuda::CUDAGuard guard(f0.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int err = roi_align_forward_launch(
      ptrs, heights, widths, kAlignScales, f0.scalar_type() == at::kBFloat16,
      rois.data_ptr<float>(), level.data_ptr<int32_t>(), static_cast<int>(b * n),
      static_cast<int>(n), static_cast<int>(c), out.data_ptr(), static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_align_forward launch failed: ", roi_pool_error_string(err));
}

// grad [B, n, C, 7, 7] f32/bf16; rois [B, n, 4] f32; level [B, n] int32;
// dfeats: the four float32 maps [B, C, h, w] of P2..P5, zeroed by the caller
// (all contiguous, one device) -> atomically adds the features-gradient.
void roi_align_backward(const at::Tensor& grad, const at::Tensor& rois, const at::Tensor& level,
                        const std::vector<at::Tensor>& dfeats) {
  TORCH_CHECK(dfeats.size() == 4, "roi_align_backward: want the four levels P2..P5");
  TORCH_CHECK(grad.is_cuda() && rois.is_cuda() && level.is_cuda(),
              "roi_align_backward: tensors must be on a CUDA device");
  TORCH_CHECK(grad.scalar_type() == at::kFloat || grad.scalar_type() == at::kBFloat16,
              "grad must be float32 or bfloat16");
  TORCH_CHECK(grad.dim() == 5 && grad.size(3) == 7 && grad.size(4) == 7 && grad.is_contiguous(),
              "grad must be contiguous [B, n, C, 7, 7]");
  const int64_t b = grad.size(0), n = grad.size(1), c = grad.size(2);
  TORCH_CHECK(rois.scalar_type() == at::kFloat && rois.dim() == 3 && rois.size(0) == b &&
                  rois.size(1) == n && rois.size(2) == 4 && rois.is_contiguous(),
              "rois must be contiguous float32 [B, n, 4] matching grad");
  TORCH_CHECK(level.scalar_type() == at::kInt && level.dim() == 2 && level.size(0) == b &&
                  level.size(1) == n && level.is_contiguous(),
              "level must be contiguous int32 [B, n] matching grad");
  TORCH_CHECK(rois.get_device() == grad.get_device() && level.get_device() == grad.get_device(),
              "roi_align_backward: tensors must share one device");
  float* ptrs[4];
  int heights[4], widths[4];
  for (int i = 0; i < 4; ++i) {
    const at::Tensor& d = dfeats[i];
    TORCH_CHECK(d.is_cuda() && d.get_device() == grad.get_device() &&
                    d.scalar_type() == at::kFloat && d.dim() == 4 && d.size(0) == b &&
                    d.size(1) == c && d.is_contiguous(),
                "dfeats must be contiguous float32 [B, C, h, w] maps on grad's device");
    ptrs[i] = d.data_ptr<float>();
    heights[i] = static_cast<int>(d.size(2));
    widths[i] = static_cast<int>(d.size(3));
  }
  const c10::cuda::CUDAGuard guard(grad.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int err = roi_align_backward_launch(
      grad.data_ptr(), grad.scalar_type() == at::kBFloat16, ptrs, heights, widths,
      kAlignScales, rois.data_ptr<float>(), level.data_ptr<int32_t>(),
      static_cast<int>(b * n), static_cast<int>(n), static_cast<int>(c),
      static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_align_backward launch failed: ", roi_pool_error_string(err));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("roi_pool_forward", &roi_pool_forward,
        "RoIPool forward into preallocated outputs (CUDA)");
  m.def("roi_pool_backward", &roi_pool_backward,
        "RoIPool features-gradient, atomically added into a zeroed float32 map (CUDA)");
  m.def("roi_align_forward", &roi_align_forward,
        "MultiScaleRoIAlign forward over P2..P5 into a preallocated output (CUDA)");
  m.def("roi_align_backward", &roi_align_backward,
        "MultiScaleRoIAlign features-gradient, atomically added into zeroed float32 maps (CUDA)");
}
