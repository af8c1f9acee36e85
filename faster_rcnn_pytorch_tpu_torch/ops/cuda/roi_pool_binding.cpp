// PyTorch binding of the RoIPool kernel in roi_pool.cu. The only source
// that includes PyTorch's headers; it checks the tensors the Python
// wrapper allocated and launches on the current CUDA stream.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>

int roi_pool_forward_launch(const void* feat, bool feat_is_bf16, const float* rois,
                            int num_rois, int rois_per_image, int channels,
                            int height, int width, int pooled, float spatial_scale,
                            void* out, int32_t* argmax, void* stream);
const char* roi_pool_error_string(int err);

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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("roi_pool_forward", &roi_pool_forward,
        "RoIPool forward into preallocated outputs (CUDA)");
}
