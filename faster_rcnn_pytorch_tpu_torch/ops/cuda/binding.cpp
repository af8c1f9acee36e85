// PyTorch binding of the kernels in roi_pool.cu, roi_align.cu,
// roi_align_slots.cu, iou.cu, nms.cu, anchor_match.cu and frozen_bn.cu. The
// only source that includes PyTorch's headers; it checks the tensors the
// Python wrappers allocated (the IoU, NMS and FrozenBN kernels' outputs it
// allocates itself) and launches on the current CUDA stream.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>
#include <cstdint>
#include <tuple>
#include <vector>

int roi_pool_forward_launch(const void* feat, bool feat_is_bf16, const float* rois,
                            int num_rois, int rois_per_image, int channels, int height,
                            int width, int pooled, float spatial_scale, int chunk_channels,
                            int chunk_rois, int shared_bytes, void* out, int32_t* argmax,
                            void* stream);
int roi_pool_backward_launch(const void* grad, bool grad_is_bf16, const int32_t* argmax,
                             int images, int rois_per_image, int channels, int height,
                             int width, int pooled, int chunk_channels, int band_rows,
                             int shared_bytes, void* dfeat, bool dfeat_is_bf16,
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

int roi_align_slots_forward_launch(const void* const* feats, const int* heights,
                                   const int* widths, const float* scales, bool is_bf16,
                                   const float* rois, const int32_t* level, int num_rois,
                                   int rois_per_image, int channels, void* out, void* stream);
int pairwise_iou_launch(const float* a, const float* b, int n, int m, float eps,
                        float union_floor, const bool* col_mask, float* out, void* stream);
int iou_match_shared_bytes(int m);
int iou_match_launch(const float* a, const float* b, int batch, int n, int m, float eps,
                     float union_floor, const bool* row_mask, const bool* col_mask,
                     float* best_val, int64_t* best_idx, void* stream);
int empty_kernel_launch(void* stream);
int anchor_match_tile();
int anchor_match_launch(const float* anchors, int a_count, const float* gt, const bool* gt_mask,
                        int batch, int g_count, int g_share, int per_lane, const bool* inside,
                        float eps, bool ties, float* iou_max, int64_t* iou_argmax, bool* best_any,
                        unsigned long long* gt_key, float* part_max, int* part_argmax,
                        void* stream);
int nms_segments_shared_bytes(int share);
int nms_segments_max_active_clusters(int width, int share);
int nms_segments_launch(const float* boxes, const bool* valid, int segments, int n, float thr,
                        int post_k, int width, int32_t* keep, int32_t* count, void* stream);
int frozen_bn_forward_launch(const void* x, const void* residual, const float* mean,
                             const float* inv, const float* bias, bool is_bf16, bool relu,
                             int64_t planes, int channels, int64_t plane, void* out,
                             void* stream);
int frozen_bn_backward_launch(const void* grad, const void* out, const float* inv,
                              bool is_bf16, int64_t planes, int channels, int64_t plane,
                              void* dx, void* dresidual, void* stream);

static constexpr float kAlignScales[4] = {1.0f / 4, 1.0f / 8, 1.0f / 16, 1.0f / 32};

// The most dynamic shared memory an sm_90 block may ask for.
static constexpr int64_t kMaxSharedBytes = 232448;

// features [B, C, H, W] f32/bf16, rois [B, n, 4] f32 (all contiguous, one
// device) -> fills out [B*n, C, P, P] (features' dtype) and, unless it is
// empty, argmax [B*n, C, P, P] int32. The plan (ops/roi_pool.py::forward_plan):
// channels and rois per block and the bytes of shared memory a block takes,
// 0 for the direct-read route.
void roi_pool_forward(const at::Tensor& features, const at::Tensor& rois,
                      double spatial_scale, int64_t pooled, int64_t chunk_channels,
                      int64_t chunk_rois, int64_t shared_bytes, at::Tensor& out,
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
  const int64_t h = features.size(2), w = features.size(3);
  const int64_t n = rois.size(1);
  TORCH_CHECK(out.scalar_type() == features.scalar_type() &&
                  out.sizes() == at::IntArrayRef({b * n, c, pooled, pooled}),
              "out must be [B*n, C, P, P] in the features' dtype");
  if (shared_bytes != 0) {
    const int64_t plane = (chunk_channels * h * w * features.element_size() + 15) / 16 * 16;
    TORCH_CHECK(chunk_channels >= 1 && chunk_rois >= 1 && h < 65536 && w < 65536 &&
                    shared_bytes >= plane + chunk_rois * 2 * pooled * 4 &&
                    shared_bytes <= kMaxSharedBytes,
                "roi_pool_forward: a plan of ", chunk_channels, " channels, ", chunk_rois,
                " rois and ", shared_bytes, " bytes does not fit a [", h, ", ", w, "] map");
  }
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
      static_cast<int>(c), static_cast<int>(h), static_cast<int>(w),
      static_cast<int>(pooled), static_cast<float>(spatial_scale),
      static_cast<int>(chunk_channels), static_cast<int>(chunk_rois),
      static_cast<int>(shared_bytes), out.data_ptr(), argmax_ptr,
      static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_pool_forward launch failed: ", roi_pool_error_string(err));
}

// grad [B, n, C, P, P] f32/bf16 and argmax [B, n, C, P, P] int32 (contiguous)
// -> writes every cell of dfeat [B, C, H, W] (float32 or bfloat16; no need
// to zero it). The plan (ops/roi_pool.py::backward_plan): channels per
// block, rows per band and the bytes of shared memory a block takes.
void roi_pool_backward(const at::Tensor& grad, const at::Tensor& argmax,
                       int64_t chunk_channels, int64_t band_rows, int64_t shared_bytes,
                       at::Tensor& dfeat) {
  TORCH_CHECK(grad.is_cuda() && argmax.is_cuda() && dfeat.is_cuda(),
              "roi_pool_backward: tensors must be on a CUDA device");
  TORCH_CHECK(grad.dim() == 5 && grad.size(3) == grad.size(4),
              "grad must be [B, n, C, P, P]");
  TORCH_CHECK(grad.scalar_type() == at::kFloat || grad.scalar_type() == at::kBFloat16,
              "grad must be float32 or bfloat16");
  TORCH_CHECK(argmax.scalar_type() == at::kInt && argmax.sizes() == grad.sizes(),
              "argmax must be int32 shaped like grad");
  TORCH_CHECK((dfeat.scalar_type() == at::kFloat || dfeat.scalar_type() == at::kBFloat16) &&
                  dfeat.dim() == 4 && dfeat.size(0) == grad.size(0) &&
                  dfeat.size(1) == grad.size(2),
              "dfeat must be float32 or bfloat16 [B, C, H, W] matching grad");
  TORCH_CHECK(grad.is_contiguous() && argmax.is_contiguous() && dfeat.is_contiguous(),
              "roi_pool_backward: tensors must be contiguous");
  TORCH_CHECK(argmax.get_device() == grad.get_device() &&
                  dfeat.get_device() == grad.get_device(),
              "roi_pool_backward: tensors must share one device");
  const int64_t b = grad.size(0), n = grad.size(1), c = grad.size(2);
  const int64_t h = dfeat.size(2), w = dfeat.size(3);
  TORCH_CHECK(chunk_channels >= 1 && band_rows >= 1 &&
                  shared_bytes >= chunk_channels * std::min(band_rows, h) * w * 4 &&
                  shared_bytes <= kMaxSharedBytes,
              "roi_pool_backward: a plan of ", chunk_channels, " channels, ", band_rows,
              " rows and ", shared_bytes, " bytes does not fit a [", h, ", ", w, "] map");
  const c10::cuda::CUDAGuard guard(grad.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const int err = roi_pool_backward_launch(
      grad.data_ptr(), grad.scalar_type() == at::kBFloat16, argmax.data_ptr<int32_t>(),
      static_cast<int>(b), static_cast<int>(n), static_cast<int>(c), static_cast<int>(h),
      static_cast<int>(w), static_cast<int>(grad.size(3)), static_cast<int>(chunk_channels),
      static_cast<int>(band_rows), static_cast<int>(shared_bytes), dfeat.data_ptr(),
      dfeat.scalar_type() == at::kBFloat16, static_cast<void*>(stream));
  TORCH_CHECK(err == 0, "roi_pool_backward launch failed: ", roi_pool_error_string(err));
}

// features: the four levels P2..P5, each [B, C, h, w] f32/bf16 (one dtype);
// rois [B, n, 4] f32 canvas pixels; level [B, n] int32 in [0, 4) (all
// contiguous, one device) -> fills out [B, n, C, 7, 7] (features' dtype).
// slots: the slot-lattice variant (roi_align_slots.cu), which also needs
// every level map to be at least 2x2.
static void roi_align_forward_impl(const std::vector<at::Tensor>& features,
                                   const at::Tensor& rois, const at::Tensor& level,
                                   at::Tensor& out, bool slots) {
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
    TORCH_CHECK(!slots || (f.size(2) >= 2 && f.size(3) >= 2),
                "roi_align_slots_forward: every level map must be at least 2x2");
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
  const auto launch = slots ? roi_align_slots_forward_launch : roi_align_forward_launch;
  const int err = launch(
      ptrs, heights, widths, kAlignScales, f0.scalar_type() == at::kBFloat16,
      rois.data_ptr<float>(), level.data_ptr<int32_t>(), static_cast<int>(b * n),
      static_cast<int>(n), static_cast<int>(c), out.data_ptr(), static_cast<void*>(stream));
  TORCH_CHECK(err == 0, slots ? "roi_align_slots_forward" : "roi_align_forward",
              " launch failed: ", roi_pool_error_string(err));
}

void roi_align_forward(const std::vector<at::Tensor>& features, const at::Tensor& rois,
                       const at::Tensor& level, at::Tensor& out) {
  roi_align_forward_impl(features, rois, level, out, false);
}

void roi_align_slots_forward(const std::vector<at::Tensor>& features, const at::Tensor& rois,
                             const at::Tensor& level, at::Tensor& out) {
  roi_align_forward_impl(features, rois, level, out, true);
}

// Boxes [..., k, 4] as the IoU kernels read them: float32 (cast, as the
// TPU kernel casts), contiguous and 16-byte aligned (one float4 a box).
static at::Tensor iou_boxes(const at::Tensor& boxes, const char* what) {
  TORCH_CHECK(boxes.is_cuda(), what, ": tensors must be on a CUDA device");
  TORCH_CHECK(boxes.size(-1) == 4, what, ": boxes must be [..., 4]");
  at::Tensor t = boxes.to(at::kFloat).contiguous();
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, what,
              ": boxes must start on a 16-byte boundary");
  return t;
}

static void check_mask(const at::Tensor& mask, const at::Tensor& like, at::IntArrayRef shape,
                       const char* what) {
  TORCH_CHECK(mask.is_cuda() && mask.get_device() == like.get_device(), what,
              ": masks must be on the boxes' device");
  TORCH_CHECK(mask.scalar_type() == at::kBool && mask.is_contiguous() && mask.sizes() == shape,
              what, ": masks must be contiguous bool of the boxes' leading shape");
}

// a [n, 4], b [m, 4] (cast to float32) -> out [n, m] float32, their pairwise
// IoU; eps as jaccard_iou, and with eps == 0 the union floored at 1e-12 as
// box_iou. col_mask [m] (bool, optional): -1 in the columns where False.
at::Tensor pairwise_iou(const at::Tensor& a_in, const at::Tensor& b_in, double eps,
                        const c10::optional<at::Tensor>& col_mask) {
  TORCH_CHECK(a_in.dim() == 2 && b_in.dim() == 2, "pairwise_iou: boxes must be [n, 4] and [m, 4]");
  const at::Tensor a = iou_boxes(a_in, "pairwise_iou"), b = iou_boxes(b_in, "pairwise_iou");
  TORCH_CHECK(a.get_device() == b.get_device(), "pairwise_iou: tensors must share one device");
  const int64_t n = a.size(0), m = b.size(0);
  TORCH_CHECK(n < (int64_t{1} << 31) && n * m < (int64_t{1} << 40), "pairwise_iou: too many boxes");
  if (col_mask) check_mask(*col_mask, a, {m}, "pairwise_iou");
  const c10::cuda::CUDAGuard guard(a.device());
  at::Tensor out = at::empty({n, m}, a.options());
  const float e = static_cast<float>(eps);
  const int err = pairwise_iou_launch(
      a.data_ptr<float>(), b.data_ptr<float>(), static_cast<int>(n), static_cast<int>(m), e,
      e == 0.0f ? 1e-12f : 0.0f, col_mask ? col_mask->data_ptr<bool>() : nullptr,
      out.data_ptr<float>(), static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "pairwise_iou launch failed: ", roi_pool_error_string(err));
  return out;
}

// a [B, n, 4] candidates, b [B, m, 4] gt (cast to float32), row_mask [B, n],
// col_mask [B, m] bool -> (max [B, n] float32, argmax [B, n] int64) of each
// row of the masked IoU matrix (-1 where either mask is False), the
// smallest index among equal maxima, as torch.max(dim=-1).
std::tuple<at::Tensor, at::Tensor> iou_match(const at::Tensor& a_in, const at::Tensor& b_in,
                                             const at::Tensor& row_mask,
                                             const at::Tensor& col_mask, double eps) {
  TORCH_CHECK(a_in.dim() == 3 && b_in.dim() == 3 && a_in.size(0) == b_in.size(0),
              "iou_match: boxes must be [B, n, 4] and [B, m, 4]");
  const at::Tensor a = iou_boxes(a_in, "iou_match"), b = iou_boxes(b_in, "iou_match");
  TORCH_CHECK(a.get_device() == b.get_device(), "iou_match: tensors must share one device");
  const int64_t batch = a.size(0), n = a.size(1), m = b.size(1);
  TORCH_CHECK(m > 0, "iou_match: no columns to reduce");
  TORCH_CHECK(batch <= 65535 && batch * n < (int64_t{1} << 31) &&
                  iou_match_shared_bytes(static_cast<int>(std::min<int64_t>(m, 1 << 20))) <=
                      kMaxSharedBytes,
              "iou_match: too many boxes");
  check_mask(row_mask, a, {batch, n}, "iou_match");
  check_mask(col_mask, a, {batch, m}, "iou_match");
  const c10::cuda::CUDAGuard guard(a.device());
  at::Tensor best = at::empty({batch, n}, a.options());
  at::Tensor index = at::empty({batch, n}, a.options().dtype(at::kLong));
  const float e = static_cast<float>(eps);
  const int err = iou_match_launch(
      a.data_ptr<float>(), b.data_ptr<float>(), static_cast<int>(batch), static_cast<int>(n),
      static_cast<int>(m), e, e == 0.0f ? 1e-12f : 0.0f, row_mask.data_ptr<bool>(),
      col_mask.data_ptr<bool>(), best.data_ptr<float>(), index.data_ptr<int64_t>(),
      static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "iou_match launch failed: ", roi_pool_error_string(err));
  return {best, index};
}

// anchors [A, 4], gt [B, G, 4] float32 (no cast: both are float32 under
// autocast too), gt_mask [B, G] and inside [B, A] bool, all contiguous on one
// card -> (iou_max [B, A] float32, iou_argmax [B, A] int64, best_any [B, A]
// bool): ops/boxes.py::rpn_match_reference's anchor assignment of the batch,
// allow_ties choosing the tie set (FPN) or the per-gt first argmax (legacy).
// gt_share and per_lane: the gt slots a pass-1 block walks and the anchors a
// lane holds (ops/boxes.py::rpn_match_plan).
std::tuple<at::Tensor, at::Tensor, at::Tensor> rpn_match(const at::Tensor& anchors,
                                                         const at::Tensor& gt,
                                                         const at::Tensor& gt_mask,
                                                         const at::Tensor& inside, double eps,
                                                         bool allow_ties, int64_t gt_share,
                                                         int64_t per_lane) {
  TORCH_CHECK(anchors.is_cuda() && gt.is_cuda(), "rpn_match: tensors must be on a CUDA device");
  TORCH_CHECK(anchors.dim() == 2 && anchors.size(1) == 4 && gt.dim() == 3 && gt.size(2) == 4,
              "rpn_match: anchors must be [A, 4] and gt [B, G, 4]");
  TORCH_CHECK(anchors.scalar_type() == at::kFloat && gt.scalar_type() == at::kFloat,
              "rpn_match: anchors and gt must be float32");
  TORCH_CHECK(anchors.is_contiguous() && gt.is_contiguous(), "rpn_match: boxes must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(anchors.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(gt.data_ptr()) % 16 == 0,
              "rpn_match: boxes must start on a 16-byte boundary");
  TORCH_CHECK(anchors.get_device() == gt.get_device(), "rpn_match: tensors must share one device");
  const int64_t a = anchors.size(0), batch = gt.size(0), g = gt.size(1);
  TORCH_CHECK(g > 0, "rpn_match: no gt slots to reduce");
  TORCH_CHECK(batch <= 65535 && a < (int64_t{1} << 31) - 1024 && g < (int64_t{1} << 31),
              "rpn_match: too many anchors or images");
  TORCH_CHECK(gt_share > 0 && (g + gt_share - 1) / gt_share <= 65535,
              "rpn_match: gt_share must split the gt slots into 1..65535 shares");
  TORCH_CHECK(per_lane == 1 || per_lane == 4, "rpn_match: per_lane must be 1 or 4");
  TORCH_CHECK(eps >= 0.0, "rpn_match: eps must be >= 0");
  check_mask(gt_mask, gt, {batch, g}, "rpn_match");
  check_mask(inside, gt, {batch, a}, "rpn_match");
  const c10::cuda::CUDAGuard guard(gt.device());
  const int64_t split = (g + gt_share - 1) / gt_share;
  at::Tensor best = at::empty({batch, a}, gt.options());
  at::Tensor index = at::empty({batch, a}, gt.options().dtype(at::kLong));
  // Scratch the kernel zeroes with one memset: the keys, a word an image, then best_any.
  const int64_t key_bytes = batch * (g + 1) * static_cast<int64_t>(sizeof(int64_t));
  at::Tensor scratch = at::empty({key_bytes + batch * a}, gt.options().dtype(at::kByte));
  at::Tensor best_any = scratch.narrow(0, key_bytes, batch * a).view(at::kBool).view({batch, a});
  at::Tensor part_max, part_argmax;  // the shares' partial results, where the gt are split
  if (split > 1) {
    part_max = at::empty({split, batch, a}, gt.options());
    part_argmax = at::empty({split, batch, a}, gt.options().dtype(at::kInt));
  }
  const int err = anchor_match_launch(
      anchors.data_ptr<float>(), static_cast<int>(a), gt.data_ptr<float>(),
      gt_mask.data_ptr<bool>(), static_cast<int>(batch), static_cast<int>(g),
      static_cast<int>(std::min<int64_t>(gt_share, g)), static_cast<int>(per_lane),
      inside.data_ptr<bool>(),
      static_cast<float>(eps), allow_ties, best.data_ptr<float>(), index.data_ptr<int64_t>(),
      best_any.data_ptr<bool>(), reinterpret_cast<unsigned long long*>(scratch.data_ptr<uint8_t>()),
      split > 1 ? part_max.data_ptr<float>() : nullptr,
      split > 1 ? part_argmax.data_ptr<int32_t>() : nullptr,
      static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "rpn_match launch failed: ", roi_pool_error_string(err));
  return {best, index, best_any};
}

// boxes [S, n, 4] (cast to float32), each segment sorted by descending score;
// valid [S, n] bool -> (keep [S, post_k] int32, count [S] int32): the sorted
// positions of each segment's first post_k greedy survivors of iou > thr,
// -1 padded, and how many there are. width: the CTAs of a segment's cluster
// (ops/nms.py::nms_plan).
std::tuple<at::Tensor, at::Tensor> nms_segments(const at::Tensor& boxes_in,
                                                const at::Tensor& valid, double thr,
                                                int64_t post_k, int64_t width) {
  TORCH_CHECK(boxes_in.dim() == 3, "nms_segments: boxes must be [S, n, 4]");
  const at::Tensor boxes = iou_boxes(boxes_in, "nms_segments");
  const int64_t s = boxes.size(0), n = boxes.size(1);
  check_mask(valid, boxes, {s, n}, "nms_segments");
  TORCH_CHECK(width >= 1 && width <= 16, "nms_segments: a cluster of ", width,
              " CTAs (1 to 16)");
  const int64_t share = (post_k + width - 1) / width;
  TORCH_CHECK(post_k >= 0 && s * width < (int64_t{1} << 31) && s * n < (int64_t{1} << 40) &&
                  n < (int64_t{1} << 31) &&
                  nms_segments_shared_bytes(static_cast<int>(std::min<int64_t>(share, 1 << 20))) <=
                      kMaxSharedBytes,
              "nms_segments: ", post_k, " kept boxes over ", width,
              " CTAs do not fit their shared memory");
  const c10::cuda::CUDAGuard guard(boxes.device());
  at::Tensor keep = at::empty({s, post_k}, boxes.options().dtype(at::kInt));
  at::Tensor count = at::empty({s}, boxes.options().dtype(at::kInt));
  const int err = nms_segments_launch(
      boxes.data_ptr<float>(), valid.data_ptr<bool>(), static_cast<int>(s), static_cast<int>(n),
      static_cast<float>(thr), static_cast<int>(post_k), static_cast<int>(width),
      keep.data_ptr<int32_t>(), count.data_ptr<int32_t>(),
      static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "nms_segments launch of ", s, " clusters of ", width,
              " CTAs failed: ", roi_pool_error_string(err));
  return {keep, count};
}

// How many clusters of `width` NMS CTAs, each holding `share` kept boxes,
// device `device` runs at once (cudaOccupancyMaxActiveClusters; 0 where it
// runs none or refuses the width).
int64_t nms_max_active_clusters(int64_t device, int64_t width, int64_t share) {
  TORCH_CHECK(width >= 1 && width <= 16 && share >= 0 && share < (1 << 20),
              "nms_max_active_clusters: width 1 to 16 and a share under 2^20");
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  const int clusters =
      nms_segments_max_active_clusters(static_cast<int>(width), static_cast<int>(share));
  return clusters < 0 ? 0 : clusters;
}

// An empty kernel on the current stream: the launch floor under the IoU
// kernels' times (chip_smoke.py phase 2).
void empty_kernel() {
  const int err = empty_kernel_launch(static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "empty kernel launch failed: ", roi_pool_error_string(err));
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

// An activation as the FrozenBN kernels read it: a CUDA [B, C, H, W] tensor
// of float32 or bfloat16, made contiguous; `like`, where given, fixes its
// device, dtype and shape.
static at::Tensor bn_activation(const at::Tensor& t, const at::Tensor* like, const char* what) {
  TORCH_CHECK(t.is_cuda() && t.dim() == 4, "frozen_bn: ", what,
              " must be a CUDA [B, C, H, W] tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16,
              "frozen_bn: ", what, " must be float32 or bfloat16");
  if (like != nullptr) {
    TORCH_CHECK(t.get_device() == like->get_device() && t.scalar_type() == like->scalar_type() &&
                    t.sizes() == like->sizes(),
                "frozen_bn: ", what, " must match x's device, dtype and shape");
  }
  return t.contiguous();
}

// A per-channel vector [C] on x's device, as float32 (the kernels round it
// to x's dtype, as the eager chain's cast does).
static at::Tensor bn_vector(const at::Tensor& t, const at::Tensor& x, const char* what) {
  TORCH_CHECK(t.is_cuda() && t.get_device() == x.get_device() && t.dim() == 1 &&
                  t.size(0) == x.size(1),
              "frozen_bn: ", what, " must be a [C] vector on x's device");
  return t.to(at::kFloat).contiguous();
}

static void check_bn_sizes(const at::Tensor& x) {
  TORCH_CHECK(x.size(1) > 0 && x.size(1) < (int64_t{1} << 31) &&
                  x.size(0) * x.size(1) < (int64_t{1} << 31) &&
                  x.size(2) * x.size(3) <= int64_t{65535} * 2048,
              "frozen_bn: a [", x.size(0), ", ", x.size(1), ", ", x.size(2), ", ", x.size(3),
              "] activation is too large for the kernel's grid");
}

// x [B, C, H, W] float32/bfloat16, mean, inv, bias [C] (cast to float32),
// residual like x or None (given, relu too) -> y like x:
// ops/frozen_bn.py::frozen_bn_reference's chain, one pass.
at::Tensor frozen_bn_forward(const at::Tensor& x_in, const at::Tensor& mean, const at::Tensor& inv,
                             const at::Tensor& bias, const c10::optional<at::Tensor>& residual_in,
                             bool relu) {
  TORCH_CHECK(relu || !residual_in, "frozen_bn: a site with a residual has a ReLU");
  const at::Tensor x = bn_activation(x_in, nullptr, "x");
  const at::Tensor residual =
      residual_in ? bn_activation(*residual_in, &x, "residual") : at::Tensor();
  const at::Tensor m = bn_vector(mean, x, "mean"), k = bn_vector(inv, x, "inv"),
                   b = bn_vector(bias, x, "bias");
  check_bn_sizes(x);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty_like(x, at::MemoryFormat::Contiguous);
  const int err = frozen_bn_forward_launch(
      x.data_ptr(), residual.defined() ? residual.data_ptr() : nullptr, m.data_ptr<float>(),
      k.data_ptr<float>(), b.data_ptr<float>(), x.scalar_type() == at::kBFloat16, relu,
      x.size(0) * x.size(1), static_cast<int>(x.size(1)), x.size(2) * x.size(3), out.data_ptr(),
      static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "frozen_bn_forward launch failed: ", roi_pool_error_string(err));
  return out;
}

// grad [B, C, H, W] float32/bfloat16, out (the site's output, for a ReLU
// site) like grad or None, inv [C] -> (dx like grad, and with residual_grad,
// which needs out, the residual's gradient, else None).
std::tuple<at::Tensor, at::Tensor> frozen_bn_backward(const at::Tensor& grad_in,
                                                      const c10::optional<at::Tensor>& out_in,
                                                      const at::Tensor& inv, bool residual_grad) {
  TORCH_CHECK(out_in || !residual_grad, "frozen_bn: a site with a residual has a ReLU");
  const at::Tensor grad = bn_activation(grad_in, nullptr, "grad");
  const at::Tensor out = out_in ? bn_activation(*out_in, &grad, "out") : at::Tensor();
  const at::Tensor k = bn_vector(inv, grad, "inv");
  check_bn_sizes(grad);
  const c10::cuda::CUDAGuard guard(grad.device());
  at::Tensor dx = at::empty_like(grad, at::MemoryFormat::Contiguous);
  at::Tensor dresidual = residual_grad ? at::empty_like(dx) : at::Tensor();
  const int err = frozen_bn_backward_launch(
      grad.data_ptr(), out.defined() ? out.data_ptr() : nullptr, k.data_ptr<float>(),
      grad.scalar_type() == at::kBFloat16, grad.size(0) * grad.size(1),
      static_cast<int>(grad.size(1)), grad.size(2) * grad.size(3), dx.data_ptr(),
      residual_grad ? dresidual.data_ptr() : nullptr,
      static_cast<void*>(at::cuda::getCurrentCUDAStream()));
  TORCH_CHECK(err == 0, "frozen_bn_backward launch failed: ", roi_pool_error_string(err));
  return {dx, dresidual};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("roi_pool_forward", &roi_pool_forward,
        "RoIPool forward into preallocated outputs (CUDA)");
  m.def("roi_pool_backward", &roi_pool_backward,
        "RoIPool features-gradient, summed in shared memory and written once (CUDA)");
  m.def("roi_align_forward", &roi_align_forward,
        "MultiScaleRoIAlign forward over P2..P5 into a preallocated output (CUDA)");
  m.def("roi_align_slots_forward", &roi_align_slots_forward,
        "MultiScaleRoIAlign forward in the slot-lattice kernel's order (CUDA)");
  m.def("pairwise_iou", &pairwise_iou,
        "Pairwise IoU [n, 4] x [m, 4] -> [n, m], -1 where a column mask is False (CUDA)");
  m.def("iou_match", &iou_match,
        "Row max and first argmax of the masked IoU, [B, n, 4] x [B, m, 4] -> [B, n] (CUDA)");
  m.def("rpn_match", &rpn_match,
        "The RPN's anchor assignment of a batch: each anchor's max IoU and first gt, and the "
        "per-gt best anchors (ties or first argmax), [A, 4] x [B, G, 4] -> [B, A], gt_share "
        "slots a pass-1 block (CUDA)");
  m.def("rpn_match_tile", &anchor_match_tile, "Anchors a block of the anchor match holds");
  m.def("nms_segments", &nms_segments,
        "Segmented exact greedy NMS, [S, n, 4] sorted boxes -> [S, post_k] kept positions, "
        "a cluster of CTAs a segment (CUDA)");
  m.def("nms_max_active_clusters", &nms_max_active_clusters,
        "Clusters of NMS CTAs the device runs at once (CUDA occupancy query)");
  m.def("empty_kernel", &empty_kernel, "An empty kernel: the launch floor (CUDA)");
  m.def("roi_align_backward", &roi_align_backward,
        "MultiScaleRoIAlign features-gradient, atomically added into zeroed float32 maps (CUDA)");
  m.def("frozen_bn_forward", &frozen_bn_forward,
        "FrozenBatchNorm2d, plus the residual add and the ReLU where given, one pass (CUDA)");
  m.def("frozen_bn_backward", &frozen_bn_backward,
        "FrozenBatchNorm2d's gradient after the ReLU's mask, and the residual's (CUDA)");
}
