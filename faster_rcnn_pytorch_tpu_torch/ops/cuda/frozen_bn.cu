// FrozenBatchNorm2d and, where the site has them, the residual add and the
// ReLU, as one pass over an NCHW activation, for Hopper, sm_90a; and the
// pass that is its gradient.
//
// Replaces no TPU kernel: the JAX package writes FrozenBN as plain jnp
// (faster_rcnn_pytorch_tpu/models/resnet.py, FrozenBatchNorm), which XLA
// fuses with the ReLU and the residual add. In eager PyTorch the same chain
// is three broadcast kernels, a residual add and a ReLU, each a full pass
// over the activation (ops/frozen_bn.py::frozen_bn_reference).
//
// Semantics, bit for bit the eager chain's in the activation dtype T
// (bfloat16 or float32), each step in float32 and rounded back to T with
// round-to-nearest-even as PyTorch's kernels round:
//   y = T(T(T(x - mean) * inv) + bias)      mean, inv, bias rounded to T first
//   y = T(y + residual)                     a bn3 site
//   y = isnan(y) ? y : fmaxf(y, 0)          ReLU, PyTorch's clamp_min(y, 0)
// and the gradient of a site, the eager chain's backward:
//   g = out <= 0 ? 0 : grad                 a ReLU site (threshold_backward)
//   dx = T(g * inv); dresidual = g          a bn3 site hands g to its branch
// Every float operation is an explicit __f*_rn intrinsic, so nvcc contracts
// nothing into an FMA.
//
// What bounds it on an H100: bytes. A site reads x (and the residual) and
// writes y once, 4-6 bytes an element in bfloat16; at the 800x1344 canvas a
// batch of 8 moves 9.5 GB over the 53 sites of a ResNet50 forward, 2.8 ms at
// 3.35 TB/s. The design is bytes only: a block owns a chunk of one channel
// plane, so the channel's three constants are read once a thread, not an
// element; each thread holds up to kUnroll 16-byte vectors of every input
// in registers before it computes and stores them (8 bfloat16 or 4 float32
// each), so a resident block has 8-16 KB in flight. A plane's first
// elements up to a 16-byte boundary and its last partial vector are scalar
// (layer 4's 25x42 planes are not a multiple of 8 elements, so most of its
// planes start off a boundary); where the tensors' bases are not congruent
// modulo 16 bytes the whole call is scalar. The grid is planes x chunks of
// 512 vectors: 4,096 blocks at the smallest site of the 800x1344 forward,
// about two waves of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // 16-byte vectors of each input a thread holds at once

struct Bf16 {
  using raw = unsigned short;
  __device__ static float widen(raw v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
  __device__ static raw narrow(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

struct F32 {
  using raw = float;
  __device__ static float widen(raw v) { return v; }
  __device__ static raw narrow(float v) { return v; }
};

template <class D>
__device__ __forceinline__ float round_to(float v) {
  return D::widen(D::narrow(v));
}

template <class D>
union Vec {
  uint4 u;
  typename D::raw e[16 / sizeof(typename D::raw)];
};

// The forward of one element: inputs x (and the residual), output y.
template <class D, bool kResidual, bool kRelu>
struct Forward {
  using raw = typename D::raw;
  static constexpr int kIn = kResidual ? 2 : 1;
  static constexpr int kOut = 1;
  float mean, inv, bias;

  __device__ Forward(const float* const* consts, int c)
      : mean(round_to<D>(consts[0][c])), inv(round_to<D>(consts[1][c])),
        bias(round_to<D>(consts[2][c])) {}

  __device__ __forceinline__ void operator()(const raw (&a)[kIn], raw (&b)[kOut]) const {
    float v = round_to<D>(__fsub_rn(D::widen(a[0]), mean));
    v = round_to<D>(__fmul_rn(v, inv));
    v = round_to<D>(__fadd_rn(v, bias));
    if (kResidual) v = round_to<D>(__fadd_rn(v, D::widen(a[kIn - 1])));
    if (kRelu && v == v) v = fmaxf(v, 0.0f);  // a NaN passes, as in clamp_min
    b[0] = D::narrow(v);
  }
};

// The gradient of one element: inputs grad (and the site's output, for the
// ReLU's mask), outputs dx (and the residual's gradient).
template <class D, bool kRelu, bool kResidualGrad>
struct Backward {
  using raw = typename D::raw;
  static constexpr int kIn = kRelu ? 2 : 1;
  static constexpr int kOut = kResidualGrad ? 2 : 1;
  float inv;

  __device__ Backward(const float* const* consts, int c) : inv(round_to<D>(consts[1][c])) {}

  __device__ __forceinline__ void operator()(const raw (&a)[kIn], raw (&b)[kOut]) const {
    raw g = a[0];
    if (kRelu && D::widen(a[kIn - 1]) <= 0.0f) g = D::narrow(0.0f);
    b[0] = D::narrow(__fmul_rn(D::widen(g), inv));
    if (kResidualGrad) b[kOut - 1] = g;
  }
};

struct Args {
  const void* in[2];
  void* out[2];
  const float* consts[3];  // mean, inv, bias: float32 [C]
  int channels;
  int64_t plane;  // H * W
};

// Block (p, k) walks chunk k of plane p: vectors [k, k + 1) * kThreads *
// kUnroll of the plane's 16-byte-aligned body (chunk 0 also its scalar head
// and tail), or with kVec false the same span of elements one by one.
template <class Op, class D, bool kVec>
__global__ void __launch_bounds__(kThreads) frozen_bn_kernel(Args args) {
  using raw = typename D::raw;
  constexpr int kWidth = 16 / sizeof(raw);
  const int64_t p = blockIdx.x;
  const Op op(args.consts, static_cast<int>(p % args.channels));
  const int64_t size = args.plane;
  const raw* in[Op::kIn];
  raw* out[Op::kOut];
#pragma unroll
  for (int i = 0; i < Op::kIn; ++i) in[i] = static_cast<const raw*>(args.in[i]) + p * size;
#pragma unroll
  for (int o = 0; o < Op::kOut; ++o) out[o] = static_cast<raw*>(args.out[o]) + p * size;

  auto element = [&](int64_t j) {
    raw a[Op::kIn], b[Op::kOut];
#pragma unroll
    for (int i = 0; i < Op::kIn; ++i) a[i] = in[i][j];
    op(a, b);
#pragma unroll
    for (int o = 0; o < Op::kOut; ++o) out[o][j] = b[o];
  };

  const int64_t first = static_cast<int64_t>(blockIdx.y) * (kThreads * kUnroll);
  if (!kVec) {
    const int64_t e0 = first * kWidth;
#pragma unroll 4
    for (int k = 0; k < kUnroll * kWidth; ++k) {
      const int64_t j = e0 + k * kThreads + threadIdx.x;
      if (j < size) element(j);
    }
    return;
  }
  // Elements before the first 16-byte boundary (every base is congruent).
  const int64_t lead =
      static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(in[0]) & 15)) & 15) / sizeof(raw));
  const int64_t head = lead < size ? lead : size;
  const int64_t body = (size - head) / kWidth;
  Vec<D> a[kUnroll][Op::kIn];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t v = first + u * kThreads + threadIdx.x;
    if (v < body) {
#pragma unroll
      for (int i = 0; i < Op::kIn; ++i) a[u][i].u = reinterpret_cast<const uint4*>(in[i] + head)[v];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t v = first + u * kThreads + threadIdx.x;
    if (v < body) {
      Vec<D> b[Op::kOut];
#pragma unroll
      for (int e = 0; e < kWidth; ++e) {
        raw ai[Op::kIn], bo[Op::kOut];
#pragma unroll
        for (int i = 0; i < Op::kIn; ++i) ai[i] = a[u][i].e[e];
        op(ai, bo);
#pragma unroll
        for (int o = 0; o < Op::kOut; ++o) b[o].e[e] = bo[o];
      }
#pragma unroll
      for (int o = 0; o < Op::kOut; ++o) reinterpret_cast<uint4*>(out[o] + head)[v] = b[o].u;
    }
  }
  if (blockIdx.y == 0) {  // the scalar head and tail: fewer than 2 * kWidth elements
    const int64_t tail = size - head - body * kWidth;
    const int64_t t = threadIdx.x;
    if (t < head) {
      element(t);
    } else if (t - head < tail) {
      element(head + body * kWidth + (t - head));
    }
  }
}

bool congruent(const void* const* ptrs, int n) {
  const uintptr_t r = reinterpret_cast<uintptr_t>(ptrs[0]) & 15;
  for (int i = 1; i < n; ++i) {
    if ((reinterpret_cast<uintptr_t>(ptrs[i]) & 15) != r) return false;
  }
  return true;
}

template <class Op, class D>
int launch(const Args& args, int64_t planes, cudaStream_t stream) {
  constexpr int64_t kChunk = kThreads * kUnroll * (16 / sizeof(typename D::raw));
  const int64_t chunks = (args.plane + kChunk - 1) / kChunk;
  if (planes <= 0 || chunks <= 0) return static_cast<int>(cudaSuccess);
  if (planes > 0x7fffffff || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4];
  int n = 0;
  for (int i = 0; i < Op::kIn; ++i) ptrs[n++] = args.in[i];
  for (int o = 0; o < Op::kOut; ++o) ptrs[n++] = args.out[o];
  const dim3 grid(static_cast<unsigned>(planes), static_cast<unsigned>(chunks));
  if (congruent(ptrs, n)) {
    frozen_bn_kernel<Op, D, true><<<grid, kThreads, 0, stream>>>(args);
  } else {
    frozen_bn_kernel<Op, D, false><<<grid, kThreads, 0, stream>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// The model's three kinds of site: BN, BN + ReLU, BN + residual + ReLU (a
// residual implies the ReLU; binding.cpp checks it).
template <class D>
int forward_launch(const Args& args, bool residual, bool relu, int64_t planes, cudaStream_t s) {
  if (residual) return launch<Forward<D, true, true>, D>(args, planes, s);
  return relu ? launch<Forward<D, false, true>, D>(args, planes, s)
              : launch<Forward<D, false, false>, D>(args, planes, s);
}

// Their gradients: a residual's gradient comes from a ReLU site.
template <class D>
int backward_launch(const Args& args, bool relu, bool residual_grad, int64_t planes,
                    cudaStream_t s) {
  if (residual_grad) return launch<Backward<D, true, true>, D>(args, planes, s);
  return relu ? launch<Backward<D, true, false>, D>(args, planes, s)
              : launch<Backward<D, false, false>, D>(args, planes, s);
}

}  // namespace

// Plain C++ entry points (no PyTorch headers here); binding.cpp checks the
// tensors, allocates the outputs and calls them on PyTorch's current stream.
// Activations are contiguous [planes / channels, channels, plane] of one
// dtype (bfloat16 or float32); mean, inv and bias contiguous float32
// [channels]. Each returns the launch's cudaError_t.

// x (and residual, or nullptr; with a residual, relu) -> out.
int frozen_bn_forward_launch(const void* x, const void* residual, const float* mean,
                             const float* inv, const float* bias, bool is_bf16, bool relu,
                             int64_t planes, int channels, int64_t plane, void* out,
                             void* stream) {
  Args args{};
  args.in[0] = x;
  args.in[1] = residual;
  args.out[0] = out;
  args.consts[0] = mean;
  args.consts[1] = inv;
  args.consts[2] = bias;
  args.channels = channels;
  args.plane = plane;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? forward_launch<Bf16>(args, residual != nullptr, relu, planes, s)
                 : forward_launch<F32>(args, residual != nullptr, relu, planes, s);
}

// grad (and the site's output `out` for a ReLU site, or nullptr) -> dx (and
// dresidual, or nullptr; with dresidual, out).
int frozen_bn_backward_launch(const void* grad, const void* out, const float* inv,
                              bool is_bf16, int64_t planes, int channels, int64_t plane,
                              void* dx, void* dresidual, void* stream) {
  Args args{};
  args.in[0] = grad;
  args.in[1] = out;
  args.out[0] = dx;
  args.out[1] = dresidual;
  args.consts[1] = inv;
  args.channels = channels;
  args.plane = plane;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? backward_launch<Bf16>(args, out != nullptr, dresidual != nullptr, planes, s)
                 : backward_launch<F32>(args, out != nullptr, dresidual != nullptr, planes, s);
}
