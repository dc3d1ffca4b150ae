// Fused BatchNorm normalize + activation, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` built in `raw` of
// `_partitioned_pallas_call` (jckx/kernels/fused_bn_act.py:108-131, the
// `pl.pallas_call` at :120), which `_bn_act_pallas` (:175-193) drives on the
// inference paths of the JAX package.
//
// What it computes, on a channels_last activation seen as (rows, C) with
// rows = N*H*W:
//     y[r, c] = act(fmaf(f32(x[r, c]), inv[c], shift[c]))  cast to x's dtype
// with act = none, relu, or leaky_relu(slope). `inv` and `shift` are the
// f32 per-channel affine that the wrapper derives from the batch statistics
// (jckx_torch/kernels/fused_bn_act.py); the kernel reads x once and writes
// y once, and nothing else of size rows*C.
//
// What bounds it: HBM bandwidth. It does 2-3 flops per element against
// 4 bytes (bf16) or 8 bytes (f32) moved, far below the ~295 flop/byte
// where an H100 stops being memory bound. At the DCGAN generator's
// serving shapes (batch 512, bf16; 3.35 TB/s, H100 SXM data sheet) the
// bound is computed from the bytes, not measured:
//     layer 0   4x4 x512   16.8 MB   5.0 us
//     layer 1   8x8 x256   33.6 MB  10.0 us
//     layer 2  16x16x128   67.1 MB  20.0 us
//     layer 3  32x32x 64  134.2 MB  40.1 us    (f32: each figure doubles)
//
// What the design does about it: one pass, 16-byte loads and stores per
// thread when C is a multiple of the vector width and both pointers are
// 16-byte aligned (every generator layer), else one element per thread
// (any C, any row count: the TPU's C % 128 / rows % 8 gate was tiling, not
// semantics). A grid-stride loop over at most 8 blocks per SM keeps the
// card full at every layer; the channel index advances incrementally, so
// the loop has no 64-bit division. inv/shift (<= a few KB) are read
// through the read-only cache. Offsets are 64-bit. The kernel runs on the
// caller's stream, allocates nothing, and the entry returns
// cudaGetLastError() so a refused launch is reported by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

enum Act : int { kNone = 0, kRelu = 1, kLeaky = 2 };
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  // round to nearest even, as torch's and XLA's casts do
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

template <int ACT>
__device__ __forceinline__ float activate(float v, float slope) {
  if (ACT == kRelu) return v < 0.f ? 0.f : v;  // NaN passes through, as jnp.maximum
  if (ACT == kLeaky) return v >= 0.f ? v : slope * v;
  return v;
}

// One element per thread: any C, any alignment.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
bn_act_scalar(const T* __restrict__ x, const float* __restrict__ inv,
              const float* __restrict__ shift, T* __restrict__ y,
              int64_t n, int64_t C, float slope) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t c = i % C;
  const int64_t step = stride % C;
  for (; i < n; i += stride) {
    const float v = fmaf(Cvt<T>::to(x[i]), __ldg(inv + c), __ldg(shift + c));
    y[i] = Cvt<T>::from(activate<ACT>(v, slope));
    c += step;
    if (c >= C) c -= C;
  }
}

// 16 bytes per thread: C % VEC == 0, so a vector never crosses a row.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
bn_act_vec(const T* __restrict__ x, const float* __restrict__ inv,
           const float* __restrict__ shift, T* __restrict__ y,
           int64_t nvec, int64_t C, float slope) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t c = (i * VEC) % C;
  const int64_t step = (stride * VEC) % C;
  for (; i < nvec; i += stride) {
    const uint4 in = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&in);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = fmaf(Cvt<T>::to(e[k]), __ldg(inv + c + k), __ldg(shift + c + k));
      o[k] = Cvt<T>::from(activate<ACT>(v, slope));
    }
    yv[i] = out;
    c += step;
    if (c >= C) c -= C;
  }
}

template <typename T, int ACT>
cudaError_t launch(const T* x, const float* inv, const float* shift, T* y,
                   int64_t rows, int64_t C, float slope, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n = rows * C;
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int64_t work = vec ? n / VEC : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t max_blocks = (int64_t)sms * kBlocksPerSM;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    bn_act_vec<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(x, inv, shift, y, work, C, slope);
  } else {
    bn_act_scalar<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(x, inv, shift, y, n, C, slope);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(const void* x, const void* inv, const void* shift, void* y,
                         int64_t rows, int64_t C, int act, float slope,
                         cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  const float* st = static_cast<const float*>(shift);
  T* yt = static_cast<T*>(y);
  switch (act) {
    case kNone: return launch<T, kNone>(xt, it, st, yt, rows, C, slope, stream);
    case kRelu: return launch<T, kRelu>(xt, it, st, yt, rows, C, slope, stream);
    case kLeaky: return launch<T, kLeaky>(xt, it, st, yt, rows, C, slope, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: device pointers to rows*C elements of `dtype` (0 = f32, 1 = bf16),
// row-major (a channels_last activation). inv, shift: C device f32 values.
// act: 0 none, 1 relu, 2 leaky_relu(slope). stream: a cudaStream_t.
// Returns a cudaError_t; 0 when the kernel was launched.
extern "C" int jckx_bn_act(const void* x, const void* inv, const void* shift, void* y,
                           int64_t rows, int64_t C, int dtype, int act, float slope,
                           void* stream) {
  if (rows <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_act<float>(x, inv, shift, y, rows, C, act, slope, st);
    case kBF16: return dispatch_act<__nv_bfloat16>(x, inv, shift, y, rows, C, act, slope, st);
    default: return cudaErrorInvalidValue;
  }
}
