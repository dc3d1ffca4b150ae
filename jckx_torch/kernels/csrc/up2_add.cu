// A GBlock's residual sum, in place, written by hand for Hopper (sm_90a):
//     y[n, h, w, c] += s[n, h / 2, w / 2, c]
// on channels_last maps, y (N, 2H, 2W, C) and s (N, H, W, C): y plus the
// nearest x2 upsampling of s, which is never written out. BigGAN's blocks
// (jckx_torch/models/biggan.py) add their shortcut, a 1x1 convolution
// taken before the upsampling, to their main path's output so.
//
// Replaces no TPU kernel: the JAX package has no BigGAN. It was added
// because PyTorch's add against a broadcast view of s takes its strided
// elementwise path, one element a thread: 3.78 ms of a 27.7 ms bs256
// render on an H100.
//
// What bounds it: HBM bandwidth. One add an element against y read and
// written and s read once: at BigGAN-128's five blocks, batch 256, bf16,
// 25.2 + 50.3 + 100.7 + 201.3 + 402.7 M elements of y, 4.5 bytes each (s
// is a quarter of y), 3.52 GB, 1.05 ms at 3.35 TB/s.
//
// What the design does about it: 16-byte loads and stores a thread when C
// is a multiple of the vector width and the pointers are 16-byte aligned,
// else one element a thread; a grid-stride loop over at most 8 blocks an
// SM. A thread finds its output row across the batch (n * 2H + h) and its
// column by division: half that row is s's row (2H is even), so no
// sample index is needed. The sum is taken in f32 and rounded once to
// the map's dtype, as torch's add. Offsets are 64-bit; it runs on the
// caller's stream, allocates nothing, and the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

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
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

// The offset in s, in units of `unit` elements (1, or a vector), of y's
// unit i; `per_pixel` units a pixel, y's rows 2W pixels wide.
__device__ __forceinline__ int64_t source_of(int64_t i, int64_t per_pixel, int64_t W2) {
  const int64_t p = i / per_pixel;
  const int64_t row = p / W2;
  const int64_t col = p - row * W2;
  return ((row / 2) * (W2 / 2) + col / 2) * per_pixel + (i - p * per_pixel);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
up2_add_scalar(T* __restrict__ y, const T* __restrict__ s, int64_t n, int64_t C, int64_t W2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = Cvt<T>::to(y[i]) + Cvt<T>::to(s[source_of(i, C, W2)]);
    y[i] = Cvt<T>::from(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
up2_add_vec(T* __restrict__ y, const T* __restrict__ s, int64_t nvec, int64_t C, int64_t W2) {
  constexpr int VEC = 16 / sizeof(T);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
  const uint4* __restrict__ sv = reinterpret_cast<const uint4*>(s);
  const int64_t per_pixel = C / VEC;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    uint4 a = yv[i];
    const uint4 b = __ldg(sv + source_of(i, per_pixel, W2));
    T* ya = reinterpret_cast<T*>(&a);
    const T* sb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ya[k] = Cvt<T>::from(Cvt<T>::to(ya[k]) + Cvt<T>::to(sb[k]));
    yv[i] = a;
  }
}

template <typename T>
cudaError_t launch(T* y, const T* s, int64_t rows, int64_t W, int64_t C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n = 4 * rows * W * C;  // y's elements
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const int64_t work = vec ? n / VEC : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t max_blocks = (int64_t)sms * kBlocksPerSM;
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    up2_add_vec<T><<<(unsigned)blocks, kThreads, 0, stream>>>(y, s, work, C, 2 * W);
  } else {
    up2_add_scalar<T><<<(unsigned)blocks, kThreads, 0, stream>>>(y, s, n, C, 2 * W);
  }
  return cudaGetLastError();
}

}  // namespace

// y: device pointer to the (N, 2H, 2W, C) map, updated in place; s: the
// (N, H, W, C) map; both `dtype` (0 = f32, 1 = bf16), row-major (channels_last).
// rows = N * H, W = s's width. stream: a cudaStream_t. Returns a
// cudaError_t; 0 when the kernel was launched.
extern "C" int jckx_up2_add(void* y, const void* s, int64_t rows, int64_t W, int64_t C,
                            int dtype, void* stream) {
  if (rows <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(static_cast<float*>(y), static_cast<const float*>(s), rows, W, C, st);
    case kBF16:
      return launch<__nv_bfloat16>(static_cast<__nv_bfloat16*>(y),
                                   static_cast<const __nv_bfloat16*>(s), rows, W, C, st);
    default: return cudaErrorInvalidValue;
  }
}
