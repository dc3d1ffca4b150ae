// Class-conditional BatchNorm normalize + ReLU, written by hand for
// Hopper (sm_90a): BigGAN's conditional BN (jckx_torch/models/biggan.py).
//
// Replaces no TPU kernel: the JAX package has no conditional BN. It is the
// per-sample form of fused_bn_act.cu's kernel. Where that one reads one
// per-channel affine (C,), this one reads one affine a sample, (N, C): the
// gain and shift that BigGAN's class embedding and latent chunk give each
// image. On a channels_last activation seen as (rows, C), rows = N*HW, the
// rows of sample n are [n*HW, (n+1)*HW), and
//     y[r, c] = relu(fmaf(f32(x[r, c]), inv[n, c], shift[n, c]))  cast to x's dtype
// (every conditional BN of BigGAN's G feeds a ReLU). The wrapper derives
// inv = (1 + g) * rstd and shift = b - mean * inv from the batch statistics
// (kernels/fused_bn_act.py); the multiply-add is one FMA, rounded once, as
// the per-channel kernel's is. With up = 2 it writes y upsampled ×2 by
// nearest neighbour, each value to its 2x2 block of a (N, 2H, 2W, C) map:
// a GBlock's first conditional BN feeds its 3x3 convolution through that
// upsampling, which this spares its own pass over the 4x larger map.
//
// What bounds it: HBM bandwidth, as the per-channel kernel (2-3 flops an
// element against 4 bytes in bf16). The (N, C) vectors add 8 bytes a
// sample and channel, a few hundred KB at most, read through the read-only
// cache. At BigGAN-128's ten conditional layers, batch 256, bf16, x read
// once and y written once: 25.2 / 100.7 / 100.7 / 201.3 / 201.3 / 402.7 /
// 402.7 / 805.3 / 805.3 / 1610.6 MB, 7.5 ... 480.8 us at 3.35 TB/s; with
// the upsampling (each block's first), y is written 4x: 62.9 / 251.7 /
// 503.3 / 1006.6 / 2013.3 MB for those five.
//
// What the design does about it: a 2-D grid, one row of blocks a sample
// (blockIdx.y, grid-strided past 65,535 samples), so a block's affine is one
// sample's and no thread divides by HW. Inside a sample the loop is the
// per-channel kernel's: 16-byte loads and stores when C is a multiple of
// the vector width and both pointers are 16-byte aligned (every BigGAN
// layer; a sample's HW*C elements then start 16-byte aligned too), else
// one element a thread; the channel index advances incrementally. Upsampled,
// a thread finds its pixel's row and column by division and stores its
// value four times (16 bytes each in the vector path). At most 8 blocks an
// SM over the whole grid. Offsets are 64-bit. It runs on the caller's
// stream, allocates nothing, and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int64_t kMaxGridY = 65535;

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
  // round to nearest even, as torch's casts do
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN passes through

// Where a sample's input element e = p*C + c (pixel p = h*W + w) lands in
// its output, in elements (UP = 1: where it was).
template <int UP>
__device__ __forceinline__ int64_t out_at(int64_t e, int64_t C, int64_t W) {
  if (UP == 1) return e;
  const int64_t p = e / C;
  const int64_t h = p / W;
  return ((2 * h * 2 * W) + 2 * (p - h * W)) * C + (e - p * C);
}

// One element a thread: any C, any alignment. `per` = HW*C input elements a sample.
template <typename T, int UP>
__global__ void __launch_bounds__(kThreads)
cbn_normalize_scalar(const T* __restrict__ x, const float* __restrict__ inv,
                     const float* __restrict__ shift, T* __restrict__ y,
                     int64_t samples, int64_t per, int64_t C, int64_t W) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = stride % C;
  for (int64_t n = blockIdx.y; n < samples; n += gridDim.y) {
    const T* xs = x + n * per;
    T* ys = y + n * per * UP * UP;
    const float* in = inv + n * C;
    const float* sh = shift + n * C;
    int64_t c = first % C;
    for (int64_t i = first; i < per; i += stride) {
      const float v = fmaf(Cvt<T>::to(xs[i]), __ldg(in + c), __ldg(sh + c));
      const T out = Cvt<T>::from(relu(v));
      const int64_t o = out_at<UP>(i, C, W);
      ys[o] = out;
      if (UP == 2) {
        ys[o + C] = out;
        ys[o + 2 * W * C] = out;
        ys[o + 2 * W * C + C] = out;
      }
      c += step;
      if (c >= C) c -= C;
    }
  }
}

// 16 bytes a thread: C % VEC == 0, so a vector never crosses a pixel or a sample.
template <typename T, int UP>
__global__ void __launch_bounds__(kThreads)
cbn_normalize_vec(const T* __restrict__ x, const float* __restrict__ inv,
                  const float* __restrict__ shift, T* __restrict__ y,
                  int64_t samples, int64_t per_vec, int64_t C, int64_t W) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (stride * VEC) % C;
  const int64_t cv = C / VEC;  // vectors a pixel
  for (int64_t n = blockIdx.y; n < samples; n += gridDim.y) {
    const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x) + n * per_vec;
    uint4* __restrict__ yv = reinterpret_cast<uint4*>(y) + n * per_vec * UP * UP;
    const float* in = inv + n * C;
    const float* sh = shift + n * C;
    int64_t c = (first * VEC) % C;
    for (int64_t i = first; i < per_vec; i += stride) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = fmaf(Cvt<T>::to(e[k]), __ldg(in + c + k), __ldg(sh + c + k));
        o[k] = Cvt<T>::from(relu(v));
      }
      const int64_t at = out_at<UP>(i * VEC, C, W) / VEC;
      yv[at] = out;
      if (UP == 2) {
        yv[at + cv] = out;
        yv[at + 2 * W * cv] = out;
        yv[at + 2 * W * cv + cv] = out;
      }
      c += step;
      if (c >= C) c -= C;
    }
  }
}

template <typename T, int UP>
cudaError_t launch(const T* x, const float* inv, const float* shift, T* y, int64_t samples,
                   int64_t per_sample_rows, int64_t W, int64_t C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t per = per_sample_rows * C;
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int64_t work = vec ? per / VEC : per;
  const int64_t grid_y = samples < kMaxGridY ? samples : kMaxGridY;
  int64_t grid_x = (work + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSM / grid_y;
  if (cap < 1) cap = 1;
  if (grid_x > cap) grid_x = cap;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (vec) {
    cbn_normalize_vec<T, UP><<<grid, kThreads, 0, stream>>>(x, inv, shift, y, samples, work, C,
                                                            W);
  } else {
    cbn_normalize_scalar<T, UP><<<grid, kThreads, 0, stream>>>(x, inv, shift, y, samples, per, C,
                                                               W);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* inv, const void* shift, void* y, int64_t samples,
                     int64_t per_sample_rows, int64_t W, int64_t C, int up, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  const float* st = static_cast<const float*>(shift);
  T* yt = static_cast<T*>(y);
  switch (up) {
    case 1: return launch<T, 1>(xt, it, st, yt, samples, per_sample_rows, W, C, stream);
    case 2: return launch<T, 2>(xt, it, st, yt, samples, per_sample_rows, W, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: device pointer to samples*per_sample_rows*C elements of `dtype`
// (0 = f32, 1 = bf16), row-major (a channels_last activation of `width`
// columns), sample n's rows contiguous; y: up*up times as many (up = 1, or
// 2: the nearest x2 upsampling of each sample's map). inv, shift:
// samples*C device f32 values, row n for sample n. stream: a cudaStream_t.
// Returns a cudaError_t; 0 when the kernel was launched.
extern "C" int jckx_cbn_act(const void* x, const void* inv, const void* shift, void* y,
                            int64_t samples, int64_t per_sample_rows, int64_t width, int64_t C,
                            int dtype, int up, void* stream) {
  if (samples <= 0 || per_sample_rows <= 0 || C <= 0 || width <= 0 ||
      per_sample_rows % width != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch<float>(x, inv, shift, y, samples, per_sample_rows, width, C, up, st);
    case kBF16:
      return dispatch<__nv_bfloat16>(x, inv, shift, y, samples, per_sample_rows, width, C, up,
                                     st);
    default: return cudaErrorInvalidValue;
  }
}
