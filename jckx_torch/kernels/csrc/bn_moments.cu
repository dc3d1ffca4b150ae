// BatchNorm batch moments: the per-channel sum and sum of squares of an
// activation, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package takes these statistics in plain
// XLA (`_stats`, jckx/kernels/fused_bn_act.py:66-71), which fuses the cast,
// the square and both column sums into one pass over the activation. The
// port's plain version of the same function (`bn_moments_plain`,
// jckx_torch/kernels/fused_bn_act.py) is four passes on the card: an f32
// copy of x, its square, two column reductions. This kernel is the one pass
// that XLA makes, on the inference route in front of the fused normalize +
// activation kernel (`fused_bn_act.cu`), which needs these sums first.
//
// What it computes, on a channels_last activation seen as (rows, C):
//     out[0, c] = sum_r f32(x[r, c])      out[1, c] = sum_r f32(x[r, c])^2
// in f32, as one (2, C) tensor (the form that sync-BN all-reduces).
//
// What bounds it: HBM bandwidth. It reads x once (2 bytes an element in
// bf16, 4 in f32) for 3 flops an element, and writes 8 bytes a channel. At
// the DCGAN / CGAN generator's serving shapes (batch 512, bf16; 3.35 TB/s,
// H100 SXM data sheet) the bound is computed from the bytes read:
//     layer 0   4x4 x512    8.4 MB  2.5 us    (bn_act's traffic 16.8 MB)
//     layer 1   8x8 x256   16.8 MB  5.0 us    (33.6 MB)
//     layer 2  16x16x128   33.6 MB 10.0 us    (67.1 MB)
//     layer 3  32x32x 64   67.1 MB 20.0 us    (134.2 MB)
// 125.8 MB and 37.6 us a render in all (f32: each figure doubles).
//
// What the design does about it: one read of x with 16-byte loads (8 bf16
// or 4 f32 channels a thread; each asks L2 for 256 bytes) where C and the
// pointer allow (every generator layer), else one element a thread (any C,
// any alignment). A block is 256 threads: up to 32 of them span a row's
// channels, the rest take further rows, and a block walks a contiguous
// range of rows with 8 loads in flight per thread, keeping each of its
// channels' sum and sum of squares in f32 registers: the 8 loads' terms are
// added among themselves first, then to the running sums. The grid follows the
// shape: a C wider than 32 vectors is split over column blocks (8,192 x 512:
// two), the rows over as many row blocks as give each thread at least 8
// loads, at most 2 blocks an SM in all, the workspace's rows (524,288 x 64:
// 261 row blocks, one wave). Each block adds its threads' sums in f64, in a
// fixed order, through shared memory and writes one partial row pair,
// rounded once, to its row of a (2 x SMs, 2, C) f32 workspace; a second
// small launch adds the partials
// in f64 in a fixed order and rounds once. No floating-point atomics, so the
// sums are the same bits on every run on the same card, and their error
// against f64 is that of the f32 runs in registers: a running sum takes one
// rounding per 8 rows, not per row. Added one row at a time, a long run
// drifts the same way on every channel: at the fine-tune's 2,765,952 x 64
// bf16 map (328 rows a thread) the sum of squares was 5.7e-7 of itself off
// on average, in blocks of 8 1.5e-8 (an f32 emulation of the kernel's order
// over 16 channels); on the card the row-at-a-time variance was 6.4e-7 of
// E[x^2] off, the plain torch route's 2.7e-7.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): ~69 us a
// render in a CUDA graph, about 1.85x the bound; a contiguous torch.sum over
// the same bytes takes ~74 us. Offsets are 64-bit. The kernels run on the
// caller's stream and allocate nothing: the wrapper allocates the workspace
// and output. The entry returns cudaGetLastError() so that a refused
// launch is reported by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "_bn_sums.cuh"

namespace {

using bn_sums::kBF16;
using bn_sums::kCombineCols;
using bn_sums::kThreads;
using bn_sums::Plan;

constexpr int kRowThreads = 32;  // most threads that span one row's channels in a block
constexpr int kUnroll = 8;       // loads in flight per thread
constexpr int kMinLoads = 8;     // fewest loads per thread before another row block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// What one thread loads at once: 16 bytes (VEC channels), or one element.
template <typename T, int VEC>
struct Raw {
  using type = typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type;
};

// A 16-byte load asks L2 for the 256 bytes around it (the rows a block reads
// next lie there), and leaves L1 alone: x is read once.
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load(const T* __restrict__ p) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 r;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(p));
    return r;
  } else {
    return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const typename Raw<T, VEC>::type& raw,
                                           float (&s)[VEC], float (&q)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float v = to_f32(e[k]);
    s[k] += v;
    q[k] = fmaf(v, v, q[k]);
  }
}

// Block (bx, by) sums rows [bx * chunk, (bx + 1) * chunk) of channels
// [by * tpr * VEC, (by + 1) * tpr * VEC) into ws[bx, 0 or 1, channel].
// Thread t takes vector column t % tpr and rows t / tpr, + rpi, + 2 rpi ...
// in f32 registers, each pass's 8 rows summed before they join the running
// sums; the block adds its threads' sums in f64, in row order, and rounds
// each channel's once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_partial(const T* __restrict__ x, float* __restrict__ ws, int64_t rows, int64_t C,
                   int tpr, int rpi, int64_t chunk) {
  __shared__ float sh[2][kThreads * VEC];
  const int tid = threadIdx.x;
  const int lc = tid % tpr;
  const int lr = tid / tpr;
  const int width = tpr * VEC;  // channels of this block
  const int64_t c0 = (int64_t)blockIdx.y * width;
  const int64_t c = c0 + (int64_t)lc * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  if (lr < rpi && c < C) {
    const int64_t r_begin = (int64_t)blockIdx.x * chunk;
    const int64_t r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
    const int64_t step = (int64_t)rpi * C;
    int64_t r = r_begin + lr;
    const T* p = x + r * C + c;
    for (; r + (kUnroll - 1) * rpi < r_end; r += kUnroll * rpi, p += kUnroll * step) {
      typename Raw<T, VEC>::type raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = load<T, VEC>(p + u * step);
      float ps[VEC], pq[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) ps[k] = pq[k] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<T, VEC>(raw[u], ps, pq);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] += ps[k];
        q[k] += pq[k];
      }
    }
    for (; r < r_end; r += rpi, p += step) accumulate<T, VEC>(load<T, VEC>(p), s, q);
  }
  if (lr < rpi) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh[0][lr * width + lc * VEC + k] = s[k];
      sh[1][lr * width + lc * VEC + k] = q[k];
    }
  }
  __syncthreads();
  if (tid < width && c0 + tid < C) {  // width <= kThreads: one channel a thread
    double a = 0.0, b = 0.0;
    for (int l = 0; l < rpi; ++l) {
      a += sh[0][l * width + tid];
      b += sh[1][l * width + tid];
    }
    float* w = ws + (int64_t)blockIdx.x * 2 * C + c0 + tid;
    w[0] = (float)a;
    w[C] = (float)b;
  }
}

// The partials' combine (_bn_sums.cuh) under this kernel's name.
__global__ void __launch_bounds__(kThreads)
bn_moments_combine(const float* __restrict__ ws, float* __restrict__ out, int64_t blocks,
                   int64_t C) {
  bn_sums::combine(ws, out, blocks, C);
}

template <typename T>
cudaError_t launch(const T* x, float* ws, float* out, int64_t rows, int64_t C, const Plan& p,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)p.row_blocks, (unsigned)p.col_blocks);
  if (p.vec == 1) {
    bn_moments_partial<T, 1><<<grid, kThreads, 0, stream>>>(x, ws, rows, C, p.tpr, p.rpi, p.chunk);
  } else {
    bn_moments_partial<T, (int)(16 / sizeof(T))><<<grid, kThreads, 0, stream>>>(
        x, ws, rows, C, p.tpr, p.rpi, p.chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (C + kCombineCols - 1) / kCombineCols;
  bn_moments_combine<<<(unsigned)blocks, kThreads, 0, stream>>>(ws, out, p.row_blocks, C);
  return cudaGetLastError();
}

}  // namespace

// x: device pointer to rows*C elements of `dtype` (0 = f32, 1 = bf16),
// row-major (a channels_last activation). ws: (max_blocks, 2, C) device f32
// scratch. out: (2, C) device f32. stream: a cudaStream_t. Returns a
// cudaError_t; 0 when both kernels were launched.
extern "C" int jckx_bn_moments(const void* x, void* ws, void* out, int64_t rows, int64_t C,
                               int dtype, int64_t max_blocks, void* stream) {
  Plan p;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // max_blocks: the most blocks of the partial kernel's grid, and the rows of
  // the workspace (the wrapper gives 2 an SM: one wave)
  cudaError_t err = bn_sums::make_plan(rows, C, C, dtype, aligned, max_blocks, kRowThreads,
                                       kMinLoads, &p);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16) {
    return launch(static_cast<const __nv_bfloat16*>(x), w, o, rows, C, p, st);
  }
  return launch(static_cast<const float*>(x), w, o, rows, C, p, st);
}
