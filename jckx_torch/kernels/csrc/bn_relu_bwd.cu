// The backward of batch-statistic BatchNorm + ReLU (the fine-tune's
// `bn_relu_train`), written by hand for Hopper (sm_90a): two passes over the
// saved activation x and the incoming gradient dout.
//
// Replaces no Pallas kernel: the JAX package's VJP (`_bn_relu_bwd`,
// jckx/ops/norm.py:134-156) is plain jnp, which XLA fuses into two sweeps.
// The port's plain version of the same function (`bn_relu_bwd_sums_plain`,
// `bn_relu_bwd_dx_plain`, jckx_torch/kernels/fused_bn_act.py) is about fifteen
// full-size f32 passes on the card: copies of x and dout in f32, the mask,
// the `where`, two column reductions, and dx one op at a time. These kernels
// are the two sweeps, with the all-reduce of sync-BN between them.
//
// What they compute, on a channels_last activation seen as (rows, C) and a
// gradient whose rows are `gs` elements apart (gs > C for a channel slice
// of a concatenated gradient, as torch.cat's backward hands it on):
//     dz[r, c]  = fmaf(f32(x[r, c]), a[c], sh[c]) > 0 ? f32(dout[r, c]) : 0
// (the mask as the forward kernel rounds it, once, so it is exactly out > 0)
//     bn_relu_bwd_sums:  out[0, c] = sum_r dz[r, c]
//                        out[1, c] = sum_r dz[r, c] * f32(x[r, c])
//     bn_relu_bwd_dx:    dx[r, c]  = a[c] * (dz[r, c] - g1[c]
//                                            - (f32(x[r, c]) - mean[c]) * k[c])
// with g1 = dbeta / n and k = inv * dgamma / n, the per-channel f32
// constants the wrapper derives from the (all-reduced) sums; dx in x's
// dtype, channels_last.
//
// What bounds them: HBM bandwidth, a few flops an element. The floor reads x
// and dout once and writes dx once: 6 bytes an element in bf16, 6,887.4 MB a
// bs128 299x299 InceptionV3 step (1,147,838,464 elements over 94 maps), 2.06
// ms at 3.35 TB/s (H100 SXM data sheet). Two passes read x and dout twice:
// 10 bytes an element, 3.43 ms; on the maps whose x + dout fit in the 50 MB
// L2 the second read comes from L2. The largest map, 2,765,952 x 64 bf16,
// moves 1,062 MB at the floor: 0.317 ms.
//
// What the design does about it: one read of x and of dout per pass with
// 16-byte loads (8 bf16 or 4 f32 channels a thread) where C, the row stride
// and the pointers allow (every InceptionV3 map and every channel slice of
// its concatenations), else one element a thread. A block holds tpr threads
// across a row's vectors (up to 256: 8 for C 64 in bf16, 56 for C 448) and
// 256 / tpr rows of them; each thread keeps its channels' constants in
// registers, and walks a contiguous range of rows with 4 rows of x and dout
// in flight. The grid follows the shape as the moments kernels' does
// (the plan that _bn_sums.cuh shares with bn_moments.cu): a C wider than 256 vectors is split over column blocks,
// the rows over as many row blocks as give each thread at least 8 rows, at
// most 2 blocks an SM in all (the rows of the sums' workspace: one wave).
// The sums keep each thread's terms in f32 registers; each block adds its
// threads' in f64, in a fixed order, through shared memory and writes one
// partial row pair, rounded once, to its row of a (2 x SMs, 2, C) f32
// workspace; a small combine launch adds the partials in f64 in a fixed
// order and rounds once. No floating-point atomics, so the sums are the
// same bits on every run on the same card. Offsets are 64-bit. The kernels
// run on the caller's stream and allocate nothing: the wrapper allocates
// the workspace and the outputs. Each entry returns cudaGetLastError() so
// that a refused launch is reported by the wrapper.

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

constexpr int kUnroll = 4;       // rows of x and dout in flight per thread
constexpr int kMinRows = 8;      // fewest rows per thread before another row block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
// round to nearest even, as torch's cast does
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

// What one thread loads or stores at once: 16 bytes (VEC channels), or one element.
template <typename T, int VEC>
struct Raw {
  using type = typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type;
};

// Read-only loads that leave L1 alone: each byte is read once a pass.
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load(const T* __restrict__ p) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 r;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(p));
    return r;
  } else {
    return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
  }
}

// Where a thread works: vector column lc of the block's tpr, row lr of its
// rpi; the block's channels start at c0, the thread's at c; its rows are
// [r_begin + lr, r_end) in steps of rpi.
struct Slot {
  int lc, lr, width;
  int64_t c0, c, r_begin, r_end;
};

template <int VEC>
__device__ __forceinline__ Slot slot(int64_t rows, int tpr, int64_t chunk) {
  Slot s;
  s.lc = threadIdx.x % tpr;
  s.lr = threadIdx.x / tpr;
  s.width = tpr * VEC;
  s.c0 = (int64_t)blockIdx.y * s.width;
  s.c = s.c0 + (int64_t)s.lc * VEC;
  s.r_begin = (int64_t)blockIdx.x * chunk;
  s.r_end = s.r_begin + chunk < rows ? s.r_begin + chunk : rows;
  return s;
}

template <int VEC>
__device__ __forceinline__ void per_channel(const float* __restrict__ v, int64_t c,
                                            float (&out)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = __ldg(v + c + k);
}

// dz of one element: dout where the forward's pre-activation, rounded once,
// is positive.
template <typename T>
__device__ __forceinline__ float relu_grad(float xv, T g, float a, float sh) {
  return fmaf(xv, a, sh) > 0.f ? to_f32(g) : 0.f;
}

// Block (bx, by) sums rows [bx * chunk, (bx + 1) * chunk) of channels
// [by * tpr * VEC, (by + 1) * tpr * VEC) into ws[bx, 0 or 1, channel]: each
// thread in f32 registers, then the block's threads in f64, in row order,
// each channel's rounded once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_sums(const T* __restrict__ x, const T* __restrict__ g, int64_t gs,
                 const float* __restrict__ a, const float* __restrict__ sh,
                 float* __restrict__ ws, int64_t rows, int64_t C, int tpr, int rpi,
                 int64_t chunk) {
  using R = typename Raw<T, VEC>::type;
  __shared__ float red[2][kThreads * VEC];
  const Slot t = slot<VEC>(rows, tpr, chunk);
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  if (t.c < C) {
    float av[VEC], bv[VEC];
    per_channel<VEC>(a, t.c, av);
    per_channel<VEC>(sh, t.c, bv);
    auto add = [&](const R& rx, const R& rg) {
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xv = to_f32(ex[k]);
        const float dz = relu_grad(xv, eg[k], av[k], bv[k]);
        s[k] += dz;
        q[k] = fmaf(dz, xv, q[k]);
      }
    };
    const int64_t sx = (int64_t)rpi * C, sg = (int64_t)rpi * gs;
    int64_t r = t.r_begin + t.lr;
    const T* px = x + r * C + t.c;
    const T* pg = g + r * gs + t.c;
    for (; r + (kUnroll - 1) * rpi < t.r_end; r += kUnroll * rpi, px += kUnroll * sx,
                                               pg += kUnroll * sg) {
      R rx[kUnroll], rg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rx[u] = load<T, VEC>(px + u * sx);
        rg[u] = load<T, VEC>(pg + u * sg);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(rx[u], rg[u]);
    }
    for (; r < t.r_end; r += rpi, px += sx, pg += sg) add(load<T, VEC>(px), load<T, VEC>(pg));
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    red[0][t.lr * t.width + t.lc * VEC + k] = s[k];
    red[1][t.lr * t.width + t.lc * VEC + k] = q[k];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t.width; j += blockDim.x) {
    if (t.c0 + j >= C) break;
    double u = 0.0, v = 0.0;
    for (int l = 0; l < rpi; ++l) {
      u += red[0][l * t.width + j];
      v += red[1][l * t.width + j];
    }
    float* w = ws + (int64_t)blockIdx.x * 2 * C + t.c0 + j;
    w[0] = (float)u;
    w[C] = (float)v;
  }
}

// The partials' combine (_bn_sums.cuh) under this kernel family's name.
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_combine(const float* __restrict__ ws, float* __restrict__ out, int64_t blocks,
                    int64_t C) {
  bn_sums::combine(ws, out, blocks, C);
}

// Block (bx, by) writes dx for the rows and channels that the sums' block
// (bx, by) reads, in x's dtype, row-major with C elements a row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_dx(const T* __restrict__ x, const T* __restrict__ g, int64_t gs,
               const float* __restrict__ a, const float* __restrict__ sh,
               const float* __restrict__ mean, const float* __restrict__ g1,
               const float* __restrict__ kk, T* __restrict__ dx, int64_t rows, int64_t C,
               int tpr, int rpi, int64_t chunk) {
  using R = typename Raw<T, VEC>::type;
  const Slot t = slot<VEC>(rows, tpr, chunk);
  if (t.c >= C) return;
  float av[VEC], bv[VEC], mv[VEC], g1v[VEC], kv[VEC];
  per_channel<VEC>(a, t.c, av);
  per_channel<VEC>(sh, t.c, bv);
  per_channel<VEC>(mean, t.c, mv);
  per_channel<VEC>(g1, t.c, g1v);
  per_channel<VEC>(kk, t.c, kv);
  auto write = [&](const R& rx, const R& rg, T* p) {
    const T* ex = reinterpret_cast<const T*>(&rx);
    const T* eg = reinterpret_cast<const T*>(&rg);
    R out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xv = to_f32(ex[k]);
      const float dz = relu_grad(xv, eg[k], av[k], bv[k]);
      from_f32(av[k] * (dz - g1v[k] - (xv - mv[k]) * kv[k]), o + k);
    }
    *reinterpret_cast<R*>(p) = out;
  };
  const int64_t sx = (int64_t)rpi * C, sg = (int64_t)rpi * gs;
  int64_t r = t.r_begin + t.lr;
  const int64_t off = r * C + t.c;
  const T* px = x + off;
  const T* pg = g + r * gs + t.c;
  T* pd = dx + off;
  for (; r + (kUnroll - 1) * rpi < t.r_end; r += kUnroll * rpi, px += kUnroll * sx,
                                             pg += kUnroll * sg, pd += kUnroll * sx) {
    R rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rx[u] = load<T, VEC>(px + u * sx);
      rg[u] = load<T, VEC>(pg + u * sg);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) write(rx[u], rg[u], pd + u * sx);
  }
  for (; r < t.r_end; r += rpi, px += sx, pg += sg, pd += sx) {
    write(load<T, VEC>(px), load<T, VEC>(pg), pd);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_sums(const T* x, const T* g, int64_t gs, const float* a, const float* sh,
                        float* ws, float* out, int64_t rows, int64_t C, const Plan& p,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)p.row_blocks, (unsigned)p.col_blocks);
  const int threads = p.tpr * p.rpi;
  if (p.vec == 1) {
    bn_relu_bwd_sums<T, 1><<<grid, threads, 0, stream>>>(x, g, gs, a, sh, ws, rows, C, p.tpr,
                                                         p.rpi, p.chunk);
  } else {
    bn_relu_bwd_sums<T, (int)(16 / sizeof(T))><<<grid, threads, 0, stream>>>(
        x, g, gs, a, sh, ws, rows, C, p.tpr, p.rpi, p.chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (C + kCombineCols - 1) / kCombineCols;
  bn_relu_bwd_combine<<<(unsigned)blocks, kThreads, 0, stream>>>(ws, out, p.row_blocks, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const T* x, const T* g, int64_t gs, const float* a, const float* sh,
                      const float* mean, const float* g1, const float* k, T* dx, int64_t rows,
                      int64_t C, const Plan& p, cudaStream_t stream) {
  const dim3 grid((unsigned)p.row_blocks, (unsigned)p.col_blocks);
  const int threads = p.tpr * p.rpi;
  if (p.vec == 1) {
    bn_relu_bwd_dx<T, 1><<<grid, threads, 0, stream>>>(x, g, gs, a, sh, mean, g1, k, dx, rows,
                                                       C, p.tpr, p.rpi, p.chunk);
  } else {
    bn_relu_bwd_dx<T, (int)(16 / sizeof(T))><<<grid, threads, 0, stream>>>(
        x, g, gs, a, sh, mean, g1, k, dx, rows, C, p.tpr, p.rpi, p.chunk);
  }
  return cudaGetLastError();
}

}  // namespace

// x: device pointer to rows*C elements of `dtype` (0 = f32, 1 = bf16),
// row-major (a channels_last activation). g: dout, the same dtype, row r at
// g + r*gs (gs >= C). a, sh: C device f32 values (the forward's affine).
// ws: (max_blocks, 2, C) device f32 scratch. out: (2, C) device f32.
// stream: a cudaStream_t. Returns a cudaError_t; 0 when both kernels were
// launched.
extern "C" int jckx_bn_relu_bwd_sums(const void* x, const void* g, int64_t gs, const void* a,
                                     const void* sh, void* ws, void* out, int64_t rows,
                                     int64_t C, int dtype, int64_t max_blocks, void* stream) {
  Plan p;
  cudaError_t err = bn_sums::make_plan(rows, C, gs, dtype, aligned16(x) && aligned16(g),
                                       max_blocks, kThreads, kMinRows, &p);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(sh);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16) {
    return launch_sums(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
                       gs, af, sf, w, o, rows, C, p, st);
  }
  return launch_sums(static_cast<const float*>(x), static_cast<const float*>(g), gs, af, sf, w,
                     o, rows, C, p, st);
}

// x, g, gs, dtype, max_blocks, stream: as above. a, sh, mean, g1, k: C device
// f32 values each. dx: rows*C elements of `dtype`, row-major. Returns a
// cudaError_t; 0 when the kernel was launched.
extern "C" int jckx_bn_relu_bwd_dx(const void* x, const void* g, int64_t gs, const void* a,
                                   const void* sh, const void* mean, const void* g1,
                                   const void* k, void* dx, int64_t rows, int64_t C, int dtype,
                                   int64_t max_blocks, void* stream) {
  Plan p;
  cudaError_t err = bn_sums::make_plan(rows, C, gs, dtype,
                                       aligned16(x) && aligned16(g) && aligned16(dx), max_blocks,
                                       kThreads, kMinRows, &p);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(a), static_cast<const float*>(sh),
                       static_cast<const float*>(mean), static_cast<const float*>(g1),
                       static_cast<const float*>(k)};
  if (dtype == kBF16) {
    return launch_dx(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
                     gs, f[0], f[1], f[2], f[3], f[4], static_cast<__nv_bfloat16*>(dx), rows, C,
                     p, st);
  }
  return launch_dx(static_cast<const float*>(x), static_cast<const float*>(g), gs, f[0], f[1],
                   f[2], f[3], f[4], static_cast<float*>(dx), rows, C, p, st);
}
