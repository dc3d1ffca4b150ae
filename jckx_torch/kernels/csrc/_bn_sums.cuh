// What the BN statistics' kernels (bn_moments.cu) and the BN + ReLU
// backward's sums (bn_relu_bwd.cu) share: the grid that follows the shape,
// and the combine that adds the blocks' partial sums.
//
// Both sum two per-channel quantities over the rows of a channels_last
// activation seen as (rows, C): blocks of kThreads threads, tpr of them
// across a row's vectors and rpi = kThreads / tpr rows of them, each block
// a contiguous range of rows, at most max_blocks blocks in all (the rows of
// a (max_blocks, 2, C) f32 workspace of partial sums). The combine adds a
// channel's partials in f64 in a fixed order and rounds once: no
// floating-point atomics, so the sums are the same bits on every run on the
// same card. Each source launches the combine under its own kernel's name
// (the trace readers find a kernel family by its name).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bn_sums {

constexpr int kThreads = 256;
constexpr int kCombineCols = 8;  // the combine: 8 channels x 32 lanes a block
constexpr int kCombineLanes = kThreads / kCombineCols;
constexpr int kCombineUnroll = 4;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Plan {
  int vec;              // channels a thread loads at once: 16 bytes' worth, or 1
  int tpr;              // threads across a row
  int rpi;              // rows a block takes at once; the block is tpr * rpi threads
  int64_t col_blocks;
  int64_t row_blocks;
  int64_t chunk;        // rows a row block takes
};

// The grid for rows x C elements of `dtype` whose rows are gs elements apart
// (gs >= C). A thread loads 16 bytes where `aligned` (every pointer on
// 16 bytes), C and gs allow, else one element. row_threads: the most threads
// across a row; a C wider than that many vectors is split over column blocks.
// The rows go to as many row blocks as give each thread at least min_passes
// rows, at most max_blocks blocks in all.
inline cudaError_t make_plan(int64_t rows, int64_t C, int64_t gs, int dtype, bool aligned,
                             int64_t max_blocks, int row_threads, int min_passes, Plan* p) {
  if (rows <= 0 || C <= 0 || gs < C || max_blocks <= 0 || (dtype != kF32 && dtype != kBF16)) {
    return cudaErrorInvalidValue;
  }
  const int vec = dtype == kBF16 ? 8 : 4;
  p->vec = aligned && C % vec == 0 && gs % vec == 0 ? vec : 1;
  const int64_t cv = C / p->vec;
  p->tpr = (int)(cv < row_threads ? cv : row_threads);
  p->rpi = kThreads / p->tpr;
  p->col_blocks = (cv + p->tpr - 1) / p->tpr;
  if (p->col_blocks > 65535) return cudaErrorInvalidValue;
  const int64_t passes = (rows + p->rpi - 1) / p->rpi;  // block-wide rows over all rows
  int64_t rb = (passes + min_passes - 1) / min_passes;
  int64_t cap = max_blocks / p->col_blocks;
  if (cap < 1) cap = 1;
  if (rb > cap) rb = cap;
  p->chunk = (passes + rb - 1) / rb * p->rpi;
  p->row_blocks = (rows + p->chunk - 1) / p->chunk;
  return cudaSuccess;
}

// The body of a combine launch of (C + 7) / 8 blocks of kThreads:
// out[k, c] = sum over b of ws[b, k, c] in f64, rounded once, b in a fixed
// order: lane l of a block adds b = l, l + 32, ... (4 loads in flight); then
// one thread a channel and sum adds the 32 lanes in order.
__device__ __forceinline__ void combine(const float* __restrict__ ws, float* __restrict__ out,
                                        int64_t blocks, int64_t C) {
  __shared__ double sh[2][kCombineLanes][kCombineCols];
  const int col = threadIdx.x % kCombineCols;
  const int lane = threadIdx.x / kCombineCols;
  const int64_t c = (int64_t)blockIdx.x * kCombineCols + col;
  double a = 0.0, b = 0.0;
  if (c < C) {
    const float* w = ws + c;
    int64_t i = lane;
    for (; i + (kCombineUnroll - 1) * kCombineLanes < blocks; i += kCombineUnroll * kCombineLanes) {
      float va[kCombineUnroll], vb[kCombineUnroll];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        va[u] = w[(i + u * kCombineLanes) * 2 * C];
        vb[u] = w[(i + u * kCombineLanes) * 2 * C + C];
      }
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        a += va[u];
        b += vb[u];
      }
    }
    for (; i < blocks; i += kCombineLanes) {
      a += w[i * 2 * C];
      b += w[i * 2 * C + C];
    }
  }
  sh[0][lane][col] = a;
  sh[1][lane][col] = b;
  __syncthreads();
  if (threadIdx.x < 2 * kCombineCols) {
    const int k = threadIdx.x / kCombineCols;
    const int j = threadIdx.x % kCombineCols;
    const int64_t cj = (int64_t)blockIdx.x * kCombineCols + j;
    double acc = 0.0;
    for (int l = 0; l < kCombineLanes; ++l) acc += sh[k][l][j];
    if (cj < C) out[k * C + cj] = (float)acc;
  }
}

}  // namespace bn_sums
