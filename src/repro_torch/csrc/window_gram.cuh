// window_gram.cuh: the (w, w) Gram matrix of one window of w tokens, on the
// block that owns the window.  Shared by knn_density.cu and token_merge.cu,
// whose TPU kernels both start from the same w x D . D x w MXU product.
//
// The window's rows are streamed through shared memory in column chunks,
// converted to f32 on the way in (staging a whole bf16 window at D=1152 in
// f32 would take 73.7 KB, over the 48 KB of static shared memory).  Every
// Gram entry is owned by one thread, which sums its products in column
// order with fmaf; entry (i, j) and entry (j, i) therefore come out
// bitwise equal, and the diagonal G[i][i] is the squared norm of row i.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace window_gram {

constexpr int kThreads = 256;                   // threads of a window's block
constexpr int kMaxW = 32;                       // largest window a block takes
constexpr int kChunk = 128;                     // feature columns per pass
constexpr int kPer = kMaxW * kMaxW / kThreads;  // Gram entries per thread

typedef float Tile[kChunk + 1];  // a padded row: column c of rows j..j+31
                                 // falls in 32 different banks
typedef float GramRow[kMaxW + 1];

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// tile[r][c] = h[r][c0 + c] in f32 for the window's w rows, c < n.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ h, int w, int D,
                                      int c0, int n, Tile* tile) {
  for (int e = threadIdx.x; e < w * kChunk; e += blockDim.x) {
    const int r = e / kChunk, c = e % kChunk;
    if (c < n) tile[r][c] = to_f32(h[(long long)r * D + c0 + c]);
  }
}

// g[i][j] = sum_c h[i][c] * h[j][c] for the window h (w, D), w <= kMaxW.
// Ends with a barrier: the caller may reuse the tile and read all of g.
template <typename T>
__device__ void gram(const T* __restrict__ h, int w, int D, Tile* tile,
                     GramRow* g) {
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int n = min(kChunk, D - c0);
    __syncthreads();  // the previous pass is done with the tile
    stage(h, w, D, c0, n, tile);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = threadIdx.x + r * kThreads;
      if (e < w * w) {
        const float* hi = tile[e / w];
        const float* hj = tile[e % w];
        float a = acc[r];
        for (int c = 0; c < n; ++c) a = fmaf(hi[c], hj[c], a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e < w * w) g[e / w][e % w] = acc[r];
  }
  __syncthreads();
}

// The reference's Gram-form squared distance (sq_i + sq_j) - 2 G_ij, in
// its operation order and without contraction into an FMA.
__device__ __forceinline__ float gram_dist(GramRow* g, int i, int j) {
  return __fsub_rn(__fadd_rn(g[i][i], g[j][j]), __fmul_rn(2.f, g[i][j]));
}

}  // namespace window_gram
