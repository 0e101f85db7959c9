// token_merge: the two token-merge kernels of the CTM stage (Eqs. 12-13,
// Alg. 2), on Hopper.
//
// Replaces the TPU kernels `merge_assign` and `unmerge_scatter` in
// src/repro/kernels/token_merge.py (Pallas, pl.pallas_call at :89 and
// :122).  Their plain twins are kernels/ref.py:merge_assign /
// unmerge_scatter in the reference and cuda_kernels/ref.py here.
//
// merge_assign, per window of w tokens h (w, D) with scores s (w,):
//   centers  = the M highest scores in lax.top_k order (descending, ties to
//              the lower index), written in selection order       (int32)
//   d2[i][m] = (hsq_i + hsq_{c_m}) - 2 <h_i, h_{c_m}>   (f32, not clamped)
//   assign_i = first argmin_m d2[i][m]                              (int32)
//   merged_m = sum_{i: assign_i = m} s_i h_i / max(sum s_i, 1e-9)  (h.dtype)
//
// unmerge_scatter: out[win][i] = merged[win][assign[win][i]], a gather
// (the TPU kernel writes it as a one-hot matmul for the MXU, so an id
// outside [0, M) matches no cluster and gives a zero row; so does this one).
//
// Design.  merge_assign: one block of 256 threads per window.  The centers
// are tokens of the window, so every distance comes from the window's own
// (w, w) Gram matrix (window_gram.cuh): d2[i][m] = dist(i, c_m).  One thread
// picks the centers (M rounds of masked argmax over w scores), w threads
// assign, M threads sum the denominators, and a second pass over D writes
// the weighted means from shared-memory tiles.  unmerge_scatter: one warp
// per output token copies its cluster's row with 16-byte vector loads
// where the row width allows; the result is bitwise.
//
// Bound at W=128 windows, w=16, M=8, D=1152, bf16 (DiT-XL/2, 4 slots):
// merge_assign reads 4.72 MB of h and 8 KB of s and writes 2.36 MB merged
// plus 12 KB of ids, ~2.1 us at 3.35 TB/s (its 75.5 MFLOP Gram and 37.7
// MFLOP of weighted sums take ~1.7 us at 67 TFLOP/s f32); unmerge_scatter
// reads 2.36 MB and 8 KB and writes 4.72 MB, ~2.1 us.  merge_assign makes
// two dependent passes of 9 load stages over each window and is
// latency-bound; unmerge_scatter is one pass of independent 16-byte copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_gram.cuh"

namespace {

using namespace window_gram;

constexpr int kUnmergeThreads = 256;  // 8 warps: 8 output tokens per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_assign_kernel(const T* __restrict__ h, const float* __restrict__ s,
                    T* __restrict__ merged, int32_t* __restrict__ assign,
                    int32_t* __restrict__ centers, int w, int M, int D) {
  __shared__ float tile[kMaxW][kChunk + 1];
  __shared__ float g[kMaxW][kMaxW + 1];
  __shared__ float ss[kMaxW];
  __shared__ int sc[kMaxW];
  __shared__ int sa[kMaxW];
  __shared__ float sden[kMaxW];
  const long long win = blockIdx.x;
  const T* hw = h + win * w * D;
  if (threadIdx.x < w) ss[threadIdx.x] = s[win * w + threadIdx.x];
  gram(hw, w, D, tile, g);  // its barriers also publish ss

  // ---- top-M centers: M rounds of argmax over the scores not yet taken;
  // strict > keeps the lowest index among equal scores (lax.top_k order)
  if (threadIdx.x == 0) {
    uint32_t taken = 0;
    for (int r = 0; r < M; ++r) {
      int best = -1;
      float bv = 0.f;
      for (int j = 0; j < w; ++j) {
        if ((taken >> j) & 1u) continue;
        if (best < 0 || ss[j] > bv) {
          best = j;
          bv = ss[j];
        }
      }
      taken |= 1u << best;
      sc[r] = best;
      centers[win * M + r] = best;
    }
  }
  __syncthreads();

  // ---- nearest center, first occurrence of the minimum (jnp.argmin)
  if (threadIdx.x < w) {
    const int i = threadIdx.x;
    int best = 0;
    float bv = gram_dist(g, i, sc[0]);
    for (int m = 1; m < M; ++m) {
      const float d2 = gram_dist(g, i, sc[m]);
      if (d2 < bv) {
        best = m;
        bv = d2;
      }
    }
    sa[i] = best;
    assign[win * w + i] = best;
  }
  __syncthreads();

  // ---- importance-weighted cluster means (Eq. 13)
  if (threadIdx.x < M) {
    float den = 0.f;
    for (int i = 0; i < w; ++i)
      if (sa[i] == (int)threadIdx.x) den = __fadd_rn(den, ss[i]);
    sden[threadIdx.x] = fmaxf(den, 1e-9f);
  }
  T* mw = merged + win * M * D;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int n = min(kChunk, D - c0);
    __syncthreads();  // sden written; the previous pass is done with the tile
    stage(hw, w, D, c0, n, tile);
    __syncthreads();
    for (int e = threadIdx.x; e < M * n; e += blockDim.x) {
      const int m = e / n, c = e % n;
      float num = 0.f;
      for (int i = 0; i < w; ++i)
        if (sa[i] == m) num = fmaf(ss[i], tile[i][c], num);
      mw[(long long)m * D + c0 + c] = from_f32<T>(__fdiv_rn(num, sden[m]));
    }
  }
}

// V is the copy unit: uint4 (16 bytes) when a row's bytes allow it.
template <typename V>
__global__ void __launch_bounds__(kUnmergeThreads)
unmerge_scatter_kernel(const V* __restrict__ merged,
                       const int32_t* __restrict__ assign, V* __restrict__ out,
                       long long n_tok, int w, int M, int row_vecs) {
  const long long tok = (long long)blockIdx.x * (kUnmergeThreads / 32) +
                        threadIdx.x / 32;
  if (tok >= n_tok) return;
  const int lane = threadIdx.x % 32;
  const int a = assign[tok];
  V* dst = out + tok * row_vecs;
  if (a < 0 || a >= M) {  // no cluster: a zero row, as the TPU one-hot gives
    const V zero{};
    for (int v = lane; v < row_vecs; v += 32) dst[v] = zero;
    return;
  }
  const V* src = merged + ((tok / w) * M + a) * row_vecs;
  for (int v = lane; v < row_vecs; v += 32) dst[v] = src[v];
}

template <typename T>
int launch_merge(const void* h, const void* s, void* merged, void* assign,
                 void* centers, int nw, int w, int M, int D,
                 cudaStream_t stream) {
  merge_assign_kernel<T><<<nw, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<T*>(merged), static_cast<int32_t*>(assign),
      static_cast<int32_t*>(centers), w, M, D);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_unmerge(const void* merged, const void* assign, void* out,
                   long long n_tok, int w, int M, long long row_bytes,
                   cudaStream_t stream) {
  const long long blocks =
      (n_tok + kUnmergeThreads / 32 - 1) / (kUnmergeThreads / 32);
  unmerge_scatter_kernel<V><<<(unsigned)blocks, kUnmergeThreads, 0, stream>>>(
      static_cast<const V*>(merged), static_cast<const int32_t*>(assign),
      static_cast<V*>(out), n_tok, w, M, (int)(row_bytes / sizeof(V)));
  return (int)cudaGetLastError();
}

}  // namespace

// h: (nw, w, D), dtype_code 0 = float32, 1 = bfloat16; s: (nw, w) float32;
// merged: (nw, M, D) in h's dtype; assign: (nw, w) and centers: (nw, M)
// int32.  Needs 1 <= w <= 32 and 1 <= M <= w.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int merge_assign_launch(const void* h, const void* s,
                                   void* merged, void* assign, void* centers,
                                   int nw, int w, int M, int D,
                                   int dtype_code, void* stream) {
  if (nw < 1 || w < 1 || w > window_gram::kMaxW || M < 1 || M > w ||
      D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_merge<__nv_bfloat16>(h, s, merged, assign, centers, nw, w,
                                       M, D, st);
  if (dtype_code == 0)
    return launch_merge<float>(h, s, merged, assign, centers, nw, w, M, D,
                               st);
  return (int)cudaErrorInvalidValue;
}

// merged: (nw, M, D) of elem_bytes-wide elements; assign: (nw, w) int32;
// out: (nw, w, D).  Returns cudaGetLastError() after the launch.
extern "C" int unmerge_scatter_launch(const void* merged, const void* assign,
                                      void* out, int nw, int w, int M, int D,
                                      int elem_bytes, void* stream) {
  if (nw < 1 || w < 1 || M < 1 || D < 1 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tok = (long long)nw * w;
  const long long row_bytes = (long long)D * elem_bytes;
  const uintptr_t base = (uintptr_t)merged | (uintptr_t)out;
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return launch_unmerge<uint4>(merged, assign, out, n_tok, w, M, row_bytes,
                                 st);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return launch_unmerge<uint32_t>(merged, assign, out, n_tok, w, M,
                                    row_bytes, st);
  return launch_unmerge<uint16_t>(merged, assign, out, n_tok, w, M,
                                  row_bytes, st);
}
