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
// Design.  merge_assign: one block per window.  The centers are tokens of
// the window, so every distance comes from the window's own (w, w) Gram
// matrix: d2[i][m] = dist(i, c_m).  Two routes
// (cuda_kernels/route.py:window_route):
//
// - "mma", bf16 h with D % 8 == 0, 16-byte aligned bases and a padded window
//   that fits in shared memory (the served windows), 512 threads: the window
//   is bulk-copied into shared memory once and stays there
//   (window_mma.cuh); the Gram is taken on the tensor cores.  Thread j finds
//   its center rank in parallel (the scores that beat s_j: greater, or
//   equal at a lower index: lax.top_k's order) while the copy lands; w
//   lanes of warp 0 assign, one ballot per cluster gives its members as a
//   bit mask, M lanes sum the denominators, and the weighted means read the
//   resident window over those masks, 8 columns per thread, stored as
//   16-byte vectors.
// - "simt", everything else (f32 h, held to 1e-4; ragged D; unaligned
//   bases), 256 threads: the Gram from window_gram.cuh (D streamed through
//   shared memory in f32 chunks, one entry per thread), one thread picks the
//   centers (M rounds of masked argmax over w scores), and a second pass
//   over D re-reads the window for the weighted means.
//
// The two routes pick the same centers, assign by the same first-occurrence
// argmin over gram_dist, and share the weighted means' arithmetic
// (__fadd_rn over tokens in order for the denominators, fmaf(s_i, h_ic, num)
// in token order, __fdiv_rn): given the same (h, s), the merged tokens are
// bitwise equal whenever the assignments are.  Only the Gram's summation
// order differs.  unmerge_scatter: one warp per output token copies its
// cluster's row with 16-byte vector loads where the row width allows; the
// result is bitwise.
//
// Bound at W=128 windows, w=16, M=8, D=1152, bf16 (DiT-XL/2, 4 slots):
// merge_assign reads 4.72 MB of h and 8 KB of s and writes 2.36 MB merged
// plus 12 KB of ids, ~2.1 us at 3.35 TB/s (its Gram and distances on the
// bf16 tensor cores, 37.7 MFLOP of weighted sums at 67 TFLOP/s f32, well
// under); unmerge_scatter reads 2.36 MB and 8 KB and writes 4.72 MB, ~2.1
// us.  The mma route reads each window once, all of it in flight; the SIMT
// route makes two dependent passes of 9 load stages over each window and is
// latency-bound; unmerge_scatter is one pass of independent 16-byte copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_gram.cuh"
#include "window_mma.cuh"

namespace {

using namespace window_gram;

constexpr int kUnmergeThreads = 256;  // 8 warps: 8 output tokens per block
constexpr int kMergeThreads = 512;    // the mma route's block: the Gram's
                                      // warps and 16 for the means

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

// The mma route: bf16 h, MT m-tiles of 16 rows (w <= 16 * MT).
template <int MT>
__global__ void __launch_bounds__(kMergeThreads)
merge_assign_kernel_mma(const __nv_bfloat16* __restrict__ h,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ merged,
                        int32_t* __restrict__ assign,
                        int32_t* __restrict__ centers, int w, int M, int D) {
  extern __shared__ __align__(16) uint8_t merge_smem[];
  const window_mma::Window win = window_mma::layout(merge_smem, w, D);
  float* ss = reinterpret_cast<float*>(win.scratch);
  int* sc = win.scratch + kMaxW;
  float* sden = reinterpret_cast<float*>(win.scratch + 3 * kMaxW);
  const long long blk = blockIdx.x;
  if (threadIdx.x < w) ss[threadIdx.x] = s[blk * w + threadIdx.x];
  // every slot in range whatever the scores hold (a NaN has no rank)
  if (threadIdx.x < M) sc[threadIdx.x] = threadIdx.x;
  window_mma::begin(win, h + blk * w * D, w, D);  // its barrier publishes ss

  // ---- top-M centers by rank while the window lands: token j's rank is
  // the number of scores that beat it (greater, or equal at a lower index)
  if (threadIdx.x < w) {
    const int j = threadIdx.x;
    const float sj = ss[j];
    int rank = 0;
    for (int i = 0; i < w; ++i) {
      const float si = ss[i];
      rank += (si > sj) || (si == sj && i < j);
    }
    if (rank < M) sc[rank] = j;
  }
  window_mma::wait(win);
  window_mma::gram<MT>(win, w, D);  // its barriers publish sc
  if (threadIdx.x < M) centers[blk * M + threadIdx.x] = sc[threadIdx.x];

  // ---- nearest center, first occurrence of the minimum (jnp.argmin), by
  // warp 0 (w <= 32): lane i assigns token i; then one ballot per cluster
  // gives its members as a bit mask, and lane m sums the denominator over
  // the set bits in token order
  uint32_t* smask = reinterpret_cast<uint32_t*>(win.scratch + 2 * kMaxW);
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    int best = -1;
    if (i < w) {
      best = 0;
      float bv = gram_dist(win.part, i, sc[0]);
#pragma unroll 4
      for (int m = 1; m < M; ++m) {
        const float d2 = gram_dist(win.part, i, sc[m]);
        if (d2 < bv) {
          best = m;
          bv = d2;
        }
      }
      assign[blk * w + i] = best;
    }
    uint32_t mine = 0;
    for (int m = 0; m < M; ++m) {
      const uint32_t bits = __ballot_sync(0xffffffffu, best == m);
      if (i == m) mine = bits;
    }
    if (i < M) {
      float den = 0.f;
      for (uint32_t b = mine; b; b &= b - 1)
        den = __fadd_rn(den, ss[__ffs(b) - 1]);
      sden[i] = fmaxf(den, 1e-9f);
      smask[i] = mine;
    }
  }
  __syncthreads();

  // ---- importance-weighted cluster means (Eq. 13), the SIMT arithmetic:
  // 8 columns of one cluster per item, its members visited in token order
  const int nv = D / 8;  // 16-byte vectors of 8 columns per row
  __nv_bfloat16* mw = merged + blk * M * D;
  for (int e = threadIdx.x; e < M * nv; e += kMergeThreads) {
    const int m = e / nv, v = e % nv;
    float num[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) num[c] = 0.f;
    for (uint32_t b = smask[m]; b; b &= b - 1) {
      const int i = __ffs(b) - 1;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(win.rows + i * win.pitch + v * 16);
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float si = ss[i];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        num[c] = fmaf(si, __bfloat162float(hv[c]), num[c]);
    }
    uint4 packed;
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(&packed);
    const float den = sden[m];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      out[c] = __float2bfloat16_rn(__fdiv_rn(num[c], den));
    *reinterpret_cast<uint4*>(mw + (long long)m * D + v * 8) = packed;
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

template <int MT>
int launch_merge_mma(const void* h, const void* s, void* merged,
                     void* assign, void* centers, int nw, int w, int M,
                     int D, cudaStream_t stream) {
  static bool opted_in = false;  // per instance; a repeated call is harmless
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_assign_kernel_mma<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, window_mma::kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  merge_assign_kernel_mma<MT>
      <<<nw, kMergeThreads, window_mma::smem_bytes(w, D), stream>>>(
          static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(s),
          static_cast<__nv_bfloat16*>(merged), static_cast<int32_t*>(assign),
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

// The mma route.  h: (nw, w, D) bfloat16, D % 8 == 0, the padded window
// within window_mma::kSmemLimit; s: (nw, w) float32; merged: (nw, M, D)
// bfloat16; assign: (nw, w) and centers: (nw, M) int32; h and merged 16-byte
// aligned.  Needs 1 <= w <= 32 and 1 <= M <= w.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int merge_assign_mma_launch(const void* h, const void* s,
                                       void* merged, void* assign,
                                       void* centers, int nw, int w, int M,
                                       int D, void* stream) {
  if (nw < 1 || w < 1 || w > window_gram::kMaxW || M < 1 || M > w ||
      D < 8 || D % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(merged))
       % 16) != 0 ||
      window_mma::smem_bytes(w, D) > window_mma::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w <= 16)
    return launch_merge_mma<1>(h, s, merged, assign, centers, nw, w, M, D,
                               st);
  return launch_merge_mma<2>(h, s, merged, assign, centers, nw, w, M, D, st);
}

// The SIMT route.  h: (nw, w, D), dtype_code 0 = float32, 1 = bfloat16; s:
// (nw, w) float32; merged: (nw, M, D) in h's dtype; assign: (nw, w) and
// centers: (nw, M) int32.  Needs 1 <= w <= 32 and 1 <= M <= w.  Returns cudaGetLastError()
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
