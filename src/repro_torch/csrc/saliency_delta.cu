// saliency_delta: per-token temporal saliency and the two Frobenius norms of
// the FastCache step statistics, on Hopper.
//
// Replaces the TPU kernel `saliency_delta` in src/repro/kernels/
// saliency_delta.py (Pallas, pl.pallas_call at :56).  Its plain twins are
// kernels/ref.py:saliency_delta in the reference and cuda_kernels/ref.py:
// saliency_delta here.  For each sample b of x, prev (B, N, D):
//
//   sal[b, n]  = sum_d (x - prev)^2                       (per token, f32)
//   diff[b]    = sum_n sal[b, n]        = ||X_b - P_b||_F^2
//   prevsq[b]  = sum_n sum_d prev^2     = ||P_b||_F^2
//
// The reference's kernel takes one (N, D) pair; the port batches the samples.
//
// Design.  The Pallas grid (N/BN, D/BD) carries the two scalars across grid
// steps in a resident output block, which relies on the TPU running the grid
// in order.  CUDA blocks run in no order, so this is two launches on the
// caller's stream, with no host sync between them and no float atomics (the
// totals feed step-level cache gates, which must be the same on every run):
//   1. row_sums: grid (ceil(N/8), B), one warp per token row.  Each lane sums
//      a strided share of the row (16-byte loads where D and the pointers
//      allow, else one element at a time), then a butterfly shuffle adds the
//      lanes in a fixed order.  Writes sal and the row's sum of prev^2.
//   2. sample_totals: grid B, one block per sample adds its N row values in a
//      fixed order (strided per-thread sums, then a shared-memory tree).
// Any N and D: the ragged edges need no padding.
//
// Bound at B=8, N=256, D=1152 in bf16 (fastcache at 4 serving slots): x and
// prev are read once, 9.44 MB, ~2.8 us at the H100 SXM's 3.35 TB/s; the
// outputs are 8 KB.  Three f32 operations per element pair, 7 MFLOP, is far
// below the bytes.  So the kernel is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;
constexpr int kTotalThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 16-byte load: 4 floats or 8 bf16 values, widened to f32.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kRowWarps * 32)
row_sums(const T* __restrict__ x, const T* __restrict__ prev,
         float* __restrict__ sal, float* __restrict__ row_prev, int N, int D) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRowWarps + warp;
  if (r >= N) return;  // the whole warp leaves together
  const long long row = (long long)blockIdx.y * N + r;
  const T* xr = x + row * D;
  const T* pr = prev + row * D;
  float d2 = 0.f, p2 = 0.f;
  if constexpr (kVector) {
    constexpr int V = Vec16<T>::n;
    for (int i = lane * V; i < D; i += 32 * V) {
      float xv[V], pv[V];
      Vec16<T>::load(xr + i, xv);
      Vec16<T>::load(pr + i, pv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(xv[j], pv[j]);
        d2 = fmaf(d, d, d2);
        p2 = fmaf(pv[j], pv[j], p2);
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float pv = to_f32(pr[i]);
      const float d = __fsub_rn(to_f32(xr[i]), pv);
      d2 = fmaf(d, d, d2);
      p2 = fmaf(pv, pv, p2);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    d2 = __fadd_rn(d2, __shfl_xor_sync(0xffffffffu, d2, s));
    p2 = __fadd_rn(p2, __shfl_xor_sync(0xffffffffu, p2, s));
  }
  if (lane == 0) {
    sal[row] = d2;
    row_prev[row] = p2;
  }
}

__global__ void __launch_bounds__(kTotalThreads)
sample_totals(const float* __restrict__ sal, const float* __restrict__ row_prev,
              float* __restrict__ diff, float* __restrict__ prevsq, int N) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* s = sal + (long long)b * N;
  const float* p = row_prev + (long long)b * N;
  float a = 0.f, c = 0.f;
  for (int i = t; i < N; i += kTotalThreads) {
    a = __fadd_rn(a, s[i]);
    c = __fadd_rn(c, p[i]);
  }
  __shared__ float sa[kTotalThreads];
  __shared__ float sc[kTotalThreads];
  sa[t] = a;
  sc[t] = c;
  __syncthreads();
  for (int st = kTotalThreads / 2; st > 0; st >>= 1) {
    if (t < st) {
      sa[t] = __fadd_rn(sa[t], sa[t + st]);
      sc[t] = __fadd_rn(sc[t], sc[t + st]);
    }
    __syncthreads();
  }
  if (t == 0) {
    diff[b] = sa[0];
    prevsq[b] = sc[0];
  }
}

template <typename T>
int launch(const void* x, const void* prev, void* sal, void* row_prev,
           void* diff, void* prevsq, int B, int N, int D,
           cudaStream_t stream) {
  const dim3 grid((N + kRowWarps - 1) / kRowWarps, B);
  const bool vector = D % Vec16<T>::n == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(prev) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(prev);
  float* st = static_cast<float*>(sal);
  float* rt = static_cast<float*>(row_prev);
  if (vector)
    row_sums<T, true><<<grid, kRowWarps * 32, 0, stream>>>(xt, pt, st, rt, N, D);
  else
    row_sums<T, false><<<grid, kRowWarps * 32, 0, stream>>>(xt, pt, st, rt, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sample_totals<<<B, kTotalThreads, 0, stream>>>(
      st, rt, static_cast<float*>(diff), static_cast<float*>(prevsq), N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x and prev).  sal and row_prev are
// (B, N) f32, diff and prevsq (B,) f32.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int saliency_delta_launch(const void* x, const void* prev,
                                     void* sal, void* row_prev, void* diff,
                                     void* prevsq, int B, int N, int D,
                                     int dtype_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, prev, sal, row_prev, diff, prevsq, B, N,
                                 D, s);
  if (dtype_code == 0)
    return launch<float>(x, prev, sal, row_prev, diff, prevsq, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}
