// fused_gate: the FastCache per-sample cache gate for one DiT layer, on Hopper.
//
// Replaces the TPU kernel `fused_gate` in src/repro/kernels/fused_gate.py
// (Pallas, pl.pallas_call at :95).  Its plain twins are kernels/ref.py:fused_gate
// in the reference and cuda_kernels/ref.py:fused_gate here.  Per sample b of
// x, prev_in, prev_out (B, C, D):
//
//   diff_b   = ||X_b - P_b||_F^2,  prevsq_b = ||P_b||_F^2           (f32)
//   gate_b   = diff_b / (max(sigma2_b, 1e-30) * C*D) <= thr  &&  eligible_b
//   out_b    = gate_b ? gamma*(X_b W + bias) + (1-gamma)*PO_b : X_b
//
// (without the blend term when use_blend == 0), out in x's dtype.
//
// Design.  The Pallas grid (B, 2, C/BC) relies on the TPU running grid steps
// in order: phase 0 accumulates the norms into a resident output block,
// phase 1 reads them.  CUDA blocks run in no order, so this is two launches
// on the caller's stream, with no host sync between them:
//   1. gate_partials: grid (parts, B).  Each block reduces one contiguous
//      chunk of one sample in a fixed order (per-thread strided sums, then a
//      shared-memory tree) into scratch[b][part].  No float atomics: the sums,
//      and so the gate bits, are the same on every run.
//   2. gate_gemm: grid (D/64, C/64, B).  Every block re-sums its sample's
//      partials in part order and rebuilds the gate in f32 with the
//      reference's operation order (thr and C*D come in as f32, as JAX
//      compares against a weak-typed Python float).  A block whose sample does
//      not gate copies its tile of X and exits; the others run a 64x64x16
//      shared-memory-tiled f32 FMA GEMM (4x4 outputs per thread) with the
//      bias and blend epilogue, rounding to bf16 with __float2bfloat16_rn.
//
// Bound at B=8, C=128, D=1152 (the DiT-XL/2 slice with 4 serving slots):
// X, P, PO and out are 2.36 MB each in bf16 and W is 5.3 MB in f32, about
// 14.7 MB, i.e. ~4.4 us at the H100 SXM's 3.35 TB/s; a GEMM over every row
// is 2*8*128*1152*1152 = 2.7 GFLOP, ~41 us at 67 TFLOP/s of f32 outside the
// tensor cores.  The kernel is bound by operations whenever a sample gates.
// Later work: a wgmma GEMM fed by TMA (bf16 X against a bf16 copy of W, or
// TF32 if the tolerance allows it), one block per SM walking the tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRedThreads = 256;
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256

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

// partials[(b * parts + part) * 2 + {0, 1}] = chunk sums of (x-p)^2 and p^2
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
gate_partials(const T* __restrict__ x, const T* __restrict__ prev,
              float* __restrict__ partials, long long n_per_sample) {
  const int b = blockIdx.y;
  const int part = blockIdx.x;
  const long long chunk = (n_per_sample + gridDim.x - 1) / gridDim.x;
  const long long lo = part * chunk;
  const long long hi = lo + chunk < n_per_sample ? lo + chunk : n_per_sample;
  const T* xs = x + (long long)b * n_per_sample;
  const T* ps = prev + (long long)b * n_per_sample;
  float d2 = 0.f, p2 = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float pv = to_f32(ps[i]);
    const float d = __fsub_rn(to_f32(xs[i]), pv);
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
    p2 = __fadd_rn(p2, __fmul_rn(pv, pv));
  }
  __shared__ float sd[kRedThreads];
  __shared__ float sp[kRedThreads];
  sd[threadIdx.x] = d2;
  sp[threadIdx.x] = p2;
  __syncthreads();
  for (int s = kRedThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sd[threadIdx.x] = __fadd_rn(sd[threadIdx.x], sd[threadIdx.x + s]);
      sp[threadIdx.x] = __fadd_rn(sp[threadIdx.x], sp[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[((long long)b * gridDim.x + part) * 2] = sd[0];
    partials[((long long)b * gridDim.x + part) * 2 + 1] = sp[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gate_gemm(const T* __restrict__ x, const T* __restrict__ prev_out,
          const float* __restrict__ w, const float* __restrict__ bias,
          const float* __restrict__ sigma2, const uint8_t* __restrict__ eligible,
          const float* __restrict__ partials, int n_parts,
          T* __restrict__ out, uint8_t* __restrict__ gate_out,
          float* __restrict__ diff_out, float* __restrict__ prevsq_out,
          int C, int D, float thr, float nd, float gamma, float one_minus_gamma,
          int use_blend) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  __shared__ int s_gate;
  if (threadIdx.x == 0) {
    float diff = 0.f, prevsq = 0.f;
    for (int p = 0; p < n_parts; ++p) {
      diff = __fadd_rn(diff, partials[((long long)b * n_parts + p) * 2]);
      prevsq = __fadd_rn(prevsq, partials[((long long)b * n_parts + p) * 2 + 1]);
    }
    const float stat = __fdiv_rn(diff, __fmul_rn(fmaxf(sigma2[b], 1e-30f), nd));
    const int g = (stat <= thr) && (eligible[b] != 0);
    s_gate = g;
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      gate_out[b] = (uint8_t)g;
      diff_out[b] = diff;
      prevsq_out[b] = prevsq;
    }
  }
  __syncthreads();
  const long long base = (long long)b * C * D;

  if (!s_gate) {  // pass-through: the real block overwrites these rows
    for (int i = threadIdx.x; i < BM * BN; i += kGemmThreads) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r < C && c < D) out[base + (long long)r * D + c] = x[base + (long long)r * D + c];
    }
    return;
  }

  __shared__ float As[BK][BM + 4];  // A tile transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kGemmThreads) {
      const int r = i / BK, kk = i % BK;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk][r] = (gr < C && gk < D) ? to_f32(x[base + (long long)gr * D + gk]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += kGemmThreads) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = n0 + c;
      Bs[kk][c] = (gk < D && gc < D) ? w[(long long)gk * D + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= D) continue;
      const long long o = base + (long long)r * D + c;
      float v = __fadd_rn(acc[i][j], bias[c]);
      if (use_blend) {
        v = __fadd_rn(__fmul_rn(gamma, v),
                      __fmul_rn(one_minus_gamma, to_f32(prev_out[o])));
      }
      out[o] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* prev_in, const void* prev_out,
           const void* w, const void* bias, const void* sigma2,
           const void* eligible, void* out, void* gate, void* diff,
           void* prevsq, void* partials, int n_parts, int B, int C, int D,
           float thr, float nd, float gamma, float one_minus_gamma,
           int use_blend, cudaStream_t stream) {
  const long long n = (long long)C * D;
  gate_partials<T><<<dim3(n_parts, B), kRedThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev_in),
      static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + BN - 1) / BN, (C + BM - 1) / BM, B);
  gate_gemm<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev_out),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(sigma2), static_cast<const uint8_t*>(eligible),
      static_cast<const float*>(partials), n_parts, static_cast<T*>(out),
      static_cast<uint8_t*>(gate), static_cast<float*>(diff),
      static_cast<float*>(prevsq), C, D, thr, nd, gamma, one_minus_gamma,
      use_blend);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, prev_in, prev_out and out).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fused_gate_launch(const void* x, const void* prev_in,
                                 const void* prev_out, const void* w,
                                 const void* bias, const void* sigma2,
                                 const void* eligible, void* out, void* gate,
                                 void* diff, void* prevsq, void* partials,
                                 int n_parts, int B, int C, int D,
                                 int dtype_code, float thr, float nd,
                                 float gamma, float one_minus_gamma,
                                 int use_blend, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, prev_in, prev_out, w, bias, sigma2,
                                 eligible, out, gate, diff, prevsq, partials,
                                 n_parts, B, C, D, thr, nd, gamma,
                                 one_minus_gamma, use_blend, s);
  if (dtype_code == 0)
    return launch<float>(x, prev_in, prev_out, w, bias, sigma2, eligible,
                         out, gate, diff, prevsq, partials, n_parts, B, C, D,
                         thr, nd, gamma, one_minus_gamma, use_blend, s);
  return (int)cudaErrorInvalidValue;
}
