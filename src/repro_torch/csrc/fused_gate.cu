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
//   2. the GEMM, one of two routes chosen on the host by a pure rule of
//      dtype, shape and alignment (cuda_kernels/route.py).  Either way every
//      block re-sums its sample's partials in part order and rebuilds the
//      gate in f32 with the reference's operation order (thr and C*D come in
//      as f32, as JAX compares against a weak-typed Python float), and a
//      block whose sample does not gate copies its tile of X and exits.
//      - gate_gemm_wgmma (bf16 X with D % 8 == 0 and 16-byte aligned bases:
//        the serving path).  The GEMM core of tc_gemm.cuh: bf16 X against a
//        bf16 copy of W made once by the caller, wgmma m64n64k16 with f32
//        accumulation, fed by TMA through a 4-stage ring; tiles of 64 rows
//        (one consumer warpgroup and one producer warp, 160 threads, 65 KB of
//        shared memory, three blocks per SM) by 64 columns, grid (D/64, C/64,
//        B).  The number of gated samples is known only on the card, so the
//        tiles are small enough that the gated samples alone fill it: at
//        B=8, C=128, D=1152 with half the samples gating, 144 of the 288
//        blocks multiply, one per SM and a few over; at C=64 (merged), 72.
//        The other blocks copy 8 KB and exit.  Rounding W to bf16 departs
//        from the TPU kernel's f32 product (see linear_blend.cu); the served
//        identity maps are exact in bf16, so there both routes agree bitwise.
//      - the same kernel over a split W (wgmma_split: bf16 X against [W_hi;
//        W_mid; W_lo], three bf16 terms stacked along K, tc_gemm.cuh), for
//        maps bf16 does not hold, such as fitted ones: the terms miss W by
//        2^-24 of |W|, so the product keeps f32-level accuracy for three
//        times the tensor-core work and two more bf16 copies of W read.
//      - gate_gemm (f32, held to 1e-4, and the bf16 shapes the wgmma route
//        does not take): a 64x64x16 shared-memory-tiled f32 FMA GEMM (4x4
//        outputs per thread).
//      Both add the bias and blend in the same operation order and round to
//      bf16 with __float2bfloat16_rn.
//   In a captured step graph the GEMM also sets the condition of the IF
//   node that skips the block (csrc/cond_node.cu) when the caller passes its
//   handle: warp 1 of block (0, 0, 0) rebuilds every sample's gate bit from
//   the partials with sample_gate's sums and operation order, so the bits
//   are those the kernel returns, and sets the handle to !all(gate).  The IF
//   node then needs no kernel of its own to read the gate back: B loads of
//   n_parts partials (128 at B = 8), beside the block's own work.  That
//   code lives only in the GEMM kernels' kSetCond instances, which a launch
//   with a handle runs; a launch without one runs the GEMM alone.
//
// Bound at B=8, C=128, D=1152 with 4 samples gating (the DiT-XL/2 slice with
// 4 serving slots): X, P and out are 2.36 MB each in bf16, PO is read for
// the 4 gated samples only (1.18 MB) and the bf16 W is 2.65 MB, about
// 10.9 MB, i.e. 3.26 us at the H100 SXM's 3.35 TB/s; the gated GEMM is
// 2*4*128*1152*1152 = 1.36 GFLOP, 1.37 us at 989 TFLOP/s of bf16 tensor
// cores.  The wgmma route is bound by bytes (2.03 us at C=64); the SIMT
// route, at 67 TFLOP/s of f32 outside the tensor cores, by operations.
// The split route computes the same function with the f32 W, whose bound is
// 13.6 MB (the f32 W is 5.31 MB), 4.05 us, by bytes; its own work, W_mid and
// W_lo read too (16.2 MB, 4.84 us) and the GEMM tripled (4.12 us), is 1.2x
// that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"  // the wgmma GEMM core (and sm90.cuh's helpers)

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

// Sample b's gate from its diff, in f32 in the reference's operation order.
__device__ __forceinline__ int gate_of(float diff, float sigma2,
                                       uint8_t eligible, float thr,
                                       float nd) {
  const float stat = __fdiv_rn(diff, __fmul_rn(fmaxf(sigma2, 1e-30f), nd));
  return (stat <= thr) && (eligible != 0);
}

// Sample b's diff re-summed from the partials in part order (sample_gate's
// sum, alone).
__device__ __forceinline__ float sample_diff(
    const float* __restrict__ partials, int n_parts, int b) {
  float diff = 0.f;
  for (int p = 0; p < n_parts; ++p)
    diff = __fadd_rn(diff, partials[((long long)b * n_parts + p) * 2]);
  return diff;
}

// Sample b's diff and prevsq re-summed from the partials in part order, and
// its gate rebuilt in f32 in the reference's operation order; the blocks of
// tile (0, 0) write them out.  By one thread of each block.
__device__ __forceinline__ int sample_gate(
    const float* __restrict__ sigma2, const uint8_t* __restrict__ eligible,
    const float* __restrict__ partials, int n_parts,
    uint8_t* __restrict__ gate_out, float* __restrict__ diff_out,
    float* __restrict__ prevsq_out, int b, float thr, float nd) {
  float diff = 0.f, prevsq = 0.f;  // sample_diff's order, both in one pass
  for (int p = 0; p < n_parts; ++p) {
    diff = __fadd_rn(diff, partials[((long long)b * n_parts + p) * 2]);
    prevsq = __fadd_rn(prevsq, partials[((long long)b * n_parts + p) * 2 + 1]);
  }
  const int g = gate_of(diff, sigma2[b], eligible[b], thr, nd);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    gate_out[b] = (uint8_t)g;
    diff_out[b] = diff;
    prevsq_out[b] = prevsq;
  }
  return g;
}

// The block-skip IF node's condition, !all(gate_b) over the B samples, into
// `cond` when `set_cond`: by warp 1 of block (0, 0, 0), each lane rebuilding
// its samples' gates as sample_gate does, the warp ANDing them.  Called by
// every thread before the block's first barrier, and compiled only into the
// kernels' kSetCond instances: its code slowed the GEMM that holds it even
// where it set nothing (launch/gate_designs.py).
__device__ __forceinline__ void set_skip_condition(
    cudaGraphConditionalHandle cond, int set_cond,
    const float* __restrict__ sigma2, const uint8_t* __restrict__ eligible,
    const float* __restrict__ partials, int n_parts, float thr, float nd) {
  if (!set_cond || threadIdx.x / 32 != 1 || blockIdx.x != 0 ||
      blockIdx.y != 0 || blockIdx.z != 0)
    return;
  const int lane = threadIdx.x % 32;
  int all = 1;
  for (int b = lane; b < (int)gridDim.z; b += 32)
    all &= gate_of(sample_diff(partials, n_parts, b), sigma2[b], eligible[b],
                   thr, nd);
  all = __all_sync(0xffffffffu, all);
  if (lane == 0) cudaGraphSetConditional(cond, all ? 0u : 1u);
}

template <typename T, bool kSetCond>
__global__ void __launch_bounds__(kGemmThreads)
gate_gemm(const T* __restrict__ x, const T* __restrict__ prev_out,
          const float* __restrict__ w, const float* __restrict__ bias,
          const float* __restrict__ sigma2, const uint8_t* __restrict__ eligible,
          const float* __restrict__ partials, int n_parts,
          T* __restrict__ out, uint8_t* __restrict__ gate_out,
          float* __restrict__ diff_out, float* __restrict__ prevsq_out,
          int C, int D, float thr, float nd, float gamma, float one_minus_gamma,
          int use_blend, cudaGraphConditionalHandle cond, int set_cond) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  __shared__ int s_gate;
  if (threadIdx.x == 0)
    s_gate = sample_gate(sigma2, eligible, partials, n_parts, gate_out,
                         diff_out, prevsq_out, b, thr, nd);
  if constexpr (kSetCond)
    set_skip_condition(cond, set_cond, sigma2, eligible, partials, n_parts,
                       thr, nd);
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
           int use_blend, cudaGraphConditionalHandle cond, int set_cond,
           cudaStream_t stream) {
  const long long n = (long long)C * D;
  gate_partials<T><<<dim3(n_parts, B), kRedThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev_in),
      static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + BN - 1) / BN, (C + BM - 1) / BM, B);
  const auto gemm = set_cond ? gate_gemm<T, true> : gate_gemm<T, false>;
  gemm<<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev_out),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(sigma2), static_cast<const uint8_t*>(eligible),
      static_cast<const float*>(partials), n_parts, static_cast<T*>(out),
      static_cast<uint8_t*>(gate), static_cast<float*>(diff),
      static_cast<float*>(prevsq), C, D, thr, nd, gamma, one_minus_gamma,
      use_blend, cond, set_cond);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route (bf16)
// ---------------------------------------------------------------------------

using GateGemm = TcGemm<1, 64, 4>;

template <bool kSetCond>
__global__ void __launch_bounds__(GateGemm::kThreads)
gate_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ prev_out,
                const float* __restrict__ bias,
                const float* __restrict__ sigma2,
                const uint8_t* __restrict__ eligible,
                const float* __restrict__ partials, int n_parts,
                __nv_bfloat16* __restrict__ out, uint8_t* __restrict__ gate_out,
                float* __restrict__ diff_out, float* __restrict__ prevsq_out,
                int C, int D, float thr, float nd, float gamma,
                float one_minus_gamma, int use_blend, int w_passes,
                cudaGraphConditionalHandle cond, int set_cond) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_gate;
  const TcRing ring = tc_ring<1, 64, 4>(smem_raw);
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * 64;
  const int n0 = blockIdx.x * 64;
  if (threadIdx.x == 0) {
    s_gate = sample_gate(sigma2, eligible, partials, n_parts, gate_out,
                         diff_out, prevsq_out, b, thr, nd);
    if (s_gate) tc_init<1, 4>(ring);
  }
  if constexpr (kSetCond)
    set_skip_condition(cond, set_cond, sigma2, eligible, partials, n_parts,
                       thr, nd);
  __syncthreads();
  const long long base = (long long)b * C * D;

  if (!s_gate) {  // pass-through in 16-byte pieces (D % 8 == 0, aligned)
    for (int i = threadIdx.x; i < 64 * 8; i += GateGemm::kThreads) {
      const int r = m0 + i / 8, c = n0 + 8 * (i % 8);
      if (r < C && c < D) {
        const long long o = base + (long long)r * D + c;
        *reinterpret_cast<uint4*>(out + o) =
            *reinterpret_cast<const uint4*>(x + o);
      }
    }
    return;
  }

  const int nk = (D + kTcChunk - 1) / kTcChunk;  // A's chunks
  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128)
      tc_produce<1, 64, 4>(ring, &xmap, &wmap, m0, b, n0, D, w_passes * nk,
                           nk);
    return;
  }
  float acc[GateGemm::kAcc];
  tc_consume<1, 64, 4>(ring, acc, 0, threadIdx.x, w_passes * nk);
  tc_store<64>(acc, out + base, prev_out + base, bias, m0, C, n0, D, gamma,
               one_minus_gamma, use_blend, threadIdx.x);
}

// w_passes = 1: w is the (D, D) bf16 copy; t > 1: the (t Kp, D) split copy.
int launch_wgmma(const void* x, const void* prev_in, const void* prev_out,
                 const void* w, const void* bias, const void* sigma2,
                 const void* eligible, void* out, void* gate, void* diff,
                 void* prevsq, void* partials, int n_parts, int B, int C,
                 int D, float thr, float nd, float gamma,
                 float one_minus_gamma, int use_blend, int w_passes,
                 cudaGraphConditionalHandle cond, int set_cond,
                 cudaStream_t stream) {
  static bool opted_in[2] = {false, false};
  const auto gemm = set_cond ? gate_gemm_wgmma<true> : gate_gemm_wgmma<false>;
  int err = tc_opt_in(gemm, GateGemm::kSmem, opted_in[set_cond ? 1 : 0]);
  if (err != 0) return err;
  const int kp = (D + kTcChunk - 1) / kTcChunk * kTcChunk;
  CUtensorMap xmap, wmap;
  if (!tc_map_3d(&xmap, x, D, C, B, 64) ||
      !tc_map_2d(&wmap, w, D, w_passes > 1 ? w_passes * kp : D))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * D;
  gate_partials<__nv_bfloat16><<<dim3(n_parts, B), kRedThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(prev_in),
      static_cast<float*>(partials), n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((D + 63) / 64, (C + 63) / 64, B);
  gemm<<<grid, GateGemm::kThreads, GateGemm::kSmem, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(prev_out),
      static_cast<const float*>(bias), static_cast<const float*>(sigma2),
      static_cast<const uint8_t*>(eligible),
      static_cast<const float*>(partials), n_parts,
      static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(gate),
      static_cast<float*>(diff), static_cast<float*>(prevsq), C, D, thr, nd,
      gamma, one_minus_gamma, use_blend, w_passes, cond, set_cond);
  return (int)cudaGetLastError();
}

bool wgmma_takes(int B, int C, int D) {
  return B >= 1 && C >= 1 && D >= 8 && D % 8 == 0 && B <= 65535 &&
         (C + 63) / 64 <= 65535;
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, prev_in, prev_out and out).
// Every launcher takes, before the stream, the handle of an IF node's
// condition and whether to set it to !all(gate) (set_cond; a handle of the
// graph being captured, 0 and 0 outside one).  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int fused_gate_launch(const void* x, const void* prev_in,
                                 const void* prev_out, const void* w,
                                 const void* bias, const void* sigma2,
                                 const void* eligible, void* out, void* gate,
                                 void* diff, void* prevsq, void* partials,
                                 int n_parts, int B, int C, int D,
                                 int dtype_code, float thr, float nd,
                                 float gamma, float one_minus_gamma,
                                 int use_blend, unsigned long long cond,
                                 int set_cond, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, prev_in, prev_out, w, bias, sigma2,
                                 eligible, out, gate, diff, prevsq, partials,
                                 n_parts, B, C, D, thr, nd, gamma,
                                 one_minus_gamma, use_blend, cond, set_cond,
                                 s);
  if (dtype_code == 0)
    return launch<float>(x, prev_in, prev_out, w, bias, sigma2, eligible,
                         out, gate, diff, prevsq, partials, n_parts, B, C, D,
                         thr, nd, gamma, one_minus_gamma, use_blend, cond,
                         set_cond, s);
  return (int)cudaErrorInvalidValue;
}

// The wgmma route: x, prev_in, prev_out and out (B, C, D) bf16, w_bf16 (D, D)
// bf16, bias (D,) f32; D % 8 == 0 and x, prev_out, w_bf16, bias and out
// 16-byte aligned (the wrapper's route rule).  Returns cudaGetLastError()
// after the launches (0 = success), or cudaErrorInvalidValue when a tensor
// map is refused.
extern "C" int fused_gate_wgmma_launch(const void* x, const void* prev_in,
                                       const void* prev_out,
                                       const void* w_bf16, const void* bias,
                                       const void* sigma2,
                                       const void* eligible, void* out,
                                       void* gate, void* diff, void* prevsq,
                                       void* partials, int n_parts, int B,
                                       int C, int D, float thr, float nd,
                                       float gamma, float one_minus_gamma,
                                       int use_blend, unsigned long long cond,
                                       int set_cond, void* stream) {
  if (!wgmma_takes(B, C, D)) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, prev_in, prev_out, w_bf16, bias, sigma2, eligible,
                      out, gate, diff, prevsq, partials, n_parts, B, C, D,
                      thr, nd, gamma, one_minus_gamma, use_blend, 1, cond,
                      set_cond, static_cast<cudaStream_t>(stream));
}

// The wgmma_split route: as fused_gate_wgmma_launch, with w_split the
// (terms Kp, D) bf16 stack of W's terms, [W_hi; 0; W_mid; 0; ...], Kp = D
// rounded up to a multiple of 64, 16-byte aligned.
extern "C" int fused_gate_wgmma_split_launch(
    const void* x, const void* prev_in, const void* prev_out,
    const void* w_split, const void* bias, const void* sigma2,
    const void* eligible, void* out, void* gate, void* diff, void* prevsq,
    void* partials, int n_parts, int B, int C, int D, float thr, float nd,
    float gamma, float one_minus_gamma, int use_blend, int terms,
    unsigned long long cond, int set_cond, void* stream) {
  if (!wgmma_takes(B, C, D) || terms < 2) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, prev_in, prev_out, w_split, bias, sigma2, eligible,
                      out, gate, diff, prevsq, partials, n_parts, B, C, D,
                      thr, nd, gamma, one_minus_gamma, use_blend, terms, cond,
                      set_cond, static_cast<cudaStream_t>(stream));
}
