// linear_blend: the learnable linear approximation with its motion-aware
// blend, out = gamma * (X W + b) + (1 - gamma) * prev, on Hopper.
//
// Replaces the TPU kernel `linear_blend` in src/repro/kernels/
// linear_blend.py (Pallas, pl.pallas_call at :51).  Its plain twins are
// kernels/ref.py:linear_blend in the reference and cuda_kernels/ref.py:
// linear_blend here.  X (M, D) and prev (M, F) are f32 or bf16, W (D, F) and
// b (F,) f32; the product is accumulated in f32 and the result is written in
// X's dtype.  The Pallas grid (M/BM, F/BF, D/BK) keeps an f32 accumulator
// block resident in VMEM across the K steps and fuses the bias and the blend
// into the last one.  Two routes here, chosen on the host by a pure rule of
// dtype, shape and alignment (cuda_kernels/route.py):
//
// wgmma route (bf16 X with D % 8 == 0, F % 8 == 0 and 16-byte aligned
// bases: every caller on the serving path).  The GEMM core of tc_gemm.cuh:
// bf16 X against a bf16 copy of W that the caller made once (the policies
// derive it from their f32 weights at construction), wgmma m64n192k16 with f32
// accumulation, fed by TMA through a 4-stage ring.  Rounding W to bf16 is a
// departure from the TPU kernel, which multiplies f32 operands: one relative
// error of at most 2^-9 per weight, ~1e-3 in the outputs at K = 1152 with W
// near the identity, inside the 2e-2 that bf16 outputs are held to; the
// served approximators are the identity, which bf16 holds exactly, so there
// the two routes agree bitwise.  TF32 would round W by only 2^-11 but needs a
// K-major W and X widened to 32 bits; the error does not call for it.  Tile
// 128 x 192 (two consumer warpgroups of 64 rows and one producer warp, 288
// threads): at M = 2048, F = 1152 that is 16 x 6 = 96 blocks, one wave on 132
// SMs (128 x 128 tiles would be 144 blocks, two waves, the second 9% full);
// 4 stages of 40 KB, 161 KB of shared memory, one block per SM.  The bias,
// the blend (prev unread at gamma = 1) and the bf16 rounding are the
// epilogue, in the SIMT kernel's operation order.
//
// wgmma_split route (the wgmma route's rule, for maps bf16 does not hold,
// such as fitted ones; a bf16 copy of those moved the served bypass by up to
// 8% rel-L2): the same kernel over W split into three bf16 terms stacked
// along K, [W_hi; W_mid; W_lo] with W_hi = bf16(W), W_mid = bf16(W - W_hi),
// W_lo = bf16(W - W_hi - W_mid), each padded to whole 64-row chunks
// (tc_gemm.cuh).  The terms miss W by at most 2^-24 of |W|, and bf16 X times
// any term is exact in f32, so only that residual and the f32 summation
// order part it from the TPU kernel's f32 product; the cost is three times
// the K walk (three passes of the tensor cores over X) and two more bf16
// copies of W read.  Two terms (2^-16) left the fitted bypass at up to
// 8.6e-4 rel-L2 on the card, with outputs near 0 past bf16's 2e-2.
//
// SIMT route (f32, and bf16 shapes the wgmma route does not take): f32 is
// held to 1e-4, which neither bf16 nor TF32 operands meet at K = 1152.  One
// block of 256 threads owns a 128x128 output tile and walks K in steps of 8:
// the A tile (transposed, padded against bank conflicts) and the W tile sit
// in shared memory, each thread keeps an 8x8 f32 accumulator in registers
// (two 4-row by two 4-column groups, 64 apart, so a quarter-warp's 16-byte
// shared loads cover contiguous words), and the next K step's tile is loaded
// into registers while the current one is multiplied.  Plain f32 FMAs in
// ascending K, so results repeat bitwise.  Any M, D and F: loads and stores
// are guarded at the ragged edges.  Both routes add the bias, blend with prev
// (skipped at gamma = 1, where (1-gamma)*prev is exactly 0 for a finite
// prev) and round to bf16 with __float2bfloat16_rn.
//
// Bound at M=2048, D=F=1152, gamma = 1 (4 serving slots x CFG x 256 tokens):
// the GEMM is 2*2048*1152*1152 = 5.44 GFLOP, 5.50 us at 989 TFLOP/s of bf16
// tensor cores (81 us at 67 TFLOP/s of f32 outside them, the SIMT route's
// bound); X, the bf16 W and out are 12.1 MB, 3.61 us at 3.35 TB/s.  So the
// wgmma route is bound by operations.  The split route computes the same
// function with the f32 W (X, the f32 W and out are 14.7 MB, 4.40 us), so
// its bound is the same 5.50 us; its own three passes are 16.3 GFLOP,
// 16.5 us, 3x that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"  // the wgmma GEMM core (and sm90.cuh's helpers)

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;            // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = BM * BK / kThreads;  // 4 elements of A and of W each
constexpr int kPadA = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_blend_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ prev,
                    T* __restrict__ out, int M, int D, int F, float gamma,
                    float one_minus_gamma, int use_prev) {
  __shared__ __align__(16) float As[BK][BM + kPadA];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // Bs[k][n]
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = t % 16;
  const int ty = t / 16;

  // global -> register staging: A element i = t + s*256 of the 128x8 tile is
  // row i / 8, column i % 8 (a row's 8 K values are contiguous in X); W
  // element i is row i / 128, column i % 128 (contiguous along F).
  float ra[kLoads], rb[kLoads];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int i = t + s * kThreads;
      const int gr = m0 + i / BK, gk = k0 + i % BK;
      ra[s] = (gr < M && gk < D) ? to_f32(x[(long long)gr * D + gk]) : 0.f;
      const int wk = k0 + i / BN, wc = n0 + i % BN;
      rb[s] = (wk < D && wc < F) ? w[(long long)wk * F + wc] : 0.f;
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int i = t + s * kThreads;
      As[i % BK][i / BK] = ra[s];
      Bs[i / BN][i % BN] = rb[s];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tiles(0);
  store_tiles();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) load_tiles(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_tiles();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= F) continue;
      const long long o = (long long)r * F + c;
      float v = __fadd_rn(acc[i][j], bias[c]);
      if (use_prev)
        v = __fadd_rn(__fmul_rn(gamma, v),
                      __fmul_rn(one_minus_gamma, to_f32(prev[o])));
      out[o] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* prev,
           void* out, int M, int D, int F, float gamma, float one_minus_gamma,
           int use_prev, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  linear_blend_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(prev),
      static_cast<T*>(out), M, D, F, gamma, one_minus_gamma, use_prev);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------

using LbGemm = TcGemm<2, 192, 4>;

__global__ void __launch_bounds__(LbGemm::kThreads, 1)
linear_blend_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ prev,
                          __nv_bfloat16* __restrict__ out, int M, int D,
                          int F, float gamma, float one_minus_gamma,
                          int use_prev, int w_passes) {
  extern __shared__ uint8_t smem_raw[];
  const TcRing ring = tc_ring<2, 192, 4>(smem_raw);
  const int m0 = blockIdx.y * LbGemm::BM;
  const int n0 = blockIdx.x * 192;
  const int nk = (D + kTcChunk - 1) / kTcChunk;  // A's chunks
  if (threadIdx.x == 0) tc_init<2, 4>(ring);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256)
      tc_produce<2, 192, 4>(ring, &xmap, &wmap, m0, 0, n0, F, w_passes * nk,
                            nk);
    return;
  }
  float acc[LbGemm::kAcc];
  tc_consume<2, 192, 4>(ring, acc, wg, threadIdx.x % 128, w_passes * nk);
  tc_store<192>(acc, out, prev, bias, m0 + 64 * wg, M, n0, F, gamma,
                one_minus_gamma, use_prev, threadIdx.x % 128);
}

// w_passes = 1: w is the (D, F) bf16 copy; t > 1: the (t Kp, F) split copy.
int launch_wgmma(const void* x, const void* w, const void* bias,
                 const void* prev, void* out, int M, int D, int F, float gamma,
                 float one_minus_gamma, int use_prev, int w_passes,
                 cudaStream_t stream) {
  if (M < 1 || D < 8 || F < 8 || D % 8 != 0 || F % 8 != 0 || w_passes < 1)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  const int err = tc_opt_in(linear_blend_kernel_wgmma, LbGemm::kSmem,
                            opted_in);
  if (err != 0) return err;
  const int kp = (D + kTcChunk - 1) / kTcChunk * kTcChunk;
  CUtensorMap xmap, wmap;
  if (!tc_map_3d(&xmap, x, D, M, 1, LbGemm::BM) ||
      !tc_map_2d(&wmap, w, F, w_passes > 1 ? w_passes * kp : D))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + 191) / 192, (M + LbGemm::BM - 1) / LbGemm::BM);
  linear_blend_kernel_wgmma<<<grid, LbGemm::kThreads, LbGemm::kSmem,
                              stream>>>(
      xmap, wmap, static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(prev),
      static_cast<__nv_bfloat16*>(out), M, D, F, gamma, one_minus_gamma,
      use_prev, w_passes);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, prev and out).  use_prev = 0
// leaves prev unread (gamma = 1).  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int linear_blend_launch(const void* x, const void* w,
                                   const void* bias, const void* prev,
                                   void* out, int M, int D, int F,
                                   int dtype_code, float gamma,
                                   float one_minus_gamma, int use_prev,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, w, bias, prev, out, M, D, F, gamma,
                                 one_minus_gamma, use_prev, s);
  if (dtype_code == 0)
    return launch<float>(x, w, bias, prev, out, M, D, F, gamma,
                         one_minus_gamma, use_prev, s);
  return (int)cudaErrorInvalidValue;
}

// The wgmma route: x (M, D), prev and out (M, F) bf16, w_bf16 (D, F) bf16,
// bias (F,) f32; D % 8 == 0, F % 8 == 0 and every base 16-byte aligned (the
// wrapper's route rule).  use_prev = 0 leaves prev unread.  Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue when a tensor map is refused.
extern "C" int linear_blend_wgmma_launch(const void* x, const void* w_bf16,
                                         const void* bias, const void* prev,
                                         void* out, int M, int D, int F,
                                         float gamma, float one_minus_gamma,
                                         int use_prev, void* stream) {
  return launch_wgmma(x, w_bf16, bias, prev, out, M, D, F, gamma,
                      one_minus_gamma, use_prev, 1,
                      static_cast<cudaStream_t>(stream));
}

// The wgmma_split route: as linear_blend_wgmma_launch, with w_split the
// (terms Kp, F) bf16 stack of W's terms, [W_hi; 0; W_mid; 0; ...], Kp = D
// rounded up to a multiple of 64, 16-byte aligned.
extern "C" int linear_blend_wgmma_split_launch(
    const void* x, const void* w_split, const void* bias, const void* prev,
    void* out, int M, int D, int F, float gamma, float one_minus_gamma,
    int use_prev, int terms, void* stream) {
  if (terms < 2) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, w_split, bias, prev, out, M, D, F, gamma,
                      one_minus_gamma, use_prev, terms,
                      static_cast<cudaStream_t>(stream));
}
