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
// gemv route (the wgmma route's rule at M <= route.GEMV_MAX_ROWS with a
// single bf16 copy: the decode gate's M = batch rows).  At such M the wgmma
// route's 128 x 192 tile is 124 rows of padding and its grid ceil(F / 192)
// blocks: at F = 1024, six SMs stream all of W, and it lost to one bf16
// addmm at every decode width (PERF.md).  This kernel spreads W over every
// SM instead: grid (ceil(F / 256) column tiles, S splits of K, ceil(M / 4)
// row groups), S from route.gemv_plan so that the tiles times the splits
// fill the 132 SMs about twice over (two blocks an SM) and no split holds
// fewer than 64 rows of K.  256 threads: 32 a column group of 8 columns
// (one 16-byte load of a W row), 8 K lanes (the warps), lane l taking rows
// k0 + l, k0 + l + 8, ... of the split, ascending, four 16-byte loads in
// flight and the next four issued before the current ones are used.  The
// block's first loads of W are issued before it waits for the kernel before
// it (programmatic stream serialization: W is a weight no kernel of the
// step writes; X, the workspace, the tickets and out are touched only after
// the wait).  X's slice of the split, 4 rows, sits in shared memory as f32;
// each thread keeps 4 x 8 f32 sums (plain fmaf: bf16 times bf16 is exact in
// f32, so each step is one rounding of the sum).  The tensor cores do not
// pay at 4 rows: mma.sync would pad the rows to 8 or 16, and the FMAs here
// (2 M D F, 0.4 GFLOP at M = 4, D = F = 7168) cost a few percent of the
// time W's bytes take; what the kernel must do is keep enough loads in
// flight on every SM.  The 8 lanes' sums meet in shared memory, added in
// lane order; each block writes its split's (4, 256) partial to a workspace
// and takes an integer ticket for its column tile (an acq_rel atomic, as
// saliency_delta's onepass route): the block that takes the last one adds
// the S partials in split order, adds the bias, blends, rounds to bf16
// with __float2bfloat16_rn and puts the ticket back to 0 for the next call
// (graph replays too).  No float atomics: results repeat bitwise; at W = I
// every partial is exact, so the result is the other routes' bits.
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
// 16.5 us, 3x that bound.  The gemv route at M = 4, D = F = 1024 reads the
// bf16 W (2.10 MB) and writes 8 KB: 0.63 us at 3.35 TB/s, by bytes (the
// product's 8.4 MFLOP is 8.5 ns on the tensor cores); at D = F = 7168, 102.8
// MB, 30.7 us.

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

// ---------------------------------------------------------------------------
// gemv route (bf16, M <= a few rows)
// ---------------------------------------------------------------------------

constexpr int kGvThreads = 256;
constexpr int kGvLanes = 8;                           // K lanes: the warps
constexpr int kGvColThreads = kGvThreads / kGvLanes;  // 32
constexpr int kGvCols = kGvColThreads * 8;            // 256 columns a tile
constexpr int kGvRows = 4;                            // rows a row group
constexpr int kGvMaxK = 2048;                         // K rows a split
constexpr int kGvUnroll = 4;                          // W loads in flight
constexpr int kGvMaxTickets = 65536;                  // tiles x row groups

__device__ unsigned int g_gemv_tickets[kGvMaxTickets];

__device__ __forceinline__ uint4 gv_load_w(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));  // read-only path
}

__device__ __forceinline__ void gv_fma(float (&acc)[kGvRows][8], uint4 wv,
                                       float4 xv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&wv);
  float wf[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    wf[2 * i] = f.x;
    wf[2 * i + 1] = f.y;
  }
  const float xr[kGvRows] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int r = 0; r < kGvRows; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xr[r], wf[j], acc[r][j]);
}

// Grid (tiles, S, row groups); ws holds (row groups, tiles, S, 4, 256) f32.
__global__ void __launch_bounds__(kGvThreads, 2)
linear_blend_kernel_gemv(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ prev,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int M, int D, int F, int kc,
                         float gamma, float one_minus_gamma, int use_prev) {
  // X's slice as (k, 4 rows), then the lanes' sums as (lane, row, column)
  __shared__ float4 smem[kGvMaxK];
  __shared__ int last;
  const int tile = blockIdx.x, split = blockIdx.y, group = blockIdx.z;
  const int splits = gridDim.y;
  const int k0 = split * kc;
  const int n_k = min(D - k0, kc);
  const int r0 = group * kGvRows;
  const int lane = threadIdx.x / kGvColThreads;
  const int c = tile * kGvCols + (threadIdx.x % kGvColThreads) * 8;
  const bool live = c < F;
  // lane's rows of the split: k0 + lane + 8 i, i < n_i
  const int n_i = lane < n_k ? (n_k - lane + kGvLanes - 1) / kGvLanes : 0;
  const __nv_bfloat16* wp = w + (long long)(k0 + lane) * F + c;
  const long long step = (long long)kGvLanes * F;

  uint4 cur[kGvUnroll];
#pragma unroll
  for (int u = 0; u < kGvUnroll; ++u)
    cur[u] = (live && u < n_i) ? gv_load_w(wp + u * step)
                               : make_uint4(0, 0, 0, 0);
  // thread t's outputs if its block is its tile's last: row t / 64, columns
  // 4 (t % 64) ... + 3 of the tile; their bias, a weight too, read now
  const int my_r = threadIdx.x / (kGvCols / 4);
  const int my_c = 4 * (threadIdx.x % (kGvCols / 4));
  const int gc = tile * kGvCols + my_c;
  const float4 bias4 =
      gc < F ? __ldg(reinterpret_cast<const float4*>(bias + gc))
             : make_float4(0.f, 0.f, 0.f, 0.f);

  // the next kernel may launch now; X, ws, the tickets and out are touched
  // only once the kernel before this one has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int rows = min(kGvRows, M - r0);
  for (int i = threadIdx.x; i < n_k; i += kGvThreads) {
    float v[kGvRows];
#pragma unroll
    for (int r = 0; r < kGvRows; ++r)
      v[r] = r < rows ? __bfloat162float(x[(long long)(r0 + r) * D + k0 + i])
                      : 0.f;
    smem[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  float acc[kGvRows][8];
#pragma unroll
  for (int r = 0; r < kGvRows; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  if (live) {
    for (int i0 = 0; i0 < n_i; i0 += kGvUnroll) {
      uint4 nxt[kGvUnroll];
#pragma unroll
      for (int u = 0; u < kGvUnroll; ++u) {
        const int i = i0 + kGvUnroll + u;
        nxt[u] = i < n_i ? gv_load_w(wp + i * step) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGvUnroll; ++u)
        if (i0 + u < n_i)
          gv_fma(acc, cur[u], smem[lane + kGvLanes * (i0 + u)]);
#pragma unroll
      for (int u = 0; u < kGvUnroll; ++u) cur[u] = nxt[u];
    }
  }
  __syncthreads();  // X's slice is no longer read

  // the lanes' sums: sums[(lane * 4 + r) * 256 + column of the tile]
  float* sums = reinterpret_cast<float*>(smem);
  const int col = (threadIdx.x % kGvColThreads) * 8;
#pragma unroll
  for (int r = 0; r < kGvRows; ++r) {
    float4* dst = reinterpret_cast<float4*>(
        sums + (lane * kGvRows + r) * kGvCols + col);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  const float4* s4 = reinterpret_cast<const float4*>(sums);
  float4 v = s4[(my_r * kGvCols + my_c) / 4];
  for (int l = 1; l < kGvLanes; ++l) {
    const float4 o = s4[((l * kGvRows + my_r) * kGvCols + my_c) / 4];
    v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y),
                    __fadd_rn(v.z, o.z), __fadd_rn(v.w, o.w));
  }
  const long long tile_id = (long long)group * gridDim.x + tile;
  float4* part = reinterpret_cast<float4*>(ws) +
                 (tile_id * splits * kGvRows * kGvCols) / 4;
  part[(split * kGvRows * kGvCols + my_r * kGvCols + my_c) / 4] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    // releases the block's partials (ordered before it by the barrier),
    // acquires the other blocks' for the threads after the next barrier
    unsigned int old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(g_gemv_tickets + tile_id)
                 : "memory");
    last = old == (unsigned int)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: the S partials in split order, then bias, blend, bf16
  float4 t = __ldcg(part + (my_r * kGvCols + my_c) / 4);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 o =
        __ldcg(part + (sp * kGvRows * kGvCols + my_r * kGvCols + my_c) / 4);
    t = make_float4(__fadd_rn(t.x, o.x), __fadd_rn(t.y, o.y),
                    __fadd_rn(t.z, o.z), __fadd_rn(t.w, o.w));
  }
  if (my_r < rows && gc < F) {  // F % 8 == 0: the 4 columns are all in
    const long long o = (long long)(r0 + my_r) * F + gc;
    float vals[4] = {t.x, t.y, t.z, t.w};
    const float bs[4] = {bias4.x, bias4.y, bias4.z, bias4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vals[j] = __fadd_rn(vals[j], bs[j]);
      if (use_prev)
        vals[j] = __fadd_rn(__fmul_rn(gamma, vals[j]),
                            __fmul_rn(one_minus_gamma,
                                      __bfloat162float(prev[o + j])));
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(vals[0], vals[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(vals[2], vals[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned int*>(&lo);
    packed.y = *reinterpret_cast<unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(out + o) = packed;
  }
  if (threadIdx.x == 0) g_gemv_tickets[tile_id] = 0;  // for the next call
}

int launch_gemv(const void* x, const void* w, const void* bias,
                const void* prev, void* out, void* ws, int M, int D, int F,
                int kc, float gamma, float one_minus_gamma, int use_prev,
                cudaStream_t stream) {
  if (M < 1 || D < 8 || F < 8 || D % 8 != 0 || F % 8 != 0 || kc < 1 ||
      kc > kGvMaxK)
    return (int)cudaErrorInvalidValue;
  const int tiles = (F + kGvCols - 1) / kGvCols;
  const int splits = (D + kc - 1) / kc;
  const int groups = (M + kGvRows - 1) / kGvRows;
  if ((long long)tiles * groups > kGvMaxTickets || splits > 65535 ||
      groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, groups);
  cfg.blockDim = dim3(kGvThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, linear_blend_kernel_gemv, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(prev),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), M, D, F, kc,
      gamma, one_minus_gamma, use_prev);
  if (err != cudaSuccess) return (int)err;
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

// The gemv route: x (M, D), prev and out (M, F) bf16, w_bf16 (D, F) bf16,
// bias (F,) f32, D % 8 == 0, F % 8 == 0, every base 16-byte aligned; ws the
// (ceil(M / 4), ceil(F / 256), ceil(D / kc), 4, 256) f32 workspace, kc the
// K rows of a split (a multiple of 8, at most 2048; route.gemv_plan).
// use_prev = 0 leaves prev unread.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int linear_blend_gemv_launch(const void* x, const void* w_bf16,
                                        const void* bias, const void* prev,
                                        void* out, void* ws, int M, int D,
                                        int F, int kc, float gamma,
                                        float one_minus_gamma, int use_prev,
                                        void* stream) {
  return launch_gemv(x, w_bf16, bias, prev, out, ws, M, D, F, kc, gamma,
                     one_minus_gamma, use_prev,
                     static_cast<cudaStream_t>(stream));
}

// The gemv route's first `count` tickets (at most kGvMaxTickets) of the
// current device, copied into host memory `out`: every call leaves them at
// zero.  A synchronizing read, for tests.  Returns the CUDA error (0 =
// success).
extern "C" int linear_blend_gemv_tickets(unsigned int* out, int count) {
  if (count < 0 || count > kGvMaxTickets) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_gemv_tickets,
                                   sizeof(unsigned int) * (size_t)count, 0,
                                   cudaMemcpyDeviceToHost);
}
