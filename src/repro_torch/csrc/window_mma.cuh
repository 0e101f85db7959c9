// window_mma.cuh: the (w, w) Gram matrix of one bf16 window on the tensor
// cores, with the window left resident in shared memory for what follows.
// Shared by the "mma" routes of knn_density.cu and token_merge.cu
// (cuda_kernels/route.py:window_route); window_gram.cuh stays the f32 SIMT
// route's.
//
// Load once, all in flight.  A window h (w, D) is one contiguous chunk of
// w * D * 2 bytes.  Lane r of warp 0 issues one 1-d bulk copy of row r
// (cp.async.bulk, sm90.cuh:bulk_load), all w completing on one mbarrier, so
// the whole window is in flight at once and no thread spends a register on
// it.  Rows land at a pitch of an odd number of 16-byte units (D * 2 + 16
// or + 32 bytes): the eight row addresses of one ldmatrix phase then fall in
// eight different 16-byte bank groups.  The first 16 bytes past each row are
// zeroed, so a last k-step that holds only 8 columns (D % 16 == 8)
// multiplies zeros.
//
// Gram on the tensor cores.  mma.sync m16n8k16, bf16 in, f32 accumulate.
// For G = H H^T both operands are tiles of H: one ldmatrix.x4 of a 16 x 16
// tile gives the A fragment (rows i) and, read as the "col" operand, the B
// fragments of both 8-token halves (rows j).  The block's first kWarps
// warps split the D / 16 k-steps into kWarps ranges (9 each at D = 1152);
// each warp stores its partial 16 x 16 Gram (32 x 32 for 16 < w <= 32: two
// m-tiles) to shared memory, and the partials are added in warp order: no
// atomics, the same bits on every run.  Rows past w read a copy of row w - 1; their
// entries are never used.  A product of two bf16 values is exact in f32, so
// the Gram differs from window_gram.cuh's fmaf chain in summation order only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "window_gram.cuh"

namespace window_mma {

using window_gram::GramRow;
using window_gram::kMaxW;

constexpr int kWarps = 8;                  // warps that take the Gram
constexpr int kThreads = 32 * kWarps;      // the smallest block
constexpr int kSmemLimit = 232448;         // bytes a block may opt into
// after the rows: kWarps partial Grams of kMaxW GramRows (the first is the
// summed Gram), 4 * kMaxW words of per-token scratch, the mbarrier
constexpr int kPartBytes = kWarps * kMaxW * (kMaxW + 1) * 4;
constexpr int kScratchBytes = 4 * kMaxW * 4;
constexpr int kExtraBytes = kPartBytes + kScratchBytes + 16;  // 34,320

// Bytes between two rows: an odd number of 16-byte units, one or two of
// them padding.  cuda_kernels/route.py:window_pitch mirrors it.
__host__ __device__ constexpr int pitch_bytes(int D) {
  return ((D / 8 + 1) | 1) * 16;
}
__host__ __device__ constexpr int smem_bytes(int w, int D) {
  return w * pitch_bytes(D) + kExtraBytes;
}

struct Window {
  uint8_t* rows;    // row r of h at rows + r * pitch
  uint32_t rows_s;  // its shared-memory address
  int pitch;
  GramRow* part;    // kWarps blocks of kMaxW rows; part[0..kMaxW) = G
  int* scratch;     // 4 blocks of kMaxW words
  uint32_t bar;
};

__device__ __forceinline__ Window layout(uint8_t* smem, int w, int D) {
  Window win;
  win.rows = smem;
  win.rows_s = smem_u32(smem);
  win.pitch = pitch_bytes(D);
  uint8_t* p = smem + w * win.pitch;
  win.part = reinterpret_cast<GramRow*>(p);
  win.scratch = reinterpret_cast<int*>(p + kPartBytes);
  win.bar = smem_u32(p + kPartBytes + kScratchBytes);
  return win;
}

// Start the window's load: init the mbarrier, zero each row's first pad
// unit, publish both (a __syncthreads), then warp 0 issues the w bulk copies.
// The block may do other work before wait().  hw: the window's (w, D) rows.
__device__ __forceinline__ void begin(const Window& win,
                                      const __nv_bfloat16* hw, int w,
                                      int D) {
  if (threadIdx.x == 0) {
    mbar_init(win.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < w)
    *reinterpret_cast<uint4*>(win.rows + threadIdx.x * win.pitch + D * 2) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x < 32) {
    const uint32_t row_bytes = (uint32_t)D * 2;
    if (threadIdx.x == 0) mbar_expect_tx(win.bar, w * row_bytes);
    __syncwarp();
    if ((int)threadIdx.x < w)
      bulk_load(win.rows_s + threadIdx.x * win.pitch,
                hw + (long long)threadIdx.x * D, row_bytes, win.bar);
  }
}

__device__ __forceinline__ void wait(const Window& win) {
  mbar_wait(win.bar, 0);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp `warp`'s partial Gram over its range of k-steps, into its block of
// win.part.
template <int MT>
__device__ __forceinline__ void gram_part(const Window& win, int w, int D,
                                          int warp, int lane) {
  const int nk = (D + 15) / 16;
  const int k_lo = warp * nk / kWarps, k_hi = (warp + 1) * nk / kWarps;
  // ldmatrix.x4 addressing: lanes 0-15 give rows 0-15 at k, lanes 16-31
  // rows 0-15 at k + 8, so the four 8x8 matrices are (rows 0-7, k 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): the A fragment's order, and the
  // B fragments of tokens 0-7 (matrices 0, 2) and 8-15 (1, 3)
  uint32_t addr[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int r = min(t * 16 + (lane & 15), w - 1);
    addr[t] = win.rows_s + r * win.pitch + (lane >> 4) * 16;
  }
  float acc[MT][MT][2][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][n][e] = 0.f;
  for (int ks = k_lo; ks < k_hi; ++ks) {
    uint32_t f[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) ldsm_x4(addr[t] + ks * 32, f[t]);
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < MT; ++b) {
        mma_bf16(acc[a][b][0], f[a], f[b][0], f[b][2]);
        mma_bf16(acc[a][b][1], f[a], f[b][1], f[b][3]);
      }
  }
  // accumulator (16 x 8): c0, c1 at row lane/4, columns 2*(lane%4) + 0, 1;
  // c2, c3 eight rows below
  GramRow* mine = win.part + warp * kMaxW;
  const int r0 = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < MT; ++b)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i = a * 16 + r0, j = b * 16 + n * 8 + c0;
        mine[i][j] = acc[a][b][n][0];
        mine[i][j + 1] = acc[a][b][n][1];
        mine[i + 8][j] = acc[a][b][n][2];
        mine[i + 8][j + 1] = acc[a][b][n][3];
      }
}

// win.part[i][j] = sum_c h[i][c] * h[j][c] for i, j < 16 * MT (rows past w
// hold no meaning), by all threads of a block of at least kThreads after
// wait(); warps past kWarps join the final sum only.  Ends with a barrier:
// the caller may read the Gram and everything written before the call.
template <int MT>
__device__ __forceinline__ void gram(const Window& win, int w, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < kWarps) gram_part<MT>(win, w, D, warp, lane);
  __syncthreads();
  constexpr int kN = 16 * MT;
  for (int e = threadIdx.x; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = win.part[i][j];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) v = __fadd_rn(v, win.part[q * kMaxW + i][j]);
    win.part[i][j] = v;
  }
  __syncthreads();
}

}  // namespace window_mma
