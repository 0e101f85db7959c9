// tc_gemm.cuh: the bf16 tensor-core GEMM core of the wgmma routes of
// linear_blend.cu (B6) and fused_gate.cu (B1), on Hopper (sm_90a).
//
// A block owns a BM x BN tile of out = epilogue(A W), BM = 64 rows per
// consumer warpgroup, with A (rows, K) bf16, K contiguous, and W (K, N) bf16,
// N contiguous.  K is walked in chunks of 64, one 128-byte swizzled row of
// bf16, through a ring of kStages stages.  A stage holds the A chunk (BM x 64,
// K-major, as Q in flash_attention.cu) and the W chunk (64 x BN in BN / 64
// boxes of 64 x 64, N contiguous, read MN-major through the descriptor's
// transpose bit, as V there), both copied by TMA with the 128-byte swizzle.
// One thread of a producer warp issues the copies: for each chunk it waits on
// the stage's "empty" barrier (every consumer warpgroup arrives on it once its
// products have read the stage), expects the stage's bytes on its "full"
// barrier and starts the copies.  Each consumer warpgroup waits on "full",
// issues four wgmma m64nBNk16 (one per k16 slice, 32 bytes apart in the
// swizzled row), commits, and waits until only this chunk's group is in
// flight, so the next chunk's products queue behind the current ones; then it
// releases the stage of the chunk before.  The f32 accumulators stay in
// registers (BN / 2 per thread), and every output sums its K products in one
// fixed order (chunk by chunk, no split of K across blocks, no atomics), so
// results repeat bitwise.  Rows past the matrix and K past its end are
// zero-filled by the copies; W boxes wholly past N are not copied (their
// columns are never stored, and a column of the product depends on its own
// column of W alone).  The epilogue adds the f32 bias, blends with prev when
// asked (prev is not read otherwise) and rounds to bf16 with
// __float2bfloat16_rn semantics, element by element as the SIMT kernels do.
//
// The split routes (wgmma_split) run the same core over W split into bf16
// terms stacked along K, [W_hi; W_mid; W_lo], each padded with zero rows to
// Kp = nk * 64 rows (cuda_kernels/route.py: split_rows): the producer walks
// terms * nk chunks of W and meets chunk i with A's chunk i % nk, so the
// consumers sum X W_hi, then X W_mid, then X W_lo into the same
// accumulators, in one fixed order.  Without the padding, a K that is not a
// multiple of 64 would put a term's first rows into the last chunk of the
// term before it.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int kTcChunk = 64;              // K per stage: 128 bytes of bf16
constexpr uint32_t kTcBox = 64 * 128;     // one 64 x 64 bf16 box
constexpr uint32_t kTcAtom = 8 * 128;     // swizzle atom: 8 rows of 128 B

template <int kWG, int BN, int kStages>
struct TcGemm {
  static_assert(BN % 64 == 0 && BN <= 256, "whole W boxes, wgmma's N");
  static constexpr int BM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG + 32;  // + the producer warp
  static constexpr int kAcc = BN / 2;              // f32 per consumer thread
  static constexpr uint32_t kABytes = BM * 128;
  static constexpr uint32_t kStageBytes = kABytes + (BN / 64) * kTcBox;
  // 1 KB of slack to align the swizzled ring, the ring, two barriers a stage
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

// The ring in a block's dynamic shared memory: stage s at base + s *
// kStageBytes (A, then the W boxes), then the full and the empty barriers.
struct TcRing {
  uint32_t base, full, empty;
};

template <int kWG, int BN, int kStages>
__device__ __forceinline__ TcRing tc_ring(uint8_t* smem_raw) {
  using G = TcGemm<kWG, BN, kStages>;
  TcRing r;
  r.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  r.full = r.base + kStages * G::kStageBytes;
  r.empty = r.full + 8 * kStages;
  return r;
}

// By one thread, before the block's __syncthreads.
template <int kWG, int kStages>
__device__ __forceinline__ void tc_init(const TcRing& r) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, kWG);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread: nk chunks of W columns [n0, n0 + BN) (a 2-d map: N,
// K), with n_cols the extent of N, chunk i of W beside chunk i % a_chunks of
// A rows [a_row, a_row + BM) of slab a_batch (a 3-d map: K, rows, slabs):
// a_chunks = nk, or nk / terms for a split W.
template <int kWG, int BN, int kStages>
__device__ __forceinline__ void tc_produce(const TcRing& r,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* wmap, int a_row,
                                           int a_batch, int n0, int n_cols,
                                           int nk, int a_chunks) {
  using G = TcGemm<kWG, BN, kStages>;
  const int boxes = min(BN / 64, (n_cols - n0 + 63) / 64);
  const uint32_t bytes = G::kABytes + boxes * kTcBox;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(r.empty + 8 * s, (i / kStages - 1) & 1);
    const uint32_t a = r.base + s * G::kStageBytes;
    const uint32_t bar = r.full + 8 * s;
    mbar_expect_tx(bar, bytes);
    tma_load_3d(a, amap, bar, (i % a_chunks) * kTcChunk, a_row, a_batch);
    for (int c = 0; c < boxes; ++c)
      tma_load_2d(a + G::kABytes + c * kTcBox, wmap, bar, n0 + 64 * c,
                  i * kTcChunk);
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_tb(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tb<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  wgmma_ss_tb_n64(d, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_tb<192>(float (&d)[96], uint64_t da,
                                              uint64_t db) {
  wgmma_ss_tb_n192(d, da, db, 1);
}

// Consumer warpgroup wg (thread tid of it): acc = its 64 rows of A times the
// block's BN columns of W, over nk chunks.
template <int kWG, int BN, int kStages>
__device__ __forceinline__ void tc_consume(const TcRing& r,
                                           float (&acc)[BN / 2], int wg,
                                           int tid, int nk) {
  using G = TcGemm<kWG, BN, kStages>;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(r.full + 8 * s, (i / kStages) & 1);
    const uint32_t a = r.base + s * G::kStageBytes + wg * 64 * 128;
    const uint32_t w = r.base + s * G::kStageBytes + G::kABytes;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcChunk / 16; ++kk)
      wgmma_tb<BN>(acc, sw128_desc(a + kk * 32, 16, kTcAtom),
                   sw128_desc(w + kk * 16 * 128, kTcBox, kTcAtom));
    wgmma_commit();
    wgmma_wait<1>();  // chunk i - 1's products are done with their stage
    pin(acc);
    if (i > 0 && tid == 0) mbar_arrive(r.empty + 8 * ((i - 1) % kStages));
  }
  wgmma_wait<0>();
  pin(acc);
}

// The epilogue of one consumer thread: thread t of a warpgroup holds rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 of the warpgroup's 64, columns
// 8 j + 2 (t % 4) + e, in acc[4 j + 2 half + e].  out and prev are (rows, n)
// row-major with n % 8 == 0 (so a column pair is whole and 4-byte aligned);
// bias is (n,) f32.
template <int BN>
__device__ __forceinline__ void tc_store(const float (&acc)[BN / 2],
                                         __nv_bfloat16* __restrict__ out,
                                         const __nv_bfloat16* __restrict__ prev,
                                         const float* __restrict__ bias,
                                         int m0, int rows, int n0, int n,
                                         float gamma, float one_minus_gamma,
                                         int use_prev, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = m0 + 16 * warp + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= n) continue;
      const long long o = (long long)r * n + c;
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      float v0 = __fadd_rn(acc[4 * j + 2 * half], bb.x);
      float v1 = __fadd_rn(acc[4 * j + 2 * half + 1], bb.y);
      if (use_prev) {
        const __nv_bfloat162 p =
            *reinterpret_cast<const __nv_bfloat162*>(prev + o);
        v0 = __fadd_rn(__fmul_rn(gamma, v0),
                       __fmul_rn(one_minus_gamma, __low2float(p)));
        v1 = __fadd_rn(__fmul_rn(gamma, v1),
                       __fmul_rn(one_minus_gamma, __high2float(p)));
      }
      *reinterpret_cast<__nv_bfloat162*>(out + o) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// A bf16 (batch, rows, cols) array, cols contiguous, as a 3-d tensor map
// (cols, rows, batch) of boxes 64 x box_rows x 1; with cols % 8 == 0 every
// stride is a multiple of 16 bytes, as TMA needs.
inline bool tc_map_3d(CUtensorMap* map, const void* ptr, int cols, int rows,
                      int batch, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 (rows, cols) matrix, cols contiguous, as a 2-d tensor map (cols,
// rows) of 64 x 64 boxes.
inline bool tc_map_2d(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * cols};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lift a kernel's dynamic shared memory limit to `bytes`, once per kernel.
template <typename Kernel>
inline int tc_opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

}  // namespace
