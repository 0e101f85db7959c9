// flash_attention: causal / sliding-window / GQA attention with an online
// softmax (the prefill's full-sequence attention), on Hopper.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (Pallas, pl.pallas_call at :91).  Its
// plain twins are kernels/ref.py:flash_attention in the reference and
// cuda_kernels/ref.py:flash_attention here.  Inputs q (B, H, Sq, dh) and
// k, v (B, KVH, Skv, dh), any strides with unit stride along dh; head h reads
// KV head h / (H / KVH); Sq <= Skv, and query i sits at position
// i + (Skv - Sq), key j at j:
//
//   live(i, j) = (!causal || j <= qpos_i) && (window <= 0 || j > qpos_i - window)
//   o_i        = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp(s_ij - max_j s_ij)
//                over the live j, s_ij = (q_i . k_j) * dh^-1/2
//
// Head dims: any multiple of 16 up to 128.  Two template instances, DH = 64
// and DH = 128; a head dim dh below DH runs on the next instance up with
// columns dh..DH-1 read as zeros (the bf16 tensor maps take the true dh as
// their innermost extent, so TMA zero-fills the rest of each 64-column box;
// the f32 loads are masked), which add nothing to Q K^T, and only the dh
// true columns of O are stored.  The scale is the caller's dh^-1/2 of the
// true dh.  Dedicated instances for 80 and 112 (wgmma N = 80 / 112) would
// skip the zero columns' work; they are not written.
//
// with the running max, the denominator and the accumulator in f32, as in
// the TPU kernel, and o in q's dtype.  Both routes below give one block to
// each (b, h, tile of 64 queries), heaviest causal tiles first, and loop over
// tiles of 64 keys from the first to the last tile that holds a live key of
// the block's queries, so tiles that are wholly masked are never read.
// Masked entries get p = 0 explicitly, so a row whose first live tile is
// partly masked, or a tile wholly masked for some rows, adds nothing.  Rows
// past Sq and keys past Skv are zero-filled and masked, so any Sq and Skv
// work.  No float atomics and no split of the key range across blocks (the
// bf16 route's two warpgroups merge their halves in a fixed order): results
// repeat bitwise.
//
// bf16 route (the serving path): wgmma on bf16 tiles fed by TMA.  Two
// consumer warpgroups per block (256 threads) split the block's key tiles,
// warpgroup w taking tiles w, w + 2, ..., so the causal diagonal's longest
// blocks run half as many tiles in sequence and one warpgroup's softmax
// overlaps the other's products.  Loads are TMA copies
// (cp.async.bulk.tensor) over 4-d tensor maps (dh, S, heads, B) built from
// the caller's strides: boxes of 64 rows x 64 elements with 128-byte
// swizzle, rows past S zero-filled by the copy.  One elected thread per
// warpgroup issues them (no producer warp, so no setmaxnreg: 256 threads
// take ~170 registers each) into the warpgroup's own ring of two K/V stages,
// each completing an mbarrier; while a warpgroup works on one tile the next
// is in flight, and a stage is refilled as soon as both products have read
// it.  S = Q K^T is wgmma m64n64k16 with Q (A) and K (B) read from shared
// memory, both K-major (dh contiguous); the f32 scores stay in the
// accumulator registers, where a row is spread over the four threads of a
// quad (max and sum: two xor shuffles).  The softmax runs in the log2
// domain, p = 2^(s dh^-1/2 log2(e) - m), one FFMA and one ex2.approx per
// score; the causal and window masks are evaluated only on tiles that
// straddle a boundary.  P is rounded to bf16 in registers and used as the
// register A operand of O += P V (wgmma m64nDHk16): the accumulator
// fragment of S lands, pair by pair, on the A fragment of the k16 slices,
// as in FlashAttention-3; V is the B operand in MN-major order (the
// descriptor's transpose bit).  Rounding P to bf16 departs from the TPU
// kernel, which keeps p in f32; the reference's own model attention rounds
// it the same way (src/repro/models/attention.py:69 and :114,
// p.astype(v.dtype)), and the result stays within the 2e-2 that bf16 is
// held to.  At the end warpgroup 1 hands its (max, denominator,
// accumulator) to warpgroup 0 through shared memory, which merges the two
// in that fixed order, so results still repeat bitwise.  The output tile
// is staged in Q's place in the swizzled layout and written by a TMA store,
// which drops rows past Sq.  Shared memory: Q, two rings of two K/V stages
// and the hand-over, 179 KB at dh = 128 and 91 KB at dh = 64, one block
// per SM.
//
// f32 route: the products cannot go to the tensor cores, since TF32 or bf16
// would miss the 2e-5 that f32 is held to (the reference's tolerance), and
// nothing on the serving path runs f32.  It keeps the SIMT kernel: Q, K and
// V tiles staged in f32 shared memory (113 KB at dh = 128, 65 KB at dh = 64),
// thread (ty, tx) owning rows 4ty..4ty+3 and columns tx + 8j of the score
// tile, f32 FMAs, p kept in f32 as in the TPU kernel.
//
// Position mode (both routes; a second template instance of each kernel,
// kPos): the caller passes int32 positions q_pos (B, Sq) and kv_pos (B, Skv)
// with their strides (a zero batch stride broadcasts one row), any Sq and
// Skv, and the mask is the reference's `_mask` (src/repro/models/
// attention.py:36-48):
//
//   live(i, j) = kv_pos_j >= 0 && (!causal || kv_pos_j <= q_pos_i)
//                && (window <= 0 || kv_pos_j > q_pos_i - window)
//
// Key tiles are not a range any more: a tile is skipped only when no pair
// of it and the block's query tile can be live, which each block finds
// itself from the positions (no host read): no key with kv_pos >= 0, or
// min(kv_pos >= 0 in tile) > max(q_pos in tile) under causal, or max(kv_pos
// in tile) <= min(q_pos in tile) - window under a window.  The bf16 route
// lists the live tiles in shared memory before its loop (one warp tests a
// tile, warp 0 compacts the flags in order), and its warpgroups take the
// list's entries w, w + 2, ...; the f32 route tests each tile in turn.
// Every entry of a visited tile is masked by the positions (each thread
// holds its rows' q positions and loads its 16 key positions of a tile
// while the tile's copy is in flight).  With q_pos = i + Skv - Sq and
// kv_pos = j the live tiles are the implicit mode's range in the same
// order and the masked softmax step equals the unmasked one on live
// entries, so position mode then gives the implicit mode's result bit for
// bit.  A row with no live key (a layout the model never makes: a token's
// own key is live, tests/test_torch_positions.py) takes the uniform mean
// of all Skv values, as the reference's `attend_direct` gives it (its
// softmax over a row of -1e30): the epilogue finds the row's denominator
// at 0 and sums V from device memory, so the rare row costs Skv reads.
// Without positions (the null pointers) the implicit instances run as
// before, with no extra load.
//
// Bound at the serve's prefill (B=1, H=16, KVH=8, S=512, dh=128, causal,
// bf16): q, k, v read and o written once is 6.29 MB, 1.88 us at 3.35 TB/s;
// the causal work is 4 * dh * 16 * 512 * 513 / 2 = 1.08 GFLOP, 1.09 us on
// the bf16 tensor cores (989 TFLOP/s) or 16.1 us at 67 TFLOP/s of f32 SIMT.
// So the bound is 1.88 us, set by bytes.  What keeps the wgmma route above
// it there is latency, not throughput: 128 blocks on 132 SMs, the longest
// running 4 key tiles per warpgroup, each tile a chain of S product, wait,
// softmax, P V product and wait, plus ~1 us of prologue (parameters, tensor
// maps, the first copies) and ~1 us of epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // TMA, mbarriers, wgmma helpers, the tensor-map encoder

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // f32 route: 16 row groups x 8 column lanes
constexpr float kNegInf = -1e30f;

// What the masks and the tile range read; both routes' parameters extend it.
// Position mode reads qpos / kvpos (element strides: batch, sequence).
struct Shape {
  int Sq, Skv, group, causal, window;
  const int* qpos;
  const int* kvpos;
  long long qpb, qps, kpb, kps;
};

struct Params : Shape {
  int dh;       // the true head dim, <= the instance's DH
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// The block's query tile and its live key range [k_lo, k_hi).
struct Tile {
  int q0, nq, qlo, k_lo, k_hi;
  __device__ explicit Tile(const Shape& p) {
    q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
    nq = min(kBQ, p.Sq - q0);
    qlo = p.Skv - p.Sq + q0;                  // position of query row 0
    k_lo = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
    k_hi = p.causal ? min(p.Skv, qlo + nq) : p.Skv;
  }
};

__device__ __forceinline__ bool live(const Shape& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// Position mode: the reference's mask on explicit positions (keys past Skv
// carry kv position -1).
__device__ __forceinline__ bool live_pos(const Shape& p, int qpos, int kpos) {
  return kpos >= 0 && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

__device__ __forceinline__ int q_position(const Shape& p, int b, int row) {
  return row < p.Sq ? __ldg(p.qpos + b * p.qpb + row * p.qps) : -1;
}

__device__ __forceinline__ int kv_position(const Shape& p, int b, int key) {
  return key < p.Skv ? __ldg(p.kvpos + b * p.kpb + key * p.kps) : -1;
}

// Whether some pair of query positions in [qmin, qmax] and live key
// positions in [kmin, kmax] (kmax < 0: no key with a position) can be live.
__device__ __forceinline__ bool tile_may_live(const Shape& p, int qmin,
                                              int qmax, int kmin, int kmax) {
  return kmax >= 0 && (!p.causal || kmin <= qmax) &&
         (p.window <= 0 || kmax > qmin - p.window);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;

// ---------------------------------------------------------------------------
// f32 route: SIMT products from shared memory
// ---------------------------------------------------------------------------

// A 64 x DH f32 tile of `src` (row stride `rs` elements, 16-byte aligned
// rows of `dh` <= DH elements, dh a multiple of 4) into shared memory with
// row pitch `pitch`; rows at or past `nvalid` and columns at or past `dh`
// are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long rs,
                                          int nvalid, int dh) {
  constexpr int kPerRow = DH / 4;
  for (int idx = threadIdx.x; idx < kBQ * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    const float4 x = r < nvalid && c < dh
                         ? *reinterpret_cast<const float4*>(src + r * rs + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + r * pitch + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

__device__ __forceinline__ float lane8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float lane8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int DH, bool kPos>
constexpr size_t simt_smem_bytes() {
  // Q and K at pitch DH + 1, V at DH, P at kBK + 1; position mode: the
  // query tile's and the key tile's positions
  return sizeof(float) *
             (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH +
                      kBQ * (kBK + 1)) +
         (kPos ? sizeof(int) * (kBQ + kBK) : 0);
}

template <int DH, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_simt(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, Params p) {
  constexpr int kQP = DH + 1;  // row-varying reads of Q and K: distinct banks
  constexpr int kPP = kBK + 1;
  constexpr int kCols = DH / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kQP;
  float* Vs = Ks + kBK * kQP;
  float* Ps = Vs + kBK * DH;
  int* Qp = reinterpret_cast<int*>(Ps + kBQ * kPP);  // position mode only
  int* Kp = Qp + kBQ;

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const Tile t(p);
  const int kvh = h / p.group;
  const float* kp = k + b * p.kb + kvh * p.kh;
  const float* vp = v + b * p.vb + kvh * p.vh;

  load_tile<DH>(Qs, kQP, q + b * p.qb + h * p.qh + t.q0 * p.qs, p.qs, t.nq,
                p.dh);
  int qmin = 0, qmax = 0;
  if constexpr (kPos) {
    if (threadIdx.x < kBQ) Qp[threadIdx.x] = q_position(p, b, t.q0 + threadIdx.x);
    __syncthreads();
    qmin = kIntMax;
    qmax = kIntMin;
    for (int r = 0; r < t.nq; ++r) {
      qmin = min(qmin, Qp[r]);
      qmax = max(qmax, Qp[r]);
    }
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int k_first = kPos ? 0 : (t.k_lo / kBK) * kBK;
  const int k_end = kPos ? p.Skv : t.k_hi;
  for (int k0 = k_first; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, p.Skv - k0);
    __syncthreads();  // Q is staged; the last tile's P and V are consumed
    if constexpr (kPos) {
      if (threadIdx.x < kBK) Kp[threadIdx.x] = kv_position(p, b, k0 + threadIdx.x);
      __syncthreads();
      int kmin = kIntMax, kmax = -1;
      for (int j = 0; j < kBK; ++j)
        if (Kp[j] >= 0) {
          kmin = min(kmin, Kp[j]);
          kmax = max(kmax, Kp[j]);
        }
      if (!tile_may_live(p, qmin, qmax, kmin, kmax)) continue;  // uniform
    }
    load_tile<DH>(Ks, kQP, kp + k0 * p.ks, p.ks, nk, p.dh);
    load_tile<DH>(Vs, DH, vp + k0 * p.vs, p.vs, nk, p.dh);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * kQP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * kQP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = kPos ? Qp[4 * ty + i] : t.qlo + 4 * ty + i;
      unsigned ok = 0;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool lj = kPos ? live_pos(p, qpos, Kp[tx + 8 * j])
                             : live(p, qpos, k0 + tx + 8 * j);
        s[i][j] = lj ? s[i][j] * p.scale : kNegInf;
        ok |= (unsigned)lj << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = lane8_max(mx);
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (ok >> j) & 1u ? expf(s[i][j] - mx) : 0.f;
        Ps[(4 * ty + i) * kPP + tx + 8 * j] = pj;
        ls += pj;
      }
      l[i] = l[i] * corr + ls;  // this lane's share; summed at the end
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * DH + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float den = fmaxf(lane8_sum(l[i]), 1e-30f);
    const int r = 4 * ty + i;
    if (r < t.nq) {
      if (kPos && den == 1e-30f) {  // no live key: the mean of all values
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
        for (int j = 0; j < p.Skv; ++j)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (tx + 8 * c < p.dh) acc[i][c] += vp[j * p.vs + tx + 8 * c];
        den = (float)p.Skv;
      }
      float* orow = o + b * p.ob + h * p.oh + (t.q0 + r) * p.os;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (tx + 8 * c < p.dh) orow[tx + 8 * c] = acc[i][c] / den;
    }
  }
}

template <int DH, bool kPos>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int H, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = simt_smem_bytes<DH, kPos>();
  static bool opted_in = false;  // per instance; a repeated call is harmless
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_simt<DH, kPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel_simt<DH, kPos><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;  // warpgroups, each on half the key tiles
constexpr int kWgThreads = 128 * kConsumers;
constexpr int kStages = 2;              // K/V ring of each warpgroup
constexpr int kBox = 64;                // TMA box: 64 rows x 64 bf16 (128 B)
constexpr uint32_t kBoxBytes = kBox * kBox * 2;
constexpr uint32_t kSwizzleAtom = 8 * 128;  // 8 rows of 128 B
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;     // a block's dynamic shared memory

template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (DH / kBox) * kBoxBytes;
}

template <int DH>
constexpr size_t wgmma_smem_bytes() {
  // 1 KB of slack to align the swizzled tiles, Q, two K/V rings, the
  // hand-over of warpgroup 1's state, an mbarrier per stage plus Q's
  return 1024 + (size_t)tile_bytes<DH>() * (1 + 2 * kConsumers * kStages) +
         4 * (DH / 2 + 4) * 128 +
         8 * (kConsumers * kStages + 1);
}

struct WgmmaParams : Shape {
  float scale_log2;  // dh^-1/2 * log2(e)
  int dh;            // position mode's rows with no live key read V itself
  const __nv_bfloat16* v;
  long long vb, vh, vs;
};

// D (64 x 64, f32) {+}= A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (64 x 16, smem,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// 2^x on the SFU (ex2.approx.ftz: 2 ulp, flushes denormals); 2^(-1e29) is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on the scores in `sc` (an m64n64 f32
// accumulator), in the log2 domain: the running max m (already scaled by
// dh^-1/2 log2 e) and this thread's share of the denominator l per row, the
// accumulator o rescaled, and sc overwritten with p.  kMasked: the tile
// straddles a mask boundary, so every entry is tested and masked ones get
// p = 0 explicitly.  kPos: the mask reads the thread's two rows' query
// positions qp and its 16 columns' key positions kp (position mode), not
// qpos0 / kpos0.
template <int DH, bool kMasked, bool kPos = false>
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[DH / 2],
                                             const WgmmaParams& wp, int qpos0,
                                             int kpos0, const int (&qp)[2],
                                             const int (&kp)[16]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qpos0 + 8 * half;
    unsigned ok = 0xffffu;
    float mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float& x = sc[4 * (e / 2) + 2 * half + (e % 2)];
      const bool lv = kPos ? live_pos(wp, qp[half], kp[e])
                           : live(wp, qpos, kpos0 + 8 * (e / 2) + (e % 2));
      if (kMasked && !lv) {
        x = kNegInf;
        ok &= ~(1u << e);
      }
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx * wp.scale_log2);
    const float corr = ex2(m[half] - m_new);
    m[half] = m_new;
    float ls = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float& x = sc[4 * (e / 2) + 2 * half + (e % 2)];
      x = ex2(fmaf(x, wp.scale_log2, -m_new));
      if (kMasked && !((ok >> e) & 1u)) x = 0.f;
      ls += x;
    }
    l[half] = l[half] * corr + ls;  // this thread's share; summed at the end
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      o[4 * c + 2 * half] *= corr;
      o[4 * c + 2 * half + 1] *= corr;
    }
  }
}

// Thread t of a warpgroup holds, in an m64nN f32 accumulator, rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, columns 8 j + 2 (t % 4) + e:
// element 4 j + 2 half + e, half 0 for r0 and 1 for r0 + 8.  Consumer
// warpgroup w takes the block's key tiles w, w + 2, ... through its own
// ring; at the end warpgroup 1 hands its (max, denominator,
// accumulator) to warpgroup 0 through shared memory, thread t to thread t,
// and warpgroup 0 merges the two in that fixed order.  The output tile is
// staged in Q's place in the swizzled box layout and written by TMA, which
// drops the rows past Sq.  kPos: position mode (see the top of the file);
// the live key tiles' list follows the mbarriers in shared memory.
template <int DH, bool kPos>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap omap,
                             const WgmmaParams wp) {
  constexpr int kChunks = DH / kBox;
  constexpr uint32_t kTile = tile_bytes<DH>();
  constexpr int kX = DH / 2 + 4;  // values handed over per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t rings = kTile * (1 + 2 * kConsumers * kStages);
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + rings);
  const uint32_t bars = base + rings + 4 * kX * 128;
  const uint32_t q_bar = bars + 8 * kConsumers * kStages;

  // position mode: [0, 4) the query tile's min / max position by warp,
  // [4] the live tile count, then the list of live key tiles
  int* list = reinterpret_cast<int*>(
      smem_raw + (q_bar + 8 - raw));
  int* live_tiles = list + 8;

  const Tile t(wp);
  const int tid = threadIdx.x % 128;  // thread within its warpgroup
  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / wp.group;
  const int kt0 = t.k_lo / kBK;
  int ntiles = (t.k_hi - kt0 * kBK + kBK - 1) / kBK;
  const uint32_t my_bars = bars + 8 * kStages * wg;
  // the key tile of this warpgroup's i-th tile
  auto tile_of = [&](int i) {
    return kPos ? live_tiles[wg + kConsumers * i] : kt0 + wg + kConsumers * i;
  };
  // stage s of this warpgroup's ring: K at k_s(s), V at k_s(s) + kTile
  auto k_s = [&](int s) {
    return base + kTile * (1 + 2 * (wg * kStages + s));
  };
  auto load_kv = [&](int s, int i) {  // this warpgroup's i-th tile
    const uint32_t bar = my_bars + 8 * s;
    const int row = tile_of(i) * kBK;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(k_s(s) + c * kBoxBytes, &kmap, bar, c * kBox, row, kvh, b);
      tma_load(k_s(s) + kTile + c * kBoxBytes, &vmap, bar, c * kBox, row,
               kvh, b);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kStages + 1; ++i)
      mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, kTile);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load(base + c * kBoxBytes, &qmap, q_bar, c * kBox, t.q0, h, b);
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  int qp[2] = {0, 0};
  if constexpr (kPos) {
    // the query tile's position range (warps 0 and 1 of warpgroup 0 hold
    // its 64 rows), then one flag per key tile (warp w tests tiles w, w +
    // 8, ...), then warp 0 compacts the flags into the ordered list
    const int gw = threadIdx.x >> 5;  // warp in the block
    if (gw < 2) {
      const int row = t.q0 + threadIdx.x;
      const int qv = q_position(wp, b, row);
      const int lo = warp_min(row < wp.Sq ? qv : kIntMax);
      const int hi = warp_max(row < wp.Sq ? qv : kIntMin);
      if (lane == 0) {
        list[2 * gw] = lo;
        list[2 * gw + 1] = hi;
      }
    }
    __syncthreads();
    const int qmin = min(list[0], list[2]), qmax = max(list[1], list[3]);
    const int n_kt = (wp.Skv + kBK - 1) / kBK;
    for (int j = gw; j < n_kt; j += kWgThreads / 32) {
      const int k0 = j * kBK + lane;
      const int a = kv_position(wp, b, k0), c = kv_position(wp, b, k0 + 32);
      const int kmin = warp_min(min(a >= 0 ? a : kIntMax, c >= 0 ? c : kIntMax));
      const int kmax = warp_max(max(a, c));
      if (lane == 0)
        live_tiles[j] = tile_may_live(wp, qmin, qmax, kmin, kmax) ? 1 : 0;
    }
    __syncthreads();
    if (gw == 0) {
      int count = 0;
      for (int c = 0; c < n_kt; c += 32) {
        const int j = c + lane;
        const bool f = j < n_kt && live_tiles[j] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, f);
        __syncwarp();  // every flag of the chunk is read before any write
        if (f) live_tiles[count + __popc(ballot & ((1u << lane) - 1u))] = j;
        count += __popc(ballot);
        __syncwarp();
      }
      if (lane == 0) list[4] = count;
    }
    __syncthreads();
    ntiles = list[4];
  }
  const int mine = (ntiles - wg + kConsumers - 1) / kConsumers;
  if (tid == 0)
    for (int s = 0; s < kStages && s < mine; ++s) load_kv(s, s);

  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int qhi = t.qlo + kBQ - 1;  // last row's position, padding included
  if constexpr (kPos) {
    qp[0] = q_position(wp, b, t.q0 + r0);
    qp[1] = q_position(wp, b, t.q0 + r0 + 8);
  }
  float o[DH / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) o[e] = 0.f;
  mbar_wait(q_bar, 0);

  for (int i = 0; i < mine; ++i) {
    const int s = i % kStages;
    const int k0 = tile_of(i) * kBK;
    int kp[16];  // position mode: this thread's 16 key positions
#pragma unroll
    for (int e = 0; e < 16; ++e)
      kp[e] = kPos ? kv_position(wp, b, k0 + c0 + 8 * (e / 2) + (e % 2)) : 0;
    mbar_wait(my_bars + 8 * s, (i / kStages) & 1);

    // S = Q K^T: dh in k16 slices, 32 bytes apart inside a swizzled row
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(base + off, 16, kSwizzleAtom),
                   sw128_desc(k_s(s) + off, 16, kSwizzleAtom), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // masks only on tiles that straddle a boundary (every tile in position
    // mode)
    const bool whole = !kPos && k0 + kBK <= wp.Skv &&
                       (!wp.causal || k0 + kBK - 1 <= t.qlo) &&
                       (wp.window <= 0 || k0 > qhi - wp.window);
    if (whole)
      softmax_step<DH, false>(sc, m, l, o, wp, t.qlo + r0, k0 + c0, qp, kp);
    else
      softmax_step<DH, true, kPos>(sc, m, l, o, wp, t.qlo + r0, k0 + c0, qp,
                                   kp);

    // O += P V: P's accumulator pairs are the A fragments of the k16 slices
    // (keys 16 kk .. 16 kk + 15); V MN-major, k16 slices 16 rows apart,
    // 64-column chunks a box apart
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<DH>(o, pa[kk],
                   sw128_desc(k_s(s) + kTile + kk * 16 * 128, kBoxBytes,
                              kSwizzleAtom));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);

    bar_sync(1 + wg, 128);  // the warpgroup's products have read stage s
    if (tid == 0 && i + kStages < mine) load_kv(s, i + kStages);
  }

  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) xch[e * 128 + tid] = o[e];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      xch[(DH / 2 + half) * 128 + tid] = m[half];
      xch[(DH / 2 + 2 + half) * 128 + tid] = l[half];
    }
    bar_arrive(3, kWgThreads);
    return;
  }
  bar_sync(3, kWgThreads);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float m1 = xch[(DH / 2 + half) * 128 + tid];
    const float mx = fmaxf(m[half], m1);
    const float c_own = ex2(m[half] - mx), c_other = ex2(m1 - mx);
    const float l1 = xch[(DH / 2 + 2 + half) * 128 + tid];
    l[half] = l[half] * c_own + l1 * c_other;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * c + 2 * half + e;
        o[idx] = o[idx] * c_own + xch[idx * 128 + tid] * c_other;
      }
  }

  // o / l in bf16 into Q's place (the swizzled box layout: 16-byte group g
  // of row r at g ^ (r % 8)), then one TMA store per 64-column chunk
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float den = l[half];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    float inv = 1.f / fmaxf(den, 1e-30f);
    const int r = r0 + 8 * half;
    if (kPos && den == 0.f && t.q0 + r < wp.Sq) {
      // no live key: the mean of all Skv values, summed in f32
      const __nv_bfloat16* vrow = wp.v + b * wp.vb + kvh * wp.vh;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * c + c0 + e;
          float acc = 0.f;
          if (col < wp.dh)
            for (int j = 0; j < wp.Skv; ++j)
              acc += __bfloat162float(vrow[j * wp.vs + col]);
          o[4 * c + 2 * half + e] = acc;
        }
      inv = 1.f / (float)wp.Skv;
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const uint32_t addr = base + (c / 8) * kBoxBytes + r * 128 +
                            (((c % 8) ^ (r % 8)) << 4) + 2 * c0;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                   "r"(pack_bf16(o[4 * c + 2 * half] * inv,
                                 o[4 * c + 2 * half + 1] * inv))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
          "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&omap)),
          "r"(base + c * kBoxBytes), "r"(c * kBox), "r"(t.q0), "r"(h),
          "r"(b)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A bf16 tensor (B, heads, S, dh) with element strides (bs, hs, ss, 1) as a
// 4-d tensor map (dh, S, heads, B) of 64 x 64 boxes, 128-byte swizzle.  A
// dimension of extent 1 gets a nominal stride (TMA wants nonzero multiples
// of 16 bytes, and never uses it).  The innermost extent is the true dh:
// a load fills the box's columns past it with zeros (and still completes
// the whole box's bytes on the mbarrier), a store drops them.
bool encode_map(CUtensorMap* map, const void* ptr, int dh, int S, int heads,
                int B, long long ss, long long hs, long long bs) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = 2ull * dh;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? 2ull * ss : row,
                                 heads > 1 ? 2ull * hs : row,
                                 B > 1 ? 2ull * bs : row};
  const cuuint32_t box[4] = {kBox, kBox, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool kPos>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int KVH, const Params& p, cudaStream_t stream) {
  // position mode: the query range, the count and a flag / entry per key
  // tile after the mbarriers
  const size_t smem =
      wgmma_smem_bytes<DH>() +
      (kPos ? sizeof(int) * (8 + (size_t)(p.Skv + kBK - 1) / kBK) : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t opted_in = 0;  // per instance; a repeated call is harmless
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_wgmma<DH, kPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  CUtensorMap qmap, kmap, vmap, omap;
  if (!encode_map(&qmap, q, p.dh, p.Sq, H, B, p.qs, p.qh, p.qb) ||
      !encode_map(&kmap, k, p.dh, p.Skv, KVH, B, p.ks, p.kh, p.kb) ||
      !encode_map(&vmap, v, p.dh, p.Skv, KVH, B, p.vs, p.vh, p.vb) ||
      !encode_map(&omap, o, p.dh, p.Sq, H, B, p.os, p.oh, p.ob))
    return (int)cudaErrorInvalidValue;
  WgmmaParams wp;
  static_cast<Shape&>(wp) = p;
  wp.scale_log2 = p.scale * kLog2e;
  wp.dh = p.dh;
  wp.v = static_cast<const __nv_bfloat16*>(v);
  wp.vb = p.vb;
  wp.vh = p.vh;
  wp.vs = p.vs;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel_wgmma<DH, kPos>
      <<<grid, kWgThreads, smem, stream>>>(qmap, kmap, vmap, omap, wp);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KVH, Skv, dh), o (B, H, Sq, dh), all of one
// dtype (dtype_code 0 = float32: the SIMT kernel; 1 = bfloat16: the wgmma
// kernel), with the given element strides along (batch, head, sequence),
// unit stride along dh, and 16-byte aligned rows (bf16: nonzero strides
// along every dimension of extent > 1, for the tensor maps).  Needs
// H % KVH == 0, 1 <= Sq <= Skv and dh a multiple of 16 in [16, 128]
// (instance 64 up to 64, else 128).  `scale` is dh^-1/2
// rounded to f32 by the caller, as the plain version's f32 product with the
// Python float rounds it.  q_pos / kv_pos: null for the implicit positions,
// or int32 (B, Sq) / (B, Skv) positions with element strides (qpb, qps) /
// (kpb, kps) for position mode, which takes any Sq >= 1.  Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int Skv, int dh, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int window, float scale, int dtype_code,
    const void* q_pos, const void* kv_pos, long long qpb, long long qps,
    long long kpb, long long kps, void* stream) {
  const bool pos = q_pos != nullptr;
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Skv < 1 ||
      (!pos && Sq > Skv) || pos != (kv_pos != nullptr) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = H / KVH;
  p.causal = causal != 0;
  p.window = window;
  p.dh = dh;
  p.scale = scale;
  p.qb = qb; p.qh = qh; p.qs = qs;
  p.kb = kb; p.kh = kh; p.ks = ks;
  p.vb = vb; p.vh = vh; p.vs = vs;
  p.ob = ob; p.oh = oh; p.os = os;
  p.qpos = static_cast<const int*>(q_pos);
  p.kvpos = static_cast<const int*>(kv_pos);
  p.qpb = qpb; p.qps = qps; p.kpb = kpb; p.kps = kps;
  if (dh < 16 || dh > 128 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 64;
  if (dtype_code == 1) {
    if (pos)
      return wide ? launch_wgmma<128, true>(q, k, v, o, B, H, KVH, p, s)
                  : launch_wgmma<64, true>(q, k, v, o, B, H, KVH, p, s);
    return wide ? launch_wgmma<128, false>(q, k, v, o, B, H, KVH, p, s)
                : launch_wgmma<64, false>(q, k, v, o, B, H, KVH, p, s);
  }
  if (dtype_code == 0) {
    if (pos)
      return wide ? launch_simt<128, true>(q, k, v, o, B, H, p, s)
                  : launch_simt<64, true>(q, k, v, o, B, H, p, s);
    return wide ? launch_simt<128, false>(q, k, v, o, B, H, p, s)
                : launch_simt<64, false>(q, k, v, o, B, H, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
