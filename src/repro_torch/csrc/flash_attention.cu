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
// with scores, p, the running max, the denominator and the accumulator in
// f32, as in the TPU kernel, and o in q's dtype.
//
// Design.  One block of 128 threads per (b, h, tile of 64 queries); the
// heaviest causal tiles are scheduled first.  The block loops over tiles of
// 64 keys from the first to the last tile that holds a live key of its
// queries, so tiles that are wholly masked are never read.  Q, K and V tiles
// are staged in shared memory in f32 (dynamic shared memory: 113 KB at
// dh = 128, 65 KB at dh = 64, over the 48 KB static limit).  Thread (ty, tx)
// owns rows 4ty..4ty+3 and columns tx + 8j of the 64 x 64 score tile, and the
// same rows and columns tx + 8c of the output; the score and PV products are
// f32 FMAs (no tensor cores), so p is never rounded to bf16, as in the TPU
// kernel.  A row's max is reduced over its 8 lanes by warp shuffles; masked
// entries get p = 0 explicitly, so a row whose first live tile is partly
// masked, or a tile wholly masked for some rows, adds nothing.  Rows past Sq
// and keys past Skv are zero-filled and masked, so any Sq and Skv work.
//
// Bound at the serve's prefill (B=1, H=16, KVH=8, S=512, dh=128, causal,
// bf16): q, k, v read and o written once is 6.29 MB, 1.88 us at 3.35 TB/s;
// the causal work is 4 * dh * 16 * 512 * 513 / 2 = 1.08 GFLOP, 1.09 us on
// the bf16 tensor cores (989 TFLOP/s) or 16.1 us at 67 TFLOP/s of f32 SIMT.
// So the bound is 1.88 us, set by bytes.  This kernel is far above it: it
// runs the products on the f32 SIMT units from shared memory (about 1.4
// shared loads per FMA), with no copy/compute overlap and 128 blocks on 132
// SMs.  Later work: mma.sync / wgmma on bf16 tiles fed by TMA, with the
// tile loads pipelined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile (kBK == kBQ: one tile loader)
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 column lanes
constexpr float kNegInf = -1e30f;

struct Params {
  int Sq, Skv, group, causal, window;
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A 64 x DH tile of `src` (row stride `rs` elements, 16-byte aligned rows)
// into f32 shared memory with row pitch `pitch`; rows at or past `nvalid`
// are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* src, long long rs,
                                          int nvalid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  for (int idx = threadIdx.x; idx < kBQ * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float* d = dst + r * pitch + c;
    if (r < nvalid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * rs + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) d[t] = to_f32(e[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) d[t] = 0.f;
    }
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

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K at pitch DH + 1, V at DH, P at kBK + 1 (f32)
  return sizeof(float) *
         (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int kQP = DH + 1;  // row-varying reads of Q and K: distinct banks
  constexpr int kPP = kBK + 1;
  constexpr int kCols = DH / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kQP;
  float* Vs = Ks + kBK * kQP;
  float* Ps = Vs + kBK * DH;

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, p.Sq - q0);
  const int kvh = h / p.group;
  const T* kp = k + b * p.kb + kvh * p.kh;
  const T* vp = v + b * p.vb + kvh * p.vh;

  // the live keys of this block's queries lie in [k_lo, k_hi)
  const int qlo = p.Skv - p.Sq + q0, qhi = qlo + nq - 1;
  const int k_lo = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Skv, qhi + 1) : p.Skv;

  load_tile<T, DH>(Qs, kQP, q + b * p.qb + h * p.qh + q0 * p.qs, p.qs, nq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    const int nk = min(kBK, p.Skv - k0);
    __syncthreads();  // Q is staged; the last tile's P and V are consumed
    load_tile<T, DH>(Ks, kQP, kp + k0 * p.ks, p.ks, nk);
    load_tile<T, DH>(Vs, DH, vp + k0 * p.vs, p.vs, nk);
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
      const int qpos = qlo + 4 * ty + i;
      unsigned live = 0;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                        (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        live |= (unsigned)ok << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = lane8_max(mx);
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (live >> j) & 1u ? expf(s[i][j] - mx) : 0.f;
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
    const float den = fmaxf(lane8_sum(l[i]), 1e-30f);
    const int r = 4 * ty + i;
    if (r < nq) {
      T* orow = o + b * p.ob + h * p.oh + (q0 + r) * p.os;
#pragma unroll
      for (int c = 0; c < kCols; ++c) store(orow + tx + 8 * c, acc[i][c] / den);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool opted_in = false;  // per instance; a repeated call is harmless
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int H, int dh, const Params& p, cudaStream_t stream) {
  if (dh == 128) return launch<T, 128>(q, k, v, o, B, H, p, stream);
  if (dh == 64) return launch<T, 64>(q, k, v, o, B, H, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, dh), k and v (B, KVH, Skv, dh), o (B, H, Sq, dh), all of one
// dtype (dtype_code 0 = float32, 1 = bfloat16), with the given element
// strides along (batch, head, sequence), unit stride along dh, and 16-byte
// aligned rows.  Needs H % KVH == 0, 1 <= Sq <= Skv and dh in {64, 128}.
// `scale` is dh^-1/2 rounded to f32 by the caller, as the plain version's
// f32 product with the Python float rounds it.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int Skv, int dh, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int window, float scale, int dtype_code, void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Sq > Skv ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = H / KVH;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  p.qb = qb; p.qh = qh; p.qs = qs;
  p.kb = kb; p.kh = kh; p.ks = ks;
  p.vb = vb; p.vh = vh; p.vs = vs;
  p.ob = ob; p.oh = oh; p.os = os;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, H, dh, p, s);
  if (dtype_code == 0) return launch_dh<float>(q, k, v, o, B, H, dh, p, s);
  return (int)cudaErrorInvalidValue;
}
