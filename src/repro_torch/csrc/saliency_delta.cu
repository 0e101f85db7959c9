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
// Two routes (cuda_kernels/route.py:saliency_route), the same bits:
//
// - "onepass", f32 or bf16 rows of a multiple of 16 bytes at 16-byte aligned
//   bases (every served call): one launch, grid (kGroups = 32, B), 256
//   threads.  The totals' order is sample_totals' below: 256 strided
//   per-thread sums ("slots": slot t adds rows t, t + 256, ... in order),
//   then a tree over the slots whose levels add slot t and t + st for st =
//   128, 64, ..., 1.  Block j takes the slots j, j + 32, ..., j + 224, so it
//   owns the rows r = j (mod 32), and warp w of it the rows of slot j + 32 w,
//   in order.  Each warp reduces its rows in row_sums' order (the lanes'
//   strided 16-byte loads straight from global memory, the fmaf chain, the
//   butterfly), writes sal and adds the row into its slot's sum; the tree's
//   levels 128, 64 and 32 pair slots of one block, so the block ends them
//   itself and publishes one partial per total.  Then an integer ticket per
//   sample (an acq_rel atomic: the partial is released with it): the
//   block that takes the last ticket adds the 32 partials in the tree's
//   levels 16 ... 1 (one warp, shuffles) and resets the ticket.  No float
//   atomics, one launch, no scratch beyond the 32 partials.  The kernel is
//   launched with programmatic stream serialization: it starts while the
//   kernel before it drains and waits (griddepcontrol.wait) before its
//   first access to global memory.
// - "simt", everything else (ragged rows, unaligned bases): two launches on
//   the caller's stream, with no host sync between them:
//   1. row_sums: grid (ceil(N/8), B), one warp per token row.  Each lane
//      sums a strided share of the row (16-byte loads where D and the
//      pointers allow, else one element at a time), then a butterfly
//      shuffle adds the lanes in a fixed order.  Writes sal and the row's
//      sum of prev^2 to a scratch tensor.
//   2. sample_totals: grid B, one block per sample adds its N row values in
//      a fixed order (strided per-thread sums, then a shared-memory tree).
//
// Neither uses float atomics: the totals feed step-level cache gates, which
// must be the same on every run, and the two routes must agree bitwise (a
// route is a function of alignment, so the same input could take either).
// Any N and D: the ragged edges need no padding.
//
// The tickets are one array per device (kMaxBatch words, zero at load, each
// left zero by the call that used it), so two onepass calls must not run on
// one device at the same time on different streams; the port launches on
// the current stream only.
//
// Bound at B=8, N=256, D=1152 in bf16 (fastcache at 4 serving slots): x and
// prev are read once, 9.44 MB, ~2.8 us at the H100 SXM's 3.35 TB/s; the
// outputs are 8 KB.  Three f32 operations per element pair, 7 MFLOP, is far
// below the bytes.  So the kernel is bound by bytes.  What the SIMT route
// loses beyond its row pass is the second launch; the onepass route pays
// instead for the ticket and the last block's read of 32 partials, and
// hides part of its own launch behind the kernel before it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;
constexpr int kTotalThreads = 256;
constexpr int kGroups = 32;         // onepass blocks per sample
constexpr int kSlotWarps = kTotalThreads / kGroups;  // slots (warps) a block
constexpr int kMaxBatch = 65535;    // grid.y

__device__ unsigned int g_tickets[kMaxBatch];

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

// A row's two sums by one warp, 16-byte loads: lane l takes elements
// l V + k 32 V + j, the fmaf chain over j inside k, then a butterfly.  Both
// routes call it, so their sal and row sums are the same bits.
template <typename T>
__device__ __forceinline__ void row_sums_vec(const T* xr, const T* pr, int D,
                                             int lane, float& d2, float& p2) {
  constexpr int V = Vec16<T>::n;
  d2 = 0.f;
  p2 = 0.f;
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
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    d2 = __fadd_rn(d2, __shfl_xor_sync(0xffffffffu, d2, s));
    p2 = __fadd_rn(p2, __shfl_xor_sync(0xffffffffu, p2, s));
  }
}

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
    row_sums_vec(xr, pr, D, lane, d2, p2);
  } else {
    for (int i = lane; i < D; i += 32) {
      const float pv = to_f32(pr[i]);
      const float d = __fsub_rn(to_f32(xr[i]), pv);
      d2 = fmaf(d, d, d2);
      p2 = fmaf(pv, pv, p2);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      d2 = __fadd_rn(d2, __shfl_xor_sync(0xffffffffu, d2, s));
      p2 = __fadd_rn(p2, __shfl_xor_sync(0xffffffffu, p2, s));
    }
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

// The onepass route: grid (kGroups, B), kTotalThreads threads.  part
// holds 2 * kGroups floats per sample: each block's partial of the two
// totals.
template <typename T>
__global__ void __launch_bounds__(kTotalThreads)
saliency_delta_onepass(const T* __restrict__ x, const T* __restrict__ prev,
                       float* __restrict__ sal, float* __restrict__ diff,
                       float* __restrict__ prevsq, float2* __restrict__ part,
                       int N, int D) {
  __shared__ float sa[kSlotWarps], sc[kSlotWarps];
  __shared__ int last;
  // the next kernel may launch now; this one reads and writes global memory
  // only once the one before it has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int j = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sample = (long long)b * N;
  // slot j + 32 warp: rows j + 32 (warp + 8 p), p = 0, 1, ... in order
  float a = 0.f, c = 0.f;
  for (long long r = j + kGroups * warp; r < N;
       r += (long long)kGroups * kSlotWarps) {
    float d2, p2;
    row_sums_vec(x + (sample + r) * D, prev + (sample + r) * D, D, lane, d2,
                 p2);
    a = __fadd_rn(a, d2);
    c = __fadd_rn(c, p2);
    if (lane == 0) sal[sample + r] = d2;
  }
  if (lane == 0) {
    sa[warp] = a;
    sc[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the tree's levels 128, 64, 32: slot j + 32 k takes slot j + 32 (k + st
    // / 32), both this block's
#pragma unroll
    for (int st = kSlotWarps / 2; st > 0; st >>= 1)
#pragma unroll
      for (int k = 0; k < st; ++k) {
        sa[k] = __fadd_rn(sa[k], sa[k + st]);
        sc[k] = __fadd_rn(sc[k], sc[k + st]);
      }
    part[(long long)b * kGroups + j] = make_float2(sa[0], sc[0]);
    unsigned int old;  // releases the partial, acquires the others'
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(g_tickets + b)
                 : "memory");
    last = old == kGroups - 1;
  }
  __syncthreads();
  if (last && warp == 0) {
    // the tree's levels 16 ... 1 over the blocks' partials, slot order
    const float2 v = __ldcg(part + (long long)b * kGroups + lane);
    float d = v.x, p = v.y;
#pragma unroll
    for (int st = kGroups / 2; st > 0; st >>= 1) {
      d = __fadd_rn(d, __shfl_down_sync(0xffffffffu, d, st));
      p = __fadd_rn(p, __shfl_down_sync(0xffffffffu, p, st));
    }
    if (lane == 0) {
      diff[b] = d;
      prevsq[b] = p;
      g_tickets[b] = 0;  // for the next call on this device
    }
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

template <typename T>
int launch_onepass(const void* x, const void* prev, void* sal, void* diff,
                   void* prevsq, void* part, int B, int N, int D,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGroups, B, 1);
  cfg.blockDim = dim3(kTotalThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, saliency_delta_onepass<T>, static_cast<const T*>(x),
      static_cast<const T*>(prev), static_cast<float*>(sal),
      static_cast<float*>(diff), static_cast<float*>(prevsq),
      static_cast<float2*>(part), N, D);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool onepass_takes(const void* x, const void* prev, int B, int N, int D,
                   int esize) {
  return B >= 1 && B <= kMaxBatch && N >= 1 && D >= 1 &&
         (long long)D * esize % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(prev) % 16 == 0;
}

}  // namespace

// The SIMT route.  dtype_code: 0 = float32, 1 = bfloat16 (x and prev).  sal
// and row_prev are (B, N) f32, diff and prevsq (B,) f32.  Returns
// cudaGetLastError() after the launches (0 = success).
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

// The onepass route.  x, prev (B, N, D) at 16-byte aligned bases with D *
// esize % 16 == 0, dtype_code 0 = float32, 1 = bfloat16; sal (B, N), diff
// and prevsq (B,), part (B, 32, 2) f32 scratch.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int saliency_delta_onepass_launch(const void* x, const void* prev,
                                             void* sal, void* diff,
                                             void* prevsq, void* part, int B,
                                             int N, int D, int dtype_code,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1 && onepass_takes(x, prev, B, N, D, 2))
    return launch_onepass<__nv_bfloat16>(x, prev, sal, diff, prevsq, part, B,
                                         N, D, s);
  if (dtype_code == 0 && onepass_takes(x, prev, B, N, D, 4))
    return launch_onepass<float>(x, prev, sal, diff, prevsq, part, B, N, D,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// How many onepass blocks of dtype_code's instance one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.  Returns the
// CUDA error (0 = success).
extern "C" int saliency_delta_onepass_blocks_per_sm(int dtype_code,
                                                    int* out) {
  if (dtype_code == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, saliency_delta_onepass<__nv_bfloat16>, kTotalThreads, 0);
  if (dtype_code == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, saliency_delta_onepass<float>, kTotalThreads, 0);
  return (int)cudaErrorInvalidValue;
}

// The first `count` tickets of the current device (at most kMaxBatch),
// copied into host memory `out`: every onepass call leaves them at zero.
// A synchronizing read, for tests.  Returns the CUDA error (0 = success).
extern "C" int saliency_delta_tickets(unsigned int* out, int count) {
  if (count < 0 || count > kMaxBatch) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_tickets,
                                   sizeof(unsigned int) * (size_t)count, 0,
                                   cudaMemcpyDeviceToHost);
}
