// knn_density: local-window kNN token density (Eq. 10; CTM stage 1), on
// Hopper.
//
// Replaces the TPU kernel `knn_density` in src/repro/kernels/knn_density.py
// (Pallas, pl.pallas_call at :51).  Its plain twins are
// kernels/ref.py:knn_density in the reference and cuda_kernels/ref.py:
// knn_density here.  Per window of w tokens h (w, D):
//
//   dist[i][j] = max((sq_i + sq_j) - 2 G_ij, 0),  dist[i][i] = inf
//   acc_i      = sum of the K smallest dist[i][:]   (K rounds, each removing
//                                                    the first occurrence)
//   rho[i]     = exp(-acc_i / (K * D))              (f32 out)
//
// Two routes (cuda_kernels/route.py:window_route), one block per window:
//
// - "mma", bf16 h with D % 8 == 0, a 16-byte aligned base and a padded
//   window that fits in shared memory (the served windows): the window is
//   bulk-copied into shared memory at once and its Gram taken on the tensor
//   cores (window_mma.cuh, 256 threads).  Thread i then forms row i of dist
//   in registers (w <= 32, unrolled, entries past w at +inf) and runs the K
//   rounds of first-occurrence masked min there: no dependent shared-memory
//   load per compare.
// - "simt", everything else (f32 h, held to 1e-4, which bf16 tensor-core
//   operands would not meet; ragged D; unaligned bases): the Gram from
//   window_gram.cuh, D streamed through shared memory in f32 chunks, one
//   entry per thread, 256 threads; thread i walks row i of dist in shared
//   memory.
//
// Both form dist in window_gram::gram_dist's operation order and finish with
// the same arithmetic, so they differ only by the Gram's summation order.
//
// Bound at W=128 windows, w=16, D=1152, bf16 (DiT-XL/2, 4 serving slots):
// 4.72 MB read and 8 KB written, ~1.4 us at 3.35 TB/s; the Gram is
// 2*128*16*16*1152 = 75.5 MFLOP, ~0.08 us on the bf16 tensor cores (~1.1 us
// at 67 TFLOP/s of f32).  Bytes bound it: the mma route keeps the whole
// window's load in flight at once (one 37 KB wave per block, 128 blocks on
// 132 SMs).  The SIMT route makes D/128 = 9 dependent load passes and is
// latency-bound far above either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "window_gram.cuh"
#include "window_mma.cuh"

namespace {

using namespace window_gram;

template <typename T>
__global__ void __launch_bounds__(kThreads)
knn_density_kernel(const T* __restrict__ h, float* __restrict__ out, int w,
                   int D, int K, float kd) {
  __shared__ float tile[kMaxW][kChunk + 1];
  __shared__ float g[kMaxW][kMaxW + 1];
  const long long win = blockIdx.x;
  gram(h + win * w * D, w, D, tile, g);

  const int i = threadIdx.x;
  if (i >= w) return;
  float* dist = tile[i];  // the tile is free after gram's last barrier
  for (int j = 0; j < w; ++j)
    dist[j] = j == i ? CUDART_INF_F : fmaxf(gram_dist(g, i, j), 0.f);
  float acc = 0.f;
  for (int r = 0; r < K; ++r) {
    int arg = 0;
    float mn = dist[0];
    for (int j = 1; j < w; ++j)
      if (dist[j] < mn) {  // strict: the first occurrence wins
        mn = dist[j];
        arg = j;
      }
    acc = __fadd_rn(acc, mn);
    dist[arg] = CUDART_INF_F;
  }
  out[win * w + i] = expf(-__fdiv_rn(acc, kd));
}

template <typename T>
int launch(const void* h, void* out, int nw, int w, int D, int K,
           cudaStream_t stream) {
  knn_density_kernel<T><<<nw, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<float*>(out), w, D, K,
      (float)((long long)K * D));
  return (int)cudaGetLastError();
}

// The mma route: bf16 h, MT m-tiles of 16 rows (w <= 16 * MT).
template <int MT>
__global__ void __launch_bounds__(window_mma::kThreads)
knn_density_kernel_mma(const __nv_bfloat16* __restrict__ h,
                       float* __restrict__ out, int w, int D, int K,
                       float kd) {
  constexpr int kN = 16 * MT;
  extern __shared__ __align__(16) uint8_t knn_smem[];
  const window_mma::Window win = window_mma::layout(knn_smem, w, D);
  const long long blk = blockIdx.x;
  window_mma::begin(win, h + blk * w * D, w, D);
  window_mma::wait(win);
  window_mma::gram<MT>(win, w, D);

  const int i = threadIdx.x;
  if (i >= w) return;
  float dist[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float v = CUDART_INF_F;
    if (j < w && j != i) v = fmaxf(gram_dist(win.part, i, j), 0.f);
    dist[j] = v;
  }
  float acc = 0.f;
  for (int r = 0; r < K; ++r) {
    int arg = 0;
    float mn = dist[0];
#pragma unroll
    for (int j = 1; j < kN; ++j)
      if (dist[j] < mn) {  // strict: the first occurrence wins
        mn = dist[j];
        arg = j;
      }
    acc = __fadd_rn(acc, mn);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j == arg) dist[j] = CUDART_INF_F;
  }
  out[blk * w + i] = expf(-__fdiv_rn(acc, kd));
}

template <int MT>
int launch_mma(const void* h, void* out, int nw, int w, int D, int K,
               cudaStream_t stream) {
  static bool opted_in = false;  // per instance; a repeated call is harmless
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_density_kernel_mma<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, window_mma::kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  knn_density_kernel_mma<MT>
      <<<nw, window_mma::kThreads, window_mma::smem_bytes(w, D), stream>>>(
          static_cast<const __nv_bfloat16*>(h), static_cast<float*>(out), w,
          D, K, (float)((long long)K * D));
  return (int)cudaGetLastError();
}

}  // namespace

// The mma route.  h: (nw, w, D) bfloat16, contiguous, 16-byte aligned, D %
// 8 == 0, the padded window within window_mma::kSmemLimit; out: (nw, w)
// float32.  Needs 2 <= w <= 32 and 1 <= K <= w - 1.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int knn_density_mma_launch(const void* h, void* out, int nw,
                                      int w, int D, int K, void* stream) {
  if (nw < 1 || w < 2 || w > window_gram::kMaxW || D < 8 || D % 8 != 0 ||
      K < 1 || K > w - 1 || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      window_mma::smem_bytes(w, D) > window_mma::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= 16) return launch_mma<1>(h, out, nw, w, D, K, s);
  return launch_mma<2>(h, out, nw, w, D, K, s);
}

// The SIMT route.  h: (nw, w, D) contiguous, dtype_code 0 = float32, 1 = bfloat16; out:
// (nw, w) float32.  Needs 2 <= w <= 32 and 1 <= K <= w - 1.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int knn_density_launch(const void* h, void* out, int nw, int w,
                                  int D, int K, int dtype_code,
                                  void* stream) {
  if (nw < 1 || w < 2 || w > window_gram::kMaxW || D < 1 || K < 1 ||
      K > w - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) return launch<__nv_bfloat16>(h, out, nw, w, D, K, s);
  if (dtype_code == 0) return launch<float>(h, out, nw, w, D, K, s);
  return (int)cudaErrorInvalidValue;
}
