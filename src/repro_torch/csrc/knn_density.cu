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
// Design.  One block of 256 threads per window.  The Gram matrix comes from
// window_gram.cuh: D streamed through shared memory in f32 chunks, one
// entry per thread.  Thread i then forms row i of dist in shared memory and
// runs the K rounds of masked row-min itself (w*K compares, no sort).
//
// Bound at W=128 windows, w=16, D=1152, bf16 (DiT-XL/2, 4 serving slots):
// 4.72 MB read and 8 KB written, ~1.4 us at 3.35 TB/s; the Gram is
// 2*128*16*16*1152 = 75.5 MFLOP, ~1.1 us at 67 TFLOP/s of f32.  The block
// holds one window at a time and makes D/128 = 9 dependent load passes, so
// it is latency-bound far above either bound.  Later work: keep every pass's
// loads in flight (cp.async ring), or put several windows on a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "window_gram.cuh"

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

}  // namespace

// h: (nw, w, D) contiguous, dtype_code 0 = float32, 1 = bfloat16; out:
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
