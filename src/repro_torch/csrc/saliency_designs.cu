// saliency_designs: the designs of saliency_delta's one-launch route that
// were measured and not kept, beside the kept one, for
// launch/saliency_designs.py.  No served path launches anything here.
//
// Includes saliency_delta.cu, so the kept kernels are the library's own:
//
// - designs_onepass_launch: saliency_delta_onepass, launched with or
//   without programmatic stream serialization;
// - designs_empty_launch: the onepass route's grid of blocks that only
//   wait for the kernel before them and exit: what a launch costs;
// - designs_bulk_launch: the onepass kernel's blocks, rows and totals, but
//   each warp's rows bulk-copied (cp.async.bulk) into shared memory on its
//   own mbarrier before it reduces them there;
// - designs_cluster_launch: grid (G, B), the G blocks of a sample one
//   thread-block cluster; each block owns ceil(N / G) consecutive rows,
//   bulk-copied into a ring of shared-memory stages of 8 rows by a
//   producer warp while 8 warps reduce the landed rows; after a cluster
//   barrier, rank 0 reads the sample's row sums from the other blocks'
//   shared memory (distributed shared memory) and adds them in
//   sample_totals' order; a second barrier keeps the memory alive until
//   read.  It records each block's SM (%smid).
//
// bf16 rows only, of a multiple of 16 bytes, at 16-byte aligned bases.

#include "saliency_delta.cu"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStageRows = 8;                       // cluster: rows a stage
constexpr int kClusterThreads = 32 * (kStageRows + 1);
constexpr int kSmemOptIn = 232448;

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// The onepass kernel with each warp's rows bulk-copied into shared memory
// first (up to `per_warp` rows a warp).
__global__ void __launch_bounds__(kTotalThreads)
bulk_onepass(const bf16* __restrict__ x, const bf16* __restrict__ prev,
             float* __restrict__ sal, float* __restrict__ diff,
             float* __restrict__ prevsq, float2* __restrict__ part, int N,
             int D, int per_warp) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[kSlotWarps];
  __shared__ float sa[kSlotWarps], sc[kSlotWarps];
  __shared__ int last;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int j = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long sample = (long long)b * N;
  const int row_bytes = D * 2;
  uint8_t* mine = smem + (long long)warp * per_warp * 2 * row_bytes;
  const uint32_t bar = smem_u32(&bars[warp]);
  const long long r0 = j + kGroups * warp, step = kGroups * kSlotWarps;
  const int rows = r0 < N ? (int)((N - 1 - r0) / step + 1) : 0;
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (rows > 0) {
      mbar_expect_tx(bar, 2u * rows * row_bytes);
      for (int p = 0; p < rows; ++p) {
        const long long r = sample + r0 + p * step;
        bulk_load(smem_u32(mine + 2 * p * row_bytes), x + r * D, row_bytes,
                  bar);
        bulk_load(smem_u32(mine + (2 * p + 1) * row_bytes), prev + r * D,
                  row_bytes, bar);
      }
    }
  }
  __syncwarp();
  float a = 0.f, c = 0.f;
  if (rows > 0) mbar_wait(bar, 0);
  for (int p = 0; p < rows; ++p) {
    float d2, p2;
    const bf16* xr = reinterpret_cast<const bf16*>(mine + 2 * p * row_bytes);
    row_sums_vec(xr, xr + D, D, lane, d2, p2);
    a = __fadd_rn(a, d2);
    c = __fadd_rn(c, p2);
    if (lane == 0) sal[sample + r0 + p * step] = d2;
  }
  if (lane == 0) {
    sa[warp] = a;
    sc[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = kSlotWarps / 2; st > 0; st >>= 1)
#pragma unroll
      for (int k = 0; k < st; ++k) {
        sa[k] = __fadd_rn(sa[k], sa[k + st]);
        sc[k] = __fadd_rn(sc[k], sc[k + st]);
      }
    part[(long long)b * kGroups + j] = make_float2(sa[0], sc[0]);
    unsigned int old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(g_tickets + b)
                 : "memory");
    last = old == kGroups - 1;
  }
  __syncthreads();
  if (last && warp == 0) {
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
      g_tickets[b] = 0;
    }
  }
}

// The onepass kernel's prologue alone.
__global__ void __launch_bounds__(kTotalThreads) empty_onepass() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The cluster design (R rows a block, S stages of kStageRows rows).
__global__ void __launch_bounds__(kClusterThreads)
cluster_design(const bf16* __restrict__ x, const bf16* __restrict__ prev,
               float* __restrict__ sal, float* __restrict__ diff,
               float* __restrict__ prevsq, int* __restrict__ sm, int N, int D,
               int R, int S) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int g = cluster_rank();
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_bytes = D * 2;
  const int sbytes = 2 * kStageRows * row_bytes;
  float* rsal = reinterpret_cast<float*>(smem + (long long)S * sbytes);
  float* rp2 = rsal + R;
  float* sa = rp2 + R;
  float* sc = sa + kTotalThreads;
  const uint32_t bars = smem_u32(sc + kTotalThreads);  // full[S], empty[S]
  const int r0 = g * R;
  const int rows = max(0, min(R, N - r0));
  const int groups = (rows + kStageRows - 1) / kStageRows;
  const long long base = ((long long)b * N + r0) * D;
  if (threadIdx.x == 0) {
    uint32_t id;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(id));
    sm[b * gridDim.x + blockIdx.x] = (int)id;
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kStageRows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kStageRows) {
    if (lane == 0) {
      for (int q = 0; q < groups; ++q) {
        const int s = q % S;
        if (q >= S) mbar_wait(bars + 8 * (S + s), (q / S - 1) & 1);
        const uint32_t n = (uint32_t)min(kStageRows, rows - q * kStageRows) *
                           (uint32_t)row_bytes;
        const uint32_t dst = smem_u32(smem + (long long)s * sbytes);
        const long long off = base + (long long)q * kStageRows * D;
        mbar_expect_tx(bars + 8 * s, 2 * n);
        bulk_load(dst, x + off, n, bars + 8 * s);
        bulk_load(dst + kStageRows * row_bytes, prev + off, n, bars + 8 * s);
      }
    }
  } else {
    for (int q = 0; q < groups; ++q) {
      const int s = q % S;
      mbar_wait(bars + 8 * s, (q / S) & 1);
      const int lr = q * kStageRows + warp;
      if (lr < rows) {
        const bf16* xr = reinterpret_cast<const bf16*>(
            smem + (long long)s * sbytes + warp * row_bytes);
        float d2, p2;
        row_sums_vec(xr, xr + kStageRows * D, D, lane, d2, p2);
        if (lane == 0) {
          sal[(long long)b * N + r0 + lr] = d2;
          rsal[lr] = d2;
          rp2[lr] = p2;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));
    }
  }
  cluster_arrive();
  cluster_wait();
  if (g == 0) {
    float a = 0.f, c = 0.f;
    if (threadIdx.x < kTotalThreads) {
      const uint32_t rsal_s = smem_u32(rsal), rp2_s = smem_u32(rp2);
      for (int i = threadIdx.x; i < N; i += kTotalThreads) {
        const int owner = i / R;
        const uint32_t off = 4u * (uint32_t)(i - owner * R);
        a = __fadd_rn(a, ld_cluster(rsal_s + off, owner));
        c = __fadd_rn(c, ld_cluster(rp2_s + off, owner));
      }
    }
    cluster_arrive();
    const int t = threadIdx.x;
    if (t < kTotalThreads) {
      sa[t] = a;
      sc[t] = c;
    }
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
  } else {
    cluster_arrive();
  }
  cluster_wait();
}

// The cluster design's launch: R = ceil(N / G) rows a block, as many stages
// as fit in kSmemOptIn; 0 stages when not one does.
struct ClusterPlan {
  int R, S;
  size_t smem;
};
ClusterPlan cluster_plan(int N, int D, int G) {
  ClusterPlan p;
  p.R = (N + G - 1) / G;
  const long long stage = 2LL * kStageRows * D * 2;
  const long long extra = 8LL * p.R + 8LL * kTotalThreads;
  const long long want = (p.R + kStageRows - 1) / kStageRows;
  const long long fit = (kSmemOptIn - extra) / (stage + 16);
  p.S = (int)(want < fit ? want : fit);
  p.smem = (size_t)(p.S * stage + extra + 16LL * p.S);
  return p;
}

cudaError_t cluster_config(int B, int G, const ClusterPlan& p,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        cluster_design, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemOptIn);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        cluster_design, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(G, B, 1);
  cfg->blockDim = dim3(kClusterThreads, 1, 1);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool takes(const void* x, const void* prev, int B, int N, int D) {
  return B >= 1 && B <= kMaxBatch && N >= 1 && D >= 8 && D % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(prev) % 16 == 0;
}

}  // namespace

// saliency_delta_onepass (bf16), with programmatic stream serialization
// when pdl != 0.  Arguments as saliency_delta_onepass_launch's.
extern "C" int designs_onepass_launch(const void* x, const void* prev,
                                      void* sal, void* diff, void* prevsq,
                                      void* part, int B, int N, int D,
                                      int pdl, void* stream) {
  if (!takes(x, prev, B, N, D)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGroups, B, 1);
  cfg.blockDim = dim3(kTotalThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, saliency_delta_onepass<bf16>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(prev), static_cast<float*>(sal),
      static_cast<float*>(diff), static_cast<float*>(prevsq),
      static_cast<float2*>(part), N, D);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// empty_onepass on the onepass route's grid for B samples, launched as the
// onepass kernel is.
extern "C" int designs_empty_launch(int B, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGroups, B, 1);
  cfg.blockDim = dim3(kTotalThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_onepass);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The onepass kernel with bulk-copied rows (bf16, programmatic stream
// serialization).  Arguments as designs_onepass_launch's.
extern "C" int designs_bulk_launch(const void* x, const void* prev,
                                   void* sal, void* diff, void* prevsq,
                                   void* part, int B, int N, int D,
                                   void* stream) {
  const int per_warp = (N + kTotalThreads - 1) / kTotalThreads;
  const size_t smem = (size_t)kSlotWarps * per_warp * 2 * D * 2;
  if (!takes(x, prev, B, N, D) || smem > (size_t)kSmemOptIn)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bulk_onepass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemOptIn - 1024);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGroups, B, 1);
  cfg.blockDim = dim3(kTotalThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bulk_onepass, static_cast<const bf16*>(x),
      static_cast<const bf16*>(prev), static_cast<float*>(sal),
      static_cast<float*>(diff), static_cast<float*>(prevsq),
      static_cast<float2*>(part), N, D, per_warp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster design in clusters of G (1 <= G <= 16) blocks; sm: B * G ints,
// each block's SM.  Returns the CUDA error (0 = success).
extern "C" int designs_cluster_launch(const void* x, const void* prev,
                                      void* sal, void* diff, void* prevsq,
                                      void* sm, int B, int N, int D, int G,
                                      void* stream) {
  const ClusterPlan p = cluster_plan(N, D, G);
  if (!takes(x, prev, B, N, D) || G < 1 || G > 16 || p.S < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(B, G, p, static_cast<cudaStream_t>(stream),
                                   &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, cluster_design, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(prev),
                           static_cast<float*>(sal), static_cast<float*>(diff),
                           static_cast<float*>(prevsq), static_cast<int*>(sm),
                           N, D, p.R, p.S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of G blocks of the cluster design at (N, D) the card
// holds at once, into *out.  Returns the CUDA error (0 = success).
extern "C" int designs_cluster_max_active(int N, int D, int G, int* out) {
  const ClusterPlan p = cluster_plan(N, D, G);
  if (G < 1 || G > 16 || p.S < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(1, G, p, 0, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, cluster_design, &cfg);
}
