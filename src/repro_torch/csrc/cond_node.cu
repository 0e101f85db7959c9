// cond_node: the IF node of a captured CUDA graph, its condition read from a
// (B,) bool mask on the device, on Hopper.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the
// reference's `jax.lax.cond(jnp.all(do_cache), skip, compute)` inside one
// jitted step (src/repro/core/policies/fastcache.py:176, decode_runner.py:
// 137, policies/base.py:351, smoothcache.py:105): on the TPU the branch is
// taken on the device and the host never sees the predicate.  Eagerly the
// port can only branch on the host, which reads the mask (a sync per layer);
// in a captured step graph the branch becomes a conditional node whose body
// is the block's capture, and this file's kernel, captured just before the
// node, sets the node's condition from the mask at every replay.  Its plain
// twin is cuda_kernels/ref.py:if_all.
//
// cond_if_begin adds, after the work captured so far on `stream`: the
// condition kernel (value = all(mask) when `when_all`, else !all(mask)) and
// an IF node depending on it, moves the stream's capture dependencies onto
// the node, and starts capturing `body` (another stream) into the node's
// body graph in relaxed mode; cond_if_end ends that capture and counts the
// body's nodes by type (a collective captured into a body may bring nodes
// of its own, and a body takes kernel, memcpy, memset, empty, child-graph
// and conditional nodes only).  IF nodes need
// CUDA 12.4; IF / ELSE pairs need 12.8, so a two-sided branch is two IF
// nodes on the same mask, one with when_all set.
//
// Bound: one read of B bytes and one 4-byte condition, far below a
// microsecond; the node's launch latency, not the kernel, is its cost (one
// block of 128 threads; B is the serving batch, at most a few hundred).

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
set_if_all(cudaGraphConditionalHandle handle,
           const unsigned char* __restrict__ mask, int n, int when_all) {
  int all = 1;
  for (int i = threadIdx.x; i < n; i += kThreads) all &= (mask[i] != 0);
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    cudaGraphSetConditional(handle, when_all ? (all != 0) : (all == 0));
  }
}

}  // namespace

extern "C" int cond_if_begin(const void* mask, int n, int when_all,
                             void* stream_ptr, void* body_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_all<<<1, kThreads, 0, stream>>>(
      handle, static_cast<const unsigned char*>(mask), n, when_all);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end at the condition kernel
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
}

extern "C" int cond_if_end(void* body_ptr, int* counts, int n_types) {
  cudaGraph_t body_graph;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &body_graph);
  if (err != cudaSuccess || counts == nullptr) return static_cast<int>(err);
  size_t n = 0;
  err = cudaGraphGetNodes(body_graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(body_graph, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    int t = static_cast<int>(type);
    counts[t < n_types ? t : n_types - 1] += 1;
  }
  return 0;
}
