// cond_node: the IF nodes of a captured CUDA graph, their conditions read
// from a (B,) bool mask on the device, on Hopper.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the
// reference's `jax.lax.cond(jnp.all(do_cache), skip, compute)` inside one
// jitted step (src/repro/core/policies/fastcache.py:176, decode_runner.py:
// 137, policies/base.py:351, smoothcache.py:105): on the TPU the branch is
// taken on the device and the host never sees the predicate.  Eagerly the
// port can only branch on the host, which reads the mask (a sync per layer);
// in a captured step graph the branch becomes a conditional node whose body
// is the block's capture, and a kernel captured before the node sets the
// node's condition at every replay.  Its plain twin is cuda_kernels/ref.py:
// if_all.
//
// The node's handle and its condition are apart:
// - cond_handle_create makes a handle of the graph that `stream` captures
//   (reset to 0 at each launch of the graph);
// - cond_set_all captures this file's kernel, set_if_all, which reads the
//   mask once and sets up to kMaxHandles handles, each to all(mask) or to
//   !all(mask): a two-sided branch (the decode gate's skip side and its
//   compute side) costs one condition kernel, not one a side;
// - a kernel that makes the mask can set a handle itself, where it already
//   has the bits: fused_gate's GEMM sets !all(gate) for fastcache's block
//   skip (csrc/fused_gate.cu), so that node has no condition kernel at all;
// - cond_if_begin adds an IF node on a handle after the work captured so
//   far on `stream`, moves the stream's capture dependencies onto the node,
//   and starts capturing `body` (another stream) into the node's body graph
//   in relaxed mode; cond_if_end ends that capture and counts the body's
//   nodes by type (a collective captured into a body may bring nodes of its
//   own, and a body takes kernel, memcpy, memset, empty, child-graph and
//   conditional nodes only).
// IF nodes need CUDA 12.4; IF / ELSE pairs need 12.8 (and a driver of 12.8),
// so a two-sided branch is two IF nodes, on the two handles one launch sets.
//
// Bound: one read of B bytes and one 4-byte condition a handle, far below a
// microsecond; the node's launch latency, not the kernel, is its cost (one
// block of 128 threads; B is the serving batch, at most a few hundred).

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHandles = 2;

struct Conditions {
  cudaGraphConditionalHandle handle[kMaxHandles];
  int when_all[kMaxHandles];  // 1: all(mask); 0: !all(mask)
  int count;
};

__global__ void __launch_bounds__(kThreads)
set_if_all(Conditions conds, const unsigned char* __restrict__ mask, int n) {
  int all = 1;
  for (int i = threadIdx.x; i < n; i += kThreads) all &= (mask[i] != 0);
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    for (int h = 0; h < conds.count; ++h)
      cudaGraphSetConditional(conds.handle[h],
                              conds.when_all[h] ? (all != 0) : (all == 0));
  }
}

// The graph `stream` is capturing into, and the nodes its capture ends at.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

// A new condition handle of the graph that `stream` captures, into *out,
// set to 0 at each launch of the graph.  Returns the CUDA error (0 =
// success).
extern "C" int cond_handle_create(void* stream_ptr, unsigned long long* out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream_ptr),
                                 &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err == cudaSuccess) *out = handle;
  return static_cast<int>(err);
}

// set_if_all on `stream` (capturing): handles[h] <- all(mask) where
// when_all[h], else !all(mask), for h < count <= kMaxHandles.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int cond_set_all(const void* mask, int n,
                            const unsigned long long* handles,
                            const int* when_all, int count,
                            void* stream_ptr) {
  if (n <= 0 || count < 1 || count > kMaxHandles)
    return static_cast<int>(cudaErrorInvalidValue);
  Conditions conds = {};
  for (int h = 0; h < count; ++h) {
    conds.handle[h] = handles[h];
    conds.when_all[h] = when_all[h];
  }
  conds.count = count;
  set_if_all<<<1, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      conds, static_cast<const unsigned char*>(mask), n);
  return static_cast<int>(cudaGetLastError());
}

// An IF node on `handle` after the work captured so far on `stream`, and the
// capture of `body` into its body graph begun.  Returns the CUDA error (0 =
// success).
extern "C" int cond_if_begin(unsigned long long handle, void* stream_ptr,
                             void* body_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
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
      static_cast<cudaStream_t>(body_ptr), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed));
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
