// Conditional nodes for captured CUDA graphs (sm_90a): the capture driver
// of core/control.py, the port's lax.while_loop and lax.cond on the card.
//
// Not the port of a TPU kernel. The JAX package compiles its while_loops
// and conds into the one device program of a step; on the TPU the loop
// test never leaves the chip. A captured CUDA graph gets the same from a
// conditional node (CUDA 12.3+): a WHILE node runs its body graph while
// its handle is non-zero, an IF node runs its body once when it is. The
// handle is set on the device by ddlo_set_cond, a one-thread kernel that
// reads the predicate (a 0-d bool tensor) and calls
// cudaGraphSetConditional: once before the node (the loop's first test,
// or the branch's), and for a WHILE once more at the end of the body (the
// next test). Nothing is read on the host.
//
// The host calls here work on the graph that torch is capturing, read
// from the capturing stream (cudaStreamGetCaptureInfo): ddlo_cond_handle
// creates a handle in it (cudaGraphConditionalHandleCreate); after the
// caller has captured a ddlo_set_cond of it, ddlo_cond_node adds the
// conditional node after the work captured so far (cudaGraphAddNode) and
// points the stream's capture past the node
// (cudaStreamUpdateCaptureDependencies); ddlo_capture_into then captures
// a second stream into the node's body graph
// (cudaStreamBeginCaptureToGraph) until ddlo_capture_close.
//
// This library links its own (static) CUDA runtime, beside torch's. A
// stream or graph handle is the driver's object under both (cudaStream_t
// is a CUstream, cudaGraph_t a CUgraph), so the handles torch gives and
// takes pass through as they are.
//
// What bounds it on an H100: latency. ddlo_set_cond reads one byte and
// writes the handle: a launch (a few microseconds) per loop turn and per
// branch, inside the graph, in place of a host round trip.

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(const bool* pred, cudaGraphConditionalHandle handle)
{
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n)
{
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n);
#endif
}

}  // namespace

extern "C" {

// handle := *pred, on the device, on `stream`
int ddlo_set_cond(const void* pred, unsigned long long handle, void* stream)
{
  set_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(pred), static_cast<cudaGraphConditionalHandle>(handle));
  return static_cast<int>(cudaGetLastError());
}

// Create a conditional handle in the graph that `stream` is capturing.
// -1: the stream is not capturing.
int ddlo_cond_handle(void* stream, unsigned long long* handle_out)
{
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t e = capture_info(static_cast<cudaStream_t>(stream), &status, &graph, &deps, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  *handle_out = static_cast<unsigned long long>(handle);
  return static_cast<int>(e);
}

// Add a conditional node on `handle` (is_while: WHILE, else IF) to the
// graph that `stream` is capturing, after the work captured so far (the
// ddlo_set_cond of its handle); the stream's capture continues after the
// node. Returns the node's body graph. -1: the stream is not capturing.
int ddlo_cond_node(void* stream, int is_while, unsigned long long handle, void** body_out)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t e = capture_info(s, &status, &graph, &deps, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  e = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
#if CUDART_VERSION >= 13000
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  *body_out = static_cast<void*>(params.conditional.phGraph_out[0]);
  return 0;
}

// capture `stream` into `graph` (a conditional node's body), thread-local
int ddlo_capture_into(void* stream, void* graph)
{
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

// a non-blocking stream of the caller's own (never one of torch's pool)
int ddlo_stream_create(void** out)
{
  cudaStream_t s;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = static_cast<void*>(s);
  return static_cast<int>(e);
}

// end the body's capture (the body graph belongs to its node)
int ddlo_capture_close(void* stream)
{
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph));
}

}  // extern "C"
