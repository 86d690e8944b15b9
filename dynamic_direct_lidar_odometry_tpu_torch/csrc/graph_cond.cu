// Conditional nodes for captured CUDA graphs (sm_90a): the capture driver
// of core/control.py, the port's lax.while_loop and lax.cond on the card.
//
// Not the port of a TPU kernel. The JAX package compiles its while_loops
// and conds into the one device program of a step; on the TPU the loop
// test never leaves the chip, and XLA fuses each cond_fun into one
// computation (e.g. gicp.py's outer_cond :409, the trial's cond :355,
// segmentation.py's CCL cond :258). A captured CUDA graph gets the same
// from a conditional node (CUDA 12.3+): a WHILE node runs its body graph
// while its handle is non-zero, an IF node runs its body once when it is.
// The handle is set on the device by ddlo_set_cond, one launch that
// evaluates the test itself and calls cudaGraphSetConditional: once
// before the node (the loop's first test, or the branch's), and for a
// WHILE once more at the end of the body (the next test). Nothing is read
// on the host. The test (core/control.Test) is
//
//   pred = (count == null || *count < limit) && any_{i < n} term(i)
//
// with term(i) a conjunction of up to three bool flags at i, each maybe
// negated (a 0-d flag is n = 1; no flag: true), or a[i] != b[i] over two
// int32 arrays. It sets one handle to pred or, for an IF / ELSE pair, a
// second to !pred in the same launch, and writes pred to an optional byte.
// The flag form runs in one block. The != form over many entries (CCL's
// 131,072 labels, twice) runs a grid: each block reduces its slice and
// adds, in one atomic on a scratch word, its ticket and whether it found
// a difference; the block that takes the last ticket decides and resets
// the word for the next launch.
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
// What bounds it on an H100: latency. A flag test reads a few bytes and
// writes the handle: one launch (~1.2 us at the floor) per loop turn and
// per branch, inside the graph, in place of the 4-7 elementwise launches
// that computed the flag before. CCL's test reads 1 MB (0.31 us at 3.35
// TB/s): one int4 of each array per thread, 128 blocks, one round of loads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two per SM; a grid-stride loop does the rest

struct CondTest {
  const int* count;  // 0-d int32, or null
  int limit;
  const uint8_t* flag[3];  // bool arrays of n entries
  int nflags;
  int neg;          // bit k: flag k negated
  const int* a;     // the != form when not null
  const int* b;
  int n;
  cudaGraphConditionalHandle handle[2];
  int handles;      // 0, 1 (pred) or 2 (pred, !pred)
  uint8_t* out;     // pred, or null
  unsigned* scratch;  // blocks that found a term (<< 16) + tickets, zero between launches: a grid only
};

// The flag form (kDiffer false) and the != form are two instances, so the
// flag form's code stays a few instruction-cache lines.
template <bool kDiffer>
__global__ void __launch_bounds__(kThreads) set_cond_kernel(CondTest t)
{
  const int stride = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  // the count is read beside the entries, not after their reduction
  const bool under = threadIdx.x != 0 || t.count == nullptr || *t.count < t.limit;
  bool any = false;
  if constexpr (kDiffer) {
    int from = 0;
    if (((reinterpret_cast<uintptr_t>(t.a) | reinterpret_cast<uintptr_t>(t.b)) & 15) == 0) {
      const int4* a4 = reinterpret_cast<const int4*>(t.a);
      const int4* b4 = reinterpret_cast<const int4*>(t.b);
      for (int q = g; q < t.n / 4; q += stride) {
        const int4 x = a4[q], y = b4[q];
        any |= (x.x != y.x) | (x.y != y.y) | (x.z != y.z) | (x.w != y.w);
      }
      from = t.n / 4 * 4;
    }
    for (int i = from + g; i < t.n; i += stride) any |= t.a[i] != t.b[i];
  } else {
    for (int i = g; i < t.n; i += stride) {
      // & and not &&: the flags' loads go out together, none waits on another
      bool r = true;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k < t.nflags) r &= (t.flag[k][i] != 0) != ((t.neg >> k & 1) != 0);
      any |= r;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x != 0) return;
  if (kDiffer && gridDim.x > 1) {
    // one atomic takes the ticket and adds the block's finding
    const unsigned seen = atomicAdd(t.scratch, any ? 0x10001u : 1u);
    if ((seen & 0xffffu) != gridDim.x - 1) return;
    // the last block: every other block's finding is in
    any = any || (seen >> 16) != 0;
    atomicExch(t.scratch, 0u);
  }
  const bool pred = any && under;
  if (t.handles > 0) cudaGraphSetConditional(t.handle[0], pred ? 1u : 0u);
  if (t.handles > 1) cudaGraphSetConditional(t.handle[1], pred ? 0u : 1u);
  if (t.out != nullptr) *t.out = pred;
}

// blocks of a launch over n entries (the != form: 4 a thread)
int grid_of(int n, bool differ)
{
  if (!differ) return 1;
  const int items = (n + 3) / 4;
  const int blocks = (items + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
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

// Evaluate the test (see above) and set `handles` handles from it, on the
// device, on `stream`. f0..f2: bool flags (nflags of them, `neg` their
// negations) or, with `differ`, f0 and f1 the int32 arrays a and b; n
// entries each. count: 0-d int32 or null. out: one byte or null. scratch:
// one zeroed uint32 when ddlo_set_cond_blocks(n, differ) > 1, which the
// kernel leaves zeroed. cudaErrorInvalidValue for a bad combination.
int ddlo_set_cond(const void* f0, const void* f1, const void* f2, int nflags, int neg, int differ,
                  int n, const void* count, int limit, unsigned long long h0, unsigned long long h1,
                  int handles, void* out, void* scratch, void* stream)
{
  const int blocks = grid_of(n, differ != 0);
  if (n < 1 || nflags < 0 || nflags > 3 || handles < 0 || handles > 2 || (differ && nflags) ||
      (blocks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CondTest t = {};
  t.count = static_cast<const int*>(count);
  t.limit = limit;
  if (differ) {
    t.a = static_cast<const int*>(f0);
    t.b = static_cast<const int*>(f1);
  } else {
    t.flag[0] = static_cast<const uint8_t*>(f0);
    t.flag[1] = static_cast<const uint8_t*>(f1);
    t.flag[2] = static_cast<const uint8_t*>(f2);
  }
  t.nflags = nflags;
  t.neg = neg;
  t.n = n;
  t.handle[0] = static_cast<cudaGraphConditionalHandle>(h0);
  t.handle[1] = static_cast<cudaGraphConditionalHandle>(h1);
  t.handles = handles;
  t.out = static_cast<uint8_t*>(out);
  t.scratch = static_cast<unsigned*>(scratch);
  const int threads = blocks > 1 ? kThreads : (n >= kThreads ? kThreads : (n + 31) / 32 * 32);
  if (differ)
    set_cond_kernel<true><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  else
    set_cond_kernel<false><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// blocks of a ddlo_set_cond launch over n entries (> 1: it needs scratch)
int ddlo_set_cond_blocks(int n, int differ) { return grid_of(n, differ != 0); }

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
