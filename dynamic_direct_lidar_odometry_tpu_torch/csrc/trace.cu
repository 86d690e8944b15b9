// Spans on the device clock (sm_90a): utils/profiling.mark's stamp.
//
// Not the port of a TPU kernel. The JAX package times its stages from the
// host around jitted calls; the port's step is one captured CUDA graph,
// whose stages have no edge on the host. A stamp is a node of that graph:
// one thread reads %globaltimer (nanoseconds), closes a span of its count
// row (adds the time since the span's open stamp, and one call, to the
// row's count slots of the span) and opens another (keeps the time in the
// row's slot of an open-time buffer of its own, so that an open time is
// never read as a count). A stamp in a conditional body records each time
// the body runs; a graph branch stamps into its own row, as its counts do.
//
// A byte on the device gates the stamp (utils/profiling.device_counts sets
// it, in stream order): when it is 0 the kernel returns at once, so with
// tracing off a stamp costs the graph one empty kernel node and writes
// nothing. When it is 1 the stamp also counts itself (its launch count,
// the key `span` of utils/profiling). A close with no open time (tracing switched on
// after the open) counts nothing, and a close clears the open time it used.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long globaltimer()
{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void span_kernel(const uint8_t* gate, long long* counts, long long* opened, int end_ns,
                            int end_n, int begin, int stamp)
{
  if (*gate == 0) return;
  const long long t = globaltimer();
  counts[stamp] += 1;
  if (end_ns >= 0 && opened[end_ns] != 0) {
    counts[end_ns] += t - opened[end_ns];
    counts[end_n] += 1;
    opened[end_ns] = 0;
  }
  if (begin >= 0) opened[begin] = t;
}

}  // namespace

extern "C" {

// One stamp on `stream`: gate, one byte; counts and opened, the int64 rows
// of the stamping row (count slots, open times); end_ns / end_n, the slots
// of the span to close (-1: none); begin, the slot of the span to open
// (-1: none); stamp, the slot of the stamps' own count.
int ddlo_span(const void* gate, void* counts, void* opened, int end_ns, int end_n, int begin,
              int stamp, void* stream)
{
  span_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gate), static_cast<long long*>(counts),
      static_cast<long long*>(opened), end_ns, end_n, begin, stamp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
