// Exact 1-NN for Hopper (sm_90a): block-sparse and dense entry points.
//
// Replaces two TPU kernels of dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:
//   - _nn1_sparse_kernel (ddlo_nn1_sparse): for every query row, the index
//     and squared distance of the nearest target row among the target
//     chunks in its query tile's active-chunk list (CSR: counts + ascending
//     chunk ids, built in torch by ops/nn_cuda.py);
//   - _nn1_kernel (ddlo_nn1_dense): the same sweep over every chunk of the
//     padded target, with no list.
// Same contract as the TPU kernels:
//   - distance is dx*dx + dy*dy + dz*dz by direct differencing;
//   - strict '<' over chunks in ascending order: ties go to the lowest
//     target index;
//   - running best starts at (3e12, 0), so a tile with no active chunk
//     reports distance 3e12 and index 0.
//
// What bounds it on an H100: ~8 FP32 operations per (query, target) pair
// (3 sub, 3 mul, 2 add) plus a compare/select, on the FP32 pipes; each
// target point is re-read from shared memory by every query thread of the
// block, so shared-memory bandwidth (one 12-byte broadcast read per pair)
// is the second limit. Device-memory traffic is small: a 512-row chunk
// (6 KB) is loaded once per block and reused by 256 queries.
//
// What the design does about it: one thread per query keeps its running
// (best_d, best_i) in registers (the TPU kernel's (QT,128) lane-class carry
// is a VPU artifact and is not carried over; its final argmin picks the
// lowest index among equal minima, which is what one strict-'<' carry over
// ascending indices gives); the block stages each active chunk from the
// (3, Tp) SoA target into shared memory with coalesced loads, and every
// thread then reads the same shared address (a broadcast, no bank
// conflicts). The arithmetic uses __fsub_rn/__fmul_rn/__fadd_rn (and the
// library is built with --fmad=false) so no FMA contraction changes the
// rounding: the distances are bit-equal to the plain PyTorch versions' and
// ties resolve identically.
//
// Shapes: a 1024-query tile is covered by 4 blocks of 256 threads; at the
// bench operating point (16,384 queries) the grid is 64 blocks on 132 SMs.
// Smaller tiles, TMA staging and a persistent grid are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e12f;

template <bool kDense>
__global__ void __launch_bounds__(kThreads) nn1_kernel(
    const float* __restrict__ q,       // (Qp, 3) row-major, Qp = n_tiles * q_tile
    const float* __restrict__ tt,      // (3, Tp) transposed target
    const int* __restrict__ counts,    // (n_tiles,) active chunks per tile (sparse)
    const int* __restrict__ lists,     // (n_tiles, n_chunks) ascending chunk ids (sparse)
    int Tp, int n_chunks, int q_tile, int t_chunk,
    int* __restrict__ out_idx,         // (Qp,)
    float* __restrict__ out_d)         // (Qp,)
{
  extern __shared__ float smem[];      // 3 * t_chunk floats
  float* sx = smem;
  float* sy = smem + t_chunk;
  float* sz = smem + 2 * t_chunk;

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const float qx = q[3 * row + 0];
  const float qy = q[3 * row + 1];
  const float qz = q[3 * row + 2];

  float best_d = kBig;
  int best_i = 0;
  int cnt = n_chunks;
  const int* lst = nullptr;
  if (!kDense) {
    const int tile = row / q_tile;     // uniform over the block (q_tile % kThreads == 0)
    cnt = counts[tile];
    lst = lists + static_cast<long long>(tile) * n_chunks;
  }

  for (int j = 0; j < cnt; ++j) {
    const int base = (kDense ? j : lst[j]) * t_chunk;
    __syncthreads();  // every thread is done reading the previous chunk
    for (int k = threadIdx.x; k < t_chunk; k += kThreads) {
      sx[k] = tt[base + k];
      sy[k] = tt[Tp + base + k];
      sz[k] = tt[2 * Tp + base + k];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < t_chunk; ++k) {
      const float dx = __fsub_rn(qx, sx[k]);
      const float dy = __fsub_rn(qy, sy[k]);
      const float dz = __fsub_rn(qz, sz[k]);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d < best_d) {
        best_d = d;
        best_i = base + k;
      }
    }
  }
  out_idx[row] = best_i;
  out_d[row] = best_d;
}

template <bool kDense>
int launch(const void* q, const void* tt, const void* counts, const void* lists,
           int Qp, int Tp, int n_chunks, int q_tile, int t_chunk,
           void* out_idx, void* out_d, void* stream) {
  const int blocks = Qp / kThreads;
  const size_t smem = 3 * static_cast<size_t>(t_chunk) * sizeof(float);
  nn1_kernel<kDense><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(tt),
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      Tp, n_chunks, q_tile, t_chunk,
      static_cast<int*>(out_idx), static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ddlo_nn1_sparse_threads() { return kThreads; }

// Both entry points launch on `stream`, allocate nothing and do not
// synchronize. They return cudaGetLastError() so a refused launch is
// reported to the caller.
extern "C" int ddlo_nn1_sparse(
    const void* q, const void* tt, const void* counts, const void* lists,
    int Qp, int Tp, int n_chunks, int q_tile, int t_chunk,
    void* out_idx, void* out_d, void* stream)
{
  return launch<false>(q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk,
                       out_idx, out_d, stream);
}

extern "C" int ddlo_nn1_dense(
    const void* q, const void* tt, int Qp, int Tp, int t_chunk,
    void* out_idx, void* out_d, void* stream)
{
  return launch<true>(q, tt, nullptr, nullptr, Qp, Tp, Tp / t_chunk, Qp, t_chunk,
                      out_idx, out_d, stream);
}
