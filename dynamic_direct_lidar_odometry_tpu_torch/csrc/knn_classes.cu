// Lane-class approximate k-NN for Hopper (sm_90a).
//
// Replaces two TPU kernels of dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:
//   - _nn_classes_kernel (ddlo_knn_classes): every chunk of the padded target;
//   - _nn_classes_sparse_kernel (ddlo_knn_classes_sparse): only the chunks
//     in the query tile's active-chunk list (CSR: counts + ascending ids).
// Together with knn_approx_pallas' top_k epilogue they compute, for each
// query row: the nearest target per class (class = target index mod 128,
// strict '<' over ascending indices, carry starting at (3e12, 0)), then the
// k smallest of those 128 class minima, ascending, equal distances going
// to the lower class (lax.top_k's tie rule on -distance). The index clamp
// to the unpadded target size stays in the wrapper (ops/nn_cuda.py), as in
// the JAX package. This is the TPU kernel's function, not an exact k-NN.
//
// What bounds it on an H100: as ops/nn1_sparse.cu, ~8 FP32 operations plus
// a compare/select per (query, target) pair on the FP32 pipes, the target
// re-read from shared memory; the epilogue (k rounds of a warp argmin over
// 128 pairs) is small beside the sweep at k = 10 and 16k targets.
//
// What the design does about it: one warp sweeps kQPW queries. Lane l
// reads the target rows j = l (mod 32) of each staged chunk, so a warp
// reads 32 consecutive floats per step (no bank conflicts), and keeps four
// (distance, index) carries per query in registers: row j's class is
// j mod 128 = l + 32 * s with s = (j / 32) mod 4, a compile-time slot once
// the row loop is unrolled by 128. Each staged target row serves kQPW
// queries, which amortizes the shared-memory read. The distances use
// __fsub_rn/__fmul_rn/__fadd_rn (built with --fmad=false) so they are
// bit-equal to the plain PyTorch version's, and ties resolve identically.
//
// Shapes: 8 warps x 4 queries = 32 queries per block; at the bench
// operating point (16,384 queries) the grid is 512 blocks. A query tile
// (q_tile rows, a multiple of 32) maps to whole blocks, so the sparse list
// is uniform over a block.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQPW = 4;                   // queries per warp
constexpr int kQPB = kWarps * kQPW;       // queries per block
constexpr float kBig = 3.0e12f;
constexpr unsigned kFull = 0xffffffffu;

template <bool kSparse>
__global__ void __launch_bounds__(kThreads) knn_classes_kernel(
    const float* __restrict__ q,       // (Qp, 3) row-major
    const float* __restrict__ tt,      // (3, Tp) transposed target
    const int* __restrict__ counts,    // (n_tiles,) active chunks per tile (sparse)
    const int* __restrict__ lists,     // (n_tiles, n_chunks) ascending chunk ids (sparse)
    int Tp, int n_chunks, int q_tile, int t_chunk, int k,
    int* __restrict__ out_idx,         // (Qp, k)
    float* __restrict__ out_d)         // (Qp, k)
{
  extern __shared__ float smem[];      // 3 * t_chunk floats
  float* sx = smem;
  float* sy = smem + t_chunk;
  float* sz = smem + 2 * t_chunk;

  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQPB + (threadIdx.x >> 5) * kQPW;

  float qx[kQPW], qy[kQPW], qz[kQPW];
  float bd[kQPW][4];
  int bi[kQPW][4];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    qx[a] = q[3 * (q0 + a) + 0];
    qy[a] = q[3 * (q0 + a) + 1];
    qz[a] = q[3 * (q0 + a) + 2];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      bd[a][s] = kBig;
      bi[a][s] = 0;
    }
  }

  int cnt = n_chunks;
  const int* lst = nullptr;
  if (kSparse) {
    const int tile = (blockIdx.x * kQPB) / q_tile;  // uniform over the block
    cnt = counts[tile];
    lst = lists + static_cast<long long>(tile) * n_chunks;
  }

  for (int j = 0; j < cnt; ++j) {
    const int base = (kSparse ? lst[j] : j) * t_chunk;
    __syncthreads();  // every warp is done reading the previous chunk
    for (int m = threadIdx.x; m < t_chunk; m += kThreads) {
      sx[m] = tt[base + m];
      sy[m] = tt[Tp + base + m];
      sz[m] = tt[2 * Tp + base + m];
    }
    __syncthreads();
    for (int g = 0; g < t_chunk; g += 128) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int m = g + 32 * s + lane;  // class (base + m) mod 128 = lane + 32 s
        const float tx = sx[m], ty = sy[m], tz = sz[m];
#pragma unroll
        for (int a = 0; a < kQPW; ++a) {
          const float dx = __fsub_rn(qx[a], tx);
          const float dy = __fsub_rn(qy[a], ty);
          const float dz = __fsub_rn(qz[a], tz);
          const float d = __fadd_rn(
              __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (d < bd[a][s]) {
            bd[a][s] = d;
            bi[a][s] = base + m;
          }
        }
      }
    }
  }

  // epilogue: k rounds of a warp-wide argmin over the 128 (distance, class)
  // pairs; equal distances go to the lower class
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    unsigned taken = 0;
    const long long out_row = static_cast<long long>(q0 + a) * k;
    for (int r = 0; r < k; ++r) {
      float d = __int_as_float(0x7f800000);  // +inf: loses to every carry
      int c = 1 << 30;
      int ix = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int cls = lane + 32 * s;
        if (!((taken >> s) & 1u) && (bd[a][s] < d || (bd[a][s] == d && cls < c))) {
          d = bd[a][s];
          c = cls;
          ix = bi[a][s];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, d, off);
        const int oc = __shfl_xor_sync(kFull, c, off);
        const int oi = __shfl_xor_sync(kFull, ix, off);
        if (od < d || (od == d && oc < c)) {
          d = od;
          c = oc;
          ix = oi;
        }
      }
      if (lane == (c & 31)) taken |= 1u << (c >> 5);
      if (lane == 0) {
        out_d[out_row + r] = d;
        out_idx[out_row + r] = ix;
      }
    }
  }
}

template <bool kSparse>
int launch(const void* q, const void* tt, const void* counts, const void* lists,
           int Qp, int Tp, int n_chunks, int q_tile, int t_chunk, int k,
           void* out_idx, void* out_d, void* stream) {
  const int blocks = Qp / kQPB;
  const size_t smem = 3 * static_cast<size_t>(t_chunk) * sizeof(float);
  knn_classes_kernel<kSparse><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(tt),
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      Tp, n_chunks, q_tile, t_chunk, k,
      static_cast<int*>(out_idx), static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries per block: Qp (and, for the sparse entry, q_tile) must be a
// multiple of it; t_chunk must be a multiple of 128
extern "C" int ddlo_knn_classes_queries_per_block() { return kQPB; }

// Both entry points launch on `stream`, allocate nothing and do not
// synchronize. They return cudaGetLastError() so a refused launch is
// reported to the caller.
extern "C" int ddlo_knn_classes(
    const void* q, const void* tt, int Qp, int Tp, int t_chunk, int k,
    void* out_idx, void* out_d, void* stream)
{
  return launch<false>(q, tt, nullptr, nullptr, Qp, Tp, Tp / t_chunk, Qp, t_chunk, k,
                       out_idx, out_d, stream);
}

extern "C" int ddlo_knn_classes_sparse(
    const void* q, const void* tt, const void* counts, const void* lists,
    int Qp, int Tp, int n_chunks, int q_tile, int t_chunk, int k,
    void* out_idx, void* out_d, void* stream)
{
  return launch<true>(q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk, k,
                      out_idx, out_d, stream);
}
