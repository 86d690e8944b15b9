// Exact 1-NN for Hopper (sm_90a): block-sparse and dense entry points.
//
// Replaces two TPU kernels of dynamic_direct_lidar_odometry_tpu/ops/nn_pallas.py:
//   - _nn1_sparse_kernel (ddlo_nn1_sparse): for every query row r of tile
//     i = r / q_tile, the index and squared distance of the nearest target
//     among the chunks lists[i, :counts[i]] (CSR: counts + ascending chunk
//     ids, built in torch by ops/nn_cuda.py from the tile's box);
//   - _nn1_kernel (ddlo_nn1_dense): the same over every chunk of the padded
//     target, with no list;
//   - _nn1_sparse_kernel under jax.vmap (ddlo_nn1_sparse_batched): B
//     independent sparse problems in one launch. The B padded targets are
//     stacked along the columns of tt (t_stream columns each), the B query
//     sets along the rows of q (tiles_per_stream tiles each), and tile t's
//     list holds stream t / tiles_per_stream's chunk ids offset by that
//     stream's first chunk, so every list stays ascending and the tie rule
//     holds within the stream. The kernel packs the stream-local index
//     (column - stream * t_stream) into the key, so the output needs no
//     second pass; the local order is the global order within a stream.
// Same function as the TPU kernels, bit for bit:
//   - d = (dx*dx + dy*dy) + dz*dz by direct differencing, with
//     __fsub_rn/__fmul_rn/__fadd_rn and the library built with --fmad=false,
//     so no contraction changes a rounding;
//   - the result starts at (3e12, 0) and takes a pair only on a strictly
//     smaller d, over ascending target index j: ties go to the lowest j.
//
// The merge rule that lets the sweep run in parallel: that sequential
// strict-'<' sweep gives the lexicographic minimum of (d, j) over the
// initial candidate and every pair. d is finite and >= +0, so the bits of
// d as a uint32 order as the floats do, and the minimum of the packed
// 64-bit key (bits(d) << 32) | j is that lexicographic minimum. A minimum
// is the same in any order, so partial results merged with atomicMin give
// a deterministic result, unlike a float atomicAdd. The wrapper fills the
// keys with (bits(3e12) << 32) | 0 first and reads idx and d back as the
// two 32-bit halves of each key (views, no unpack launch).
//
// What bounds it: FP32 issue. A pair needs 3 sub, 3 mul and 2 add, each
// rounded on its own (8 FP32-pipe instructions), and its share of a
// minimum, which runs on the ALU pipe beside them; device memory moves a
// few bytes per thousand pairs. No tensor cores: the work is a 3-wide
// difference, not a matrix product, and the ||q||^2 + ||t||^2 - 2 q.t
// expansion a wgmma would need rounds differently and cancels
// catastrophically for nearby points (why the TPU kernel differences
// directly, nn_pallas.py:14-18).
//
// The first design (one thread per query, one block walking its tile's
// whole chunk list) was measured on an H100 at 0.264 ms against a
// 0.0137 ms bound (S2M 16,384 x 65,536, r = 2 m). What held it back, and what this
// design does about each:
//   1. Idle SMs: the grid was Qp / 256 blocks (64 for 16,384 queries), and
//      only the 5 tiles with real queries had chunks, so 20 blocks of 8
//      warps ran on 20 of 132 SMs, each sweeping ~22 chunks in sequence.
//      Now the grid is (query blocks) x (splits): split y of a block takes
//      a contiguous run of the tile's work, in units of kStage target rows
//      (ceil(units / splits) units each, from the device-side counts, so
//      the host reads nothing and a long list is cut finer than a short
//      one). The wrapper sizes splits from static shapes and the card's
//      resident-block count (8 waves' worth if every query block had work:
//      a sparse call has work in a few tiles only).
//   2. One pair per shared read: a thread held one query and read three
//      4-byte SoA words per pair, and paid a compare and two selects per
//      pair. Now a thread holds kR queries with their kR running (d, j);
//      one 16-byte broadcast read of each SoA row gives 4 targets, so 3
//      shared loads serve 4 * kR pairs; and a pair costs the 8 distance
//      operations plus 3/4 of a min (the group of 4's minimum), with the
//      index looked up only when a group beats the running best.
//   3. No copy/compute overlap: each chunk was staged with plain loads
//      between two barriers. Now a ring of kRing slots is filled by 16-byte
//      cp.async; slot s + kRing - 1 lands while slot s is swept, with one
//      barrier per slot.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kR = 4;                        // queries held by each thread
constexpr int kRows = kThreads * kR;         // query rows per block
constexpr int kStage = 64;                   // target rows per ring slot (one work unit)
constexpr int kRing = 3;                     // ring slots
constexpr int kVec = kStage / 4;             // 16-byte copies per SoA row of a slot
constexpr float kBig = 3.0e12f;
static_assert(kStage % 4 == 0 && kRing >= 2 && kR >= 1, "bad NN1 constants");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// (qx - tx)^2 + (qy - ty)^2, then + (qz - tz)^2: the plain versions'
// order, rounded at every step (no contraction)
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads) nn1_kernel(
    const float* __restrict__ q,       // (Qp, 3) row-major
    const float* __restrict__ tt,      // (3, Tp) transposed target, 16-byte aligned
    const int* __restrict__ counts,    // (n_tiles,) active chunks per tile (sparse)
    const int* __restrict__ lists,     // (n_tiles, n_chunks) ascending chunk ids (sparse)
    int Qp, int Tp, int n_chunks, int q_tile, int t_chunk,
    int tiles_per_stream, int t_stream,  // batched sparse: index offset per stream
    unsigned long long* __restrict__ keys)  // (Qp,) packed (bits(d) << 32) | j, min-merged
{
  __shared__ __align__(16) float ring[kRing][3][kStage];

  const int row0 = blockIdx.x * kRows;
  const int per_chunk = t_chunk / kStage;
  int units = n_chunks * per_chunk;
  const int* lst = nullptr;
  int j0 = 0;  // first column of this block's stream (0 unless batched)
  if (!kDense) {
    const int tile = row0 / q_tile;    // uniform over the block (q_tile % kRows == 0)
    units = counts[tile] * per_chunk;
    lst = lists + static_cast<long long>(tile) * n_chunks;
    j0 = (tile / tiles_per_stream) * t_stream;
  }
  // this split's run of units [u0, u0 + n_st): uniform over the block
  const int per_split = (units + gridDim.y - 1) / gridDim.y;
  const int u0 = blockIdx.y * per_split;
  const int n_st = min(units - u0, per_split);
  if (n_st <= 0) return;

  float qx[kR], qy[kR], qz[kR], bd[kR];
  int bi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = row0 + threadIdx.x + r * kThreads;
    const bool in = kDense ? row < Qp : true;
    qx[r] = in ? q[3 * row + 0] : 0.0f;
    qy[r] = in ? q[3 * row + 1] : 0.0f;
    qz[r] = in ? q[3 * row + 2] : 0.0f;
    bd[r] = kBig;
    bi[r] = 0;
  }

  // first target column of unit u (ascending in u: the list is ascending)
  auto unit_base = [&](int u) -> int {
    const int e = u / per_chunk;
    const int c = kDense ? e : __ldg(lst + e);
    return c * t_chunk + (u - e * per_chunk) * kStage;
  };
  // stage s of the run into ring slot s % kRing; always commits a group
  // (empty past the run) so the wait below counts uniformly
  auto issue = [&](int s) {
    if (s < n_st) {
      const int base = unit_base(u0 + s);
      float* dst = &ring[s % kRing][0][0];
      for (int m = threadIdx.x; m < 3 * kVec; m += kThreads) {
        const int c = m / kVec, k = (m - c * kVec) * 4;
        cp_async16(dst + c * kStage + k, tt + static_cast<long long>(c) * Tp + base + k);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s have landed
    __syncthreads();             // everyone's have; everyone is done with stage s - 1
    issue(s + kRing - 1);        // into the slot stage s - 1 used
    const float* sx = &ring[s % kRing][0][0];
    const float* sy = sx + kStage;
    const float* sz = sx + 2 * kStage;
    const int base = unit_base(u0 + s);
#pragma unroll 2
    for (int k = 0; k < kStage; k += 4) {
      const float4 X = *reinterpret_cast<const float4*>(sx + k);  // broadcast reads
      const float4 Y = *reinterpret_cast<const float4*>(sy + k);
      const float4 Z = *reinterpret_cast<const float4*>(sz + k);
      const float tx[4] = {X.x, X.y, X.z, X.w};
      const float ty[4] = {Y.x, Y.y, Y.z, Y.w};
      const float tz[4] = {Z.x, Z.y, Z.z, Z.w};
      // the group's minimum per query (exact: d is never NaN or -0); only
      // when it beats the running best (rare after the first targets) is
      // the group's first index at that minimum looked up. Equal to the
      // strict-'<' sweep over the 4 targets in order.
      float m[kR];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        m[r] = fminf(fminf(dist2(qx[r], qy[r], qz[r], tx[0], ty[0], tz[0]),
                           dist2(qx[r], qy[r], qz[r], tx[1], ty[1], tz[1])),
                     fminf(dist2(qx[r], qy[r], qz[r], tx[2], ty[2], tz[2]),
                           dist2(qx[r], qy[r], qz[r], tx[3], ty[3], tz[3])));
        any |= m[r] < bd[r];
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (m[r] < bd[r]) {
            int u = 3;
            if (dist2(qx[r], qy[r], qz[r], tx[2], ty[2], tz[2]) == m[r]) u = 2;
            if (dist2(qx[r], qy[r], qz[r], tx[1], ty[1], tz[1]) == m[r]) u = 1;
            if (dist2(qx[r], qy[r], qz[r], tx[0], ty[0], tz[0]) == m[r]) u = 0;
            bd[r] = m[r];
            bi[r] = base + k + u;
          }
        }
      }
    }
  }

  const unsigned long long init = static_cast<unsigned long long>(__float_as_uint(kBig)) << 32;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = row0 + threadIdx.x + r * kThreads;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(bd[r])) << 32) |
        static_cast<unsigned int>(bi[r] - j0);
    if ((kDense ? row < Qp : true) && key < init) atomicMin(keys + row, key);
  }
}

template <bool kDense>
int launch(const void* q, const void* tt, const void* counts, const void* lists,
           int Qp, int Tp, int n_chunks, int q_tile, int t_chunk,
           int tiles_per_stream, int t_stream, int splits, void* keys, void* stream) {
  const dim3 grid((Qp + kRows - 1) / kRows, splits);
  nn1_kernel<kDense><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(tt),
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      Qp, Tp, n_chunks, q_tile, t_chunk, tiles_per_stream, t_stream,
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query rows per block (the sparse q_tile must be a multiple) and target
// rows per work unit (t_chunk, and the dense Tp, must be multiples)
extern "C" int ddlo_nn1_rows_per_block() { return kRows; }
extern "C" int ddlo_nn1_stage_rows() { return kStage; }

// Blocks of the kernel resident on the whole current device at once (SMs x
// blocks per SM); host API only, no device synchronization. -1 on error.
extern "C" int ddlo_nn1_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_kernel<true>, kThreads, 0) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

// Both entry points launch on `stream`, allocate nothing and do not
// synchronize; `keys` must hold the initial key on entry. They return
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int ddlo_nn1_sparse(
    const void* q, const void* tt, const void* counts, const void* lists,
    int Qp, int Tp, int n_chunks, int q_tile, int t_chunk, int splits,
    void* keys, void* stream)
{
  return launch<false>(q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk,
                       1 << 30, 0, splits, keys, stream);
}

// B stacked sparse problems (see the top of the file): q (B * tiles_per_stream
// * q_tile, 3), tt (3, Tp = B * t_stream), counts and lists per stacked tile,
// the lists' row stride n_chunks (one stream's chunk count). The index in
// each key is local to the query's stream.
extern "C" int ddlo_nn1_sparse_batched(
    const void* q, const void* tt, const void* counts, const void* lists,
    int Qp, int Tp, int n_chunks, int q_tile, int t_chunk,
    int tiles_per_stream, int t_stream, int splits, void* keys, void* stream)
{
  return launch<false>(q, tt, counts, lists, Qp, Tp, n_chunks, q_tile, t_chunk,
                       tiles_per_stream, t_stream, splits, keys, stream);
}

extern "C" int ddlo_nn1_dense(
    const void* q, const void* tt, int Qp, int Tp, int splits, void* keys, void* stream)
{
  return launch<true>(q, tt, nullptr, nullptr, Qp, Tp, Tp / kStage, Qp, kStage,
                      1 << 30, 0, splits, keys, stream);
}
