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
// Distances are ((dx*dx + dy*dy) + dz*dz) with every operation rounded
// (__fsub_rn/__fmul_rn/__fadd_rn, built with --fmad=false), bit-equal to
// the plain PyTorch version's, so ties resolve identically.
//
// What bounds it on an H100: FP32 issue, as csrc/nn1_sparse.cu: 8 rounded
// FP32 operations per (query, target) pair; device memory moves a few
// bytes per thousand pairs. No tensor cores, for the same reason as there.
//
// The first design (one warp per 4 queries, lane l owning classes l,
// l + 32, l + 64, l + 96; a (distance, index) carry per class; 512-row
// chunks staged by plain loads between two barriers) was measured on an
// H100 at 0.163 ms against a 0.064 ms bound (16,384 x 16,384, k = 10).
// What held it back, and what this design does about each:
//   1. Instruction mix: a pair cost its 8 FP32 operations plus a compare,
//      two selects (distance, index) and 3/4 of a 4-byte shared load.
//      Now lane l owns classes 4l .. 4l+3, so one 16-byte read of each SoA
//      row brings four consecutive target rows, all of classes the lane
//      owns (3 loads per 16 pairs). The sweep runs in batches of kUnits
//      128-row units: a batch holds kUnits rows of each class, and a carry
//      takes the minimum of their distances, two at a time (for d >= +0,
//      never NaN or -0 here, the float's bits order as the float, and
//      sm_90 has a three-way integer minimum), then compares once: a pair
//      costs 8 FP32 operations and about 0.9 ALU operations. The carry
//      holds no index but the number of the batch that last lowered it
//      (strict '<', so the earliest batch at the final minimum). The index
//      is found after the top-k, for the k winners only: the lowest unit
//      of that batch whose row of the class has the winning distance,
//      recomputed from device memory with the same rounded arithmetic.
//      That is the strict-'<' sweep over ascending indices.
//   2. Staging was not overlapped. Now a ring of kRing batches is filled
//      by 16-byte cp.async, each warp copying whole units; batch
//      b + kRing - 1 lands while batch b is swept, one barrier per batch
//      (1,024 rows). A batch past the end of the sweep is padded with far
//      rows whose distance overflows to +inf, so the sweep has no
//      remainder path.
//   3. The epilogue took 15 shuffles per round (a 5-step butterfly over
//      distance, class and index). Now each lane orders its 4 classes
//      once; a round is the warp minimum of the lanes' heads
//      (__reduce_min_sync, one instruction on sm_90), a ballot for the
//      lowest lane that holds it (its head is the lowest class at that
//      distance), one shuffle for that head's (batch, slot), and a pop.
//      The four queries of a warp run their rounds interleaved; lane r
//      keeps round r's winner, so the output rows are written 32 ranks at
//      a time.
// Measured and not taken: persistent blocks walking the query groups in
// whole waves (sized from an occupancy query) were 3-4 % slower than one
// block per group under the hardware's own scheduler; ordering the pruned
// entry's blocks by descending list length was 2 % slower than index
// order; 2, 4 or 16 warps per block, 4 or 16 units per batch and 2 or 4
// ring slots were within 5 % and none faster.
//
// One query's sweep is never split across blocks: the merge would be 128
// keys per query.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQPW = 4;                   // queries per warp
constexpr int kQPB = kWarps * kQPW;       // queries per group (one block)
constexpr int kUnit = 128;                // target rows per unit: one row of each class
constexpr int kUnits = 8;                 // units per batch (one ring slot, one barrier)
constexpr int kRing = 3;                  // ring slots
constexpr int kVec = kUnit / 4;           // 16-byte copies per SoA row of a unit
constexpr float kBig = 3.0e12f;
constexpr float kFar = 1.0e30f;           // (q - kFar)^2 overflows to +inf
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kTaken = 0xffffffffu;  // above the bits of every distance
static_assert(kUnit == 4 * 32, "a lane owns 4 consecutive classes of 128");
static_assert(kUnits % kWarps == 0, "a warp stages whole units of a batch");
static_assert(kRing >= 2 && kUnits % 2 == 0 && kQPW >= 1, "bad k-NN constants");

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

// (qx - tx)^2 + (qy - ty)^2, then + (qz - tz)^2: the plain version's
// order, rounded at every step (no contraction)
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <bool kSparse>
__global__ void __launch_bounds__(kThreads) knn_classes_kernel(
    const float* __restrict__ q,       // (Qp, 3) row-major
    const float* __restrict__ tt,      // (3, Tp) transposed target, 16-byte aligned
    const int* __restrict__ counts,    // (n_tiles,) active chunks per tile (sparse)
    const int* __restrict__ lists,     // (n_tiles, n_chunks) ascending chunk ids (sparse)
    int Tp, int n_chunks, int q_tile, int t_chunk, int k,
    int* __restrict__ out_idx,         // (Qp, k)
    float* __restrict__ out_d)         // (Qp, k)
{
  __shared__ __align__(16) float ring[kRing][kUnits][3][kUnit];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_chunk = t_chunk / kUnit;

  const int grp = blockIdx.x;  // this block's query group
  int units = n_chunks * per_chunk;
  const int* lst = nullptr;
  if (kSparse) {
    const int tile = (grp * kQPB) / q_tile;  // uniform over the block (q_tile % kQPB == 0)
    units = counts[tile] * per_chunk;
    lst = lists + static_cast<long long>(tile) * n_chunks;
  }
  const int q0 = grp * kQPB + warp * kQPW;
  const int n_batches = (units + kUnits - 1) / kUnits;

  // first target column of unit u (ascending in u: the list is ascending)
  auto unit_base = [&](int u) -> int {
    const int e = u / per_chunk;
    const int c = kSparse ? __ldg(lst + e) : e;
    return c * t_chunk + (u - e * per_chunk) * kUnit;
  };
  // batch b of the sweep into ring slot b % kRing: a warp stages whole
  // units, 16 bytes per lane and SoA row; a unit past the sweep's end (the
  // last batch may hold fewer than kUnits) is filled with far rows, whose
  // distance overflows to +inf and lowers no minimum. Always commits a
  // group (empty past the sweep) so the wait below counts uniformly.
  auto issue = [&](int b) {
    if (b < n_batches) {
#pragma unroll
      for (int g = warp; g < kUnits; g += kWarps) {
        float* dst = &ring[b % kRing][g][0][0] + 4 * lane;
        const int u = b * kUnits + g;
        if (u < units) {
          const float* src = tt + unit_base(u) + 4 * lane;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            cp_async16(dst + c * kUnit, src + static_cast<long long>(c) * Tp);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            *reinterpret_cast<float4*>(dst + c * kUnit) = make_float4(kFar, kFar, kFar, kFar);
        }
      }
    }
    cp_async_commit();
  };

  // The carries hold the distance's bits: for d >= +0 (never NaN here) they
  // order as the float does, and sm_90 has a three-way integer minimum.
  float qx[kQPW], qy[kQPW], qz[kQPW];
  unsigned bd[kQPW][4];  // the carry of class 4 * lane + s ...
  int bb[kQPW][4];       // ... and the batch that last lowered it (-1: none)
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
    qx[a] = q[3 * (q0 + a) + 0];
    qy[a] = q[3 * (q0 + a) + 1];
    qz[a] = q[3 * (q0 + a) + 2];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      bd[a][s] = __float_as_uint(kBig);
      bb[a][s] = -1;
    }
  }

#pragma unroll
  for (int b = 0; b < kRing - 1; ++b) issue(b);

  for (int b = 0; b < n_batches; ++b) {
    cp_async_wait<kRing - 2>();  // this thread's copies of batch b have landed
    __syncthreads();             // everyone's have; everyone is done with batch b - 1
    issue(b + kRing - 1);        // into the slot batch b - 1 used
    // m[a][s]: the lesser of the carry and the least distance of query a to
    // the batch's rows of class 4 * lane + s; lane l reads rows 4l .. 4l+3
    // of each unit with one 16-byte load per SoA row. Units are folded in
    // two at a time by a three-way minimum.
    const float4* slot = reinterpret_cast<const float4*>(&ring[b % kRing][0][0][0]) + lane;
    unsigned m[kQPW][4], held[kQPW][4];
#pragma unroll
    for (int a = 0; a < kQPW; ++a) {
#pragma unroll
      for (int s = 0; s < 4; ++s) m[a][s] = bd[a][s];
    }
#pragma unroll
    for (int g = 0; g < kUnits; ++g) {
      const float4 X = slot[(g * 3 + 0) * kVec];
      const float4 Y = slot[(g * 3 + 1) * kVec];
      const float4 Z = slot[(g * 3 + 2) * kVec];
      const float tx[4] = {X.x, X.y, X.z, X.w};
      const float ty[4] = {Y.x, Y.y, Y.z, Y.w};
      const float tz[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
      for (int a = 0; a < kQPW; ++a) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const unsigned d = __float_as_uint(dist2(qx[a], qy[a], qz[a], tx[s], ty[s], tz[s]));
          if (g % 2 == 0) {
            held[a][s] = d;
          } else {
            m[a][s] = __vimin3_u32(m[a][s], held[a][s], d);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kQPW; ++a) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (m[a][s] < bd[a][s]) {
          bd[a][s] = m[a][s];
          bb[a][s] = b;
        }
      }
    }
  }

  // epilogue: each lane orders its 4 (distance bits, 4 * batch + slot)
  // pairs ascending, equal distances in slot order (adjacent exchanges on
  // strict '>': stable). Then k rounds: the warp minimum of the lanes'
  // heads, the lowest lane that holds it (its head is the lowest class at
  // that distance: class = 4 * lane + slot), one shuffle for that head's
  // pair, and the owner pops its head. Lane r % 32 keeps round r's winner,
  // and every 32 rounds the lanes find their winner's index and write
  // their rank of the kQPW output rows.
  unsigned key[kQPW][4];
  int pk[kQPW][4];
#pragma unroll
  for (int a = 0; a < kQPW; ++a) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      key[a][s] = bd[a][s];
      pk[a][s] = 4 * bb[a][s] + s;  // slot = pk & 3, batch = pk >> 2 (-1: none)
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int i = 0; i < 3 - pass; ++i) {
        const bool swap = key[a][i] > key[a][i + 1];
        const unsigned k0 = key[a][i], k1 = key[a][i + 1];
        const int p0 = pk[a][i], p1 = pk[a][i + 1];
        key[a][i] = swap ? k1 : k0;
        key[a][i + 1] = swap ? k0 : k1;
        pk[a][i] = swap ? p1 : p0;
        pk[a][i + 1] = swap ? p0 : p1;
      }
    }
  }
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int nr = min(32, k - r0);
    unsigned wd[kQPW];
    int wc[kQPW], wb[kQPW];
#pragma unroll
    for (int a = 0; a < kQPW; ++a) {
      wd[a] = 0u;
      wc[a] = 0;
      wb[a] = -1;
    }
    for (int r = 0; r < nr; ++r) {
#pragma unroll
      for (int a = 0; a < kQPW; ++a) {
        const unsigned gm = __reduce_min_sync(kFull, key[a][0]);
        const int owner = __ffs(__ballot_sync(kFull, key[a][0] == gm)) - 1;
        const int gp = __shfl_sync(kFull, pk[a][0], owner);
        const bool pop = lane == owner;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          key[a][s] = pop ? key[a][s + 1] : key[a][s];
          pk[a][s] = pop ? pk[a][s + 1] : pk[a][s];
        }
        key[a][3] = pop ? kTaken : key[a][3];
        if (lane == r) {
          wd[a] = gm;
          wc[a] = 4 * owner + (gp & 3);
          wb[a] = gp >> 2;
        }
      }
    }
    if (lane < nr) {
#pragma unroll
      for (int a = 0; a < kQPW; ++a) {
        const float d = __uint_as_float(wd[a]);
        // the lowest unit of batch wb whose row of class wc is at d; a
        // carry no batch lowered is (3e12, 0)
        int ix = 0;
        if (wb[a] >= 0) {
#pragma unroll
          for (int g = kUnits - 1; g >= 0; --g) {
            const int u = wb[a] * kUnits + g;
            if (u < units) {
              const int row = unit_base(u) + wc[a];
              const float dd = dist2(qx[a], qy[a], qz[a], __ldg(tt + row),
                                     __ldg(tt + Tp + row),
                                     __ldg(tt + 2 * static_cast<long long>(Tp) + row));
              if (dd == d) ix = row;
            }
          }
        }
        const long long o = static_cast<long long>(q0 + a) * k + r0 + lane;
        out_d[o] = d;
        out_idx[o] = ix;
      }
    }
  }
}

template <bool kSparse>
int launch(const void* q, const void* tt, const void* counts, const void* lists,
           int Qp, int Tp, int n_chunks, int q_tile, int t_chunk, int k,
           void* out_idx, void* out_d, void* stream) {
  knn_classes_kernel<kSparse><<<Qp / kQPB, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(tt),
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      Tp, n_chunks, q_tile, t_chunk, k,
      static_cast<int*>(out_idx), static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// queries per group: Qp (and, for the sparse entry, q_tile) must be a
// multiple of it; t_chunk must be a multiple of ddlo_knn_classes_unit_rows()
extern "C" int ddlo_knn_classes_queries_per_block() { return kQPB; }
extern "C" int ddlo_knn_classes_unit_rows() { return kUnit; }

// Both entry points launch one block per query group on `stream`, allocate
// nothing and do not synchronize. They return cudaGetLastError() so a
// refused launch is reported to the caller.
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
