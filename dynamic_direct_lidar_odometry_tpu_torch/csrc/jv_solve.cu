// Jonker-Volgenant assignment for Hopper (sm_90a), one solve per block.
//
// Computes dynamic_direct_lidar_odometry_tpu/ops/hungarian.py's solve
// (:23): the minimum-cost assignment of a square N x N f32 cost matrix by
// successive shortest augmenting paths (the e-maxx formulation with a
// virtual column 0 and 1-indexed rows and columns), rows inserted in order
// and rows with row_valid false skipped. The JAX package runs it as one
// jitted program of lax loops (fori_loop over the rows :98, a while_loop
// for the shortest path :71 and one for the augmentation :84); it has no
// Pallas kernel. The port's plain version (ops/hungarian.py solve_plain)
// drives those loops from the host, reading the device once per path step
// and once per augmentation. Here the whole solve runs in one block, with
// no host read and one launch:
//   - thread j owns column j (0..N): its potential v[j], its minv[j] and
//     its used flag live in registers; u (by row), p (row of each column)
//     and way (the path's predecessor column) live in shared memory, since
//     other threads index them;
//   - a path step is the plain version's, bit for bit: cur = (C[i0] -
//     u[i0]) - v[j] in f32 (__fsub_rn), minv and way lowered where cur <
//     minv, then the argmin over the unused real columns as a block
//     reduction over (value, column) that keeps torch.argmin's order: a NaN
//     first, then the smaller value, then the lower column; the winner's
//     value is delta, u[p[j]] += delta and v[j] -= delta for the used
//     columns (their rows are distinct), minv[j] -= delta for the others;
//   - thread 0 walks the augmenting path; the block ends with col_of_row,
//     the JAX scatter's last write in column order winning where several
//     columns name a row (an unassigned column, p = 0, names row N - 1).
// Both loops are bounded (2N + 2 path steps, N + 1 augmentation steps; a
// valid solve needs at most N + 2 and N). A solve that hits a bound writes
// -2 to every row, which the plain version never returns.
//
// What bounds it on an H100: latency. The solve is serial: one augmenting
// path per valid row, each path step a dependent chain of a row read
// (N f32 from L2 or device memory), a block reduction and a few barriers.
// The bytes (N^2 f32 read once) and the operations (a few per column and
// step) take nanoseconds at the card's rates; the path steps, each a few
// microseconds of dependent latency at most, set the time.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e12f;  // hungarian._INF
constexpr int kMaxThreads = 1024;

// (a, ia) comes before (b, ib) in torch.argmin's order
__device__ __forceinline__ bool before(float a, int ia, float b, int ib)
{
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

__device__ __forceinline__ void warp_argmin(float& v, int& i)
{
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
jv_solve_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid, int n,
                int* __restrict__ col_of_row)
{
  extern __shared__ int smem[];
  float* u = reinterpret_cast<float*>(smem);  // u[row], rows 0..n
  int* p = smem + (n + 1);                    // p[col]: its row, 0 if free
  int* way = p + (n + 1);                     // way[col]: previous column on the path
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float s_delta;
  __shared__ int s_j1;
  __shared__ int s_ok;

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, warps = blockDim.x >> 5;
  const bool real = j >= 1 && j <= n;
  if (j <= n) {
    u[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }
  if (j == 0) s_ok = 1;
  float v = 0.0f, minv = kInf;
  bool used = false;
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    if (row_valid != nullptr && !row_valid[i - 1]) continue;
    if (j == 0) p[0] = i;
    minv = kInf;
    used = false;
    __syncthreads();
    int j0 = 0;
    for (int step = 0;; ++step) {
      if (j == j0) used = true;
      const int i0 = p[j0];
      const float ui0 = u[i0];
      float cand = kInf;
      if (real && !used) {
        const float cur = __fsub_rn(__fsub_rn(cost[(size_t)(i0 - 1) * n + (j - 1)], ui0), v);
        if (cur < minv) {
          minv = cur;
          way[j] = j0;
        }
        cand = minv;
      }
      float bv = cand;
      int bi = j;
      warp_argmin(bv, bi);
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();  // every read of u and p above is done
      if (warp == 0) {
        bv = lane < warps ? red_v[lane] : kInf;
        bi = lane < warps ? red_i[lane] : INT_MAX;
        warp_argmin(bv, bi);
        if (lane == 0) {
          s_j1 = bi;
          s_delta = bv;
        }
      }
      __syncthreads();
      const int j1 = s_j1;
      const float delta = s_delta;
      if (j <= n) {
        if (used) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v = __fsub_rn(v, delta);
        } else {
          minv = __fsub_rn(minv, delta);
        }
      }
      __syncthreads();  // u settled before the next step reads it
      j0 = j1;
      if (p[j1] == 0) break;
      if (step > 2 * n + 1) {
        if (j == 0) s_ok = 0;
        break;
      }
    }
    if (j == 0 && s_ok) {
      // augment along the alternating path
      int jj = j0;
      for (int step = 0; jj != 0 && step <= n; ++step) {
        const int jw = way[jj];
        p[jj] = p[jw];
        jj = jw;
      }
      if (jj != 0) s_ok = 0;
    }
    __syncthreads();
    if (!s_ok) break;
  }

  // col_of_row[p[c] - 1] = c - 1 for every column c, the last c winning
  for (int r = j; r < n; r += blockDim.x) {
    int last = 0;
    for (int c = 1; c <= n; ++c) {
      const int dst = p[c] - 1 < 0 ? p[c] - 1 + n : p[c] - 1;
      if (dst == r) last = c;
    }
    col_of_row[r] = s_ok ? last - 1 : -2;
  }
}

}  // namespace

// cost (n, n) f32 row-major, row_valid (n,) bool (1 byte each) or null,
// col_of_row (n,) int32, 1 <= n <= 1023; one block on `stream`, no
// allocation, no synchronization. Returns cudaErrorInvalidValue for
// another n, else cudaGetLastError(), so a refused launch is reported.
extern "C" int ddlo_jv_solve(const void* cost, const void* row_valid, int n, void* col_of_row,
                             void* stream)
{
  if (n < 1 || n + 1 > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = (n + 1 + 31) / 32 * 32;
  const size_t shared = (size_t)(n + 1) * (sizeof(float) + 2 * sizeof(int));
  jv_solve_kernel<<<1, threads, shared, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(row_valid), n,
      static_cast<int*>(col_of_row));
  return (int)cudaGetLastError();
}
