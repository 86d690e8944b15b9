// Jonker-Volgenant assignment for Hopper (sm_90a): one solve per block,
// one warp up to N = 127.
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
// no host read and one launch.
//
// What bounds it on an H100: latency. The solve is serial: one augmenting
// path per valid row, each path step a dependent chain (the row of the
// step's column, the new minima, their argmin). The bytes (N^2 f32 read
// once) and the operations (a few per column and step) take nanoseconds
// at the card's rates. So the design shortens the chain of a step:
//   - the cost matrix is copied once into shared memory at entry, by one
//     TMA bulk copy (cp.async.bulk) completing on an mbarrier (16 KB at
//     N = 64), so a step reads its row from shared memory, not from L2 or
//     device memory; row_valid is staged beside it. A matrix over the
//     shared-memory budget (N > 239) is read from device memory by the
//     same code (kShared = false);
//   - lane l of warp w owns the columns j = 32 C w + 32 k + l, k < C
//     (kCols: 1-4 by N up to N = 127, then 4): their potential v, minv,
//     way, used flag and row p live in its registers; u (by row) and p
//     (the row of each column) in shared memory, since every lane indexes
//     them. Once a column is used, its owner alone updates its row's u,
//     so it keeps that u in a register and only stores it. N + 1 <= 128
//     columns (the bench tracker's N = 64) is one warp: the argmin is a
//     scan over the lane's own columns as an order key (a NaN first, then
//     the value, -0 = +0), then two __reduce_min_sync (the key, then the
//     least column among the ties, packed with its row p) and one
//     __shfl_sync of the winner's exact value from its lane, with no
//     shared broadcast and no barrier; a larger N takes up to 8 warps and
//     one __syncthreads a step (the warps' winners, double-buffered by
//     step);
//   - the next step's row (its u and its cost) is read right after the
//     argmin, before this step's stores, which never touch it;
//   - lane 0 walks the augmentation alone (each lane first stores its
//     columns' way), and the epilogue is O(N): each column names its row.
// The arithmetic is the plain version's, bit for bit: cur = (C[i0] -
// u[i0]) - v[j] in f32 (__fsub_rn), minv and way lowered where cur <
// minv, the argmin over the unused real columns in torch.argmin's order
// (a NaN first, then the smaller value, then the lower column); the
// winner's value is delta, u[p[j]] += delta and v[j] -= delta for the
// used columns (their rows are distinct), minv[j] -= delta for the others.
// Both loops are bounded (2N + 2 path steps, N + 1 augmentation steps; a
// valid solve needs at most N + 2 and N). A solve that hits a bound writes
// -2 to every row, which the plain version never returns.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e12f;  // hungarian._INF
constexpr int kMaxCols = 4;      // columns a lane, at most
constexpr int kMaxWarps = 8;     // 1,024 columns: N <= 1,023
// dynamic shared memory a block may take on an H100 (232,448 bytes),
// less room for the kernel's static shared memory
constexpr int kSharedBudget = 232448 - 1024;

// torch.argmin's order of values as an unsigned: a NaN first (0), then
// ascending, -0 equal to +0 (ties then go to the lower column)
__device__ __forceinline__ unsigned order_key(float x)
{
  const unsigned b = x == 0.0f ? 0u : __float_as_uint(x);
  // a negative value's bits inverted, a positive one's sign bit set
  const unsigned o = b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
  return x != x ? 0u : o;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p)
{
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes of the small arrays before the matrix: u, p, way (n + 1 each)
// and row_valid (n), rounded up to 16
__host__ __device__ inline int small_bytes(int n)
{
  return ((n + 1) * 12 + n + 15) / 16 * 16;
}

// the whole dynamic shared memory with the matrix in it (16 bytes of
// slack: the matrix starts at the source's offset modulo 16)
inline long long shared_bytes(int n)
{
  return small_bytes(n) + 4LL * n * n + 16;
}

template <int kCols, bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps)
jv_solve_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid, int n,
                int* __restrict__ col_of_row)
{
  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);  // u[row], rows 0..n
  int* p = reinterpret_cast<int*>(u + n + 1);  // p[col]: its row, 0 if free
  int* way = p + (n + 1);                      // way[col], stored for the augmentation
  uint8_t* valid = reinterpret_cast<uint8_t*>(way + n + 1);
  __shared__ unsigned red_o[2][kMaxWarps], red_j[2][kMaxWarps];
  __shared__ float red_v[2][kMaxWarps];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_ok;

  constexpr int kWarpCols = 32 * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5, threads = blockDim.x;
  const int base = warp * kWarpCols + lane;  // column of k = 0

  for (int c = tid; c <= n; c += threads) {
    u[c] = 0.0f;
    p[c] = 0;
  }
  for (int r = tid; r < n; r += threads) valid[r] = row_valid == nullptr || row_valid[r];

  const float* C = cost;
  if constexpr (kShared) {
    // cost[q] goes to Cs[q]; Cs and cost agree modulo 16 bytes, so the
    // aligned middle is one bulk copy and the <= 3 floats on either side
    // plain loads
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(cost) & 15);
    float* Cs = reinterpret_cast<float*>(smem + small_bytes(n) + mis);
    const int total = 4 * n * n;
    const int head = min(total, (16 - mis) & 15);
    const int body = (total - head) & ~15;
    const int tail = total - head - body;
    for (int q = tid; q < head / 4; q += threads) Cs[q] = cost[q];
    for (int q = tid; q < tail / 4; q += threads) Cs[(head + body) / 4 + q] = cost[(head + body) / 4 + q];
    if (tid == 0) {
      const uint32_t b = shared_addr(&bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (body > 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(body)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(shared_addr(Cs + head / 4)), "l"(cost + head / 4), "r"(body), "r"(b)
            : "memory");
      } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b) : "memory");
      }
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
          " selp.b32 %0, 1, 0, P;\n}"
          : "=r"(done)
          : "r"(shared_addr(&bar)), "r"(0u)
          : "memory");
    }
    C = Cs;
  }
  __syncthreads();  // u, p, valid and the matrix's edges

  float v[kCols], minv[kCols], ur[kCols], row[kCols];
  int wy[kCols], rr[kCols];
  unsigned pc[kCols];  // p of this lane's columns (p changes only in an augmentation)
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    v[k] = 0.0f;
    minv[k] = kInf;
    wy[k] = 0;  // way persists across rows, as in the plain version
    ur[k] = 0.0f;
    rr[k] = 0;
    row[k] = 0.0f;
    pc[k] = 0;
  }
  // bit k: column base + 32 k exists (<= n); is a real column (>= 1)
  unsigned live = 0, real = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    live |= (base + 32 * k <= n ? 1u : 0u) << k;
    real |= (base + 32 * k >= 1 && base + 32 * k <= n ? 1u : 0u) << k;
  }
  // this lane's columns of cost row r (1-indexed) into row[]
  auto load_row = [&](int r) {
    const float* src = C + (size_t)(r - 1) * n - 1;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (real >> k & 1u) row[k] = src[base + 32 * k];
  };
  int ok = 1, phase = 0;

  for (int i = 1; i <= n && ok; ++i) {
    if (!valid[i - 1]) continue;
    unsigned used = 0;  // bit k: column base + 32 k is used
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      minv[k] = kInf;
      pc[k] = base + 32 * k == 0 ? i : pc[k];  // p[0] = i
    }
    int j0 = 0, i0 = i;
    float ui0 = u[i];
    load_row(i);
    for (int step = 0;; ++step) {
      // column j0 joins the tree with row i0; from now on its owner
      // alone writes u[i0], so it keeps it in a register (ur) and stores
      // it. Selects, not branches, throughout: the lanes' columns differ
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const bool now = base + 32 * k == j0;
        used |= (now ? 1u : 0u) << k;
        ur[k] = now ? ui0 : ur[k];
        rr[k] = now ? i0 : rr[k];
      }
      unsigned bo = ~0u, bj = ~0u, bp = 0;  // this lane's best: order key, column, its p
      float bval = 0.0f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const bool open = (real & ~used) >> k & 1u;
        const float cur = __fsub_rn(__fsub_rn(row[k], ui0), v[k]);
        const bool lower = open && cur < minv[k];
        minv[k] = lower ? cur : minv[k];
        wy[k] = lower ? j0 : wy[k];
        const float cand = open ? minv[k] : kInf;
        const unsigned o = live >> k & 1u ? order_key(cand) : ~0u;
        const bool better = o < bo;  // the lower column wins a tie: k ascends
        bo = better ? o : bo;
        bj = better ? static_cast<unsigned>(base + 32 * k) : bj;
        bp = better ? pc[k] : bp;
        bval = better ? cand : bval;
      }
      // the warp's winner: the least key, then the least column (packed
      // with its row p, < 2^10 each); its value, exactly (the sign of a
      // zero, a NaN's bits), from its lane
      unsigned mo = __reduce_min_sync(0xffffffffu, bo);
      unsigned win = __reduce_min_sync(0xffffffffu, bo == mo ? bj << 16 | bp : ~0u);
      float delta = __shfl_sync(0xffffffffu, bval, (win >> 16) & 31);
      if (warps > 1) {
        // the warps' winners, double-buffered by step: a buffer is
        // written again two steps on, after the next barrier
        const int par = phase++ & 1;
        if (lane == 0) {
          red_o[par][warp] = mo;
          red_j[par][warp] = win;
          red_v[par][warp] = delta;
        }
        __syncthreads();
        const int w = lane & (kMaxWarps - 1);
        const unsigned o = w < warps ? red_o[par][w] : ~0u;
        mo = __reduce_min_sync(0xffffffffu, o);
        win = __reduce_min_sync(0xffffffffu, o == mo && w < warps ? red_j[par][w] : ~0u);
        delta = red_v[par][(win >> 16) / kWarpCols];
      }
      const int j1 = static_cast<int>(win >> 16);
      const int pj = static_cast<int>(win & 0xffffu);
      // the next step's row, read before this step's stores: it is an
      // unused column's, which no store of this step touches
      if (j1 != 0 && pj != 0) {
        ui0 = u[pj];
        load_row(pj);
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        // u[p[j]] += delta, v[j] -= delta for the used columns (their
        // rows are distinct), minv[j] -= delta for the others
        const bool was = used >> k & 1u;
        const float nu = __fadd_rn(ur[k], delta);
        ur[k] = was ? nu : ur[k];
        if (was) u[rr[k]] = nu;
        v[k] = was ? __fsub_rn(v[k], delta) : v[k];
        minv[k] = was ? minv[k] : __fsub_rn(minv[k], delta);
      }
      j0 = j1;
      if (pj == 0) break;
      if (step > 2 * n + 1) {
        ok = 0;
        break;
      }
      i0 = pj;
      if (j1 == 0) {
        // column 0 again (every candidate at or above _INF): its row i's
        // u was just stored by its owner
        if (warps > 1) __syncthreads(); else __syncwarp();
        ui0 = u[i];
        load_row(i);
      }
    }
    if (!ok) break;
    // augment along the alternating path, in lane 0 of warp 0
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (base + 32 * k <= n) way[base + 32 * k] = wy[k];
    if (warps > 1) __syncthreads(); else __syncwarp();
    if (tid == 0) {
      // p[jj] = p[way[jj]] back to column 0, the next link read before
      // this one's store (p[jw] is stored one link later)
      p[0] = i;
      int jj = j0, jw = way[jj];
      for (int step = 0; jj != 0 && step <= n; ++step) {
        const int pw = p[jw], jn = way[jw];
        p[jj] = pw;
        jj = jw;
        jw = jn;
      }
      s_ok = jj == 0;
    }
    if (warps > 1) __syncthreads(); else __syncwarp();
    ok = s_ok;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (live >> k & 1u) pc[k] = p[base + 32 * k];
  }

  // col_of_row[p[c] - 1] = c - 1 for every column c, the last c winning
  // (the JAX scatter); an unassigned column (p = 0) names row n - 1. Each
  // column names its row with an atomicMax into way (now free), rows that
  // no column names keep 0, i.e. -1.
  __syncthreads();
  for (int r = tid; r < n; r += threads) way[r] = 0;
  __syncthreads();
  if (ok) {
    int last = 0;  // the largest column naming row n - 1
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = base + 32 * k;
      if (c < 1 || c > n) continue;
      const int pc = p[c];
      if (pc >= 1 && pc < n)
        atomicMax(&way[pc - 1], c);
      else
        last = max(last, c);
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last > 0) atomicMax(&way[n - 1], last);
  }
  __syncthreads();
  for (int r = tid; r < n; r += threads) col_of_row[r] = ok ? way[r] - 1 : -2;
}

}  // namespace

// cost (n, n) f32 row-major, row_valid (n,) bool (1 byte each) or null,
// col_of_row (n,) int32, 1 <= n <= 1023; one block on `stream`, no
// allocation, no synchronization. Returns cudaErrorInvalidValue for
// another n, else cudaGetLastError(), so a refused launch is reported.
extern "C" int ddlo_jv_solve(const void* cost, const void* row_valid, int n, void* col_of_row,
                             void* stream)
{
  if (n < 1 || n + 1 > 32 * kMaxCols * kMaxWarps) return (int)cudaErrorInvalidValue;
  // one warp with 1-4 columns a lane up to N = 127, then warps of 4
  const int cols = (n + 32) / 32 < kMaxCols ? (n + 32) / 32 : kMaxCols;
  const int threads = 32 * ((n + 1 + 32 * cols - 1) / (32 * cols));
  const bool staged = shared_bytes(n) <= kSharedBudget;
  const size_t shared = staged ? (size_t)shared_bytes(n) : (size_t)small_bytes(n);
  using Kernel = void (*)(const float*, const uint8_t*, int, int*);
  static const Kernel kernels[2][kMaxCols] = {
      {jv_solve_kernel<1, false>, jv_solve_kernel<2, false>, jv_solve_kernel<3, false>,
       jv_solve_kernel<4, false>},
      {jv_solve_kernel<1, true>, jv_solve_kernel<2, true>, jv_solve_kernel<3, true>,
       jv_solve_kernel<4, true>}};
  const Kernel kernel = kernels[staged][cols - 1];
  if (shared > 48 * 1024) {
    // above 48 KB a kernel takes dynamic shared memory only once allowed,
    // per device (a host call, made before the first launch on each)
    static bool allowed[64][kMaxCols] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !allowed[dev][cols - 1]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBudget);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) allowed[dev][cols - 1] = true;
    }
  }
  kernel<<<1, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(row_valid), n,
      static_cast<int*>(col_of_row));
  return (int)cudaGetLastError();
}

// the largest n whose cost matrix the kernel stages in shared memory
extern "C" int ddlo_jv_shared_max_n()
{
  int n = 1;
  while (shared_bytes(n + 1) <= kSharedBudget) ++n;
  return n;
}
