// GICP's Levenberg-Marquardt lambda loop for Hopper (sm_90a): the whole
// loop in one launch (ddlo_lm_inner), and its trial's two halves as
// kernels of their own (ddlo_lm_propose, ddlo_lm_decide) for the callers
// that sum the error elsewhere.
//
// Computes the JAX package's lm_inner (dynamic_direct_lidar_odometry_tpu/
// ops/gicp.py:350-404, its while_loop at :404): lambda trials until a
// step is accepted (rho >= 0), convergence is detected on a rejected
// step, or lm_max_iterations trials have run. A trial is
//   - the proposal: d = solve6_ldlt(H + lam I, -b) (:123, the unrolled
//     LDLT with its |pivot| < 1e-30 guard, forward and back
//     substitution), optionally d = 0 for a degenerate stream (the GN
//     branch), then delta = se3_exp(d) (core/se3.py:143: so3_exp_quat
//     with its theta^2 < 1e-10 branch, quat_to_matrix, from_rt);
//   - xi = delta x and the error yi = sum e^T M e at xi, the
//     correspondences, weights M and points B held from the
//     linearization (_compute_error, :261-269);
//   - the decision: rho = (y0 - yi) / max(d . (lam d - b), 1e-30), accept
//     (rho >= 0), converge-on-reject (_is_converged(delta)) or
//     reject-and-grow, the new lambda and nu, the pose, the last delta and
//     the flags.
// No Pallas kernel is replaced: XLA fuses the JAX trial's scalar math and
// its error into a few fusions. The port's plain versions (ops/gicp.py
// lm_inner_plain, lm_propose_plain, lm_decide_plain) run the same
// function as eager PyTorch operations.
//
// ddlo_lm_inner: one cluster of kCluster = 8 blocks per stream
// (cudaLaunchKernelEx with a cluster dimension; 8 is the portable cluster
// size), each of 16 point warps (512 threads) and one control warp. The
// error is a sum over P = 8 x 512 = 4,096 partials in a fixed order,
// which the plain version writes the same way:
//   - per point, src_t as _transform_points (three products summed left
//     to right, then the translation), e = (B - src_t) * valid, each row
//     of M e summed left to right and q = e . Me left to right;
//   - thread t of the cluster (block rank r, thread i: t = 512 r + i)
//     takes points t, t + P, ... and sums them left to right; a point past
//     N enters as +0 (the plain version's zero padding);
//   - halving steps over the 32 lanes (v[l] + v[l + h]), then over the 16
//     warps, then over the 8 blocks.
// The starting error y0 is evaluated once at the starting pose in this
// same order (so that a step d = 0 gives yi == y0 bit for bit and rho = 0
// is accepted, as in JAX, where both are one jnp.sum): on the
// shared-memory route by the point warps while the first proposal is
// made, on the device-memory route in the first trial's pass beside its
// error (one read of the points, not two).
//
// What bounds it on an H100, and what the design does about it:
//   - the launch: one launch runs every stream's whole loop, with no
//     glue operation, fill, conditional node or host read around it;
//   - the bytes: one pass over 61 bytes a point (source 12, M 36, B 12,
//     validity 1), ~1 MB at 16,384 points, about 0.3 us at 3.35 TB/s.
//     Each block copies its share into shared memory once, by 1-D bulk
//     asynchronous copies (cp.async.bulk on an mbarrier, issued by a
//     lane each), so every pass after it reads shared memory; B, a
//     strided view of the gathered target features, is loaded by the
//     threads beside them. Past what 8 blocks hold (N > 28,672: the CLI's
//     65,536-point cloud) every pass reads the points from device memory
//     (L2) with the same code (kShared = false);
//   - the serial chain of a trial: the LDLT, the exponential and the
//     compose (~420 dependent operations), the reduction and the decision.
//     The control warp's lane 0 of every block runs it on the same inputs
//     in the same order, so each block knows the next pose and whether its
//     stream goes on without a broadcast; rank 0 alone writes the outputs.
//     It overlaps the points' work: the first proposal runs while the
//     point warps stage the points (and sum y0), a decision's denominator
//     and convergence test while they sum the trial's error, and from the
//     second trial on the next proposal (as if this trial grows lambda,
//     the only way a loop goes on) too. A trial then costs the pass, the
//     point warps' named barrier, one cluster barrier (the partials,
//     all-gathered through distributed shared memory, double-buffered by
//     trial), the decision and a block barrier.
// ddlo_lm_propose / ddlo_lm_decide: one thread per stream; bound by the
// launch (a few microseconds) against ~300 and ~60 dependent f32
// operations on ~200 bytes a stream.
//
// Bits: every operation is the plain version's on the card, in its order,
// each rounded once (--fmad=false, and the _rn intrinsics besides): the
// sums (theta^2, the rho denominator, the compose, the error) left to
// right or in the tree above, as the plain version writes them; the
// constants that PyTorch takes as Python scalars rounded to f32 first
// (1e-30, 1e-12, 1e-10, 1/48, 1/8, 1/3); clamp_min passing a NaN through
// as torch.clamp_min does; sinf / cosf for torch.sin / torch.cos; the
// convergence test's divisions by its epsilons, f32 tensors in the plain
// version, true f32 divisions.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;
constexpr float kPivotMin = 1e-30f;  // solve6_ldlt's pivot guard
constexpr float kEps = 1e-12f;  // se3._EPS
constexpr float kSmall = 1e-10f;  // so3_exp_quat's small-angle test
constexpr float kInv48 = (float)(1.0 / 48.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kDenomMin = 1e-30f;

// lm_inner's grid: a cluster of kCluster blocks per stream, the error's
// kPartials partial sums (gicp.LM_CLUSTER, gicp.LM_THREADS)
constexpr int kCluster = 8;
constexpr int kInnerThreads = 512;
constexpr int kInnerWarps = kInnerThreads / 32;
constexpr int kPartials = kCluster * kInnerThreads;
// a block: the 16 point warps and the control warp
constexpr int kBlockThreads = kInnerThreads + 32;
// dynamic shared memory a block may take on an H100 (232,448 bytes),
// less room for the kernel's static shared memory
constexpr int kSharedBudget = 232448 - 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

// d = solve6_ldlt(H + lam I, -b) (zeroed when `zero`), T = se3_exp(d);
// h (6, 6) and bv (6,) row-major
__device__ __forceinline__ void propose(const float* __restrict__ h, const float* __restrict__ bv, float l,
                                        bool zero, float x[6], float T[16])
{
  const float loff = mul(l, 0.0f);  // lam times an off-diagonal entry of I

  // LDLT of A = H + lam I (its lower triangle)
  float L[6][6];
  float D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float dj = add(h[6 * j + j], l);
#pragma unroll
    for (int k = 0; k < j; ++k) dj = sub(dj, mul(mul(L[j][k], L[j][k]), D[k]));
    D[j] = fabsf(dj) < kPivotMin ? kPivotMin : dj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = add(h[6 * i + j], loff);
#pragma unroll
      for (int k = 0; k < j; ++k) v = sub(v, mul(mul(L[i][k], L[j][k]), D[k]));
      L[i][j] = div(v, D[j]);
    }
  }
  // L y = -b
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = -bv[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = sub(v, mul(L[i][k], y[k]));
    y[i] = v;
  }
  // L^T x = y / D
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = div(y[i], D[i]);
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v = sub(v, mul(L[k][i], x[k]));
    x[i] = v;
  }
  if (zero) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  }

  // so3_exp_quat of the rotation part
  const float o0 = x[0], o1 = x[1], o2 = x[2];
  const float ts = add(add(mul(o0, o0), mul(o1, o1)), mul(o2, o2));
  const float th = __fsqrt_rn(clamp_min(ts, kEps));
  const float half = mul(0.5f, th);
  const bool small = ts < kSmall;
  const float imag = small ? sub(0.5f, mul(kInv48, ts)) : div(sinf(half), th);
  const float w = small ? sub(1.0f, mul(0.125f, ts)) : cosf(half);
  const float qx = mul(imag, o0), qy = mul(imag, o1), qz = mul(imag, o2);

  // quat_to_matrix, from_rt
  T[0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  T[1] = mul(2.0f, sub(mul(qx, qy), mul(w, qz)));
  T[2] = mul(2.0f, add(mul(qx, qz), mul(w, qy)));
  T[3] = x[3];
  T[4] = mul(2.0f, add(mul(qx, qy), mul(w, qz)));
  T[5] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  T[6] = mul(2.0f, sub(mul(qy, qz), mul(w, qx)));
  T[7] = x[4];
  T[8] = mul(2.0f, sub(mul(qx, qz), mul(w, qy)));
  T[9] = mul(2.0f, add(mul(qy, qz), mul(w, qx)));
  T[10] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  T[11] = x[5];
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

struct Decision {
  float lam, nu;
  bool acc, crj;  // accepted; converged on a reject
};

// what a trial's decision needs before its error is known: the rho
// denominator d^T (H + lam I) d = d . (lam d - b), summed left to right,
// and _is_converged(delta): every |R - I| / rot_eps and |t| / trans_eps
// below 1
struct Prepared {
  float dot;
  bool converged;
};

__device__ __forceinline__ Prepared prepare(const float* d, const float* bv, const float* dl, float l,
                                            float rot_eps, float trans_eps)
{
  Prepared out;
  out.dot = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float dk = d[k];
    const float p = mul(dk, sub(mul(l, dk), bv[k]));
    out.dot = k == 0 ? p : add(out.dot, p);
  }
  out.converged = true;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out.converged &= div(fabsf(sub(dl[4 * r + c], r == c ? 1.0f : 0.0f)), rot_eps) < 1.0f;
    out.converged &= div(fabsf(dl[4 * r + 3]), trans_eps) < 1.0f;
  }
  return out;
}

// the rest of a trial once yi is known, for a stream whose act flag is a
__device__ __forceinline__ Decision decide(float y0, float yi, Prepared p, float l, float n, bool a)
{
  const float rho = div(sub(y0, yi), clamp_min(p.dot, kDenomMin));
  const bool reject = rho < 0.0f;
  Decision out;
  out.acc = a && !reject;
  out.crj = a && reject && p.converged;
  const bool grow = a && reject && !out.crj;
  const float t = sub(mul(2.0f, rho), 1.0f);
  const float shrink = clamp_min(sub(1.0f, mul(mul(t, t), t)), kThird);
  out.lam = out.acc ? mul(l, shrink) : (grow ? mul(n, l) : l);
  out.nu = grow ? mul(2.0f, n) : n;
  return out;
}

// xi = delta x, each entry summed left to right
__device__ __forceinline__ void compose(const float* dl, const float* x, float* xi)
{
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xi[4 * i + j] = add(add(add(mul(dl[4 * i], x[j]), mul(dl[4 * i + 1], x[4 + j])),
                              mul(dl[4 * i + 2], x[8 + j])),
                          mul(dl[4 * i + 3], x[12 + j]));
}

__global__ void __launch_bounds__(kThreads)
lm_propose_kernel(const float* __restrict__ H, const float* __restrict__ b,
                  const float* __restrict__ lam, const uint8_t* __restrict__ zero, int B,
                  float* __restrict__ d_out, float* __restrict__ delta_out)
{
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  float x[6], T[16];
  propose(H + 36 * s, b + 6 * s, lam[s], zero != nullptr && zero[s], x, T);
#pragma unroll
  for (int i = 0; i < 6; ++i) d_out[6 * s + i] = x[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) delta_out[16 * s + i] = T[i];
}

__global__ void __launch_bounds__(kThreads)
lm_decide_kernel(const float* __restrict__ y0, const float* __restrict__ yi,
                 const float* __restrict__ d, const float* __restrict__ b,
                 const float* __restrict__ delta, const float* __restrict__ xi,
                 float* __restrict__ lam, float* __restrict__ nu, float* __restrict__ x,
                 float* __restrict__ delta_done, uint8_t* __restrict__ done,
                 uint8_t* __restrict__ accepted, uint8_t* __restrict__ conv,
                 uint8_t* __restrict__ act, int* __restrict__ j, int B, float rot_eps,
                 float trans_eps)
{
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s == 0) *j += 1;
  if (s >= B) return;
  const float* dl = delta + 16 * s;
  const bool a = act[s] != 0;
  const float l = lam[s];
  const Decision r =
      decide(y0[s], yi[s], prepare(d + 6 * s, b + 6 * s, dl, l, rot_eps, trans_eps), l, nu[s], a);
  lam[s] = r.lam;
  nu[s] = r.nu;
  if (r.acc) {
#pragma unroll
    for (int k = 0; k < 16; ++k) x[16 * s + k] = xi[16 * s + k];
  }
  if (r.acc || r.crj) {
#pragma unroll
    for (int k = 0; k < 16; ++k) delta_done[16 * s + k] = dl[k];
  }
  done[s] = done[s] || r.acc || r.crj;
  accepted[s] = accepted[s] || r.acc;
  conv[s] = conv[s] || r.crj;
  act[s] = a && !(r.acc || r.crj);
}

// ---- lm_inner ----

// bytes of one staged array's region: K segments of 512 points, plus 16
// of slack (the array starts at its source's offset modulo 16)
__host__ __device__ constexpr int region_bytes(int K, int elem)
{
  return (K * kInnerThreads * elem + 16 + 15) / 16 * 16;
}

// the dynamic shared memory of the shared-memory route: the source
// points, M and the validity (bulk copies), then B (3 floats a point)
__host__ __device__ constexpr long long inner_shared_bytes(int K)
{
  return (long long)region_bytes(K, 12) + region_bytes(K, 36) + region_bytes(K, 1) +
         (long long)K * kInnerThreads * 12;
}

// the most rows of P points that the shared-memory route holds (28,672
// points)
constexpr int kMaxSharedK = 7;
static_assert(inner_shared_bytes(kMaxSharedK) <= kSharedBudget &&
              inner_shared_bytes(kMaxSharedK + 1) > kSharedBudget);

struct InnerArgs {
  const float* x0;  // (B, 4, 4) the starting pose
  float* lam;  // (B,) in place
  const float* H;  // (B, 6, 6)
  const float* b;  // (B, 6)
  const float* src;  // (B, N, 3)
  const uint8_t* valid;  // (B, N)
  const float* M;  // (B, N, 3, 3)
  const float* Bp;  // B's rows: 3 floats at Bp + s * b_stream + n * b_row
  long long b_stream;
  int b_row;
  const uint8_t* run;  // (B,) or null: the stream runs
  const uint8_t* degenerate;  // (B,)
  float* nu;  // (B,) the outputs
  float* x;  // (B, 4, 4)
  float* delta_done;  // (B, 4, 4)
  uint8_t* done;
  uint8_t* accepted;
  uint8_t* conv;
  uint8_t* act;
  int* j;  // (B,) trials run
  int N, K, max_trials;
  float rot_eps, trans_eps;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p)
{
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// e^T M e of one point at the pose whose top three rows are P (row-major
// 3 x 4), the validity as 0 / 1
__device__ __forceinline__ float point_error(const float* P, float p0, float p1, float p2,
                                             const float* bb, const float* m, float vf)
{
  float e[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float st =
        add(add(add(mul(p0, P[4 * r]), mul(p1, P[4 * r + 1])), mul(p2, P[4 * r + 2])), P[4 * r + 3]);
    e[r] = mul(sub(bb[r], st), vf);
  }
  float q = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float me = add(add(mul(m[3 * r], e[0]), mul(m[3 * r + 1], e[1])), mul(m[3 * r + 2], e[2]));
    q = r == 0 ? mul(e[0], me) : add(q, mul(e[r], me));
  }
  return q;
}

// the fixed tree over the cluster's 8 partials
__device__ __forceinline__ float cluster_sum(const float (*part)[2], int which)
{
  float v[kCluster];
#pragma unroll
  for (int k = 0; k < kCluster; ++k) v[k] = part[k][which];
#pragma unroll
  for (int h = kCluster / 2; h >= 1; h /= 2)
#pragma unroll
    for (int k = 0; k < h; ++k) v[k] = add(v[k], v[k + h]);
  return v[0];
}

// the two halves of a cluster barrier (every thread of the cluster); the
// arrival orders no memory (it is made before any write)
__device__ __forceinline__ void cluster_arrive()
{
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the point warps' named barrier (the control warp does not take part)
__device__ __forceinline__ void point_warps_sync()
{
  asm volatile("bar.sync 1, %0;" ::"n"(kInnerThreads) : "memory");
}

template <bool kShared>
__global__ void __launch_bounds__(kBlockThreads, 1) lm_inner_kernel(const InnerArgs a)
{
  extern __shared__ __align__(16) unsigned char smem[];
  // the pose, and per trial parity the proposal (d, delta, xi = delta x)
  __shared__ float s_x[16], s_xi[2][16], s_delta[2][16], s_d[2][6];
  __shared__ int s_ragged;
  __shared__ float s_part[2][kCluster][2];  // [trial parity][block rank][yi, y0]
  __shared__ float s_warp[kInnerWarps][2];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_go;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ctrl = warp == kInnerWarps;  // the control warp: the stream's scalar chain
  const int N = a.N, K = a.K;
  const bool active = (a.run == nullptr || a.run[s]) && !a.degenerate[s];
  if (!active || a.max_trials <= 0) {
    // no trial: the state as the loop starts it (every block of the
    // cluster leaves here, before any cluster barrier)
    if (rank == 0 && tid < 16) {
      a.x[16 * s + tid] = a.x0[16 * s + tid];
      a.delta_done[16 * s + tid] = tid % 5 == 0 ? 1.0f : 0.0f;
    }
    if (rank == 0 && tid == 0) {
      a.nu[s] = 2.0f;
      a.done[s] = 0;
      a.accepted[s] = 0;
      a.conv[s] = 0;
      a.act[s] = active;
      a.j[s] = 0;
    }
    return;
  }

  // the cluster barrier that guards distributed shared memory (every
  // block of the cluster runs before one writes into another): arrived at
  // here, waited on before the first write
  cluster_arrive();

  const float* Hs = a.H + 36 * s;
  const float* bsv = a.b + 6 * s;
  const float* src = a.src + (size_t)s * N * 3;
  const float* Mg = a.M + (size_t)s * N * 9;
  const uint8_t* vg = a.valid + (size_t)s * N;
  const float* Bg = a.Bp + (size_t)s * a.b_stream;
  const float* sp = src;
  const float* mp = Mg;
  const uint8_t* vp = vg;
  float* bs = nullptr;

  // this thread's sums over its points n = r P + 512 rank + tid (r < K)
  // at the pose whose top rows are P (and at P0 too when `both`), left
  // to right, a point past N entering as +0
  auto point_sums = [&](const float* P, const float* P0, bool both, float& acc, float& acc0) {
    acc = 0.0f;
    acc0 = 0.0f;
#pragma unroll(kShared ? 4 : 1)
    for (int r = 0; r < K; ++r) {
      // a point past N still reads (its slot in shared memory, or point
      // N - 1 in device memory), so that the loads of unrolled rows go
      // out together
      const int n = r * kPartials + rank * kInnerThreads + tid;
      const int nc = min(n, N - 1);
      const int li = kShared ? r * kInnerThreads + tid : nc;
      const float* p = sp + (size_t)li * 3;
      const float* m = mp + (size_t)li * 9;
      const float* bb = kShared ? bs + (size_t)li * 3 : Bg + (size_t)nc * a.b_row;
      const float vf = vp[li] ? 1.0f : 0.0f;
      const float p0 = p[0], p1 = p[1], p2 = p[2];
      float mm[9], b3[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) mm[k] = m[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) b3[k] = bb[k];
      const float q = n < N ? point_error(P, p0, p1, p2, b3, mm, vf) : 0.0f;
      const float q0 = both && n < N ? point_error(P0, p0, p1, p2, b3, mm, vf) : 0.0f;
      acc = r == 0 ? q : add(acc, q);
      acc0 = r == 0 ? q0 : add(acc0, q0);
    }
  };
  // the warp's halving steps; lane 0 stores the warp's sum in column c
  auto warp_sum = [&](float v, int c) {
#pragma unroll
    for (int h = 16; h >= 1; h /= 2) v = add(v, __shfl_down_sync(0xffffffffu, v, h));
    if (lane == 0) s_warp[warp][c] = v;
  };

  // the control lane's state (every thread holds these registers, so the
  // pose and b stay in memory)
  float lam = 0.0f, nu = 2.0f, y0 = 0.0f;
  Prepared prep;
  // a proposal at lambda l into slot c: d, delta and xi = delta x computed
  // in registers, then stored for the decision and the point warps
  auto propose_into = [&](float l, int c) {
    float d[6], dl[16], xi[16];
    propose(Hs, bsv, l, false, d, dl);
    compose(dl, s_x, xi);
#pragma unroll
    for (int k = 0; k < 6; ++k) s_d[c][k] = d[k];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      s_delta[c][k] = dl[k];
      s_xi[c][k] = xi[k];
    }
  };
  if (ctrl) {
    // the first proposal, while the point warps stage their points and
    // sum the error at the start
    if (lane == 0) {
      lam = a.lam[s];
#pragma unroll
      for (int k = 0; k < 16; ++k) s_x[k] = a.x0[16 * s + k];
      propose_into(lam, 0);
    }
  } else {
    if constexpr (kShared) {
      // this block's points: segment r holds points r P + 512 rank + i,
      // i < 512, at local index 512 r + i of each array
      const unsigned char* gsrc[3] = {reinterpret_cast<const unsigned char*>(src),
                                      reinterpret_cast<const unsigned char*>(Mg), vg};
      constexpr int elem[3] = {12, 36, 1};
      unsigned char* dst[3];
      unsigned char* r0 = smem;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        dst[q] = r0 + (reinterpret_cast<uintptr_t>(gsrc[q]) & 15);
        r0 += region_bytes(K, elem[q]);
      }
      bs = reinterpret_cast<float*>(r0);
      sp = reinterpret_cast<const float*>(dst[0]);
      mp = reinterpret_cast<const float*>(dst[1]);
      vp = dst[2];
      if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(&s_bar)), "r"(1u) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        // bytes outside the bulk copies: a stream's arrays off a 16-byte
        // boundary, or a last segment whose bytes are no multiple of 16
        s_ragged = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(Mg) |
                     reinterpret_cast<uintptr_t>(vg)) & 15) != 0 || N % 16 != 0;
      }
      point_warps_sync();  // the barrier is initialised before the copies complete on it
      // each segment's 16-byte-aligned middle is one bulk copy; the <= 15
      // bytes on either side and B (strided) are plain loads. Every
      // segment of an array has its offset modulo 16 (512 points of 12,
      // 36 or 1 bytes are a multiple of 16)
      // array q's element bytes and source, by selects (q may be a lane's)
      auto elem_of = [&](int q) { return q == 0 ? elem[0] : (q == 1 ? elem[1] : elem[2]); };
      auto src_of = [&](int q) { return q == 0 ? gsrc[0] : (q == 1 ? gsrc[1] : gsrc[2]); };
      auto cut = [&](int r, int q, int& head, int& body, int& tail) {
        const int cnt = min(max(N - (r * kPartials + rank * kInnerThreads), 0), kInnerThreads);
        const int bytes = cnt * elem_of(q);
        const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src_of(q)) & 15);
        head = min(bytes, (16 - mis) & 15);
        body = (bytes - head) & ~15;
        tail = bytes - head - body;
      };
      if (warp == 0) {
        // lane 0 announces the bytes of every copy, then lane 3 r + q
        // issues segment r's copy of array q (3 K <= 21 copies, in
        // parallel)
        if (lane == 0) {
          unsigned total = 0;
          for (int r = 0; r < K; ++r)
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              int head, body, tail;
              cut(r, q, head, body, tail);
              total += body;
            }
          if (total > 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(&s_bar)),
                         "r"(total)
                         : "memory");
          else
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_addr(&s_bar)) : "memory");
        }
        __syncwarp();
        const int r = lane / 3, q = lane % 3;
        if (r < K) {
          int head, body, tail;
          cut(r, q, head, body, tail);
          const int e = elem_of(q);
          unsigned char* d = q == 0 ? dst[0] : (q == 1 ? dst[1] : dst[2]);
          const unsigned char* g = src_of(q);
          if (body > 0)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                    shared_addr(d + (size_t)r * kInnerThreads * e + head)),
                "l"(g + (size_t)(r * kPartials + rank * kInnerThreads) * e + head), "r"(body),
                "r"(shared_addr(&s_bar))
                : "memory");
        }
      }
      // B: every load first, then the stores (one latency, not K)
      float bl[kMaxSharedK][3];
#pragma unroll
      for (int r = 0; r < kMaxSharedK; ++r) {
        const int n = r * kPartials + rank * kInnerThreads + tid;
        if (r < K && n < N) {
#pragma unroll
          for (int c = 0; c < 3; ++c) bl[r][c] = Bg[(size_t)n * a.b_row + c];
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxSharedK; ++r) {
        if (r < K && r * kPartials + rank * kInnerThreads + tid < N) {
#pragma unroll
          for (int c = 0; c < 3; ++c) bs[(r * kInnerThreads + tid) * 3 + c] = bl[r][c];
        }
      }
      for (int r = 0; r < (s_ragged ? K : 0); ++r) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          int head, body, tail;
          cut(r, q, head, body, tail);
          const unsigned char* g = gsrc[q] + (size_t)(r * kPartials + rank * kInnerThreads) * elem[q];
          unsigned char* d = dst[q] + (size_t)r * kInnerThreads * elem[q];
          if (tid < head) d[tid] = g[tid];
          if (tid < tail) d[head + body + tid] = g[head + body + tid];
        }
      }
      uint32_t ready = 0;
      while (!ready) {
        asm volatile(
            "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
            " selp.b32 %0, 1, 0, P;\n}"
            : "=r"(ready)
            : "r"(shared_addr(&s_bar)), "r"(0u)
            : "memory");
      }
      point_warps_sync();  // the plain-loaded bytes of the other threads

      // the error at the start (y0), while the control warp proposes (on
      // the device-memory route the first trial's pass sums it beside its
      // own: one read of the points, not two)
      float P0[12], acc, acc0;
#pragma unroll
      for (int k = 0; k < 12; ++k) P0[k] = a.x0[16 * s + k];
      point_sums(P0, P0, false, acc0, acc);
      warp_sum(acc0, 1);
    }
  }
  __syncthreads();  // the first proposal and the y0 warp sums are in place

  for (int t = 0;; ++t) {
    const int cur = t & 1;
    if (!ctrl) {
      // the trial's error
      float Pi[12], P0[12], acc, acc0;
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        Pi[k] = s_xi[cur][k];
        P0[k] = s_x[k];
      }
      point_sums(Pi, P0, !kShared && t == 0, acc, acc0);
      warp_sum(acc, 0);
      if (!kShared && t == 0) warp_sum(acc0, 1);
      point_warps_sync();
    } else if (lane == 0) {
      // beside the point warps' pass and reduction: what the decision
      // needs before the error, and from the second trial on the next
      // trial's proposal, as if this one grows lambda (the only way the
      // loop goes on: an accepted or converged trial ends it); the first
      // trial, which most loops end with, is not held up by it
      prep = prepare(s_d[cur], bsv, s_delta[cur], lam, a.rot_eps, a.trans_eps);
      if (t >= 1 && t + 1 < a.max_trials) propose_into(mul(nu, lam), cur ^ 1);
    }
    if (t == 0) cluster_wait();
    if (warp == 0) {
      float v = lane < kInnerWarps ? s_warp[lane][0] : 0.0f;
      float v0 = lane < kInnerWarps ? s_warp[lane][1] : 0.0f;
#pragma unroll
      for (int h = kInnerWarps / 2; h >= 1; h /= 2) {
        v = add(v, __shfl_down_sync(0xffffffffu, v, h));
        v0 = add(v0, __shfl_down_sync(0xffffffffu, v0, h));
      }
      v = __shfl_sync(0xffffffffu, v, 0);
      v0 = __shfl_sync(0xffffffffu, v0, 0);
      if (lane < kCluster) {
        // this block's partials into slot `rank` of every block
        float* out = cluster.map_shared_rank(&s_part[cur][rank][0], lane);
        out[0] = v;
        out[1] = v0;
      }
    }
    cluster.sync();
    if (ctrl && lane == 0) {
      const float yi = cluster_sum(s_part[cur], 0);
      if (t == 0) y0 = cluster_sum(s_part[cur], 1);
      const Decision r = decide(y0, yi, prep, lam, nu, true);
      lam = r.lam;
      nu = r.nu;
      if (r.acc) {
#pragma unroll
        for (int k = 0; k < 16; ++k) s_x[k] = s_xi[cur][k];
      }
      const bool ended = r.acc || r.crj;
      const bool stop = ended || t + 1 >= a.max_trials;
      if (stop && rank == 0) {
        a.lam[s] = lam;
        a.nu[s] = nu;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          a.x[16 * s + k] = s_x[k];
          a.delta_done[16 * s + k] = ended ? s_delta[cur][k] : (k % 5 == 0 ? 1.0f : 0.0f);
        }
        a.done[s] = ended;
        a.accepted[s] = r.acc;
        a.conv[s] = r.crj;
        a.act[s] = !ended;
        a.j[s] = t + 1;
      }
      if (!stop && t == 0) propose_into(lam, cur ^ 1);  // lambda grown
      s_go = !stop;
    }
    __syncthreads();
    if (!s_go) break;
  }
}

}  // namespace

// H (B, 6, 6), b (B, 6), lam (B,) f32; zero (B,) bool (1 byte each) or
// null; d (B, 6), delta (B, 4, 4) f32, all contiguous. One thread per
// stream on `stream`, no allocation, no synchronization. Returns
// cudaErrorInvalidValue for B < 1, else cudaGetLastError().
extern "C" int ddlo_lm_propose(const void* H, const void* b, const void* lam, const void* zero, int B,
                               void* d, void* delta, void* stream)
{
  if (B < 1) return (int)cudaErrorInvalidValue;
  lm_propose_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(H), static_cast<const float*>(b), static_cast<const float*>(lam),
      static_cast<const uint8_t*>(zero), B, static_cast<float*>(d), static_cast<float*>(delta));
  return (int)cudaGetLastError();
}

// y0, yi, lam, nu (B,) f32; d, b (B, 6); delta, xi, x, delta_done
// (B, 4, 4) f32; done, accepted, conv, act (B,) bool; j () int32; all
// contiguous. lam, nu, x, delta_done, the four flags and j are updated in
// place; rot_eps / trans_eps: the convergence epsilons in f32. Returns
// cudaErrorInvalidValue for B < 1, else cudaGetLastError().
extern "C" int ddlo_lm_decide(const void* y0, const void* yi, const void* d, const void* b,
                              const void* delta, const void* xi, void* lam, void* nu, void* x,
                              void* delta_done, void* done, void* accepted, void* conv, void* act,
                              void* j, int B, float rot_eps, float trans_eps, void* stream)
{
  if (B < 1) return (int)cudaErrorInvalidValue;
  lm_decide_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(y0), static_cast<const float*>(yi), static_cast<const float*>(d),
      static_cast<const float*>(b), static_cast<const float*>(delta), static_cast<const float*>(xi),
      static_cast<float*>(lam), static_cast<float*>(nu), static_cast<float*>(x),
      static_cast<float*>(delta_done), static_cast<uint8_t*>(done), static_cast<uint8_t*>(accepted),
      static_cast<uint8_t*>(conv), static_cast<uint8_t*>(act), static_cast<int*>(j), B, rot_eps,
      trans_eps);
  return (int)cudaGetLastError();
}

// The whole lambda loop of B streams in one launch. x0 (B, 4, 4), lam
// (B,), H (B, 6, 6), b (B, 6) f32; src (B, N, 3), M (B, N, 3, 3) f32 and
// valid (B, N) bool, contiguous; B's point n of stream s at Bp + s *
// b_stream + n * b_row floats (3 contiguous floats); run (B,) bool or
// null, degenerate (B,) bool: a stream runs trials when run and not
// degenerate. lam is updated in place; nu (B,), x, delta_done (B, 4, 4)
// f32, done, accepted, conv, act (B,) bool and j (B,) int32 (each
// stream's trials) are written. One cluster of 8 blocks per stream on
// `stream`, no allocation, no synchronization. Returns
// cudaErrorInvalidValue for B < 1 or N < 1, else cudaGetLastError().
extern "C" int ddlo_lm_inner(const void* x0, void* lam, const void* H, const void* b, const void* src,
                             const void* valid, const void* M, const void* Bp, long long b_stream,
                             int b_row, const void* run, const void* degenerate, void* nu, void* x,
                             void* delta_done, void* done, void* accepted, void* conv, void* act,
                             void* j, int B, int N, int max_trials, float rot_eps, float trans_eps,
                             void* stream)
{
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  InnerArgs a;
  a.x0 = static_cast<const float*>(x0);
  a.lam = static_cast<float*>(lam);
  a.H = static_cast<const float*>(H);
  a.b = static_cast<const float*>(b);
  a.src = static_cast<const float*>(src);
  a.valid = static_cast<const uint8_t*>(valid);
  a.M = static_cast<const float*>(M);
  a.Bp = static_cast<const float*>(Bp);
  a.b_stream = b_stream;
  a.b_row = b_row;
  a.run = static_cast<const uint8_t*>(run);
  a.degenerate = static_cast<const uint8_t*>(degenerate);
  a.nu = static_cast<float*>(nu);
  a.x = static_cast<float*>(x);
  a.delta_done = static_cast<float*>(delta_done);
  a.done = static_cast<uint8_t*>(done);
  a.accepted = static_cast<uint8_t*>(accepted);
  a.conv = static_cast<uint8_t*>(conv);
  a.act = static_cast<uint8_t*>(act);
  a.j = static_cast<int*>(j);
  a.N = N;
  a.K = N > kPartials ? (N + kPartials - 1) / kPartials : 1;
  a.max_trials = max_trials;
  a.rot_eps = rot_eps;
  a.trans_eps = trans_eps;

  const long long staged = inner_shared_bytes(a.K);
  const bool shared = a.K <= kMaxSharedK;
  void (*kernel)(const InnerArgs) = shared ? lm_inner_kernel<true> : lm_inner_kernel<false>;
  if (shared && staged > 48 * 1024) {
    // above 48 KB a kernel takes dynamic shared memory only once allowed,
    // per device (a host call, made before the first launch on each)
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !allowed[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBudget);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = shared ? (size_t)staged : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the largest N whose points the lm_inner kernel keeps in shared memory
extern "C" int ddlo_lm_inner_shared_max_n() { return kMaxSharedK * kPartials; }

// the error's partial sums: blocks per cluster and threads per block
extern "C" int ddlo_lm_inner_layout() { return kCluster * 1000 + kInnerThreads; }
