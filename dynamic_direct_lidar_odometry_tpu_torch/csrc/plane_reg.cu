// PLANE-regularized covariances for Hopper (sm_90a): two entry points.
//
// ddlo_window_plane_cov computes what the JAX package's plane_covariances
// (dynamic_direct_lidar_odometry_tpu/ops/covariance.py:26) computes on its
// accelerator branch, _window_self_covariances (:89), then
// regularize_plane (:213), then the mask, in one launch: for each row of
// a Morton-sorted cloud, its k nearest among the 384 rows of its 128-row
// block and the two blocks beside it (rolled), every candidate with d2 <=
// the k-th smallest weighted in, their block-anchored moments, and the
// regularization below; identity for a masked row. The JAX package leaves
// this to XLA (no Pallas kernel). Its plain version is the port's
// ops/covariance.py window_plane_covariances_plain, which writes the
// order out: XLA's on the CPU (window_cov_kernel's comment), so both give
// the jitted JAX function's CPU bits.
//
// ddlo_plane_reg is the regularization alone (the exact k-NN branch):
// each symmetric covariance becomes I - (1 - 1e-3) n n^T, n the unit
// eigenvector of its smallest eigenvalue by the closed form (Cardano's
// eigenvalue, then the largest cross product of two rows of A - lmin I;
// e_z when that is ~0), smallest_eigvec_sym3 (:165). The port's plain
// version, ops/covariance.py regularize_plane_plain, rounds as XLA's CPU
// fusions do (its comments say how that was read); both entry points run
// that chain operation for operation, in registers, one thread per
// matrix (the device function regularize):
//   - every f32 operation is one __fadd_rn / __fsub_rn / __fmul_rn /
//     __fmaf_rn (the build passes --fmad=false and no --ftz, so nothing
//     else contracts or flushes), each _fma of the plain version one
//     __fmaf_rn;
//   - denormals are flushed (ftz below) exactly where the plain version
//     calls _ftz, and nowhere else; a flushed zero is +0, as hardshrink's;
//   - the plain version's roots and quotients go through f64 and round
//     once to f32: correctly rounded (53 >= 2 * 24 + 2), the bits of
//     __fsqrt_rn / __fdiv_rn, which the kernels take (NaN payloads aside);
//   - glibc's cosf (f64 range reduction and polynomials) and its fdlibm
//     atan2f / atanf (f32), which XLA calls for cos and arccos, are the
//     plain version's _cosf, _atan2f and _atanf;
//   - a comparison with a constant compares with the constant rounded to
//     f32, as PyTorch does with a Python number;
//   - every constant is written as the exact hex of the f32 (or f64) value
//     the plain version uses, so no decimal literal is rounded twice.
//
// What bounds them on an H100. ddlo_plane_reg: bytes, 72 a matrix (0.35
// us for 16,384 at 3.35 TB/s; its 123 f32 and 27 f64 operations take 0.06
// and 0.03 us); the launch costs more, so one thread per matrix is the
// whole design. ddlo_window_plane_cov: operations, 8 a (query, candidate)
// pair for d2 (6,291,456 pairs at 16,384 points: 1.5 us at the FP32 rate,
// against 0.24 us for its 49 bytes a row). The design is set by the
// selection, which the plain version leaves to torch.topk over a
// (N / 128, 128, 384) distance tensor written and read five times. Here
// one CTA per (block, 8 queries) stages the 384 anchored candidates
// (6 KB) in shared memory, and skips even that when all its rows are
// masked (a masked row is the identity whatever its covariance: on a
// bench scan ~70 % of the rows are sentinels). A warp takes a query, 12
// d2 a lane in registers; rk comes from a bisection over order-preserving
// keys (2 operations a pair a round in two chains, the warp's count one
// redux; it ends when a round counts exactly k: ~15 rounds, 32 at most;
// any k, any ties) and the moments from a pass over the selected
// candidates only; then one thread per query of the CTA runs the
// regularization (its long serial chain issues once for 8
// queries, not once per warp).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// the largest f32 denormal: |x| <= this is flushed
constexpr float kDenormMax = 0x1.fffffcp-127f;

__device__ __forceinline__ float ftz(float x)
{
  return (x >= -kDenormMax && x <= kDenormMax) ? 0.0f : x;
}

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// the plain version's _fma and _mul (flushed) and its clamps (NaN passes)
__device__ __forceinline__ float fma_z(float a, float b, float c) { return ftz(__fmaf_rn(a, b, c)); }
__device__ __forceinline__ float mul_z(float a, float b) { return ftz(__fmul_rn(a, b)); }
__device__ __forceinline__ float clamp_min(float x, float lo) { return (x != x) ? x : (x < lo ? lo : x); }
__device__ __forceinline__ float clamp(float x, float lo, float hi)
{
  return (x != x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}

// _sqrt_rn (not flushed) and _div_rn (flushed): the plain version's f64
// root or quotient rounded once to f32 is the correctly rounded f32 one
// (53 >= 2 * 24 + 2), which __fsqrt_rn / __fdiv_rn give directly
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ float div_rn(float a, float b) { return ftz(__fdiv_rn(a, b)); }

// f32 constants of the chain (covariance._CONSTS)
constexpr float kOne = 1.0f, kTwo = 2.0f, kOneHalf = 1.5f, kHalf = 0.5f;
constexpr float kThird = 0x1.555556p-2f, kSixth = 0x1.555556p-3f;
constexpr float kTwoPi3 = 0x1.0c1524p+1f, kPlane = 0x1.ff7ceep-1f;
constexpr float kPi = 0x1.921fb6p+1f, kPiLo = -0x1.777a5cp-24f, kPiO2 = 0x1.921fb6p+0f;
constexpr float kClampP = 0x1.4484c0p-100f;  // 1e-30
constexpr float kNrmMin = 0x1.197998p-40f;   // 1e-12

// glibc's fdlibm atanf (sysdeps/ieee754/flt-32/s_atanf.c) for x >= 0, as
// covariance._atanf: every operation rounded to f32
__device__ float atanf_glibc(float x)
{
  const float at0 = 0x1.555556p-2f, at1 = -0x1.99999ap-3f, at2 = 0x1.24924ap-3f;
  const float at3 = -0x1.c71c70p-4f, at4 = 0x1.745cdcp-4f, at5 = -0x1.3b0f2ap-4f;
  const float at6 = 0x1.10d66ap-4f, at7 = -0x1.dde2d6p-5f, at8 = 0x1.97b4b2p-5f;
  const float at9 = -0x1.2b4442p-5f, at10 = 0x1.0ad3aep-6f;
  const float hi3 = 0x1.921fb4p+0f, lo3 = 0x1.4442d0p-24f;
  const int bits = __float_as_int(x);
  const int idx = (bits >= 0x3EE00000) + (bits >= 0x3F300000) + (bits >= 0x3F980000)
                  + (bits >= 0x401C0000) - 1;
  float red = x;
  if (idx == 0) {
    red = __fdiv_rn(fsub(fmul(kTwo, x), kOne), fadd(kTwo, x));
  } else if (idx == 1) {
    red = __fdiv_rn(fsub(x, kOne), fadd(x, kOne));
  } else if (idx == 2) {
    red = __fdiv_rn(fsub(x, kOneHalf), fadd(kOne, fmul(kOneHalf, x)));
  } else if (idx == 3) {
    red = __fdiv_rn(-kOne, x);
  }
  const float z = fmul(red, red);
  const float w = fmul(z, z);
  float t = fadd(at8, fmul(w, at10));
  t = fadd(at6, fmul(w, t));
  t = fadd(at4, fmul(w, t));
  t = fadd(at2, fmul(w, t));
  const float s1 = fmul(z, fadd(at0, fmul(w, t)));
  float r = fadd(at7, fmul(w, at9));
  r = fadd(at5, fmul(w, r));
  r = fadd(at3, fmul(w, r));
  const float s2 = fmul(w, fadd(at1, fmul(w, r)));
  const float tail = fmul(red, fadd(s1, s2));
  // atanhi[idx], atanlo[idx] (selected, not indexed: no local memory)
  const float hi = idx == 0 ? 0x1.dac670p-2f : idx == 1 ? 0x1.921fb4p-1f
                 : idx == 2 ? 0x1.f730bcp-1f : hi3;
  const float lo = idx == 0 ? 0x1.586ed2p-28f : idx == 1 ? 0x1.4442d0p-25f
                 : idx == 2 ? 0x1.281f68p-25f : lo3;
  float out = idx < 0 ? fsub(red, tail) : fsub(hi, fsub(fsub(tail, lo), red));
  if (bits >= 0x4C000000) out = fadd(hi3, lo3);
  return out;
}

// glibc's atan2f (sysdeps/ieee754/flt-32/e_atan2f.c) for y >= 0, as
// covariance._atan2f (its later selections override the earlier ones)
__device__ float atan2f_glibc(float y, float x)
{
  const int ix = __float_as_int(x) & 0x7FFFFFFF;
  const int iy = __float_as_int(y) & 0x7FFFFFFF;
  const int e = (iy - ix) >> 23;
  const bool neg = signbit(x);
  float z = atanf_glibc(fabsf(__fdiv_rn(y, x)));
  if (e > 60) z = fadd(kPiO2, fmul(kHalf, kPiLo));
  if (neg && e < -60) z = 0.0f;
  float out = neg ? fsub(kPi, fsub(z, kPiLo)) : z;
  if (x == 1.0f) out = atanf_glibc(y);
  if (iy == 0) out = neg ? kPi : y;
  if (ix == 0) out = kPiO2;
  if (x != x || y != y) out = fadd(x, y);
  return out;
}

// glibc's cosf (sysdeps/ieee754/flt-32/s_cosf.c, tables of sincosf_data.c)
// for pi/4 <= |y| < 120, as covariance._cosf: f64 throughout, rounded once
__device__ float cosf_glibc(float y)
{
  const double hpi_inv = 0x1.45f306dc9c883p+23, hpi = 0x1.921fb54442d18p+0;
  const double c1 = -0x1.ffffffd0c621cp-2, c2 = 0x1.55553e1068f19p-5;
  const double c3 = -0x1.6c087e89a359dp-10, c4 = 0x1.99343027bf8c3p-16;
  const double s0 = -0x1.555545995a603p-3, s1 = 0x1.1107605230bc4p-7;
  const double s2 = -0x1.994eb3774cf24p-13;
  double x = (double)y;
  const int n = (__double2int_rz(__dmul_rn(x, hpi_inv)) + 0x800000) >> 24;
  x = __dadd_rn(x, -__dmul_rn((double)n, hpi));
  const double s = (((n + 1) & 2) == 0) ? 1.0 : -1.0;
  const double flip = ((n & 2) != 0) ? -1.0 : 1.0;
  const double x2 = __dmul_rn(x, x);
  const double xs = __dmul_rn(x, s);
  const double x3 = __dmul_rn(xs, x2);
  const double sin_r = __dadd_rn(__dadd_rn(xs, __dmul_rn(x3, s0)),
                                 __dmul_rn(__dmul_rn(x3, x2), __dadd_rn(s1, __dmul_rn(x2, s2))));
  const double k0 = flip, k1 = __dmul_rn(flip, c1), k2 = __dmul_rn(flip, c2);
  const double k3 = __dmul_rn(flip, c3), k4 = __dmul_rn(flip, c4);
  const double x4 = __dmul_rn(x2, x2);
  const double cos_r = __dadd_rn(__dadd_rn(__dadd_rn(k0, __dmul_rn(x2, k1)), __dmul_rn(x4, k2)),
                                 __dmul_rn(__dmul_rn(x4, x2), __dadd_rn(k3, __dmul_rn(x2, k4))));
  return __double2float_rn(((n & 1) == 0) ? cos_r : sin_r);
}

// covariance._sumsq: fma(v2, v2, fma(v1, v1, v0 * v0))
__device__ __forceinline__ float sumsq(float v0, float v1, float v2)
{
  return fma_z(v2, v2, fma_z(v1, v1, mul_z(v0, v0)));
}

// covariance._cross: each lane's first product contracted
__device__ __forceinline__ void cross(const float u[3], const float v[3], float out[3])
{
  out[0] = fma_z(u[1], v[2], -mul_z(u[2], v[1]));
  out[1] = fma_z(u[2], v[0], -mul_z(u[0], v[2]));
  out[2] = fma_z(u[0], v[1], -mul_z(u[1], v[0]));
}

// covariance._smallest_eigvec for one matrix (row-major, 9 floats)
__device__ void smallest_eigvec(const float A[9], float n[3])
{
  const float a00 = ftz(A[0]), a01 = ftz(A[1]), a02 = ftz(A[2]);
  const float a11 = ftz(A[4]), a12 = ftz(A[5]), a22 = ftz(A[8]);
  const float s = ftz(fadd(ftz(fadd(a00, a11)), a22));
  const float q = mul_z(s, kThird);
  const float b00 = ftz(fsub(a00, q)), b11 = ftz(fsub(a11, q)), b22 = ftz(fsub(a22, q));
  const float sq0 = sumsq(b11, b00, b22);
  const float sq1 = sumsq(a02, a01, a12);
  const float p = sqrt_rn(clamp_min(mul_z(ftz(fadd(sq0, fmul(sq1, kTwo))), kSixth), kClampP));
  // det(A - q I): the three 2x2 minors, then their sum
  const float m0 = fma_z(b11, b22, -mul_z(a12, a12));
  const float m1 = fma_z(a01, b22, -mul_z(a12, a02));
  const float m2 = fma_z(a12, a01, -mul_z(b11, a02));
  const float detB = fma_z(a02, m2, fma_z(b00, m0, -mul_z(a01, m1)));
  const float r = clamp(div_rn(detB, mul_z(mul_z(fmul(p, kTwo), p), p)), -1.0f, 1.0f);
  const float acos = atan2f_glibc(sqrt_rn(mul_z(fsub(kOne, r), fadd(r, kOne))), r);
  const float cs = cosf_glibc(fma_z(acos, kThird, kTwoPi3));
  const float p2 = fmul(p, kTwo);
  // lmin of c01's fusion (q's product contracted), and of c02's and c12's
  const float lmin0 = fma_z(s, kThird, mul_z(cs, p2));
  const float lmin1 = fma_z(cs, p2, q);
  const float r0a[3] = {ftz(fsub(a00, lmin0)), a01, a02};
  const float r1a[3] = {a01, ftz(fsub(a11, lmin0)), a12};
  const float r0b[3] = {ftz(fsub(a00, lmin1)), a01, a02};
  const float r1b[3] = {a01, ftz(fsub(a11, lmin1)), a12};
  const float r2[3] = {a02, a12, ftz(fsub(a22, lmin1))};
  float c01[3], c02[3], c12[3];
  cross(r0a, r1a, c01);
  cross(r0b, r2, c02);
  cross(r1b, r2, c12);
  const float n01 = sumsq(c01[0], c01[1], c01[2]);
  const float n02 = sumsq(c02[0], c02[1], c02[2]);
  const float n12 = sumsq(c12[0], c12[1], c12[2]);
  const bool take01 = n01 >= n02 && n01 >= n12, take02 = n02 >= n12;
  float best[3];
  for (int i = 0; i < 3; ++i) best[i] = take01 ? c01[i] : (take02 ? c02[i] : c12[i]);
  const float nrm = sqrt_rn(sumsq(best[0], best[1], best[2]));
  if (nrm > kNrmMin) {
    const float d = clamp_min(nrm, kClampP);
    for (int i = 0; i < 3; ++i) n[i] = div_rn(best[i], d);
  } else {
    n[0] = 0.0f;
    n[1] = 0.0f;
    n[2] = 1.0f;
  }
}

// I - (1 - 1e-3) n n^T of A's smallest eigenvector n, rounded as
// regularize_plane_plain's last line: fma(-(n_a (1 - 1e-3)), n_b, I_ab),
// flushed; `out` row-major
__device__ __forceinline__ void regularize(const float A[9], float* __restrict__ out)
{
  float n[3];
  smallest_eigvec(A, n);
  for (int a = 0; a < 3; ++a) {
    const float na = -mul_z(n[a], kPlane);
    for (int b = 0; b < 3; ++b) out[a * 3 + b] = fma_z(na, n[b], a == b ? 1.0f : 0.0f);
  }
}

// ---- ddlo_plane_reg: one thread per matrix ----

__global__ void __launch_bounds__(kThreads)
plane_reg_kernel(const float* __restrict__ cov, int m, float* __restrict__ out)
{
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= m) return;
  float A[9];
  for (int i = 0; i < 9; ++i) A[i] = cov[(size_t)row * 9 + i];
  regularize(A, out + (size_t)row * 9);
}

// ---- ddlo_window_plane_cov: the Morton-window covariances, regularized ----
//
// covariance.window_plane_covariances_plain, in its order (XLA's on the
// CPU): the 384 candidates j of a query, j = t * kLanes + l in lane l of
// its warp; each sum over the selected ones in 4 accumulators by j mod 4,
// each in ascending j (an unselected candidate skipped), then
// (a0 + a1) + (a2 + a3); cov = fma(-mean_a, mean_b, sum_ab / cnt).

constexpr int kBlockRows = 128;                  // rows of a Morton block
constexpr int kCands = 3 * kBlockRows;           // a query's block and the two beside it
constexpr int kLanes = 32;                       // a warp per query
constexpr int kPerLane = kCands / kLanes;        // 12
constexpr int kQueries = 8;                      // queries (warps) per CTA
constexpr int kWinThreads = kQueries * kLanes;   // 256
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kValueRounds = 10;                 // the bisection's rounds in value, at most
constexpr float kPad = 3.0e12f;                  // the virtual rows past N

// order-preserving key of a float (-0 below +0; the finite floats and the
// infinities between 0x007FFFFF and 0xFF800000), and its inverse
__device__ __forceinline__ unsigned key_of(float x)
{
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of(unsigned key)
{
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// the sign bit of tf - d: 1 where d > tf. The sign of a rounded
// difference is the exact one's; equal values give +0, and -0 - +0 = -0
// keeps -0 below +0, as the keys do
__device__ __forceinline__ unsigned above(float tf, float d)
{
  return __float_as_uint(__fsub_rn(tf, d)) >> 31;
}

// count(d <= tf) over the warp's candidates (12 a lane, two chains)
__device__ __forceinline__ int count_le(const float (&d)[kPerLane], float tf)
{
  unsigned gt0 = 0u, gt1 = 0u;
#pragma unroll
  for (int t = 0; t < kPerLane; t += 2) {
    gt0 += above(tf, d[t]);
    gt1 += above(tf, d[t + 1]);
  }
  return kCands - (int)__reduce_add_sync(kFull, gt0 + gt1);
}

// one live query's window covariance (c00, c01, c02, c11, c12, c22) into
// c6, by the warp (lane 0 writes); the candidates staged in cand
__device__ __forceinline__ void query_cov(const float4* __restrict__ cand, int qi, int lane, int k,
                                          float* __restrict__ c6)
{
  const float4 yq = cand[kBlockRows + qi];

  // d2 = (|yq|^2 + |yc|^2) - 2 yq.yc, the dots as XLA's CPU loops
  // (fma(a2, b2, fma(a1, b1, a0 b0))), the rest rounded op by op
  float d[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const float4 c = cand[t * kLanes + lane];
    const float cross = __fmaf_rn(yq.z, c.z, __fmaf_rn(yq.y, c.y, __fmul_rn(yq.x, c.x)));
    d[t] = __fsub_rn(__fadd_rn(yq.w, c.w), __fmul_rn(2.0f, cross));
  }

  // rk, the k-th smallest d2 (duplicates counted, as torch.topk): the
  // least key T with count(key <= T) >= k. The bracket: the float below
  // the smallest d2 counts 0; the largest lane minimum counts >= 32 (each
  // lane's minimum is a candidate), so it bounds T for k <= 32, the
  // largest d2 for any k. Bisection halves it in value (d2 are spread
  // over a few octaves) for at most kValueRounds rounds while a float lies
  // strictly between, then in key, down to one key (a tie at the k-th
  // value never counts exactly k: in value it would crawl through every
  // exponent down to 0); the warp's count is a redux. A round whose count
  // is exactly k ends it: T is then the largest key <= mid.
  unsigned kmin = 0xFFFFFFFFu, kmax = 0u;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    kmin = min(kmin, key_of(d[t]));
    kmax = max(kmax, key_of(d[t]));
  }
  const unsigned least = max(__reduce_min_sync(kFull, kmin), 0x00800000u);  // -inf keeps NaN out
  float vlo = float_of(least - 1u);
  float vhi = float_of(__reduce_max_sync(kFull, k <= kLanes ? kmin : kmax));
  bool exact = false;
  for (int r = 0; r < kValueRounds; ++r) {
    const float mid = __fadd_rn(vlo, __fmul_rn(0.5f, __fsub_rn(vhi, vlo)));
    if (!(mid > vlo && mid < vhi)) break;  // no float between, or infinities
    const int le = count_le(d, mid);
    if (le >= k) {
      vhi = mid;
      if (le == k) {
        exact = true;
        break;
      }
    } else {
      vlo = mid;
    }
  }
  unsigned lo = key_of(vlo) + 1u, hi = key_of(vhi);
  while (!exact && lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    const int le = count_le(d, float_of(mid));
    if (le >= k) {
      hi = mid;
      exact = le == k;
    } else {
      lo = mid + 1;
    }
  }
  if (exact) {
    const float tf = float_of(hi);
    unsigned best = 0u;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (!above(tf, d[t])) best = max(best, key_of(d[t]));
    }
    hi = __reduce_max_sync(kFull, best);
  }
  const float rk = float_of(hi);

  // the selected candidates (d2 <= rk) as bits of t
  unsigned sel = 0u;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (d[t] <= rk) sel |= 1u << t;
  }
  const int cnt = (int)__reduce_add_sync(kFull, (unsigned)__popc(sel));

  // sum y (3) and y y^T (6 of 9: the matrix is symmetric bit for bit).
  // Lane v < 4 runs accumulator v: its selected candidates j = t * 32 + l
  // with l mod 4 = v, in ascending j, from the ballots of each t
  unsigned ball[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) ball[t] = __ballot_sync(kFull, (sel >> t) & 1u);
  float s[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < 4) {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      unsigned m = ball[t] & (0x11111111u << lane);
      while (m) {
        const int l = __ffs(m) - 1;
        m &= m - 1u;
        const float4 c = cand[t * kLanes + l];
        s[0] = __fadd_rn(s[0], c.x);
        s[1] = __fadd_rn(s[1], c.y);
        s[2] = __fadd_rn(s[2], c.z);
        s[3] = __fadd_rn(s[3], __fmul_rn(c.x, c.x));
        s[4] = __fadd_rn(s[4], __fmul_rn(c.x, c.y));
        s[5] = __fadd_rn(s[5], __fmul_rn(c.x, c.z));
        s[6] = __fadd_rn(s[6], __fmul_rn(c.y, c.y));
        s[7] = __fadd_rn(s[7], __fmul_rn(c.y, c.z));
        s[8] = __fadd_rn(s[8], __fmul_rn(c.z, c.z));
      }
    }
  }
  // (a0 + a1) + (a2 + a3) in lane 0
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    s[i] = __fadd_rn(s[i], __shfl_down_sync(kFull, s[i], 1));
    s[i] = __fadd_rn(s[i], __shfl_down_sync(kFull, s[i], 2));
  }
  if (lane != 0) return;
  // mean = sum_y / cnt (cnt at least 1); cov = fma(-mean_a, mean_b, sum_ab / cnt)
  const float cn = (float)max(cnt, 1);
  const float m0 = __fdiv_rn(s[0], cn), m1 = __fdiv_rn(s[1], cn), m2 = __fdiv_rn(s[2], cn);
  c6[0] = __fmaf_rn(-m0, m0, __fdiv_rn(s[3], cn));
  c6[1] = __fmaf_rn(-m0, m1, __fdiv_rn(s[4], cn));
  c6[2] = __fmaf_rn(-m0, m2, __fdiv_rn(s[5], cn));
  c6[3] = __fmaf_rn(-m1, m1, __fdiv_rn(s[6], cn));
  c6[4] = __fmaf_rn(-m1, m2, __fdiv_rn(s[7], cn));
  c6[5] = __fmaf_rn(-m2, m2, __fdiv_rn(s[8], cn));
}

__global__ void __launch_bounds__(kWinThreads)
window_cov_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask,
                  int n, int k, float* __restrict__ out)
{
  // the candidates anchored at the block's row 0: y0, y1, y2, |y|^2; the
  // queries' covariances (6 entries) for the regularization
  __shared__ float4 cand[kCands];
  __shared__ float cov[kQueries][6];
  const int blk = blockIdx.y, nb = gridDim.y;
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  const int qi = blockIdx.x * kQueries + w;  // the query's row in its block
  const int row = blk * kBlockRows + qi;
  const bool live = row < n && mask[row];
  if (row < n && !live && lane == 0) {  // identity, whatever its covariance: no work
    for (int i = 0; i < 9; ++i) out[(size_t)row * 9 + i] = (i % 4 == 0) ? 1.0f : 0.0f;
  }
  if (!__syncthreads_or(live)) return;  // no live row here: nothing to stage

  const float* anchor = points + (size_t)blk * kBlockRows * 3;  // row blk * 128 < n
#pragma unroll
  for (int j = threadIdx.x; j < kCands; j += kWinThreads) {
    // j / 128 = 0, 1, 2: the block before (rolled), this one, the one after
    const int src = ((blk + nb - 1 + j / kBlockRows) % nb) * kBlockRows + j % kBlockRows;
    float px = kPad, py = kPad, pz = kPad;
    if (src < n) {
      px = points[(size_t)src * 3];
      py = points[(size_t)src * 3 + 1];
      pz = points[(size_t)src * 3 + 2];
    }
    const float y0 = __fsub_rn(px, anchor[0]), y1 = __fsub_rn(py, anchor[1]);
    const float y2 = __fsub_rn(pz, anchor[2]);
    const float cc = __fmaf_rn(y2, y2, __fmaf_rn(y1, y1, __fmul_rn(y0, y0)));
    cand[j] = make_float4(y0, y1, y2, cc);
  }
  __syncthreads();
  if (live) query_cov(cand, qi, lane, k, cov[w]);
  __syncthreads();
  // the regularization, one thread per live query of the CTA (its
  // instructions issue once for them all, not once per warp)
  if (threadIdx.x < kQueries) {
    const int r = blk * kBlockRows + blockIdx.x * kQueries + threadIdx.x;
    if (r < n && mask[r]) {
      const float* c = cov[threadIdx.x];
      const float A[9] = {c[0], c[1], c[2], c[1], c[3], c[4], c[2], c[4], c[5]};
      regularize(A, out + (size_t)r * 9);
    }
  }
}

}  // namespace

// (m, 3, 3) f32 in, (m, 3, 3) f32 out, both contiguous; launches on
// `stream`, allocates nothing, does not synchronize, and returns
// cudaGetLastError() so a refused launch is reported.
extern "C" int ddlo_plane_reg(const void* cov, int m, void* out, void* stream)
{
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (m + kThreads - 1) / kThreads;
  plane_reg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(cov), m, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// points (n, 3) f32 and mask (n,) bool (one byte each), both contiguous;
// out (n, 3, 3) f32. 1 <= k <= 384. One CTA per (Morton block, 8 of its
// queries), a warp per query; launches on `stream`, allocates nothing, does not
// synchronize, and returns cudaGetLastError().
extern "C" int ddlo_window_plane_cov(const void* points, const void* mask, int n, int k, void* out,
                                     void* stream)
{
  if (n <= 0 || k < 1 || k > kCands) return (int)cudaErrorInvalidValue;
  const dim3 grid(kBlockRows / kQueries, (n + kBlockRows - 1) / kBlockRows);
  window_cov_kernel<<<grid, kWinThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(points), static_cast<const unsigned char*>(mask), n, k,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
