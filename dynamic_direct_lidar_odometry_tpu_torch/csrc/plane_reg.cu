// PLANE regularization of 3x3 covariances for Hopper (sm_90a).
//
// Computes dynamic_direct_lidar_odometry_tpu/ops/covariance.py's
// regularize_plane (:213) with smallest_eigvec_sym3 (:165): each symmetric
// covariance becomes I - (1 - 1e-3) n n^T, n the unit eigenvector of its
// smallest eigenvalue by the closed form (Cardano's eigenvalue, then the
// largest cross product of two rows of A - lmin I; e_z when that is ~0).
// The JAX package leaves this to XLA (no Pallas kernel). The port's plain
// version, ops/covariance.py regularize_plane_plain, rounds as XLA's CPU
// fusions do (its comments say how that was read); this kernel is that
// chain operation for operation, in registers, one thread per matrix:
//   - every f32 operation is one __fadd_rn / __fsub_rn / __fmul_rn /
//     __fmaf_rn (the build passes --fmad=false and no --ftz, so nothing
//     else contracts or flushes), each _fma of the plain version one
//     __fmaf_rn;
//   - denormals are flushed (ftz below) exactly where the plain version
//     calls _ftz, and nowhere else; a flushed zero is +0, as hardshrink's;
//   - roots and quotients go through f64 and round once to f32, as the
//     plain version's _sqrt_rn / _div_rn: correctly rounded (53 >= 2 * 24
//     + 2), the same bits as __fsqrt_rn / __fdiv_rn;
//   - glibc's cosf (f64 range reduction and polynomials) and its fdlibm
//     atan2f / atanf (f32), which XLA calls for cos and arccos, are the
//     plain version's _cosf, _atan2f and _atanf;
//   - a comparison with a constant compares with the constant rounded to
//     f32, as PyTorch does with a Python number;
//   - every constant is written as the exact hex of the f32 (or f64) value
//     the plain version uses, so no decimal literal is rounded twice.
//
// What bounds it on an H100: bytes. 72 bytes per matrix (9 f32 in, 9
// out) take 0.35 us for 16,384 matrices at 3.35 TB/s; the 116 f32 and 34
// f64 operations per matrix (counted in chip_smoke.py) take 0.06 and 0.03
// us at the card's FP32 and FP64 rates. At that size the launch itself
// costs more than either, so one thread per matrix, nine loads and nine
// stores at a 36-byte stride, is the whole design: one launch where the
// plain version makes ~700.

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

// _sqrt_rn (not flushed) and _div_rn (flushed)
__device__ __forceinline__ float sqrt_rn(float x) { return __double2float_rn(__dsqrt_rn((double)x)); }
__device__ __forceinline__ float div_rn(float a, float b)
{
  return ftz(__double2float_rn(__ddiv_rn((double)a, (double)b)));
}

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

// ---- kernel ----

__global__ void __launch_bounds__(kThreads)
plane_reg_kernel(const float* __restrict__ cov, int m, float* __restrict__ out)
{
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= m) return;
  float A[9];
  for (int i = 0; i < 9; ++i) A[i] = cov[(size_t)row * 9 + i];
  float n[3];
  smallest_eigvec(A, n);
  // fma(-(n_a (1 - 1e-3)), n_b, I_ab), flushed
  for (int a = 0; a < 3; ++a) {
    const float na = -mul_z(n[a], kPlane);
    for (int b = 0; b < 3; ++b) {
      out[(size_t)row * 9 + a * 3 + b] = fma_z(na, n[b], a == b ? 1.0f : 0.0f);
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
