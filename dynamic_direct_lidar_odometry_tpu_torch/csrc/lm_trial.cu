// One Levenberg-Marquardt lambda trial of GICP for Hopper (sm_90a): the
// step proposal and the accept/reject update, one thread per stream.
//
// Computes the trial body of dynamic_direct_lidar_odometry_tpu/ops/gicp.py
// (:360-392) around its error re-evaluation, which stays in PyTorch (a
// 4x4 compose and a sum over every point):
//   - lm_propose_kernel: d = solve6_ldlt(H + lam I, -b) (:123, the
//     unrolled LDLT with its |pivot| < 1e-30 guard, forward and back
//     substitution), optionally d = 0 for a degenerate stream (the GN
//     branch), then delta = se3_exp(d) (core/se3.py:143: so3_exp_quat
//     with its theta^2 < 1e-10 branch, quat_to_matrix, from_rt);
//   - lm_decide_kernel: once yi = error(delta x) is known, the gain ratio
//     rho = (y0 - yi) / max(d . (lam d - b), 1e-30), accept (rho >= 0),
//     converge-on-reject (_is_converged(delta)) or reject-and-grow, the
//     new lambda and nu, the pose, the last delta and the flags, updated
//     in place; the stream's active flag drops once it is done; thread 0
//     adds one to the trial count j.
// The JAX package has no Pallas kernel here: XLA fuses the trial's scalar
// math into a few fusions. The port's plain versions (ops/gicp.py
// lm_propose_plain / lm_decide_plain) run the same function as ~300 and
// ~25 eager operations.
//
// Bits: every operation is the plain version's on the card, in its order,
// each rounded once (--fmad=false, and the _rn intrinsics besides): the
// two sums (theta^2 and the rho denominator) left to right, as the plain
// version writes them; the constants that PyTorch takes as Python scalars
// rounded to f32 first (1e-30, 1e-12, 1e-10, 1/48, 1/8, 1/3); clamp_min
// passing a NaN through as torch.clamp_min does; sinf / cosf for
// torch.sin / torch.cos; the convergence test's divisions by its
// epsilons, f32 tensors in the plain version, true f32 divisions.
//
// What bounds it on an H100: latency. A stream is ~300 dependent f32
// operations on 112 bytes in (H's lower triangle, b, lam) and 88 out
// (propose) or ~60 on 128 bytes, 336 when it accepts (decide); at
// B <= 64 streams the bytes and operations take well under a nanosecond
// at the card's rates, and the launch itself (a few microseconds) sets
// the time. The design keeps the whole trial's scalar
// math in registers of one thread per stream, fully unrolled, so each
// trial is two launches instead of ~300.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr float kPivotMin = 1e-30f;  // solve6_ldlt's pivot guard
constexpr float kEps = 1e-12f;  // se3._EPS
constexpr float kSmall = 1e-10f;  // so3_exp_quat's small-angle test
constexpr float kInv48 = (float)(1.0 / 48.0);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kDenomMin = 1e-30f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

__global__ void __launch_bounds__(kThreads)
lm_propose_kernel(const float* __restrict__ H, const float* __restrict__ b,
                  const float* __restrict__ lam, const uint8_t* __restrict__ zero, int B,
                  float* __restrict__ d_out, float* __restrict__ delta_out)
{
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const float* h = H + 36 * s;
  const float l = lam[s];
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
    float v = -b[6 * s + i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = sub(v, mul(L[i][k], y[k]));
    y[i] = v;
  }
  // L^T x = y / D
  float x[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = div(y[i], D[i]);
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v = sub(v, mul(L[k][i], x[k]));
    x[i] = v;
  }
  if (zero != nullptr && zero[s]) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) d_out[6 * s + i] = x[i];

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
  float* T = delta_out + 16 * s;
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
  const float l = lam[s], n = nu[s];

  // d^T (H + lam I) d = d . (lam d - b), summed left to right
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float dk = d[6 * s + k];
    const float p = mul(dk, sub(mul(l, dk), b[6 * s + k]));
    dot = k == 0 ? p : add(dot, p);
  }
  const float rho = div(sub(y0[s], yi[s]), clamp_min(dot, kDenomMin));
  const bool reject = rho < 0.0f;

  // _is_converged(delta): every |R - I| / rot_eps and |t| / trans_eps below 1
  const float* dl = delta + 16 * s;
  bool converged = true;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      converged &= div(fabsf(sub(dl[4 * r + c], r == c ? 1.0f : 0.0f)), rot_eps) < 1.0f;
    converged &= div(fabsf(dl[4 * r + 3]), trans_eps) < 1.0f;
  }

  const bool a = act[s] != 0;
  const bool acc = a && !reject;
  const bool crj = a && reject && converged;
  const bool grow = a && reject && !crj;
  const float t = sub(mul(2.0f, rho), 1.0f);
  const float shrink = clamp_min(sub(1.0f, mul(mul(t, t), t)), kThird);
  lam[s] = acc ? mul(l, shrink) : (grow ? mul(n, l) : l);
  nu[s] = grow ? mul(2.0f, n) : n;
  if (acc) {
#pragma unroll
    for (int k = 0; k < 16; ++k) x[16 * s + k] = xi[16 * s + k];
  }
  if (acc || crj) {
#pragma unroll
    for (int k = 0; k < 16; ++k) delta_done[16 * s + k] = dl[k];
  }
  done[s] = done[s] || acc || crj;
  accepted[s] = accepted[s] || acc;
  conv[s] = conv[s] || crj;
  act[s] = a && !(acc || crj);
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
