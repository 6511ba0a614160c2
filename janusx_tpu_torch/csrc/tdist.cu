// T1 — the two-sided Student-t p of every SNP of an LM scan, one thread a
// lane, in f64.
//
// Replaces no Pallas kernel. The JAX package forms this p on the host
// (janusx_tpu/models/lm.py:33-48, scipy's betainc over every SNP, called at
// :314); the port's plain version, ops/kernels.py:student_t_p_plain, is the
// same algorithm as torch ops, which the wrapper takes for tensors on the
// CPU. As torch
// ops on the card it was ~27 launches a step of a continued fraction that
// needs ~90 steps at n = 5,000: some 3,000 launches a scan of 500,000 SNPs,
// each of a few microseconds of device work, so the host's launching was
// the cost. Here a lane runs its own steps and stops at its own
// convergence, in one launch.
//
// p = I_x(df/2, 1/2) at x = df / (df + t^2) (Numerical Recipes 6.4, betai):
// the front factor x^a (1-x)^b / B(a, b) from log B(a, b), which the
// wrapper passes, times the continued fraction by the modified Lentz method
// (betacf); past the turning point x >= (a + 1) / (a + b + 2) it is
// 1 - I_{1-x}(b, a), whose fraction converges there. 1 - x is formed from
// t, not from the rounded x. A lane stops at the first step whose factor
// is within EPS of 1. NaN t gives NaN, infinite t DBL_MIN, a value that is
// not finite 1; the rest is clamped to [DBL_MIN, 1], as the host's
// models/lm.py:student_t_p_two_sided does.
//
// What bounds it on the H100: the f64 units. At n = 5,000 a lane takes
// ~20-90 steps of four f64 divisions and ~12 other f64 operations; for
// 500,000 lanes that is ~3·10^9 f64 operations, under a millisecond at the
// card's f64 rate, against 8 MB read and written once.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAX_STEPS = 4096;  // ops/kernels.py _CF_MAX_STEPS
constexpr double EPS = 1e-15;    // ops/kernels.py _CF_EPS
constexpr double TINY = 1e-300;  // ops/kernels.py _CF_TINY

__device__ __forceinline__ double off_zero(double v) { return fabs(v) < TINY ? TINY : v; }

__device__ double betacf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0;
  double d = 1.0 / off_zero(1.0 - qab / qap * x);
  double h = d;
  for (int m = 1; m <= MAX_STEPS; ++m) {
    const double m2 = 2.0 * m;
    double k = m * (b - m) / ((qam + m2) * (a + m2));
    d = 1.0 / off_zero(1.0 + k * x * d);
    c = off_zero(1.0 + k * x / c);
    h *= d * c;
    k = -(a + m) * (qab + m) / ((a + m2) * (qap + m2));
    d = 1.0 / off_zero(1.0 + k * x * d);
    c = off_zero(1.0 + k * x / c);
    const double last = d * c;
    h *= last;
    if (fabs(last - 1.0) <= EPS) break;
  }
  return h;
}

__global__ void __launch_bounds__(NT) student_t_p_kernel(const double* __restrict__ t,
                                                         double* __restrict__ p, long long n,
                                                         double df, double log_beta) {
  const double a = 0.5 * df, b = 0.5, turn = (a + 1.0) / (a + b + 2.0);
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * NT) {
    const double ti = t[i];
    double v;
    if (isnan(ti)) {
      v = ti;
    } else if (isinf(ti)) {
      v = DBL_MIN;
    } else {
      const double tt = ti * ti;
      const double x = df / (df + tt);
      const double xc = isinf(tt) ? 1.0 : tt / (df + tt);
      const double front = exp(-log_beta - a * log1p(tt / df) + b * log(xc));
      v = x >= turn ? 1.0 - front * betacf(b, a, xc) / b : front * betacf(a, b, x) / a;
      v = isfinite(v) ? fmin(fmax(v, DBL_MIN), 1.0) : 1.0;
    }
    p[i] = v;
  }
}

}  // namespace

// t and p: n f64 each, contiguous, on the stream's device; df > 0;
// log_beta = log B(df/2, 1/2). Returns cudaGetLastError() after the launch.
extern "C" int jx_student_t_p(const double* t, double* p, long long n, double df,
                              double log_beta, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (!(df > 0.0)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + NT - 1) / NT;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  student_t_p_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(t, p, n, df, log_beta);
  return static_cast<int>(cudaGetLastError());
}
