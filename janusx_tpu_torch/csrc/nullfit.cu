// N1 — the null REML fit of the dense LMM: each lane's whole lockstep Brent
// over log10 lambda inside one thread block, one launch for every lane.
//
// Replaces no Pallas kernel. It replaces the XLA loop of the null fit in
// janusx_tpu/core/reml.py (fit_null_reml: the lax.while_loop of
// janusx_tpu/ops/brent.py over neg_reml_null), which the port ran as torch
// ops (core/reml.py:fit_null_reml_plain, ops/brent.py's
// brent_minimize_batched over neg_reml_null): ~8,200 launches and a host
// sync every Brent iteration for a fit of under 2 M flops. Its plain
// version is core/reml.py:fit_null_reml_plain, which fit_null_reml takes
// for states on the CPU.
//
// A lane is one trait's rotated state: per lane PXy (n, p) and Pyy (n). The
// eigenvalues s (n) and the covariate products PXX (n, p*p) are shared by
// every lane of a launch (traits on one sample mask and one basis). Each
// evaluation of -REML(log10 lambda), with v = s + 10^x and w = 1/v, is
// 1. one block-wide f64 reduction over the samples of w PXX, w PXy, w Pyy,
//    log v and the flag "some v <= 0": each thread takes the rows
//    tid, tid + NT, ... and holds CH columns in registers per pass; then a
//    butterfly of warp shuffles, and the warps' partials summed in order
//    from shared memory;
// 2. the small algebra on one warp, in f64, with the p x p matrix in shared
//    memory (past p = SMEM_MAX_P, where the sums, the factor and the solve
//    no longer fit, in a workspace of the lane's own in global memory,
//    which the wrapper allocates): the Cholesky of M + ridge I with its
//    failure flag, beta, log|A|, r'Wr, the REML and ML values and the 1e8
//    sentinel, as core/reml.py's neg_reml_null and ml_null compute them;
// 3. one thread's Brent step, brent_minimize_batched's step for step (the
//    start at the midpoint, the parabolic trial, the golden fallback,
//    tol1/tol2, the edge clamp, e left untouched on an accepted parabolic
//    step, the stop test), in round-to-nearest intrinsics so that no
//    multiply-add is fused where the torch version rounds twice. It
//    publishes the next trial point through shared memory.
// A lane's result depends on its own operands only: every block runs the
// same instructions in the same order, so a lane gives the same bits in
// any launch. It differs from the plain version by the order of the f64
// sums.
//
// What bounds it on the H100: neither bytes nor operations. At n = 5,000
// and p = 1 an evaluation reads 160 KB (from L2 after the first) and does
// ~20 k flops; a fit waits on a chain of ~30-60 dependent evaluations, each
// a block reduction (a division and a log per row, five shuffle rounds,
// three barriers), the warp's algebra and the one-thread Brent step. The
// design keeps that chain on one SM with no launch and no host round trip
// between evaluations; lanes run on separate SMs, so T lanes take about the
// time of one.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;             // threads per block (one block per lane)
constexpr int NW = NT / 32;
constexpr int CH = 8;               // reduction columns a thread holds per pass
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may opt in to
constexpr double GOLD = 0.3819660;  // ops/brent.py _GOLD
constexpr double BAD = 1e8;         // core/reml.py _BAD
constexpr unsigned FULL = 0xffffffffu;

// a lane's work buffers in doubles: the sums [M (p*p) | rhs (p) | a_yy |
// log|V|], the factor L (p*p) and the solve (p)
__host__ __device__ constexpr size_t work_doubles(int p) {
  return 2 * static_cast<size_t>(p) * p + 2 * static_cast<size_t>(p) + 2;
}

// shared memory in doubles: the warps' partials (NW x CH), the published
// trial point and stop flag, and the work buffers when they fit
constexpr size_t FIXED_DOUBLES = NW * CH + 2;
__host__ __device__ constexpr size_t smem_doubles(int p) {
  return FIXED_DOUBLES + work_doubles(p);
}

// the largest p whose work buffers fit in shared memory; past it they lie in
// a global workspace
constexpr int SMEM_MAX_P = 119;
static_assert(smem_doubles(SMEM_MAX_P) * 8 <= SMEM_LIMIT &&
                  smem_doubles(SMEM_MAX_P + 1) * 8 > SMEM_LIMIT,
              "SMEM_MAX_P is the largest p whose buffers fit a block's shared memory");

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// The sums of one evaluation at lambda = lbd into sums[0, p*p + p + 2).
// sums lies in shared or, past SMEM_MAX_P, in global memory: the barriers
// below order either for the block. Returns, to every thread, whether some
// v = s + lbd is not positive (then v counts as 1 in the sums, as
// torch.where(v > 0, v, 1) does).
__device__ bool reduce_pieces(double lbd, const double* __restrict__ s,
                              const double* __restrict__ PXX, const double* __restrict__ pxy,
                              const double* __restrict__ pyy, int n, int p, double* part,
                              double* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pp = p * p, Q = pp + p + 1, QL = Q + 1;  // column Q: log v
  int nonpos = 0;
  for (int c0 = 0; c0 < QL; c0 += CH) {
    double acc[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) acc[k] = 0.0;
    for (int i = tid; i < n; i += NT) {
      const double v = s[i] + lbd;
      const bool pos = v > 0.0;
      const double vs = pos ? v : 1.0;
      const double w = 1.0 / vs;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int j = c0 + k;
        if (j < pp) {
          acc[k] += w * PXX[static_cast<size_t>(i) * pp + j];
        } else if (j < pp + p) {
          acc[k] += w * pxy[static_cast<size_t>(i) * p + (j - pp)];
        } else if (j == Q - 1) {
          acc[k] += w * pyy[i];
        } else if (j == Q) {
          acc[k] += log(vs);
          nonpos |= !pos;
        }
      }
    }
    // every lane ends with the same bits: a + b == b + a in IEEE
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(FULL, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < CH; ++k) part[warp * CH + k] = acc[k];
    }
    __syncthreads();
    if (tid < CH && c0 + tid < QL) {
      double t = part[tid];
      for (int g = 1; g < NW; ++g) t += part[g * CH + tid];
      sums[c0 + tid] = t;
    }
    __syncthreads();
  }
  return __syncthreads_or(nonpos) != 0;
}

struct Eval {
  double neg_reml, ml;
};

// Warp 0: -REML and ML at the sums (neg_reml_null, ml_null); every lane
// returns the same values. Returns early, on every lane together, for an
// invalid lambda or a failed factorization.
__device__ Eval small_algebra(const double* sums, double* L, double* z, int n, int p,
                              double ridge, double c_reml, double c_ml, bool invalid) {
  const int ln = threadIdx.x & 31;
  const int pp = p * p;
  const Eval bad = {BAD, -BAD};
  if (invalid) return bad;
  const double* M = sums;
  const double* rhs = sums + pp;
  const double ayy = sums[pp + p], logdetV = sums[pp + p + 1];
  for (int e = ln; e < pp; e += 32) L[e] = (e / p == e % p) ? M[e] + ridge : M[e];
  __syncwarp();
  // right-looking Cholesky into the lower triangle; a pivot that is not a
  // finite positive number fails it (cholesky_ex's info, or a diagonal
  // that is not finite and positive)
  for (int k = 0; k < p; ++k) {
    const double d = L[k * p + k];
    if (!(d > 0.0) || !isfinite(d)) return bad;
    const double lkk = sqrt(d);
    __syncwarp();
    if (ln == 0) L[k * p + k] = lkk;
    for (int i = k + 1 + ln; i < p; i += 32) L[i * p + k] /= lkk;
    __syncwarp();
    const int m = p - 1 - k;
    for (int e = ln; e < m * m; e += 32) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) L[i * p + j] -= L[i * p + k] * L[j * p + k];
    }
    __syncwarp();
  }
  // beta = (L L')^-1 rhs: L z = rhs, then L' beta = z, in z
  for (int i = ln; i < p; i += 32) z[i] = rhs[i];
  __syncwarp();
  for (int k = 0; k < p; ++k) {
    const double zk = z[k] / L[k * p + k];
    __syncwarp();
    if (ln == 0) z[k] = zk;
    for (int i = k + 1 + ln; i < p; i += 32) z[i] -= L[i * p + k] * zk;
    __syncwarp();
  }
  for (int k = p - 1; k >= 0; --k) {
    const double bk = z[k] / L[k * p + k];
    __syncwarp();
    if (ln == 0) z[k] = bk;
    for (int i = ln; i < k; i += 32) z[i] -= L[k * p + i] * bk;
    __syncwarp();
  }
  double logdetA = 0.0, lin = 0.0;
  for (int k = 0; k < p; ++k) {
    logdetA += log(L[k * p + k]);
    lin += z[k] * rhs[k];
  }
  logdetA = 2.0 * logdetA;
  // beta' M beta with the unridged M, as _quad_rtwr
  double quad = 0.0;
  for (int i = ln; i < p; i += 32) {
    double row = 0.0;
    for (int k = 0; k < p; ++k) row += M[i * p + k] * z[k];
    quad += z[i] * row;
  }
  for (int off = 16; off > 0; off >>= 1) quad += __shfl_xor_sync(FULL, quad, off);
  const double rtwr = ayy - 2.0 * lin + quad;
  const double lr = log(rtwr);
  const double reml = c_reml - 0.5 * (static_cast<double>(n - p) * lr + logdetV + logdetA);
  const double ml = c_ml - 0.5 * (static_cast<double>(n) * lr + logdetV);
  Eval ev;
  ev.neg_reml = (rtwr > 0.0 && isfinite(reml)) ? -reml : BAD;
  ev.ml = (rtwr > 0.0 && isfinite(ml)) ? ml : -BAD;
  return ev;
}

// One lane's Brent state (brent_minimize_batched's tensors, one element),
// with the ML value at x.
struct Brent {
  double a, c, x, w, v, fx, fw, fv, e, mlx;
};

// The trial point of the next iteration: false when the lane has converged;
// else u and the e the iteration leaves.
__device__ bool brent_trial(const Brent& b, double tol, double* u_out, double* e_out) {
  const double m = mul(0.5, add(b.a, b.c));
  const double tol1 = add(mul(tol, fabs(b.x)), DBL_EPSILON);
  const double tol2 = mul(2.0, tol1);
  if (fabs(sub(b.x, m)) <= sub(tol2, mul(0.5, sub(b.c, b.a)))) return false;
  // the parabolic trial
  const double xv = sub(b.x, b.v), xw = sub(b.x, b.w);
  double p = sub(mul(xv, mul(xw, sub(b.fx, b.fv))), mul(xw, mul(xv, sub(b.fx, b.fw))));
  double q = mul(2.0, sub(mul(xv, sub(b.fx, b.fw)), mul(xw, sub(b.fx, b.fv))));
  if (q > 0.0) p = -p;
  q = fabs(q);
  const double sstep = p / (q > DBL_EPSILON ? q : 1.0);
  const double u_try = add(b.x, sstep);
  const bool par_ok = fabs(b.e) > tol1 && q > DBL_EPSILON && sub(u_try, b.a) >= tol2 &&
                      sub(b.c, u_try) >= tol2 && fabs(sstep) < mul(0.5, fabs(b.e));
  double d_par = sstep;
  if (sub(add(b.x, d_par), b.a) < tol2 || sub(b.c, add(b.x, d_par)) < tol2)
    d_par = b.x < m ? tol1 : -tol1;
  // the golden fallback
  const double e_gold = b.x < m ? sub(b.c, b.x) : sub(b.a, b.x);
  double d = par_ok ? d_par : mul(GOLD, e_gold);
  *e_out = par_ok ? b.e : e_gold;
  if (fabs(d) < tol1) d = d >= 0.0 ? tol1 : -tol1;
  *u_out = add(b.x, d);
  return true;
}

// The bracket and the three best points after f(u) = fu (ML mlu).
__device__ void brent_update(Brent& b, double u, double fu, double mlu, double e_new) {
  const bool better = fu <= b.fx;
  Brent n = b;
  n.e = e_new;
  if (better) {
    n.a = u >= b.x ? b.x : b.a;
    n.c = u >= b.x ? b.c : b.x;
    n.v = b.w;
    n.fv = b.fw;
    n.w = b.x;
    n.fw = b.fx;
    n.x = u;
    n.fx = fu;
    n.mlx = mlu;
  } else {
    n.a = u >= b.x ? b.a : u;
    n.c = u >= b.x ? u : b.c;
  }
  const bool repl_w = !better && (fu <= b.fw || b.w == b.x);
  if (repl_w) {
    n.v = b.w;
    n.fv = b.fw;
    n.w = u;
    n.fw = fu;
  }
  if (!better && !repl_w && (fu <= b.fv || b.v == b.x || b.v == b.w)) {
    n.v = u;
    n.fv = fu;
  }
  b = n;
}

__global__ void __launch_bounds__(NT, 1) null_reml_brent_kernel(
    const double* __restrict__ s, const double* __restrict__ PXX,
    const double* __restrict__ PXy, const double* __restrict__ Pyy, double* __restrict__ out,
    double* ws, int n, int p, double lo, double hi, double tol, int max_iter, double ridge,
    double c_reml, double c_ml) {
  extern __shared__ double sm[];
  const int pp = p * p;
  double* part = sm;
  double* pub = part + NW * CH;  // [0] the next trial point, [1] 1 once the lane is done
  double* sums = ws ? ws + blockIdx.x * work_doubles(p) : pub + 2;
  double* L = sums + pp + p + 2;
  double* z = L + pp;
  const int tid = threadIdx.x;
  const double* pxy = PXy + static_cast<size_t>(blockIdx.x) * n * p;
  const double* pyy = Pyy + static_cast<size_t>(blockIdx.x) * n;

  Brent b = {};  // thread 0's
  double e_next = 0.0;
  double xt = mul(0.5, add(lo, hi));
  for (int it = 0;; ++it) {
    const double lbd = pow(10.0, xt);
    const bool invalid = reduce_pieces(lbd, s, PXX, pxy, pyy, n, p, part, sums) ||
                         !(lbd > 0.0) || !isfinite(lbd);
    if (tid < 32) {
      const Eval ev = small_algebra(sums, L, z, n, p, ridge, c_reml, c_ml, invalid);
      if (tid == 0) {
        if (it == 0) {
          b = Brent{lo, hi, xt, xt, xt, ev.neg_reml, ev.neg_reml, ev.neg_reml, 0.0, ev.ml};
        } else {
          brent_update(b, xt, ev.neg_reml, ev.ml, e_next);
        }
        double u = b.x;
        const bool done = it >= max_iter || !brent_trial(b, tol, &u, &e_next);
        pub[0] = u;
        pub[1] = done ? 1.0 : 0.0;
      }
    }
    __syncthreads();
    if (pub[1] != 0.0) break;
    xt = pub[0];
  }
  if (tid == 0) {
    out[3 * blockIdx.x + 0] = b.x;
    out[3 * blockIdx.x + 1] = b.fx;
    out[3 * blockIdx.x + 2] = b.mlx;
  }
}

}  // namespace

// The doubles of global workspace a launch at p needs per lane: 0 where the
// work buffers fit in shared memory.
extern "C" long long jx_null_reml_workspace(int p) {
  return p > SMEM_MAX_P ? static_cast<long long>(work_doubles(p)) : 0;
}

// T lanes: s (n), PXX (n, p*p), PXy (T, n, p), Pyy (T, n), all f64 and
// contiguous; out (T, 3) f64 = [log10 lambda, -REML, ML at it] per lane; ws
// T x jx_null_reml_workspace(p) f64, or null where that is 0. lo <= hi;
// tol > 0 (brent_minimize_batched's clamped |tol|); c_reml and c_ml the
// objectives' constants. Returns cudaGetLastError() after the launch.
extern "C" int jx_null_reml_brent(const double* s, const double* PXX, const double* PXy,
                                  const double* Pyy, double* out, double* ws, int T, int n,
                                  int p, double lo, double hi, double tol, int max_iter,
                                  double ridge, double c_reml, double c_ml, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (p < 1 || n <= p || (p > SMEM_MAX_P && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (p > SMEM_MAX_P ? FIXED_DOUBLES : smem_doubles(p)) * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(null_reml_brent_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  null_reml_brent_kernel<<<T, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      s, PXX, PXy, Pyy, out, p > SMEM_MAX_P ? ws : nullptr, n, p, lo, hi, tol, max_iter, ridge,
      c_reml, c_ml);
  return static_cast<int>(cudaGetLastError());
}
