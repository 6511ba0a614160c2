// G1 / G2 — one Gibbs sweep over every marker block of the Bayes marker
// models (jx gs -BayesB / -BayesCpi / -BayesA), one launch per iteration.
//
// Replaces the XLA loops of janusx_tpu/gs/bayes.py (no Pallas there):
// - G1 gibbs_sweep_marker: the block scan of _gibbs (bayes.py:76-116), the
//   per-marker spike-and-slab chain of BayesB and BayesCpi;
// - G2 gibbs_sweep_block_mvn: the block scan of _gibbs_blocked_a
//   (bayes.py:214-236), BayesA's joint draw of each block of C markers from
//   N(Cb^-1 rhs, ve Cb^-1), Cb = G1 + diag(ve / vb) + 1e-4 I.
// Their plain versions are ops/kernels.py:gibbs_sweep_marker_plain and
// gibbs_sweep_block_mvn_plain; both kernels take the same random draws.
//
// What bounds them on the H100: not the bytes. One sweep reads the f32
// marker rows Zb once (m n 4 bytes: 282 MB at m = 50,000 and n = 1,410,
// 0.08 ms at 3.35 TB/s) and the block Grams Gb (m C 4 bytes). The chain is
// serial: G1's C dependent marker steps per block (each a few divides, a
// log-odds, an exp and a compare), G2's C x C Cholesky and two triangular
// solves per block. So the floor is the dependency chain's latency, not a
// rate of the card.
//
// Design: the sample axis is split over the grid, not the marker axis (a
// single block per chain could stream Zb at a fraction of the card's
// bandwidth only). Each of the P co-resident CTAs (a cooperative launch,
// P at most one per SM) owns S consecutive samples, taken in chunks of SC
// that fit in shared memory. When one chunk holds the whole slice (S <=
// SC: n up to about 40,000 on the H100's 132 SMs) the CTA keeps its slice
// of the residual r in shared memory for the whole sweep; past that, r's
// slice stays in global memory, where only its CTA touches it. Per marker
// block:
//  1. each CTA loads its slice of the block's rows (and of r, when it is
//     not kept) into shared memory chunk by chunk and writes its partial
//     Z1 r (C values) to a double-buffered global scratch;
//  2. before the grid barrier it stages what does not depend on r: G1
//     (rows of C + 1 floats, so a warp reads a row or a column without
//     bank conflicts), the block's draws and per-marker constants (G1's
//     whole marker step but the part that needs the right-hand side); G2
//     also forms Cb, its Cholesky factor and G1 b_old;
//  3. one grid-wide barrier (an atomic counter; every CTA is resident);
//  4. every CTA sums the P partials in the same fixed order, so every CTA
//     holds the same right-hand sides to the last bit, and runs the same
//     serial chain in one warp (lane l keeps the values of markers l,
//     l + 32, l + 64, l + 96 in registers; the marker being drawn is
//     broadcast by a shuffle). G1 keeps the right-hand sides current by
//     rhs[k] -= G1[k, j] (b_j - b_old_j) after marker j, the reference's
//     correction G1[k] . (b_new - b_old) summed one marker at a time. G2
//     solves L y = rhs, then L^T b = y + sqrt(ve) z: the reference's mean
//     L^-T L^-1 rhs plus noise sqrt(ve) L^-T z with two triangular solves
//     in place of three;
//  5. each CTA updates its own r slice from the rows it kept (no second
//     barrier; with more than one chunk it reads the earlier chunks' rows
//     again); CTA 0 writes the block's b, var_b (and G1's delta).
// Divisions become products by reciprocals formed off the chain (G2's
// solves multiply by 1/L[j][j]; G1's step, below), so the two kernels
// round differently from their plain versions, which keep the
// reference's form.
// Nothing else is held across blocks, so the scratch is P x C x 2 floats
// and a counter. Scalars that change between sweeps (ve, the slab
// variance, pi, s0_b, var_b's fill value) are read from device memory, so
// the chain never waits for the host.

#include <cuda_runtime.h>

namespace {

constexpr int CMAX = 128;  // markers per block (the reference's default C)
constexpr int NVEC = 12;   // per-marker values staged in shared memory (3 float4)

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every CTA of the (cooperative, hence resident) grid arrives once per
// marker block; the counter only grows, so barrier b waits for (b + 1) P
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (ld_acquire(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// C + 1 floats per row (odd for C even): a warp reads a row or a column of
// a staged C x C block without bank conflicts
struct Smem {
  float* G;   // C x (C + 1): G1 (G1 kernel) or Cb, then its factor L (G2)
  float* Z;   // C x (SC + 1): one chunk of this CTA's slice of the block's rows
  float* r;   // SC: the same chunk of the residual
  float4* v;  // NVEC / 4 x C per-marker values, 16-byte aligned
};

__host__ __device__ __forceinline__ size_t vec_offset(int C, int SC) {
  return (static_cast<size_t>(C) * (C + 1) + static_cast<size_t>(C) * (SC + 1) + SC + 3) / 4 *
         4;
}

__device__ __forceinline__ Smem carve(float* sm, int C, int SC) {
  Smem s;
  s.G = sm;
  s.Z = s.G + C * (C + 1);
  s.r = s.Z + C * (SC + 1);
  s.v = reinterpret_cast<float4*>(sm + vec_offset(C, SC));
  return s;
}

// this CTA's samples [i0, i0 + ns) in chunks of SC; KEEP: one chunk for
// every CTA (S <= SC), so r's slice stays in shared memory all sweep (a
// template argument, so the common case compiles to straight-line code)
template <bool KEEP>
struct Slice {
  int i0, ns, SC;
  __device__ int chunks() const { return KEEP ? 1 : (ns + SC - 1) / SC; }
  __device__ int len(int c) const { return KEEP ? ns : min(SC, ns - c * SC); }
};

// the block's C x C Gram into shared memory, rows of C + 1 floats; each
// warp takes whole rows, so loads and stores run along a row
template <int NT>
__device__ __forceinline__ void stage_gram(const float* G1, float* G, int C) {
  const int lane = threadIdx.x & 31, LD = C + 1;
  for (int k = threadIdx.x >> 5; k < C; k += NT / 32) {
#pragma unroll 4
    for (int l = lane; l < C; l += 32) G[k * LD + l] = __ldg(G1 + k * C + l);
  }
}

// one chunk of the block's rows (and of r, when it is not kept) into
// shared memory, zero past the slice
template <int NT, bool KEEP>
__device__ __forceinline__ void load_chunk(const float* Z1, const float* r, const Smem& s,
                                           const Slice<KEEP>& sl, int C, int n, int c) {
  const int t = threadIdx.x, LDZ = sl.SC + 1, i0 = sl.i0 + c * sl.SC, cn = sl.len(c);
  for (int k = t >> 5; k < C; k += NT / 32)
    for (int i = t & 31; i < sl.SC; i += 32)
      s.Z[k * LDZ + i] = i < cn ? __ldg(Z1 + static_cast<size_t>(k) * n + i0 + i) : 0.f;
  if (!KEEP)
    for (int i = t; i < sl.SC; i += NT) s.r[i] = i < cn ? r[i0 + i] : 0.f;
}

// step 1: this CTA's partial Z1 r, chunk by chunk; the last chunk stays in
// shared memory for step 5
template <int NT, bool KEEP>
__device__ __forceinline__ void partial_zr(const float* Z1, const float* r, const Smem& s,
                                           float* part, const Slice<KEEP>& sl, int C, int n) {
  static_assert(NT >= CMAX, "one thread per marker of the block");
  const int t = threadIdx.x, LDZ = sl.SC + 1;
  float a = 0.f;
  for (int c = 0; c < sl.chunks(); ++c) {
    if (c > 0) __syncthreads();  // the previous chunk's products are done
    load_chunk<NT, KEEP>(Z1, r, s, sl, C, n, c);
    __syncthreads();
    if (t < C)
      for (int i = 0; i < sl.len(c); ++i) a = fmaf(s.Z[t * LDZ + i], s.r[i], a);
  }
  if (t < C) part[static_cast<size_t>(blockIdx.x) * C + t] = a;
}

// step 4: the fixed-order sum of the P partials (read through L2: other
// SMs wrote them), the same in every CTA
__device__ __forceinline__ float sum_partials(const float* part, int P, int C, int k) {
  float a = 0.f;
  for (int p = 0; p < P; ++p) a += __ldcg(part + static_cast<size_t>(p) * C + k);
  return a;
}

// step 5: r -= (b_new - b_old) . Z1 on this CTA's slice, the resident last
// chunk first, then the earlier ones loaded again
template <int NT, bool KEEP>
__device__ __forceinline__ void update_r(const float* Z1, float* r, const Smem& s,
                                         const float* db, const Slice<KEEP>& sl, int C, int n) {
  const int LDZ = sl.SC + 1;
  for (int c = sl.chunks() - 1; c >= 0; --c) {
    if (c < sl.chunks() - 1) {
      __syncthreads();  // the later chunk is written back
      load_chunk<NT, KEEP>(Z1, r, s, sl, C, n, c);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < sl.len(c); i += NT) {
      float a = 0.f;
      for (int k = 0; k < C; ++k) a = fmaf(db[k], s.Z[k * LDZ + i], a);
      s.r[i] = s.r[i] - a;
      if (!KEEP) r[sl.i0 + c * sl.SC + i] = s.r[i];
    }
  }
}

// the kept slice of r in and out of shared memory around the sweep
template <int NT, bool KEEP>
__device__ __forceinline__ void kept_r(float* r, const Smem& s, const Slice<KEEP>& sl, bool in) {
  if (!KEEP) return;
  for (int i = threadIdx.x; i < sl.SC; i += NT) {
    if (in) s.r[i] = i < sl.ns ? r[sl.i0 + i] : 0.f;
    else if (i < sl.ns) r[sl.i0 + i] = s.r[i];
  }
}

// ------------------------------------------------------------------ G1
// method: 1 = BayesB (per-marker slab variances var_b), 2 = BayesCpi (one
// shared slab variance; var_b is dead state, left as it is).
//
// Marker j's step (bayes.py:85-101) is split into what does not depend on
// its right-hand side, formed for all C markers in parallel before the
// barrier, and the chain. With Cj = x2/ve + 1/vb and var = 1/Cj:
//   mean  = rhs / ve / Cj                     = rhs * a,  a = 1 / (ve Cj)
//   logit = logit(pi) + (mean^2/var + log var - log vb) / 2
//                                             = h mean^2 + c, h = Cj / 2
//   delta = ru < sigmoid(logit)               = logit > logit(ru)
//   b     = delta ? mean + sqrt(var) rn : 0   (0 on padding markers)
// so the chain has no division and no transcendental: the same draws give
// the same decisions except where rounding moves a threshold (the plain
// version keeps the reference's form; the tests hold the two to identical δ).
template <int NT, bool KEEP>
__global__ void __launch_bounds__(NT) gibbs_marker_kernel(
    const float* __restrict__ Zb, const float* __restrict__ Gb,
    const float* __restrict__ x2, float* beta, float* var_b, float* delta,
    const float* __restrict__ rn, const float* __restrict__ ru,
    const float* __restrict__ rca, const float* __restrict__ rci, float* r,
    const float* __restrict__ scal, float* work, unsigned* counter, int nb, int C,
    int n, int S, int SC, int method) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Smem s = carve(sm, C, SC);
  const int t = threadIdx.x, lane = t & 31, P = gridDim.x, LD = C + 1;
  const Slice<KEEP> sl{static_cast<int>(blockIdx.x) * S,
                       min(S, n - static_cast<int>(blockIdx.x) * S), SC};
  float4 *step = s.v, *keep = s.v + C;  // {a, h, c, logit(ru)}, {sqrt(var) rn, b_old, x2, -}
  float* rhs = reinterpret_cast<float*>(s.v + 2 * C);  // then b_new, db, delta
  float *bns = rhs + C, *dbs = rhs + 2 * C, *dls = rhs + 3 * C;
  const float ve = scal[0], vslab = scal[1], pi = scal[2], s0b = scal[3], vfill = scal[4];
  const float lp = logf(pi) - log1pf(-pi);
  kept_r<NT, KEEP>(r, s, sl, true);

  for (int b = 0; b < nb; ++b) {
    const size_t o = static_cast<size_t>(b) * C;
    float* part = work + static_cast<size_t>(b & 1) * P * C;
    __syncthreads();  // the previous block is done with the shared tiles
    partial_zr<NT, KEEP>(Zb + o * n, r, s, part, sl, C, n);
    stage_gram<NT>(Gb + o * C, s.G, C);
    for (int k = t; k < C; k += NT) {
      const float xk = x2[o + k], vb = method == 2 ? vslab : var_b[o + k];
      const float cj = xk / ve + 1.f / vb, var = 1.f / cj, u = ru[o + k];
      step[k] = make_float4(1.f / (ve * cj), 0.5f * cj,
                            lp + 0.5f * (logf(var) - logf(vb)), logf(u) - log1pf(-u));
      keep[k] = make_float4(sqrtf(var) * rn[o + k], beta[o + k], xk, 0.f);
    }
    grid_barrier(counter, static_cast<unsigned>(b + 1) * P);
    for (int k = t; k < C; k += NT)
      rhs[k] = sum_partials(part, P, C, k) + keep[k].z * keep[k].y;  // Z1 r + x2 b_old
    __syncthreads();
    if (t < 32) {  // the marker chain, one warp; lane l holds markers l + 32 q
      float rh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) rh[q] = lane + 32 * q < C ? rhs[lane + 32 * q] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * q + jj;
          if (j >= C) break;
          const float4 a = step[j], k4 = keep[j];
          const float mean = __shfl_sync(0xffffffffu, rh[q], jj) * a.x;
          const bool d = fmaf(a.y, mean * mean, a.z) > a.w;
          const float bj = d && k4.z > 0.f ? mean + k4.x : 0.f;
          const float db = bj - k4.y;
          // rhs[k] -= G1[k, j] db: column j of G1, marker k = lane + 32 q2
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2)
            if (lane + 32 * q2 < C) rh[q2] = fmaf(-s.G[(lane + 32 * q2) * LD + j], db, rh[q2]);
          if (lane == jj) {
            bns[j] = bj;
            dbs[j] = db;
            dls[j] = d ? 1.f : 0.f;
          }
        }
      }
    }
    __syncthreads();
    update_r<NT, KEEP>(Zb + o * n, r, s, dbs, sl, C, n);
    if (blockIdx.x == 0) {  // bayes.py:106-115
      for (int k = t; k < C; k += NT) {
        beta[o + k] = bns[k];
        delta[o + k] = dls[k];
        if (method != 2) {
          float vb = dls[k] > 0.f ? (s0b + bns[k] * bns[k]) / rca[o + k] : s0b / rci[o + k];
          var_b[o + k] = keep[k].z > 0.f ? vb : vfill;
        }
      }
    }
  }
  __syncthreads();
  kept_r<NT, KEEP>(r, s, sl, false);
}

// ------------------------------------------------------------------ G2
// Cb = L L^T, right-looking, on the block padded to CMAX x CMAX with the
// identity past C. Each of the 256 threads holds an 8 x 8 tile of the
// matrix in registers (a 16 x 16 grid of tiles; the 136 lower ones work).
// Per column j two barriers: the diagonal's owner publishes A[j][j]; the
// owners of column j scale it by 1/sqrt(A[j][j]) into col[] (0 at and
// above the diagonal), and every lower tile right of and below it takes
// col col^T. L's lower tiles then go back to shared memory (the diagonal
// entries keep the pivots) and the reciprocals of L's diagonal stay in
// dinv, which the solves multiply by.
constexpr int TILE = 8;
constexpr int NT_MVN = (CMAX / TILE) * (CMAX / TILE);

__device__ __forceinline__ void cholesky(float* A, float* col, float* dinv, float* dsh) {
  constexpr int LD = CMAX + 1, NB = CMAX / TILE;
  const int ti = threadIdx.x / NB, tk = threadIdx.x % NB;
  const bool lower = tk <= ti;
  float a[TILE][TILE];
  __syncthreads();  // Cb's diagonal is in place
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c)
      a[r][c] = lower ? A[(TILE * ti + r) * LD + TILE * tk + c] : 0.f;
  for (int jb = 0; jb < NB; ++jb) {
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      if (ti == jb && tk == jb) *dsh = a[jj][jj];
      __syncthreads();
      if (tk == jb) {
        const float rj = __frsqrt_rn(*dsh);
        if (ti == jb) dinv[TILE * jb + jj] = rj;
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          float l = 0.f;
          if (ti > jb || (ti == jb && r > jj)) {
            l = a[r][jj] * rj;
            a[r][jj] = l;
          }
          col[TILE * ti + r] = l;
        }
      }
      __syncthreads();
      if (lower && tk >= jb) {
        const float4 r0 = reinterpret_cast<const float4*>(col)[2 * ti];
        const float4 r1 = reinterpret_cast<const float4*>(col)[2 * ti + 1];
        const float4 c0 = reinterpret_cast<const float4*>(col)[2 * tk];
        const float4 c1 = reinterpret_cast<const float4*>(col)[2 * tk + 1];
        const float cr[TILE] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        const float cc[TILE] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < TILE; ++r)
#pragma unroll
          for (int c = 0; c < TILE; ++c) a[r][c] = fmaf(-cr[r], cc[c], a[r][c]);
      }
    }
  }
  if (lower) {
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c = 0; c < TILE; ++c) A[(TILE * ti + r) * LD + TILE * tk + c] = a[r][c];
  }
  __syncthreads();
}

template <int NT, bool KEEP>
__global__ void __launch_bounds__(NT) gibbs_block_mvn_kernel(
    const float* __restrict__ Zb, const float* __restrict__ Gb,
    const float* __restrict__ x2, float* beta, float* var_b,
    const float* __restrict__ z, const float* __restrict__ rchi, float* r,
    const float* __restrict__ scal, float* work, unsigned* counter, int nb, int C, int n,
    int S, int SC) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Smem s = carve(sm, CMAX, SC);  // the factor is padded to CMAX
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, P = gridDim.x, LD = CMAX + 1;
  const Slice<KEEP> sl{static_cast<int>(blockIdx.x) * S,
                       min(S, n - static_cast<int>(blockIdx.x) * S), SC};
  float* v = reinterpret_cast<float*>(s.v);
  float *col = v, *x2s = v + CMAX, *bos = x2s + C, *bns = bos + C, *zs = bns + C,
        *gbo = zs + C, *dbs = gbo + C, *rhs = dbs + C, *dinv = rhs + C, *dsh = dinv + CMAX;
  const float ve = scal[0], s0b = scal[3], vfill = scal[4], sve = sqrtf(ve);
  float* A = s.G;
  kept_r<NT, KEEP>(r, s, sl, true);

  for (int b = 0; b < nb; ++b) {
    const size_t o = static_cast<size_t>(b) * C;
    float* part = work + static_cast<size_t>(b & 1) * P * C;
    __syncthreads();
    partial_zr<NT, KEEP>(Zb + o * n, r, s, part, sl, C, n);
    const float* G1 = Gb + o * C;
    for (int k = warp; k < CMAX; k += NT / 32)
#pragma unroll 4
      for (int l = lane; l < CMAX; l += 32)
        A[k * LD + l] = k < C && l < C ? __ldg(G1 + k * C + l) : (k == l ? 1.f : 0.f);
    for (int k = t; k < C; k += NT) {
      x2s[k] = x2[o + k];
      bos[k] = beta[o + k];
      zs[k] = z[o + k];
    }
    __syncthreads();
    // G1 b_old, then Cb = G1 + diag(dinv) + 1e-4 I (bayes.py:215-217)
    for (int k = t; k < C; k += NT) {
      float a = 0.f;
      for (int l = 0; l < C; ++l) a = fmaf(A[k * LD + l], bos[l], a);
      gbo[k] = a;
    }
    __syncthreads();
    for (int k = t; k < C; k += NT) {
      const float di = x2s[k] > 0.f ? ve / fmaxf(var_b[o + k], 1e-12f) : 1.f;
      A[k * LD + k] = (A[k * LD + k] + di) + 1e-4f;
    }
    cholesky(A, col, dinv, dsh);
    grid_barrier(counter, static_cast<unsigned>(b + 1) * P);
    for (int k = t; k < C; k += NT) rhs[k] = sum_partials(part, P, C, k) + gbo[k];
    __syncthreads();
    if (t < 32) {  // L y = rhs, then L^T b = y + sqrt(ve) z, one warp
      float acc[4], sol[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] = lane + 32 * q < C ? rhs[lane + 32 * q] : 0.f;
        sol[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * q + jj;
          if (j >= C) break;
          const float yj = __shfl_sync(0xffffffffu, acc[q], jj) * dinv[j];
          if (lane == jj) sol[q] = yj;
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            const int k = lane + 32 * q2;
            if (k > j && k < C) acc[q2] = fmaf(-A[k * LD + j], yj, acc[q2]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = lane + 32 * q < C ? sol[q] + sve * zs[lane + 32 * q] : 0.f;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        for (int jj = 31; jj >= 0; --jj) {
          const int j = 32 * q + jj;
          if (j >= C) continue;
          const float bj = __shfl_sync(0xffffffffu, acc[q], jj) * dinv[j];
          if (lane == jj) sol[q] = bj;
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            const int k = lane + 32 * q2;
            if (k < j) acc[q2] = fmaf(-A[j * LD + k], bj, acc[q2]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = lane + 32 * q;
        if (k < C) {
          const float bk = x2s[k] > 0.f ? sol[q] : 0.f;
          bns[k] = bk;
          dbs[k] = bk - bos[k];
        }
      }
    }
    __syncthreads();
    update_r<NT, KEEP>(Zb + o * n, r, s, dbs, sl, C, n);
    if (blockIdx.x == 0) {  // bayes.py:233-235
      for (int k = t; k < C; k += NT) {
        beta[o + k] = bns[k];
        var_b[o + k] = x2s[k] > 0.f ? (s0b + bns[k] * bns[k]) / rchi[o + k] : vfill;
      }
    }
  }
  __syncthreads();
  kept_r<NT, KEEP>(r, s, sl, false);
}

size_t smem_bytes(int C, int SC) {
  return sizeof(float) * (vec_offset(C, SC) + NVEC * static_cast<size_t>(C));
}

// S samples per CTA over at most one CTA per SM, P = ceil(n / S) CTAs, in
// chunks of SC that fit the device's shared memory at C markers per block
int plan(int n, int C, int& S, int& SC, int& P) {
  int dev, sms, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  S = max(32, (n + sms - 1) / sms);
  P = (n + S - 1) / S;
  const int fit = (optin / 4 - NVEC * C - C * (C + 2)) / (C + 1);
  SC = max(1, min(S, fit));
  while (SC > 1 && smem_bytes(C, SC) > static_cast<size_t>(optin)) --SC;
  return smem_bytes(C, SC) > static_cast<size_t>(optin) ? static_cast<int>(cudaErrorInvalidValue)
                                                         : 0;
}

int launch(const void* fn, int P, int NT, size_t smem, void** args, unsigned* counter,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchCooperativeKernel(fn, dim3(P), dim3(NT), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

constexpr int NT_MARKER = 256;

}  // namespace

// work holds 2 P C floats, P at most the device's SM count
extern "C" int jx_gibbs_marker(const float* Zb, const float* Gb, const float* x2, float* beta,
                               float* var_b, float* delta, const float* rn, const float* ru,
                               const float* rca, const float* rci, float* r,
                               const float* scal, float* work, unsigned* counter, int nb,
                               int C, int n, int method, void* stream) {
  if (nb <= 0 || C <= 0 || C > CMAX || n <= 0 || (method != 1 && method != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int S, SC, P;
  if (const int e = plan(n, C, S, SC, P)) return e;
  void* args[] = {&Zb, &Gb, &x2, &beta, &var_b, &delta, &rn, &ru, &rca, &rci, &r, &scal,
                  &work, &counter, &nb, &C, &n, &S, &SC, &method};
  const void* fn = S <= SC ? (const void*)gibbs_marker_kernel<NT_MARKER, true>
                           : (const void*)gibbs_marker_kernel<NT_MARKER, false>;
  return launch(fn, P, NT_MARKER, smem_bytes(C, SC), args, counter,
                static_cast<cudaStream_t>(stream));
}

extern "C" int jx_gibbs_block_mvn(const float* Zb, const float* Gb, const float* x2,
                                  float* beta, float* var_b, const float* z,
                                  const float* rchi, float* r, const float* scal, float* work,
                                  unsigned* counter, int nb, int C, int n, void* stream) {
  if (nb <= 0 || C <= 0 || C > CMAX || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int S, SC, P;
  if (const int e = plan(n, CMAX, S, SC, P)) return e;
  void* args[] = {&Zb, &Gb, &x2, &beta, &var_b, &z, &rchi, &r, &scal, &work, &counter, &nb,
                  &C, &n, &S, &SC};
  const void* fn = S <= SC ? (const void*)gibbs_block_mvn_kernel<NT_MVN, true>
                           : (const void*)gibbs_block_mvn_kernel<NT_MVN, false>;
  return launch(fn, P, NT_MVN, smem_bytes(CMAX, SC), args, counter,
                static_cast<cudaStream_t>(stream));
}
