// G1 / G2 — one Gibbs sweep over every marker block of the Bayes marker
// models (jx gs -BayesB / -BayesCpi / -BayesA): a pre-pass over all blocks
// at once, then one serial pass over the blocks.
//
// Replaces the XLA loops of janusx_tpu/gs/bayes.py (no Pallas there):
// - G1 gibbs_sweep_marker: the block scan of _gibbs (bayes.py:76-116), the
//   per-marker spike-and-slab chain of BayesB and BayesCpi;
// - G2 gibbs_sweep_block_mvn: the block scan of _gibbs_blocked_a
//   (bayes.py:214-236), BayesA's joint draw of each block of C markers from
//   N(Cb^-1 rhs, ve Cb^-1), Cb = G1 + diag(ve / vb) + 1e-4 I.
// Their plain versions are ops/kernels.py:gibbs_sweep_marker_plain and
// gibbs_sweep_block_mvn_plain (the reference's form), and the plain mirrors
// of this file's schedule gibbs_sweep_marker_hoisted_plain and
// gibbs_sweep_block_mvn_hoisted_plain; all take the same random draws.
//
// What bounds them on the H100: not the bytes. One sweep reads the f32
// marker rows Zb once (m n 4 bytes: 282 MB at m = 50,000 and n = 1,410,
// 0.08 ms at 3.35 TB/s) and the block Grams Gb (m C 4 bytes). The blocks are
// serial: block b's right-hand sides need the residual r after block b - 1,
// so a sweep is the dependent latency of nb block steps. The chain floor
// is a model of that latency's instruction part: the dependent
// instructions of one block's serial path times their latency (FP32
// arithmetic 4 cycles, a shuffle 24; assumed, not measured), times nb, at
// the SM clock (chip_smoke.py's chain_floor_ms, printed in phase 13). Per
// block: ceil(S / 8) + 3 arithmetic and a shuffle for this CTA's Z1 r,
// ceil(P / 2) + 1 for the sum of the P partials, ceil(C / 16) + 4 and
// three shuffles for r -= Z1^T db; G1 adds
// 1 + 5 C arithmetic and C shuffles for its chain (per marker step FMUL
// rhs^2, FFMA log-odds, FSETP, FSEL db, the shuffle of db, FFMA of the next
// right-hand side), G2 20 for its 128 x 128 product. Barriers, memory
// latencies and the copies of the next block's rows come on top.
//
// Design. Nothing that depends only on the state carried into the sweep
// stays on the serial path:
// - the pre-pass (one launch, one CTA per block over every SM) writes one
//   record per block. G1's (39,424 bytes): the per-marker constants of the
//   chain ({a, h, c, logit(u)}, {sqrt(var) rn, b_old, the take threshold,
//   -b_old}, {rca, rci, x2}) and the rows of G1 left of the diagonal,
//   each padded to 4 floats (tri_row). G2's (67,584 bytes): M = Cb^-1 =
//   X^T X with X = L^-1 (the Cholesky factor L by the register-tiled
//   `cholesky`, X by a register-tiled forward substitution), w = X^T (X G1
//   b_old + sqrt(ve) z), b_old, x2 and rchi. So G2's draw is b = M (Z1 r)
//   + w: the reference's mean L^-T L^-1 (Z1 r + G1 b_old) plus noise
//   sqrt(ve) L^-T z, with no triangular solve left on the serial path. The
//   records take nb x 39,424 or nb x 67,584 bytes of scratch (15.4 MB and
//   26.4 MB at m = 50,000; 184.8 MB and 316.8 MB at m = 600,000).
// - the serial pass splits the sample axis over P CTAs; CTA p owns S
//   consecutive samples. Per marker block:
//   1. each CTA forms its partial Z1 r (two threads a marker, four
//      accumulators each) from its slice of the block's rows, already in
//      shared memory;
//   2. the P partials are exchanged and every CTA sums them in the same
//      fixed order, so every CTA holds the same right-hand sides to the
//      last bit;
//   3. the block's draw, the same in every CTA. G1: the marker chain on one
//      warp. Lane l keeps the right-hand sides of markers l + 32 q and their
//      constants in registers; at step j marker j's lane draws, db_j goes to
//      every lane by one shuffle, and every lane's later right-hand sides
//      take -G1[k][j] db_j, the entries read four steps at a time (one
//      16-byte load a row). So each right-hand side takes the reference's
//      corrections one marker at a time, in order, and no shared-memory
//      load is on the dependent path. C = 128 is its own template case
//      with the loop unrolled; b, db and delta are drawn again after the
//      chain by each marker's lane from its final right-hand side. G2: b =
//      M u + w, each thread's 16 x 4 tile of M loaded into registers when
//      the block begins;
//   4. each CTA updates its own slice of r, the 128-marker sum split over
//      8 lanes of a warp (shuffles sum them); CTA 0's upper half writes b,
//      var_b (and G1's delta).
//   Paths, chosen by the plan from n: a cluster of P <= 16 CTAs
//   (non-portable size, one GPC) of at most 121 samples each, n up to
//   1,936 (wider slices lose to the grid; at 121 G1's slice stops fitting
//   twice beside its records): each CTA pushes its partials into every
//   CTA's inbox with st.async, counted in bytes on the receiver's
//   mbarrier, so a block needs no cluster-wide barrier (one at the start
//   and one at the end of the sweep). Past that, a cooperative
//   grid of P <= one CTA per SM with an atomic grid barrier and the
//   partials in global memory (read through L2, two threads a marker),
//   with r's slice kept in shared memory, or, past 37,092 (G1) and 57,156
//   (G2) samples, streamed in chunks from global memory.
//   Buffers (227 KB of shared memory per CTA): G1's record is double
//   buffered (block b + 1's copy, one cp.async.bulk on an mbarrier, runs
//   behind block b's chain). The slice of the block's rows is double
//   buffered on the cluster path and, on the grid path, up to 18,084 (G1)
//   and 27,588 (G2) samples, else loaded after the previous block: 16-byte
//   cp.async of each row's 16-byte-aligned span, the slice at a shift of
//   0-3 floats in its row (row_shift), copied by G1's seven other warps
//   behind the chain and by G2's threads while the partials are exchanged.
// Divisions become products by reciprocals formed in the pre-pass, so the
// kernels round differently from their plain versions, which keep the
// reference's form.
// Scalars that change between sweeps (ve, the slab variance, pi, s0_b,
// var_b's fill value) are read from device memory, so the sweep never
// waits for the host.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CMAX = 128;                       // markers per block (the reference's default C)
constexpr int NT = 256;                         // threads per CTA, every kernel here
constexpr int TILE = 8;                         // G2's register tiles: 16 x 16 tiles of 8 x 8
constexpr int CLUSTER_MAX = 16;                 // non-portable cluster size: one GPC
// the widest slice a cluster CTA takes: past it the grid's narrower slices
// win (G2 at n = 3,088, 193 samples a CTA: 3.4459 ms a sweep against the
// grid's 3.0957 at n = 3,089; at n = 1,936 the cluster 2.7237 ms, the grid
// 3.1809 at 1,937; m = 50,000, chip_smoke.py phase 13's gibbs_path_times on
// an NVIDIA H100 80GB HBM3 at 700 W); 121 is also where G1's two row
// buffers stop fitting
constexpr int CLUSTER_S_MAX = 121;
// row k of a block's Gram left of the diagonal, G1[k][0 .. k - 1], padded
// with zeros to a multiple of 4 floats, starts at tri_row(k)
__host__ __device__ constexpr int tri_row(int k) {
  const int A = k / 4, B = k % 4;
  return 4 * (2 * A * (A - 1) + 3 * A + (B > 0 ? A + (B - 1) * (A + 1) : 0));
}
constexpr int TRI = tri_row(CMAX);              // 8,320 floats
constexpr int REC_MARKER = 12 * CMAX + TRI;     // G1 record, floats
constexpr int REC_MVN = CMAX * CMAX + 4 * CMAX; // G2 record, floats
constexpr int MARKER = 1, MVN = 2;              // the kernel
constexpr int CLUSTER = 0, GRID = 1, CHUNKED = 2;  // the serial pass's path
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(NT == (CMAX / TILE) * (CMAX / TILE), "one 8 x 8 tile per thread");


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one record from global into shared memory, completing on ``bar``; the
// buffer's earlier reads went through the generic proxy
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ------------------------------------------------------------ pre-pass G1
// One CTA per block: the chain's per-marker constants from the state
// carried into the sweep, and G1's rows left of the diagonal (tri_row).
// With Cj = x2/ve + 1/vb and var = 1/Cj, marker j's step (bayes.py:85-101)
// becomes
//   mean  = rhs / ve / Cj                     = rhs * a,  a = 1 / (ve Cj)
//   logit = logit(pi) + (mean^2/var + log var - log vb) / 2
//                                             = h rhs^2 + c, h = Cj a^2 / 2
//   delta = ru < sigmoid(logit)               = logit > logit(ru)
//   b     = delta ? mean + sqrt(var) rn : 0   (0 on padding markers)
// so the chain has no division and no transcendental. The record's
// float4s: step {a, h, c, logit(ru)}; keep {sqrt(var) rn, b_old, the
// threshold that draws b (logit(ru), +inf on padding markers), 0 - b_old};
// post {rca, rci, x2, 0}.
__global__ void __launch_bounds__(NT) gibbs_marker_prep_kernel(
    const float* __restrict__ Gb, const float* __restrict__ x2, const float* __restrict__ beta,
    const float* __restrict__ var_b, const float* __restrict__ rn, const float* __restrict__ ru,
    const float* __restrict__ rca, const float* __restrict__ rci, const float* __restrict__ scal,
    float* __restrict__ rec, int C, int method) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t o = static_cast<size_t>(blockIdx.x) * C;
  const float* G1 = Gb + o * C;
  float* R = rec + static_cast<size_t>(blockIdx.x) * REC_MARKER;
  float4 *step = reinterpret_cast<float4*>(R), *keep = step + CMAX, *post = keep + CMAX;
  const float ve = scal[0], vslab = scal[1], pi = scal[2];
  const float lp = logf(pi) - log1pf(-pi);
  for (int k = t; k < C; k += NT) {
    const float xk = x2[o + k], vb = method == 2 ? vslab : var_b[o + k], bo = beta[o + k];
    const float cj = xk / ve + 1.f / vb, var = 1.f / cj, u = ru[o + k];
    const float a = 1.f / (ve * cj), thr = logf(u) - log1pf(-u);
    step[k] = make_float4(a, 0.5f * cj * a * a, lp + 0.5f * (logf(var) - logf(vb)), thr);
    keep[k] = make_float4(sqrtf(var) * rn[o + k], bo, xk > 0.f ? thr : __int_as_float(0x7f800000),
                          0.f - bo);
    post[k] = make_float4(rca[o + k], rci[o + k], xk, 0.f);
  }
  float* tri = R + 12 * CMAX;
  for (int k = warp; k < C; k += NT / 32)
    for (int j = lane; j < (k + 3) / 4 * 4; j += 32)
      tri[tri_row(k) + j] = j < k ? __ldg(G1 + k * C + j) : 0.f;
}

// ------------------------------------------------------------ pre-pass G2
// Cb = L L^T, right-looking, on the block padded to CMAX x CMAX with the
// identity past C. Each of the 256 threads holds an 8 x 8 tile of the
// matrix in registers (a 16 x 16 grid of tiles; the 136 lower ones work).
// Per column j two barriers: the diagonal's owner publishes A[j][j]; the
// owners of column j scale it by 1/sqrt(A[j][j]) into col[] (0 at and
// above the diagonal), and every lower tile right of and below it takes
// col col^T. L's lower tiles then go back to shared memory (the diagonal
// entries keep the pivots) and the reciprocals of L's diagonal stay in
// dinv.
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

// X = L^-1 by forward substitution on the identity, in the same register
// tiles: at column j the owners of row j scale it by 1/L[j][j] and publish
// it (row[] alternates between two buffers, so one barrier a column
// suffices), then every lower tile below takes L[i][j] row. X replaces A
// (zeros above the diagonal).
__device__ __forceinline__ void tri_inverse(float* A, const float* dinv, float* rowbuf) {
  constexpr int LD = CMAX + 1, NB = CMAX / TILE;
  const int ti = threadIdx.x / NB, tk = threadIdx.x % NB;
  const bool lower = tk <= ti;
  float x[TILE][TILE];
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) x[r][c] = ti == tk && r == c ? 1.f : 0.f;
  for (int jb = 0; jb < NB; ++jb) {
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      const int j = TILE * jb + jj;
      float* row = rowbuf + (j & 1) * CMAX;
      if (ti == jb && lower) {
        const float d = dinv[j];
#pragma unroll
        for (int c = 0; c < TILE; ++c) {
          x[jj][c] *= d;
          row[TILE * tk + c] = x[jj][c];
        }
      }
      __syncthreads();
      if (lower && ti >= jb && tk <= jb) {
        float rr[TILE];
#pragma unroll
        for (int c = 0; c < TILE; ++c) rr[c] = row[TILE * tk + c];
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const int i = TILE * ti + r;
          if (i > j) {
            const float l = A[i * LD + j];
#pragma unroll
            for (int c = 0; c < TILE; ++c) x[r][c] = fmaf(-l, rr[c], x[r][c]);
          }
        }
      }
    }
  }
  __syncthreads();  // every tile is done reading L
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) A[(TILE * ti + r) * LD + TILE * tk + c] = x[r][c];
  __syncthreads();
}

// M = X^T X into global memory (rows of CMAX floats), one 8 x 8 tile per
// thread; X is lower triangular, so the sum starts at the tile pair's
// larger row, and M[a][c] and M[c][a] are the same sum in the same order.
__device__ __forceinline__ void gram_xtx(const float* X, float* M) {
  constexpr int LD = CMAX + 1, NB = CMAX / TILE;
  const int ta = threadIdx.x / NB, tc = threadIdx.x % NB;
  float acc[TILE][TILE];
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[r][c] = 0.f;
  for (int i = TILE * max(ta, tc); i < CMAX; ++i) {
    float xa[TILE], xc[TILE];
#pragma unroll
    for (int c = 0; c < TILE; ++c) {
      xa[c] = X[i * LD + TILE * ta + c];
      xc[c] = X[i * LD + TILE * tc + c];
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c = 0; c < TILE; ++c) acc[r][c] = fmaf(xa[r], xc[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    float4* dst = reinterpret_cast<float4*>(M + (TILE * ta + r) * CMAX + TILE * tc);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// One CTA per block: Cb and G1 b_old from the carried state (bayes.py:
// 215-217), L, X = L^-1, then the record M | w | b_old | x2 | rchi.
__global__ void __launch_bounds__(NT) gibbs_mvn_prep_kernel(
    const float* __restrict__ Gb, const float* __restrict__ x2, const float* __restrict__ beta,
    const float* __restrict__ var_b, const float* __restrict__ z,
    const float* __restrict__ rchi, const float* __restrict__ scal, float* __restrict__ rec,
    int C) {
  extern __shared__ float4 sm4[];
  float* A = reinterpret_cast<float*>(sm4);
  constexpr int LD = CMAX + 1;
  float* v = A + CMAX * LD;  // 16-byte aligned: CMAX (CMAX + 1) is a multiple of 4
  float *col = v, *dinv = col + CMAX, *bos = dinv + CMAX, *gbo = bos + CMAX, *zv = gbo + CMAX,
        *tv = zv + CMAX, *rowbuf = tv + CMAX, *dsh = rowbuf + 2 * CMAX;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t o = static_cast<size_t>(blockIdx.x) * C;
  const float ve = scal[0], sve = sqrtf(ve);
  const float* G1 = Gb + o * C;
  for (int k = warp; k < CMAX; k += NT / 32)
#pragma unroll 4
    for (int l = lane; l < CMAX; l += 32)
      A[k * LD + l] = k < C && l < C ? __ldg(G1 + k * C + l) : (k == l ? 1.f : 0.f);
  for (int k = t; k < CMAX; k += NT) {
    bos[k] = k < C ? beta[o + k] : 0.f;
    zv[k] = k < C ? z[o + k] : 0.f;
  }
  __syncthreads();
  // G1 b_old, then Cb = G1 + diag(ve / var_b) + 1e-4 I
  for (int k = t; k < CMAX; k += NT) {
    float a = 0.f;
    for (int l = 0; l < C; ++l) a = fmaf(A[k * LD + l], bos[l], a);
    gbo[k] = k < C ? a : 0.f;
  }
  __syncthreads();
  for (int k = t; k < C; k += NT) {
    const float di = x2[o + k] > 0.f ? ve / fmaxf(var_b[o + k], 1e-12f) : 1.f;
    A[k * LD + k] = (A[k * LD + k] + di) + 1e-4f;
  }
  cholesky(A, col, dinv, dsh);
  tri_inverse(A, dinv, rowbuf);
  float* R = rec + static_cast<size_t>(blockIdx.x) * REC_MVN;
  gram_xtx(A, R);
  if (t < CMAX) {  // X G1 b_old + sqrt(ve) z
    float a = 0.f;
    for (int k = 0; k <= t; ++k) a = fmaf(A[t * LD + k], gbo[k], a);
    tv[t] = fmaf(sve, zv[t], a);
  }
  __syncthreads();
  if (t < CMAX) {  // w = X^T (X G1 b_old + sqrt(ve) z)
    float a = 0.f;
    for (int i = t; i < CMAX; ++i) a = fmaf(A[i * LD + t], tv[i], a);
    float* W = R + CMAX * CMAX;
    W[t] = a;
    W[CMAX + t] = bos[t];
    W[2 * CMAX + t] = t < C ? x2[o + t] : 0.f;
    W[3 * CMAX + t] = t < C ? rchi[o + t] : 1.f;
  }
}

// ------------------------------------------------------------ serial pass
// shared memory, in floats: four mbarriers (G1's two record buffers, the
// cluster path's two partial inboxes), G1's two record buffers, the cluster
// path's inboxes (2 x CLUSTER_MAX x CMAX: every CTA's partials of a block,
// by block parity), the row buffer(s) of CMAX x LDZ, the residual's slice
// or chunk, then 13 vectors of CMAX (this CTA's partials, the right-hand
// sides, b, db, delta or var_b, and G2's 8-row-group reduction)
__host__ __device__ __forceinline__ size_t sweep_floats(int alg, bool cluster, int LDZ, int nz) {
  const size_t recf = alg == MARKER ? 2 * static_cast<size_t>(REC_MARKER) : 0;
  const size_t inbox = cluster ? 2 * CLUSTER_MAX * CMAX : 0;
  return 8 + recf + inbox + static_cast<size_t>(nz) * CMAX * LDZ + (LDZ + 3) / 4 * 4 + 13 * CMAX;
}

// this CTA's shared address ``a`` in CTA ``rank`` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// A CTA's slice of row k of the block's rows starts at sample ``base``; in
// shared memory the row's slice sits at k LDZ + row_shift (0-3 floats), so
// that a copy of it can start at a 16-byte boundary in both memories.
__device__ __forceinline__ int row_shift(const float* Z1, int k, int n, int base) {
  return static_cast<int>(
      (reinterpret_cast<uintptr_t>(Z1 + static_cast<size_t>(k) * n + base) >> 2) & 3);
}

// one chunk of this CTA's slice of the block's rows [base, base + cn) (and
// of r, when it is not kept) into shared memory
template <bool KEEP>
__device__ __forceinline__ void load_chunk(const float* Z1, const float* r, float* zs, float* rs,
                                           int base, int cn, int LDZ, int C, int n) {
  const int t = threadIdx.x;
  for (int k = t >> 5; k < C; k += NT / 32) {
    float* row = zs + k * LDZ + row_shift(Z1, k, n, base);
    for (int i = t & 31; i < cn; i += 32) row[i] = __ldg(Z1 + static_cast<size_t>(k) * n + base + i);
  }
  if (!KEEP)
    for (int i = t; i < cn; i += NT) rs[i] = r[base + i];
}

// a kept slice of the block's rows by 16-byte cp.async from ``nthr``
// threads (this one is ``tid``), a warp a row: each row's 16-byte-aligned
// span, or, for a span reaching outside the marker rows [lo, hi), 4-byte
// copies; complete at each of those threads' next cp_async_wait_all
__device__ __forceinline__ void load_slice_async(const float* Z1, float* zs, int i0, int ns,
                                                 int LDZ, int C, int n, const float* lo,
                                                 const float* hi, int tid, int nthr) {
  for (int k = tid >> 5; k < C; k += nthr >> 5) {
    const float* g = Z1 + static_cast<size_t>(k) * n + i0;
    const int sh = row_shift(Z1, k, n, i0), len = (sh + ns + 3) & ~3;
    float* row = zs + k * LDZ;
    if (g - sh >= lo && g - sh + len <= hi) {
      for (int c = tid & 31; c < len / 4; c += 32) cp_async16(row + 4 * c, g - sh + 4 * c);
    } else {
      for (int i = tid & 31; i < ns; i += 32) cp_async4(row + sh + i, g + i);
    }
  }
}

// step 1: this CTA's partial Z1 r for marker t / 2, chunk by chunk (two
// threads a marker, even and odd samples, four accumulators each); the
// last chunk stays in shared memory for step 4
template <bool KEEP>
__device__ __forceinline__ float partial_zr(const float* Z1, const float* r, float* zs, float* rs,
                                            int i0, int ns, int SC, int nchunks, int LDZ, int C,
                                            int n, bool zpre) {
  const int t = threadIdx.x, k = t >> 1;
  float a = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int cn = KEEP ? ns : min(SC, ns - c * SC);
    if (!zpre) {
      if (c > 0) __syncthreads();  // the previous chunk's products are done
      load_chunk<KEEP>(Z1, r, zs, rs, i0 + c * SC, cn, LDZ, C, n);
      __syncthreads();
    }
    if (k < C) {
      const float* z = zs + k * LDZ + row_shift(Z1, k, n, i0 + c * SC);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int i = t & 1;
      for (; i + 6 < cn; i += 8) {
        a0 = fmaf(z[i], rs[i], a0);
        a1 = fmaf(z[i + 2], rs[i + 2], a1);
        a2 = fmaf(z[i + 4], rs[i + 4], a2);
        a3 = fmaf(z[i + 6], rs[i + 6], a3);
      }
      for (; i < cn; i += 2) a0 = fmaf(z[i], rs[i], a0);
      a += (a0 + a1) + (a2 + a3);
    }
  }
  return a + __shfl_xor_sync(FULL_MASK, a, 1);
}

// step 4: r -= (b_new - b_old) . Z1 on this CTA's slice, the resident last
// chunk first, then the earlier ones loaded again; lanes 8 s .. 8 s + 7 of
// a warp share a sample, each summing the markers of one residue mod 8
// (their db in registers)
template <bool KEEP>
__device__ __forceinline__ void update_r(const float* Z1, float* r, float* zs, float* rs,
                                         const float* db, int i0, int ns, int SC, int nchunks,
                                         int LDZ, int C, int n) {
  const int t = threadIdx.x, g = t & 7;
  float d[CMAX / 8];
#pragma unroll
  for (int e = 0; e < CMAX / 8; ++e) d[e] = g + 8 * e < C ? db[g + 8 * e] : 0.f;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int cn = KEEP ? ns : min(SC, ns - c * SC), base = i0 + c * SC;
    if (c < nchunks - 1) {
      __syncthreads();  // the later chunk is written back
      load_chunk<KEEP>(Z1, r, zs, rs, base, cn, LDZ, C, n);
      __syncthreads();
    }
    // row k's slice at k LDZ + row_shift: (sh0 + k n) mod 4
    const int sh0 = row_shift(Z1, 0, n, base);
    for (int ib = 0; ib < cn; ib += NT / 8) {
      const int i = ib + (t >> 3);
      float a0 = 0.f, a1 = 0.f;
      if (i < cn) {
#pragma unroll
        for (int e = 0; e < CMAX / 8; e += 2) {
          const int k = g + 8 * e;
          if (k < C) a0 = fmaf(d[e], zs[k * LDZ + ((sh0 + k * n) & 3) + i], a0);
          if (k + 8 < C) a1 = fmaf(d[e + 1], zs[(k + 8) * LDZ + ((sh0 + (k + 8) * n) & 3) + i], a1);
        }
      }
      float a = a0 + a1;
      a += __shfl_xor_sync(FULL_MASK, a, 1);
      a += __shfl_xor_sync(FULL_MASK, a, 2);
      a += __shfl_xor_sync(FULL_MASK, a, 4);
      if (g == 0 && i < cn) {
        const float v = rs[i] - a;
        rs[i] = v;
        if (!KEEP) r[base + i] = v;
      }
    }
  }
}

// G1's chain state in one lane: the right-hand sides of its markers k =
// lane + 32 q, their step constants, and four steps' entries G1[k][j ..
// j + 3] of each row (0 where j >= k)
struct ChainLane {
  float rh[4];
  float ca[4], ch[4], cc[4], ck[4], cs[4], cb[4];  // a, h, c, the take threshold, sqrt(var) rn, b_old
  float4 g[4];
};

// v > thr ? d1 : d0 as one compare and one select (kept from being folded
// into a select and a subtraction behind the compare)
__device__ __forceinline__ float select_gt(float v, float thr, float d1, float d0) {
  float d;
  asm("{\n.reg .pred p;\nsetp.gt.f32 p, %1, %2;\nselp.f32 %0, %3, %4, p;\n}\n"
      : "=f"(d)
      : "f"(v), "f"(thr), "f"(d1), "f"(d0));
  return d;
}

// G1's marker step j (lane jj of register q; E = j mod 4). The draw is
// made by marker j's lane from registers and its db broadcast (one
// shuffle); every lane's later right-hand sides take -G1[k][j] db in the
// order of j, the same FMA as one marker at a time. The Gram's entries come
// four steps at a time (one 16-byte load a row). The dependent path of a
// step: rhs_j -> rhs_j^2 -> log-odds -> the draw's predicate -> db ->
// shuffle -> rhs_{j+1}.
template <int E>
__device__ __forceinline__ void chain_step(ChainLane& s, int j, int q, int jj, int C,
                                           const float* tri, const int (&row)[4], int lane) {
  if (E == 0) {
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      const int k = lane + 32 * q2;
      s.g[q2] = q2 >= q && k < C && j < (k + 3) / 4 * 4
                    ? *reinterpret_cast<const float4*>(tri + row[q2] + j)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float r = s.rh[q];
  const float lo = fmaf(s.ch[q], r * r, s.cc[q]);  // the log-odds of inclusion
  const float bj = fmaf(r, s.ca[q], s.cs[q]);      // mean + sqrt(var) rn
  const float db = __shfl_sync(FULL_MASK, select_gt(lo, s.ck[q], bj - s.cb[q], 0.f - s.cb[q]), jj);
#pragma unroll
  for (int q2 = 0; q2 < 4; ++q2) {
    const float c = E == 0 ? s.g[q2].x : E == 1 ? s.g[q2].y : E == 2 ? s.g[q2].z : s.g[q2].w;
    if (q2 >= q) s.rh[q2] = fmaf(-c, db, s.rh[q2]);
  }
}

// the marker chain of one block on one warp; then each lane draws its own
// markers again from their final right-hand sides (the same arithmetic on
// the same values) and writes b, db and delta
template <bool FULL>
__device__ __forceinline__ void chain(const float* R, const float* rhs, float* bns, float* dbs,
                                      float* dls, int C) {
  const int lane = threadIdx.x & 31;
  const float4 *step = reinterpret_cast<const float4*>(R), *keep = step + CMAX;
  const float* tri = R + 12 * CMAX;
  ChainLane s;
  int row[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = lane + 32 * q;
    const bool in = k < C;
    const float4 a = step[in ? k : 0], kp = keep[in ? k : 0];
    s.ca[q] = a.x;
    s.ch[q] = a.y;
    s.cc[q] = a.z;
    s.ck[q] = kp.z;
    s.cs[q] = kp.x;
    s.cb[q] = kp.y;
    s.rh[q] = in ? rhs[k] : 0.f;
    row[q] = tri_row(k);
  }
  if constexpr (FULL) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j4 = 32 * q; j4 < 32 * q + 32; j4 += 4) {
        chain_step<0>(s, j4, q, j4 & 31, CMAX, tri, row, lane);
        chain_step<1>(s, j4 + 1, q, (j4 + 1) & 31, CMAX, tri, row, lane);
        chain_step<2>(s, j4 + 2, q, (j4 + 2) & 31, CMAX, tri, row, lane);
        chain_step<3>(s, j4 + 3, q, (j4 + 3) & 31, CMAX, tri, row, lane);
      }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int j4 = 32 * q; j4 < 32 * q + 32 && j4 < C; j4 += 4) {
        chain_step<0>(s, j4, q, j4 & 31, C, tri, row, lane);
        if (j4 + 1 >= C) break;
        chain_step<1>(s, j4 + 1, q, (j4 + 1) & 31, C, tri, row, lane);
        if (j4 + 2 >= C) break;
        chain_step<2>(s, j4 + 2, q, (j4 + 2) & 31, C, tri, row, lane);
        if (j4 + 3 >= C) break;
        chain_step<3>(s, j4 + 3, q, (j4 + 3) & 31, C, tri, row, lane);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = lane + 32 * q;
    if (k < C) {
      const float r = s.rh[q];
      const float lo = fmaf(s.ch[q], r * r, s.cc[q]);
      const float bj = fmaf(r, s.ca[q], s.cs[q]);
      const bool take = lo > s.ck[q];
      bns[k] = take ? bj : 0.f;
      dbs[k] = select_gt(lo, s.ck[q], bj - s.cb[q], 0.f - s.cb[q]);
      dls[k] = lo > step[k].w ? 1.f : 0.f;
    }
  }
}

// G2's draw: b = M u + w. Warp w sums rows 16 w .. 16 w + 15 of M for
// the four columns 4 l .. 4 l + 3 of its lane l (M's 16 x 4 tile was loaded
// into registers when the block began, as float4s); the eight row groups'
// sums are added in the same order for every column. Then the mask, db and
// var_b's new value from marker t's {w, b_old, x2, rchi}.
__device__ __forceinline__ void mvn_draw(const float4 (&m)[16], float4 wv, const float* u,
                                         float* red, float* bns, float* dbs, float* vbs, int C,
                                         float s0b, float vfill) {
  const int t = threadIdx.x, rg = t >> 5, cg = t & 31;
  const float4* u4 = reinterpret_cast<const float4*>(u) + 4 * rg;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int l4 = 0; l4 < 4; ++l4) {
    const float4 v = u4[l4];
    const float ul[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 mm = m[4 * l4 + e];
      a.x = fmaf(mm.x, ul[e], a.x);
      a.y = fmaf(mm.y, ul[e], a.y);
      a.z = fmaf(mm.z, ul[e], a.z);
      a.w = fmaf(mm.w, ul[e], a.w);
    }
  }
  reinterpret_cast<float4*>(red + rg * CMAX)[cg] = a;
  __syncthreads();
  if (t < C) {
    const float* rc = red + t;
    const float sum = ((rc[0] + rc[CMAX]) + (rc[2 * CMAX] + rc[3 * CMAX])) +
                      ((rc[4 * CMAX] + rc[5 * CMAX]) + (rc[6 * CMAX] + rc[7 * CMAX]));
    const float bn = wv.z > 0.f ? sum + wv.x : 0.f;
    bns[t] = bn;
    dbs[t] = bn - wv.y;
    vbs[t] = wv.z > 0.f ? (s0b + bn * bn) / wv.w : vfill;
  }
}

// The serial pass over the nb blocks (ALG: MARKER or MVN; FULL: C == CMAX
// compiled as its own case; MODE: the path). method: 1 = BayesB (per-marker
// slab variances var_b), 2 = BayesCpi (one shared slab variance; var_b is
// dead state, left as it is).
template <int ALG, bool FULL, int MODE>
__global__ void __launch_bounds__(NT) gibbs_sweep_kernel(
    const float* __restrict__ Zb, const float* __restrict__ rec, float* beta, float* var_b,
    float* delta, float* r, const float* __restrict__ scal, float* work, unsigned* counter,
    int nb, int C, int n, int S, int SC, int LDZ, int zpre, int method) {
  constexpr bool KEEP = MODE != CHUNKED;
  constexpr int RECF = ALG == MARKER ? REC_MARKER : REC_MVN;
  constexpr uint32_t RB = RECF * sizeof(float);
  if (FULL) C = CMAX;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  uint64_t *bar = reinterpret_cast<uint64_t*>(sm), *ibar = bar + 2;
  float* recs = sm + 8;
  float* inbox = recs + (ALG == MARKER ? 2 * RECF : 0);
  float* zbuf = inbox + (MODE == CLUSTER ? 2 * CLUSTER_MAX * CMAX : 0);
  float* rs = zbuf + (zpre ? 2 : 1) * CMAX * LDZ;
  float *mine = rs + (LDZ + 3) / 4 * 4, *rhs = mine + CMAX, *bns = rhs + CMAX, *dbs = bns + CMAX,
        *aux = dbs + CMAX, *red = aux + CMAX;
  const int t = threadIdx.x, p = blockIdx.x, P = gridDim.x;
  const int i0 = p * S, ns = min(S, n - p * S);
  const int nchunks = KEEP ? 1 : (ns + SC - 1) / SC;
  const float s0b = scal[3], vfill = scal[4];
  // CTA 0's upper half writes the results, so thread 0's fence on the grid
  // path waits for its own stores only
  const int kw = t - (NT - CMAX);

  if (t == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (MODE == CLUSTER) cluster_sync();  // every inbox barrier is initialised
  if constexpr (ALG == MARKER)
    if (t == 0) bulk_load(recs, rec, RB, &bar[0]);
  if (KEEP)
    for (int i = t; i < ns; i += NT) rs[i] = r[i0 + i];
  const float* zend = Zb + static_cast<size_t>(nb) * C * n;
  if (zpre) {
    load_slice_async(Zb, zbuf, i0, ns, LDZ, C, n, Zb, zend, t, NT);
    cp_async_wait_all();
  }

  for (int b = 0; b < nb; ++b) {
    const size_t o = static_cast<size_t>(b) * C;
    const float* Z1 = Zb + o * n;
    const int s = b & 1;
    const float* R = ALG == MARKER ? recs + s * RECF : rec + static_cast<size_t>(b) * RECF;
    float* zs = zbuf + (zpre ? s : 0) * CMAX * LDZ;
    float* znext = zbuf + (s ^ 1) * CMAX * LDZ;
    __syncthreads();  // block b - 1 is done; block b's rows are in place
    float4 m[16];
    float4 wv;
    if constexpr (ALG == MARKER) {
      if (t == 0 && b + 1 < nb)  // block b + 1's record, behind this block's chain
        bulk_load(recs + (s ^ 1) * RECF, rec + static_cast<size_t>(b + 1) * RECF, RB,
                  &bar[s ^ 1]);
    } else {  // this thread's 16 x 4 tile of M, in flight behind steps 1-2
      const float4* M4 = reinterpret_cast<const float4*>(R) + (t >> 5) * 16 * (CMAX / 4) + (t & 31);
#pragma unroll
      for (int l = 0; l < 16; ++l) m[l] = __ldg(M4 + l * (CMAX / 4));
      const float* W = R + CMAX * CMAX + (t & (CMAX - 1));
      wv = make_float4(__ldg(W), __ldg(W + CMAX), __ldg(W + 2 * CMAX), __ldg(W + 3 * CMAX));
    }
    if (MODE == CLUSTER && t == 0)  // every CTA's partials of this block, counted in bytes
      mbar_expect_tx(&ibar[s], P * CMAX * sizeof(float));

    // 1-2. the right-hand sides
    const float pz = partial_zr<KEEP>(Z1, r, zs, rs, i0, ns, SC, nchunks, LDZ, C, n, zpre);
    const int k2 = t >> 1;
    if constexpr (MODE == CLUSTER) {  // pushed into every CTA's inbox slot p
      if ((t & 1) == 0) mine[k2] = k2 < C ? pz : 0.f;
      __syncthreads();
      const uint32_t slot = smem_u32(inbox + (s * CLUSTER_MAX + p) * CMAX), ib = smem_u32(&ibar[s]);
      for (int e = t; e < P * (CMAX / 4); e += NT) {
        const int q = e / (CMAX / 4), v = e % (CMAX / 4);
        st_async(mapa(slot + 16 * v, q), reinterpret_cast<const float4*>(mine)[v], mapa(ib, q));
      }
    } else {
      if ((t & 1) == 0 && k2 < C) work[(static_cast<size_t>(s) * P + p) * C + k2] = pz;
      __syncthreads();
      if (t == 0) {
        __threadfence();
        atomicAdd(counter, 1u);
      }
    }
    if constexpr (ALG == MVN)  // the next block's rows, while the others arrive
      if (zpre && b + 1 < nb)
        load_slice_async(Z1 + static_cast<size_t>(C) * n, znext, i0, ns, LDZ, C, n, Zb, zend, t,
                         NT);
    if constexpr (MODE == CLUSTER) {
      mbar_wait(&ibar[s], (b >> 1) & 1);
    } else {
      if (t == 0) {
        // every CTA of the (cooperative, hence resident) grid arrives once
        // per block; the counter only grows, so block b waits for (b + 1) P
        while (ld_acquire(counter) < static_cast<unsigned>(b + 1) * P) __nanosleep(32);
        __threadfence();
      }
      __syncthreads();
    }
    {  // the P partials in the same order in every CTA, half of them per thread half
      const int k = t & (CMAX - 1), h = t >> 7;
      float a = 0.f;
      if (k < C) {
        if constexpr (MODE == CLUSTER) {
          const float* in = inbox + s * CLUSTER_MAX * CMAX + k;
          for (int q = h; q < P; q += 2) a += in[q * CMAX];
        } else {
          const float* pw = work + static_cast<size_t>(s) * P * C + k;
#pragma unroll 8
          for (int q = h; q < P; q += 2) a += __ldcg(pw + static_cast<size_t>(q) * C);
        }
      }
      red[h * CMAX + k] = a;
    }
    if constexpr (ALG == MARKER) mbar_wait(&bar[s], (b >> 1) & 1);
    __syncthreads();
    if (t < CMAX) {
      const float u = t < C ? red[t] + red[CMAX + t] : 0.f;
      if constexpr (ALG == MARKER) {
        const float4 kp = reinterpret_cast<const float4*>(R)[CMAX + t];
        const float4 pc = reinterpret_cast<const float4*>(R)[2 * CMAX + t];
        rhs[t] = t < C ? u + pc.z * kp.y : 0.f;  // Z1 r + x2 b_old
      } else {
        rhs[t] = u;
      }
    }
    __syncthreads();

    // 3. the block's draw, the same in every CTA; G1's other warps copy the
    // next block's rows meanwhile
    if constexpr (ALG == MARKER) {
      if (t < 32)
        chain<FULL>(R, rhs, bns, dbs, aux, C);
      else if (zpre && b + 1 < nb)
        load_slice_async(Z1 + static_cast<size_t>(C) * n, znext, i0, ns, LDZ, C, n, Zb, zend,
                         t - 32, NT - 32);
    } else {
      mvn_draw(m, wv, rhs, red, bns, dbs, aux, C, s0b, vfill);
    }
    __syncthreads();

    // 4. r -= Z1^T db on this CTA's slice; CTA 0 writes the block (bayes.py:
    // 106-115, 233-235)
    update_r<KEEP>(Z1, r, zs, rs, dbs, i0, ns, SC, nchunks, LDZ, C, n);
    if (p == 0 && kw >= 0 && kw < C) {
      beta[o + kw] = bns[kw];
      if constexpr (ALG == MARKER) {
        delta[o + kw] = aux[kw];
        if (method != 2) {
          const float4 pc = reinterpret_cast<const float4*>(R)[2 * CMAX + kw];
          const float vb = aux[kw] > 0.f ? (s0b + bns[kw] * bns[kw]) / pc.x : s0b / pc.y;
          var_b[o + kw] = pc.z > 0.f ? vb : vfill;
        }
      } else {
        var_b[o + kw] = aux[kw];
      }
    }
    if (zpre) cp_async_wait_all();
  }
  if constexpr (MODE == CLUSTER) cluster_sync();  // nothing is in flight to a CTA that left
  __syncthreads();
  if (KEEP)
    for (int i = t; i < ns; i += NT) r[i0 + i] = rs[i];
}

// ------------------------------------------------------------ host side
struct Plan {
  int mode, P, S, SC, LDZ, zpre;
  size_t smem;
};

template <int ALG, int MODE>
const void* sweep_fn(bool full) {
  if constexpr (ALG == MARKER)
    return full ? (const void*)gibbs_sweep_kernel<ALG, true, MODE>
                : (const void*)gibbs_sweep_kernel<ALG, false, MODE>;
  else  // G2 has no chain to unroll
    return (const void*)gibbs_sweep_kernel<ALG, false, MODE>;
}

template <int ALG>
const void* sweep_fn(int mode, bool full) {
  return mode == CLUSTER ? sweep_fn<ALG, CLUSTER>(full)
         : mode == GRID  ? sweep_fn<ALG, GRID>(full)
                         : sweep_fn<ALG, CHUNKED>(full);
}

const void* sweep_fn(int alg, int mode, int C) {
  return alg == MARKER ? sweep_fn<MARKER>(mode, C == CMAX) : sweep_fn<MVN>(mode, false);
}

cudaLaunchConfig_t cluster_config(int P, size_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_smem(const void* fn, size_t smem, int P) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && P > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// the row buffers' stride for slices of S samples: room for the 0-3 float
// shift, a multiple of 4 floats (16-byte rows), and 4 mod 8 so that the
// lanes of a warp reading 8 rows meet distinct banks
int row_stride(int S) {
  const int L = (S + 6) & ~3;
  return L % 8 ? L : L + 4;
}

// can one cluster of P CTAs with this shared memory be resident at once
bool cluster_fits(const void* fn, int P, size_t smem) {
  if (set_smem(fn, smem, P) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(P, smem, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return clusters >= 1;
}

// the serial pass's path and sample split: a cluster of at most 16 CTAs
// of at most CLUSTER_S_MAX samples when the slices and both row buffers
// fit, else a cooperative grid of at most one CTA per SM, r kept in shared
// memory when its slice fits (the rows double buffered when two fit), else
// chunks of SC samples
int plan(int alg, int n, int C, Plan& pl) {
  int dev, sms, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t cap = static_cast<size_t>(optin);
  auto bytes = [&](bool cl, int LDZ, int nz) { return sizeof(float) * sweep_floats(alg, cl, LDZ, nz); };
  const int Sc = max(32, (n + CLUSTER_MAX - 1) / CLUSTER_MAX), Pc = (n + Sc - 1) / Sc;
  const size_t smc = bytes(true, row_stride(Sc), 2);
  if (Sc <= CLUSTER_S_MAX && smc <= cap &&
      cluster_fits(sweep_fn(alg, CLUSTER, C), Pc, smc)) {
    pl = {CLUSTER, Pc, Sc, Sc, row_stride(Sc), 1, smc};
    return 0;
  }
  const int S = max(32, (n + sms - 1) / sms), P = (n + S - 1) / S, LDZ = row_stride(S);
  if (bytes(false, LDZ, 2) <= cap) {
    pl = {GRID, P, S, S, LDZ, 1, bytes(false, LDZ, 2)};
  } else if (bytes(false, LDZ, 1) <= cap) {
    pl = {GRID, P, S, S, LDZ, 0, bytes(false, LDZ, 1)};
  } else {
    int SC = S;
    while (SC > 1 && bytes(false, row_stride(SC), 1) > cap) --SC;
    if (bytes(false, row_stride(SC), 1) > cap) return static_cast<int>(cudaErrorInvalidValue);
    pl = {CHUNKED, P, S, SC, row_stride(SC), 0, bytes(false, row_stride(SC), 1)};
  }
  return 0;
}

int launch_sweep(int alg, int C, const Plan& pl, void** args, unsigned* counter,
                 cudaStream_t st) {
  const void* fn = sweep_fn(alg, pl.mode, C);
  cudaError_t e = set_smem(fn, pl.smem, pl.mode == CLUSTER ? pl.P : 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pl.mode == CLUSTER) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(pl.P, pl.smem, st, &attr);
    e = cudaLaunchKernelExC(&cfg, fn, args);
  } else {
    e = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(fn, dim3(pl.P), dim3(NT), args, pl.smem, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int launch_prep(const void* fn, int nb, size_t smem, void** args, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaLaunchKernel(fn, dim3(nb), dim3(NT), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t MVN_PREP_SMEM = sizeof(float) * (CMAX * (CMAX + 1) + 8 * CMAX + 4);

}  // namespace

// The serial pass's plan for kernel ``alg`` (1 = G1, 2 = G2) at n samples
// and C markers a block: out = {path (0 cluster, 1 grid, 2 chunked), P, S,
// SC, LDZ, rows double buffered, shared bytes}.
extern "C" int jx_gibbs_plan(int alg, int n, int C, long long* out) {
  if ((alg != MARKER && alg != MVN) || n <= 0 || C <= 0 || C > CMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  if (const int e = plan(alg, n, C, pl)) return e;
  const long long v[7] = {pl.mode, pl.P, pl.S, pl.SC, pl.LDZ, pl.zpre,
                          static_cast<long long>(pl.smem)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// floats per block of the pre-pass's records: 1 = G1, 2 = G2
extern "C" int jx_gibbs_record_floats(int alg) {
  return alg == MARKER ? REC_MARKER : alg == MVN ? REC_MVN : 0;
}

// phases: 1 = the pre-pass, 2 = the serial pass, 3 = both (a sweep). rec
// holds nb x REC_MARKER floats, work 2 P C floats (P at most the device's
// SM count), counter one unsigned.
extern "C" int jx_gibbs_marker(const float* Zb, const float* Gb, const float* x2, float* beta,
                               float* var_b, float* delta, const float* rn, const float* ru,
                               const float* rca, const float* rci, float* r,
                               const float* scal, float* rec, float* work, unsigned* counter,
                               int nb, int C, int n, int method, int phases, void* stream) {
  if (nb <= 0 || C <= 0 || C > CMAX || n <= 0 || (method != 1 && method != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    void* args[] = {&Gb, &x2, &beta, &var_b, &rn, &ru, &rca, &rci, &scal, &rec, &C, &method};
    if (const int e = launch_prep((const void*)gibbs_marker_prep_kernel, nb, 0, args, st))
      return e;
  }
  if (phases & 2) {
    Plan pl;
    if (const int e = plan(MARKER, n, C, pl)) return e;
    void* args[] = {&Zb,  &rec, &beta, &var_b, &delta,  &r,       &scal,   &work,   &counter,
                    &nb,  &C,   &n,    &pl.S,  &pl.SC,  &pl.LDZ,  &pl.zpre, &method};
    return launch_sweep(MARKER, C, pl, args, counter, st);
  }
  return 0;
}

// rec holds nb x REC_MVN floats; the rest as jx_gibbs_marker's
extern "C" int jx_gibbs_block_mvn(const float* Zb, const float* Gb, const float* x2,
                                  float* beta, float* var_b, const float* z,
                                  const float* rchi, float* r, const float* scal, float* rec,
                                  float* work, unsigned* counter, int nb, int C, int n,
                                  int phases, void* stream) {
  if (nb <= 0 || C <= 0 || C > CMAX || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    void* args[] = {&Gb, &x2, &beta, &var_b, &z, &rchi, &scal, &rec, &C};
    if (const int e =
            launch_prep((const void*)gibbs_mvn_prep_kernel, nb, MVN_PREP_SMEM, args, st))
      return e;
  }
  if (phases & 2) {
    Plan pl;
    if (const int e = plan(MVN, n, C, pl)) return e;
    float* delta = nullptr;
    int method = 0;
    void* args[] = {&Zb,  &rec, &beta, &var_b, &delta,  &r,       &scal,   &work,   &counter,
                    &nb,  &C,   &n,    &pl.S,  &pl.SC,  &pl.LDZ,  &pl.zpre, &method};
    return launch_sweep(MVN, C, pl, args, counter, st);
  }
  return 0;
}
