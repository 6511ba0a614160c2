// K2 — per-(trait, SNP, lambda) profiled -REML lattice of the grid LMM scan.
//
// Replaces janusx_tpu/ops/pallas_kernels.py:grid_neg_reml_lattice (kernel
// body _grid_lattice_kernel; operand packer janusx_tpu/models/lmm.py:
// _lattice_operands, whose SH row layout is mirrored by
// janusx_tpu_torch/ops/kernels.py:pack_sh). The reference calls that kernel
// once per trait on the same rotated block (janusx_tpu/models/lmm.py:578-591,
// an unrolled loop over T); this kernel takes the trait axis in one launch.
//
// For trait t, SNP b and grid point g with weights w_g = 1/(s + lambda_g) it
// forms the 2+p grams agg = sum_k Gr^2 w, agy_t = sum_k Gr y_t w,
// axg_q = sum_k Gr X_q w, then evaluates the closed-form Schur complement of
// the ridged covariate Gram against trait t's per-lambda rows of SH (column
// g), and writes +inf on invalid cells (non-finite value, r'Wr <= 0 or
// Schur <= 0) exactly as the Pallas kernel does. Within one multi-trait scan
// the weights, the covariates and so agg and axg are the same for every
// trait: they are formed once per cell, and only agy and the epilogue are
// per trait (at p = 1 and T = 4, 6 grams per cell instead of 12).
//
// What bounds it on the H100: (1 + p + T) B G n FMAs plus (1 + p + T) B n
// products against B n + G n floats read once per tile, so it is
// FP32-arithmetic bound. The XLA formulation it replaces also wrote ~15
// (B, G) intermediates to memory; here they never leave registers.
//
// Design: each 256-thread block owns a 32 SNP x 64 lambda tile of a chunk of
// up to TT = 4 traits (the grid's z axis walks the chunks) and loops over the
// sample axis in shared-memory chunks of 32 (so, unlike the Pallas kernel,
// which held whole sample rows in VMEM, any n works and there is no lane
// cap). Each thread holds 2 x 4 cells x (1 + p + TT) f32 accumulators in
// registers; per sample it forms Gr*Gr, Gr*X_q and Gr*y_t once per SNP row
// (the reference's elementwise products) and FMAs them against the 4
// weights. The Schur epilogue then runs in registers, once per trait. Ragged
// T, B, G and n are masked. p (1..4) and TT (1..4) are template parameters.
// Each trait's sums are the same FMAs in the same order whatever T is, so a
// launch over T traits equals T single-trait launches bit for bit.
// Accumulation is plain f32 FMA, so JX_TPU_GRID_MXU_PREC (the TPU's
// one-pass vs six-pass MXU choice) has no effect on this kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BB = 32;  // SNP rows per block
constexpr int BG = 64;  // lambda points per block
constexpr int BK = 32;  // samples per shared-memory chunk
constexpr int TB = 2;   // SNP rows per thread (ty + 16 i)
constexpr int TG = 4;   // lambda points per thread (tx + 16 j)
constexpr int NT = 256;

template <int P, int TT>
__global__ void __launch_bounds__(NT)
lattice_kernel(const float* __restrict__ Gr, const float* __restrict__ W,
               const float* __restrict__ YX, const float* __restrict__ SH,
               float* __restrict__ out, int T, int B, int G, int n, int ldg,
               int ldw, int ldyx, float ridge, float nfp) {
  __shared__ float Gs[BB][BK + 1];
  __shared__ float Ws[BG][BK + 1];
  __shared__ float Xs[P][BK];
  __shared__ float Ys[TT][BK];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b0 = blockIdx.x * BB;  // rows on x: no 65,535-block limit on B
  const int g0 = blockIdx.y * BG;
  const int t0 = blockIdx.z * TT;

  float agg[TB][TG], axg[P][TB][TG], agy[TT][TB][TG];
#pragma unroll
  for (int i = 0; i < TB; ++i)
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      agg[i][j] = 0.0f;
#pragma unroll
      for (int q = 0; q < P; ++q) axg[q][i][j] = 0.0f;
#pragma unroll
      for (int t = 0; t < TT; ++t) agy[t][i][j] = 0.0f;
    }

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BB * BK) / NT; ++l) {
      const int idx = tid + NT * l;
      const int r = idx / BK, c = idx % BK;
      const int gb = b0 + r, gk = k0 + c;
      Gs[r][c] = (gb < B && gk < n) ? Gr[(size_t)gb * ldg + gk] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (BG * BK) / NT; ++l) {
      const int idx = tid + NT * l;
      const int r = idx / BK, c = idx % BK;
      const int gg = g0 + r, gk = k0 + c;
      Ws[r][c] = (gg < G && gk < n) ? W[(size_t)gg * ldw + gk] : 0.0f;
    }
    // YX rows: T traits, then P covariates shared by every trait
    if (tid < (TT + P) * BK) {
      const int r = tid / BK, c = tid % BK;
      const bool in = k0 + c < n;
      if (r < TT) {
        Ys[r][c] = (in && t0 + r < T) ? YX[(size_t)(t0 + r) * ldyx + k0 + c] : 0.0f;
      } else {
        Xs[r - TT][c] = in ? YX[(size_t)(T + r - TT) * ldyx + k0 + c] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float w[TG];
#pragma unroll
      for (int j = 0; j < TG; ++j) w[j] = Ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const float g = Gs[ty + 16 * i][kk];
        const float gg = g * g;
        float gx[P], gy[TT];
#pragma unroll
        for (int q = 0; q < P; ++q) gx[q] = g * Xs[q][kk];
#pragma unroll
        for (int t = 0; t < TT; ++t) gy[t] = g * Ys[t][kk];
#pragma unroll
        for (int j = 0; j < TG; ++j) {
          agg[i][j] = fmaf(gg, w[j], agg[i][j]);
#pragma unroll
          for (int t = 0; t < TT; ++t) agy[t][i][j] = fmaf(gy[t], w[j], agy[t][i][j]);
#pragma unroll
          for (int q = 0; q < P; ++q) axg[q][i][j] = fmaf(gx[q], w[j], axg[q][i][j]);
        }
      }
    }
    __syncthreads();
  }

  // SH rows of each trait: [Ar_inv (P*P), Ainv_axy (P), Axx (P*P), axy (P),
  // ayy, logdetAr, logdetV], each of length G
  constexpr int O_ARINV = 0, O_AINVAXY = P * P, O_AXX = P * P + P;
  constexpr int O_AXY = 2 * P * P + P, O_AYY = 2 * P * P + 2 * P;
  constexpr int R = 2 * P * P + 2 * P + 3;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t0 + t >= T) break;
    const float* sh = SH + (size_t)(t0 + t) * R * G;
    float* o = out + (size_t)(t0 + t) * B * G;
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      const int g = g0 + tx + 16 * j;
      if (g >= G) continue;
      float Ar_inv[P][P], Ainv_axy[P], Axx[P][P], axy[P];
#pragma unroll
      for (int a = 0; a < P; ++a) {
        Ainv_axy[a] = sh[(size_t)(O_AINVAXY + a) * G + g];
        axy[a] = sh[(size_t)(O_AXY + a) * G + g];
#pragma unroll
        for (int b = 0; b < P; ++b) {
          Ar_inv[a][b] = sh[(size_t)(O_ARINV + a * P + b) * G + g];
          Axx[a][b] = sh[(size_t)(O_AXX + a * P + b) * G + g];
        }
      }
      const float ayy = sh[(size_t)O_AYY * G + g];
      const float logdetAr = sh[(size_t)(O_AYY + 1) * G + g];
      const float logdetV = sh[(size_t)(O_AYY + 2) * G + g];
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const int b = b0 + ty + 16 * i;
        if (b >= B) continue;
        const float cgg = agg[i][j], cgy = agy[t][i][j];
        float cxg[P];
#pragma unroll
        for (int q = 0; q < P; ++q) cxg[q] = axg[q][i][j];
        float u[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < P; ++c) s += Ar_inv[a][c] * cxg[c];
          u[a] = s;
        }
        float xu = 0.0f, xa = 0.0f;
#pragma unroll
        for (int a = 0; a < P; ++a) {
          xu += cxg[a] * u[a];
          xa += cxg[a] * Ainv_axy[a];
        }
        const float schur = (cgg + ridge) - xu;
        const float beta_g = (cgy - xa) / schur;
        float bX[P];
#pragma unroll
        for (int a = 0; a < P; ++a) bX[a] = Ainv_axy[a] - beta_g * u[a];
        float lin = 0.0f, qxx = 0.0f, xb = 0.0f;
#pragma unroll
        for (int a = 0; a < P; ++a) {
          lin += bX[a] * axy[a];
          xb += cxg[a] * bX[a];
#pragma unroll
          for (int c = 0; c < P; ++c) qxx += bX[a] * Axx[a][c] * bX[c];
        }
        lin += beta_g * cgy;
        const float quad = qxx + 2.0f * beta_g * xb + beta_g * beta_g * cgg;
        const float rtwr = ayy - 2.0f * lin + quad;
        const float neg =
            0.5f * (nfp * logf(rtwr) + logdetV + logdetAr + logf(schur));
        const bool bad = !isfinite(neg) || rtwr <= 0.0f || schur <= 0.0f;
        o[(size_t)b * G + g] = bad ? INFINITY : neg;
      }
    }
  }
}

template <int P, int TT>
int launch(const float* Gr, const float* W, const float* YX, const float* SH,
           float* out, int T, int B, int G, int n, int ldg, int ldw, int ldyx,
           float ridge, float nfp, cudaStream_t stream) {
  dim3 grid((B + BB - 1) / BB, (G + BG - 1) / BG, (T + TT - 1) / TT);
  lattice_kernel<P, TT><<<grid, NT, 0, stream>>>(Gr, W, YX, SH, out, T, B, G, n,
                                                 ldg, ldw, ldyx, ridge, nfp);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const float* Gr, const float* W, const float* YX, const float* SH,
             float* out, int T, int B, int G, int n, int ldg, int ldw, int ldyx,
             float ridge, float nfp, cudaStream_t s) {
  switch (T < 4 ? T : 4) {  // traits per block: all of them, up to 4
    case 1: return launch<P, 1>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 2: return launch<P, 2>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 3: return launch<P, 3>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    default: return launch<P, 4>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
  }
}

}  // namespace

// Gr (B, ldg) f32, W (G, ldw) f32, YX (T + p, ldyx) f32 — T trait rows, then
// p covariate rows; the first n lanes of each row are used; SH (T, 2p^2+2p+3,
// G) f32 contiguous; out (T, B, G) f32 contiguous. nfp = n - (p + 1).
// Returns cudaGetLastError() as an int, or cudaErrorInvalidValue for p
// outside 1..4.
extern "C" int jx_grid_lattice(const float* Gr, const float* W,
                               const float* YX, const float* SH, float* out,
                               int T, int B, int G, int n, int p, int ldg,
                               int ldw, int ldyx, float ridge, float nfp,
                               void* stream) {
  if (T <= 0 || B <= 0 || G <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 1: return launch_p<1>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 2: return launch_p<2>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 3: return launch_p<3>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 4: return launch_p<4>(Gr, W, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
