// K2 — per-(SNP, lambda) profiled -REML lattice of the grid LMM scan.
//
// Replaces janusx_tpu/ops/pallas_kernels.py:grid_neg_reml_lattice (kernel
// body _grid_lattice_kernel; operand packer janusx_tpu/models/lmm.py:
// _lattice_operands, whose SH row layout is mirrored by
// janusx_tpu_torch/ops/kernels.py:pack_sh).
//
// For SNP b and grid point g with weights w_g = 1/(s + lambda_g) it forms
// the 2+p grams agg = sum_k Gr^2 w, agy = sum_k Gr y w, axg_q = sum_k Gr X_q w,
// then evaluates the closed-form Schur complement of the ridged covariate
// Gram against the per-lambda rows of SH (column g), and writes +inf on
// invalid cells (non-finite value, r'Wr <= 0 or Schur <= 0) exactly as the
// Pallas kernel does.
//
// What bounds it on the H100: (2+p) B G n FMAs plus (2+p) B n products
// against B n + G n floats read once per tile, so it is FP32-arithmetic
// bound. The XLA formulation it replaces also wrote ~15 (B, G)
// intermediates to memory; here they never leave registers.
//
// Design: each 256-thread block owns a 32 SNP x 64 lambda tile and loops
// over the sample axis in shared-memory chunks of 32 (so, unlike the Pallas
// kernel, which held whole sample rows in VMEM, any n works and there is no
// lane cap). Each thread holds 2 x 4 cells x (2+p) f32 accumulators in
// registers; per sample it forms Gr*Gr, Gr*y and Gr*X_q once per SNP row
// (the reference's elementwise products) and FMAs them against the 4 weights.
// The Schur epilogue then runs in registers. Ragged B, G and n are masked.
// p is a template parameter (1..4, as in the reference). Accumulation is
// plain f32 FMA, so JX_TPU_GRID_MXU_PREC (the TPU's one-pass vs six-pass
// MXU choice) has no effect on this kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BB = 32;  // SNP rows per block
constexpr int BG = 64;  // lambda points per block
constexpr int BK = 32;  // samples per shared-memory chunk
constexpr int TB = 2;   // SNP rows per thread (ty + 16 i)
constexpr int TG = 4;   // lambda points per thread (tx + 16 j)
constexpr int NT = 256;

template <int P>
__global__ void __launch_bounds__(NT)
lattice_kernel(const float* __restrict__ Gr, const float* __restrict__ W,
               const float* __restrict__ YX, const float* __restrict__ SH,
               float* __restrict__ out, int B, int G, int n, int ldg, int ldw,
               int ldyx, float ridge, float nfp) {
  __shared__ float Gs[BB][BK + 1];
  __shared__ float Ws[BG][BK + 1];
  __shared__ float Ys[P + 1][BK];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b0 = blockIdx.x * BB;  // rows on x: no 65,535-block limit on B
  const int g0 = blockIdx.y * BG;

  float agg[TB][TG], agy[TB][TG], axg[P][TB][TG];
#pragma unroll
  for (int i = 0; i < TB; ++i)
#pragma unroll
    for (int j = 0; j < TG; ++j) {
      agg[i][j] = 0.0f;
      agy[i][j] = 0.0f;
#pragma unroll
      for (int q = 0; q < P; ++q) axg[q][i][j] = 0.0f;
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
    if (tid < (P + 1) * BK) {
      const int q = tid / BK, c = tid % BK;
      Ys[q][c] = (k0 + c < n) ? YX[(size_t)q * ldyx + k0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float w[TG];
#pragma unroll
      for (int j = 0; j < TG; ++j) w[j] = Ws[tx + 16 * j][kk];
      const float y = Ys[0][kk];
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const float g = Gs[ty + 16 * i][kk];
        const float gg = g * g;
        const float gy = g * y;
        float gx[P];
#pragma unroll
        for (int q = 0; q < P; ++q) gx[q] = g * Ys[1 + q][kk];
#pragma unroll
        for (int j = 0; j < TG; ++j) {
          agg[i][j] = fmaf(gg, w[j], agg[i][j]);
          agy[i][j] = fmaf(gy, w[j], agy[i][j]);
#pragma unroll
          for (int q = 0; q < P; ++q) axg[q][i][j] = fmaf(gx[q], w[j], axg[q][i][j]);
        }
      }
    }
    __syncthreads();
  }

  // SH rows: [Ar_inv (P*P), Ainv_axy (P), Axx (P*P), axy (P), ayy,
  //           logdetAr, logdetV], each of length G
  constexpr int O_ARINV = 0, O_AINVAXY = P * P, O_AXX = P * P + P;
  constexpr int O_AXY = 2 * P * P + P, O_AYY = 2 * P * P + 2 * P;
#pragma unroll
  for (int j = 0; j < TG; ++j) {
    const int g = g0 + tx + 16 * j;
    if (g >= G) continue;
    float Ar_inv[P][P], Ainv_axy[P], Axx[P][P], axy[P];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      Ainv_axy[a] = SH[(size_t)(O_AINVAXY + a) * G + g];
      axy[a] = SH[(size_t)(O_AXY + a) * G + g];
#pragma unroll
      for (int b = 0; b < P; ++b) {
        Ar_inv[a][b] = SH[(size_t)(O_ARINV + a * P + b) * G + g];
        Axx[a][b] = SH[(size_t)(O_AXX + a * P + b) * G + g];
      }
    }
    const float ayy = SH[(size_t)O_AYY * G + g];
    const float logdetAr = SH[(size_t)(O_AYY + 1) * G + g];
    const float logdetV = SH[(size_t)(O_AYY + 2) * G + g];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b >= B) continue;
      const float cgg = agg[i][j], cgy = agy[i][j];
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
      out[(size_t)b * G + g] = bad ? INFINITY : neg;
    }
  }
}

template <int P>
int launch(const float* Gr, const float* W, const float* YX, const float* SH,
           float* out, int B, int G, int n, int ldg, int ldw, int ldyx,
           float ridge, float nfp, cudaStream_t stream) {
  dim3 grid((B + BB - 1) / BB, (G + BG - 1) / BG);
  lattice_kernel<P><<<grid, NT, 0, stream>>>(Gr, W, YX, SH, out, B, G, n, ldg,
                                             ldw, ldyx, ridge, nfp);
  return (int)cudaGetLastError();
}

}  // namespace

// Gr (B, ldg) f32, W (G, ldw) f32, YX (1+p, ldyx) f32 — the first n lanes
// of each row are used; SH (2p^2+2p+3, G) f32 contiguous; out (B, G) f32
// contiguous. nfp = n - (p + 1). Returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for p outside 1..4.
extern "C" int jx_grid_lattice(const float* Gr, const float* W,
                               const float* YX, const float* SH, float* out,
                               int B, int G, int n, int p, int ldg, int ldw,
                               int ldyx, float ridge, float nfp,
                               void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 1: return launch<1>(Gr, W, YX, SH, out, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 2: return launch<2>(Gr, W, YX, SH, out, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 3: return launch<3>(Gr, W, YX, SH, out, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 4: return launch<4>(Gr, W, YX, SH, out, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
