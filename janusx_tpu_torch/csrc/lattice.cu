// K2 — per-(trait, SNP, lambda) profiled -REML lattice of the grid LMM scan,
// on Hopper's tensor cores (wgmma, bf16 operands, f32 accumulators).
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
// The two modes (JX_TPU_GRID_MXU_PREC), each the same function as its plain
// version (ops/kernels.py:grid_neg_reml_lattice_plain):
// - "highest" (the port's default): f32-accurate grams. W is split once per
//   scan into three bf16 pieces W0 + W1 + W2 = W (ops/kernels.py:split_w,
//   exact); each product Gr*Gr, Gr*y_t, Gr*X_q is formed in f32 in registers
//   and split there into three bf16 pieces A0 + A1 + A2; the six significant
//   cross products A0W0, A0W1, A1W0, A0W2, A1W1, A2W0 (the XLA HIGHEST
//   scheme) are exact in the f32 accumulator.
// - "default" (the reference's own default, Precision.DEFAULT on the TPU):
//   the products and W rounded to bf16 (round to nearest), one pass.
//
// What bounds it on the H100: (1 + p + T) B G n multiply-adds against
// B n + G n floats read and T B G written, far above the card's ridge
// point, so the tensor cores bound it: six bf16 passes in "highest", one in
// "default" (then the ~2 GB of Gr and the lattice come close, 0.6 ms).
//
// Design: one warpgroup (128 threads) per block owns a 64 SNP x 32 lambda
// tile of a chunk of up to TT = 4 traits (grid x: row tiles times lambda
// tiles, lambda tiles fastest so blocks that run together share Gr rows in
// L2; grid z: trait chunks). W's pieces stream through a two-stage
// shared-memory ring by cp.async, 64 samples per stage, in the 128-byte
// swizzle wgmma reads as its B operand. A is never in memory: each thread
// loads its two rows' Gr values (16 bytes per row and k16 step: split_w
// stores each 16-sample step of W in the order that makes wgmma's A
// fragment columns 2t, 2t+1, 2t+8, 2t+9 the samples 4t..4t+3), multiplies
// them by the gram's row (Gr itself, y_t or X_q), splits and packs the
// products straight into A-fragment registers; the next 32 samples' loads
// are issued under the last gram's wgmma group (faster in "highest" on an
// H100 than loading them where they are first used). Per gram and 32
// samples the warpgroup issues the mode's m64n32k16 passes into a tile
// accumulator that starts from zero, waits, and adds the tile into the
// gram's f32 register sum: the tensor cores' running sum over all of n is
// not a full IEEE sum (K1 lost 7.8e-4 that way, csrc/rotate.cu), so it is
// promoted every 32 samples. The 1+p+TT sums (16 registers each) stay in registers, and the
// Schur epilogue then runs on them once per trait. Two or more blocks per
// SM keep the tensor cores busy while one waits or forms its fragments.
// The tile width (32) keeps 9 sums (p = 4, TT = 4) inside 255 registers
// beside the fragments; it does not depend on T. Ragged T, B, G and n are
// masked (W's pieces and the covariate rows are zero-padded; Gr reads past
// n give 0). Each trait's sums are the same instructions in the same order
// whatever T is, so a launch over T traits equals T single-trait launches
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // SNP rows per block: one warpgroup, the wgmma m
constexpr int BN = 32;        // lambda points per block: the wgmma n
constexpr int BK = 64;        // samples per shared-memory stage: 128 bytes of bf16
constexpr int HK = 32;        // samples per commit group: two k16 steps
constexpr int THREADS = 128;
constexpr int TILE_BYTES = BN * BK * 2;  // one W piece, one stage
constexpr int NA = BN / 2;               // accumulator registers per gram

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep a register's value where it is across asynchronous wgmma reads
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// B descriptor: K-major tile of BN rows x 128 bytes in the 128-byte swizzle,
// 8-row groups 1024 bytes apart (as csrc/rotate.cu's)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 32 f32 per warpgroup) = a (64 x 16 bf16, registers) * b (16 x 32)
// + (scale ? d : 0)
__device__ __forceinline__ void mma(float (&d)[NA], const uint32_t (&a)[4],
                                    uint64_t b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// two f32 as a bf16x2 register, each rounded to nearest; lo in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// (lo, hi) as NP bf16x2 pieces: one rounded pair, or three whose sum is
// the pair (each piece the rounded rest of the ones before)
template <int NP>
__device__ __forceinline__ void split(float lo, float hi, uint32_t (&fr)[2][NP][4],
                                      int j, int r) {
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const uint32_t u = pack_rn(lo, hi);
    fr[j][q][r] = u;
    if (q + 1 < NP) {
      lo -= lo_f(u);
      hi -= hi_f(u);
    }
  }
}

// Gr[row, k .. k+3], 0 past n; one 16-byte load where the row allows it
__device__ __forceinline__ float4 load4(const float* row, int k, int n, int vec) {
  if (vec && k + 4 <= n) return __ldg(reinterpret_cast<const float4*>(row + k));
  float4 v;
  v.x = k < n ? __ldg(row + k) : 0.0f;
  v.y = k + 1 < n ? __ldg(row + k + 1) : 0.0f;
  v.z = k + 2 < n ? __ldg(row + k + 2) : 0.0f;
  v.w = k + 3 < n ? __ldg(row + k + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

template <int P, int TT, bool ONE>
__global__ void __launch_bounds__(THREADS, 2)
lattice_wgmma(const float* __restrict__ Gr, const uint16_t* __restrict__ Ws,
              const float* __restrict__ YX, const float* __restrict__ SH,
              float* __restrict__ out, int T, int B, int G, int n, int ldg,
              int ldw, int ldyx, int gpad, int tpad, float ridge, float nfp,
              int vec) {
  constexpr int NP = ONE ? 1 : 3;   // bf16 pieces of each operand
  constexpr int NG = 1 + P + TT;    // grams per cell: agg, axg_q, agy_t
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int gtiles = (G + BN - 1) / BN;
  const int m0 = (blockIdx.x / gtiles) * BM;
  const int g0 = (blockIdx.x % gtiles) * BN;
  const int t0 = blockIdx.z * TT;
  // warp w of the warpgroup, lane = 4 g + t; rows r0 and r0 + 8
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = m0 + 16 * w + g;
  const int r1 = r0 + 8;
  // rows past B read row B - 1: their cells are never written
  const float* row0 = Gr + static_cast<size_t>(min(r0, B - 1)) * ldg;
  const float* row1 = Gr + static_cast<size_t>(min(r1, B - 1)) * ldg;
  const int KT = (n + BK - 1) / BK;

  // one stage of W's pieces: BN rows x 8 chunks of 16 bytes each, chunk c
  // of row r at chunk c ^ (r & 7) (the 128-byte swizzle)
  auto load_stage = [&](int kt) {
    const uint32_t st = smem_u32(ring + (kt & 1) * NP * TILE_BYTES);
#pragma unroll
    for (int l = 0; l < NP * BN * 8 / THREADS; ++l) {
      const int idx = tid + THREADS * l;
      const int q = idx / (BN * 8), r = (idx / 8) % BN, c = idx % 8;
      const uint16_t* src =
          Ws + (static_cast<size_t>(q) * gpad + g0 + r) * ldw + kt * BK + 8 * c;
      cp_async16(st + q * TILE_BYTES + r * 128 + ((c ^ (r & 7)) << 4), src);
    }
    cp_async_commit();
  };

  float acc[NG][NA], tile[NA];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int r = 0; r < NA; ++r) acc[i][r] = 0.0f;
#pragma unroll
  for (int r = 0; r < NA; ++r) tile[r] = 0.0f;

  // the two rows' Gr values of 32 samples [k16 step][row]; the next 32 are
  // loaded into the same registers once the last gram's fragments are
  // formed, so the load runs under that gram's wgmma group
  float4 x[2][2];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      x[j][0] = load4(row0, k0 + 16 * j + 4 * t, n, vec);
      x[j][1] = load4(row1, k0 + 16 * j + 4 * t, n, vec);
    }
  };
  load_x(0);

  load_stage(0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_stage(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the ring was written through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t base = smem_u32(ring + (kt & 1) * NP * TILE_BYTES);
#pragma unroll 1
    for (int hk = 0; hk < BK / HK; ++hk) {
      const int k0 = kt * BK + hk * HK;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        // the gram's row: Gr itself, covariate q = i - 1, or trait i - 1 - P
        const float* mrow =
            YX + static_cast<size_t>(i <= P ? tpad + i - 1 : t0 + i - 1 - P) * ldyx;
        uint32_t fr[2][NP][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float4 m;
          if (i > 0)
            m = __ldg(reinterpret_cast<const float4*>(mrow + k0 + 16 * j + 4 * t));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = mul4(x[j][h], i == 0 ? x[j][h] : m);
            split<NP>(v.x, v.y, fr, j, h);      // fragment columns 2t, 2t+1
            split<NP>(v.z, v.w, fr, j, 2 + h);  // fragment columns 2t+8, 2t+9
          }
        }
        if (i == NG - 1 && k0 + HK < n) load_x(k0 + HK);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t b = base + (2 * hk + j) * 32;  // k16 step 2 hk + j
          const int sc = j > 0;  // the group's first pass starts from zero
          if (ONE) {
            mma(tile, fr[j][0], b_desc(b), sc);
          } else {
            const uint64_t w0 = b_desc(b), w1 = b_desc(b + TILE_BYTES),
                           w2 = b_desc(b + 2 * TILE_BYTES);
            mma(tile, fr[j][2], w0, sc);  // A2 W0
            mma(tile, fr[j][1], w1, 1);   // A1 W1
            mma(tile, fr[j][0], w2, 1);   // A0 W2
            mma(tile, fr[j][1], w0, 1);   // A1 W0
            mma(tile, fr[j][0], w1, 1);   // A0 W1
            mma(tile, fr[j][0], w0, 1);   // A0 W0
          }
        }
        wg_commit();
        wg_wait<0>();
        // the wgmmas read fr and write tile asynchronously: the compiler
        // may reuse or read those registers only from here on
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < NP; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) keep(fr[j][q][r]);
#pragma unroll
        for (int r = 0; r < NA; ++r) {
          keep(tile[r]);
          acc[i][r] += tile[r];
        }
      }
    }
    __syncthreads();  // the stage is read: the next load may overwrite it
  }

  // accumulator layout: register 4 jn + 2 h + e holds row 16 w + g + 8 h,
  // column 8 jn + 2 t + e of the 64 x BN tile.
  // SH rows of each trait: [Ar_inv (P*P), Ainv_axy (P), Axx (P*P), axy (P),
  // ayy, logdetAr, logdetV], each of length G
  constexpr int O_ARINV = 0, O_AINVAXY = P * P, O_AXX = P * P + P;
  constexpr int O_AXY = 2 * P * P + P, O_AYY = 2 * P * P + 2 * P;
  constexpr int R = 2 * P * P + 2 * P + 3;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    if (t0 + tt >= T) break;
    const float* sh = SH + static_cast<size_t>(t0 + tt) * R * G;
    float* o = out + static_cast<size_t>(t0 + tt) * B * G;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = g0 + 8 * jn + 2 * t + e;
        if (col >= G) continue;
        float Ar_inv[P][P], Ainv_axy[P], Axx[P][P], axy[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
          Ainv_axy[a] = sh[static_cast<size_t>(O_AINVAXY + a) * G + col];
          axy[a] = sh[static_cast<size_t>(O_AXY + a) * G + col];
#pragma unroll
          for (int b = 0; b < P; ++b) {
            Ar_inv[a][b] = sh[static_cast<size_t>(O_ARINV + a * P + b) * G + col];
            Axx[a][b] = sh[static_cast<size_t>(O_AXX + a * P + b) * G + col];
          }
        }
        const float ayy = sh[static_cast<size_t>(O_AYY) * G + col];
        const float logdetAr = sh[static_cast<size_t>(O_AYY + 1) * G + col];
        const float logdetV = sh[static_cast<size_t>(O_AYY + 2) * G + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = h ? r1 : r0;
          if (b >= B) continue;
          const int reg = 4 * jn + 2 * h + e;
          const float cgg = acc[0][reg], cgy = acc[1 + P + tt][reg];
          float cxg[P];
#pragma unroll
          for (int q = 0; q < P; ++q) cxg[q] = acc[1 + q][reg];
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
          o[static_cast<size_t>(b) * G + col] = bad ? INFINITY : neg;
        }
      }
    }
  }
}

template <int P, int TT, bool ONE>
int launch(const float* Gr, const uint16_t* Ws, const float* YX, const float* SH,
           float* out, int T, int B, int G, int n, int ldg, int ldw, int ldyx,
           float ridge, float nfp, cudaStream_t stream) {
  constexpr int NP = ONE ? 1 : 3;
  constexpr size_t SMEM = size_t(2) * NP * TILE_BYTES + 1024;
  const long long blocks =
      static_cast<long long>((B + BM - 1) / BM) * ((G + BN - 1) / BN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int gpad = (G + BN - 1) / BN * BN;
  const int tpad = (T + TT - 1) / TT * TT;
  const int vec = ldg % 4 == 0 && reinterpret_cast<uintptr_t>(Gr) % 16 == 0;
  dim3 grid(static_cast<unsigned>(blocks), 1, (T + TT - 1) / TT);
  lattice_wgmma<P, TT, ONE><<<grid, THREADS, SMEM, stream>>>(
      Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, gpad, tpad, ridge, nfp, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int P, bool ONE>
int launch_p(const float* Gr, const uint16_t* Ws, const float* YX, const float* SH,
             float* out, int T, int B, int G, int n, int ldg, int ldw, int ldyx,
             float ridge, float nfp, cudaStream_t s) {
  switch (T < 4 ? T : 4) {  // traits per block: all of them, up to 4
    case 1: return launch<P, 1, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 2: return launch<P, 2, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 3: return launch<P, 3, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    default: return launch<P, 4, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
  }
}

template <bool ONE>
int launch_mode(const float* Gr, const uint16_t* Ws, const float* YX, const float* SH,
                float* out, int T, int B, int G, int n, int p, int ldg, int ldw,
                int ldyx, float ridge, float nfp, cudaStream_t s) {
  switch (p) {
    case 1: return launch_p<1, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 2: return launch_p<2, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 3: return launch_p<3, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    case 4: return launch_p<4, ONE>(Gr, Ws, YX, SH, out, T, B, G, n, ldg, ldw, ldyx, ridge, nfp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Gr (B, ldg) f32, the first n lanes of each row used; W the bf16 pieces of
// the grid weights (3, gpad, ldw) from ops/kernels.py:split_w (gpad = G
// rounded up to 32, ldw a multiple of 64 >= n, zero-padded, each 16-sample
// step in split_w's order); YX (tpad + p, ldyx) f32, 16-byte aligned rows,
// zero past n: tpad trait rows (T, then zero rows up to a multiple of
// min(T, 4)), then p covariate rows; SH (T, 2p^2+2p+3, G) f32 contiguous;
// out (T, B, G) f32 contiguous. nfp = n - (p + 1); prec 0 is "highest", 1
// "default". Returns cudaGetLastError() as an int, or cudaErrorInvalidValue
// for p outside 1..4 or a misshapen operand.
extern "C" int jx_grid_lattice(const float* Gr, const void* W, const float* YX,
                               const float* SH, float* out, int T, int B, int G,
                               int n, int p, int ldg, int ldw, int ldyx,
                               float ridge, float nfp, int prec, void* stream) {
  if (T <= 0 || B <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || ldw % BK || ldw < n || ldyx % 4 || ldyx < ldw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* Ws = static_cast<const uint16_t*>(W);
  auto run = prec ? launch_mode<true> : launch_mode<false>;
  return run(Gr, Ws, YX, SH, out, T, B, G, n, p, ldg, ldw, ldyx, ridge, nfp, s);
}
