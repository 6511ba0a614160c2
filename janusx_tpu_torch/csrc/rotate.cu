// K1 — fused 2-bit decode + rotation: R[M, N] = decode_centered(packed, mean) @ U.
//
// Replaces janusx_tpu/ops/pallas_kernels.py:decode_rotate_planar (kernel body
// _rotate_kernel, tile decode _decode_tile_planar, padding wrapper
// rotate_block_pallas), in its default "highest" (full f32) mode.
//
// What bounds it on the H100: at the scan's shapes (M = 2048 SNP rows per
// block, K = N = n samples ~ 1.4k) it is a dense f32 product of ~2 M K N
// flops against ~M K / 4 packed bytes + K N * 4 bytes of U, so it is bound
// by FP32 arithmetic (no tensor cores in full-f32 mode), not by memory.
//
// Design: a tiled SIMT GEMM. Each 256-thread block owns a 128 x 128 output
// tile and walks the sample axis in chunks of 16. Per chunk, every thread
// decodes two packed bytes (8 samples of one SNP row, natural sample order:
// sample 4b+s sits in bits 2s of byte b) straight into shared memory —
// code 3 (missing/pad) and samples k >= K become exactly 0, otherwise
// code - mean, the reference's f32 arithmetic — so the decoded block never
// exists in device memory. The block also stages a 16 x 128 tile of U.
// Shared memory is double-buffered: the next chunk's bytes and U values
// are loaded into registers while the current chunk is multiplied, so one
// barrier per chunk suffices. Each thread accumulates an 8 x 8 register
// tile with FP32 FMAs (rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j
// and 64 + 4 tx + j), reading its operands as float4 from shared memory.
// Ragged M, N and K are masked in the kernel; nothing is padded on the
// host and no plane-major sample permutation is needed (that existed only
// for a Mosaic layout limit). Each output sums k in ascending order, one
// FMA at a time. The scan launches it once per resident superblock (up to
// ~300k SNP rows at n ~ 1.4k: thousands of blocks), because one 2048-row
// block gives only 16 x 12 = 192 blocks for the card's 132 SMs x 2 slots,
// which leaves a quarter of them idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // SNP rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // samples per chunk (4 packed bytes per row)
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int UL = (BK * BN) / NT;  // U values each thread stages per chunk

// two blocks per SM: capping registers at 128 (from 163) measured faster
// than one block per SM at every M tried on the H100
__global__ void __launch_bounds__(NT, 2)
decode_rotate_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ mean,
                     const float* __restrict__ U,
                     float* __restrict__ out,
                     int M, int K, int N, int ldp, int ldu, int ldo) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;  // rows on x: no 65,535-block limit on M
  const int n0 = blockIdx.y * BN;

  // decode role: SNP row dr of the tile, packed bytes 2 dj and 2 dj + 1 of
  // each chunk (samples 8 dj .. 8 dj + 7 of the chunk)
  const int dr = tid >> 1;
  const int dj = tid & 1;
  const int grow = m0 + dr;
  const bool row_ok = grow < M;
  const float mu = row_ok ? mean[grow] : 0.0f;
  const uint8_t* prow = packed + (size_t)(row_ok ? grow : 0) * ldp;

  uint32_t bytes;     // next chunk's two packed bytes (low = first)
  float ureg[UL];     // next chunk's U values

  auto load = [&](int k0) {
    const int kb = k0 + 8 * dj;  // first sample of this thread's bytes
    const int b0 = (k0 >> 2) + 2 * dj;
    uint32_t lo = 0xFFu, hi = 0xFFu;
    if (row_ok && kb < K) lo = prow[b0];
    if (row_ok && kb + 4 < K) hi = prow[b0 + 1];
    bytes = lo | (hi << 8);
#pragma unroll
    for (int l = 0; l < UL; ++l) {
      const int idx = tid + NT * l;
      const int gk = k0 + idx / BN;
      const int gc = n0 + idx % BN;
      ureg[l] = (gk < K && gc < N) ? U[(size_t)gk * ldu + gc] : 0.0f;
    }
  };
  auto store = [&](int buf, int k0) {
    const int kb = k0 + 8 * dj;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t code = (bytes >> (2 * s)) & 3u;
      As[buf][8 * dj + s][dr] =
          (code == 3u || kb + s >= K) ? 0.0f : (float)code - mu;
    }
#pragma unroll
    for (int l = 0; l < UL; ++l) {
      const int idx = tid + NT * l;
      Bs[buf][idx / BN][idx % BN] = ureg[l];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0, 0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      store(buf ^ 1, k0 + BK);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (c < N) out[(size_t)r * ldo + c] = acc[i][j];
    }
  }
}

}  // namespace

// packed (M, ldp) uint8 with K <= 4 * ldp; mean (M,) f32; U (K, ldu) f32
// with N <= ldu; out (M, ldo) f32. Returns cudaGetLastError() as an int.
extern "C" int jx_decode_rotate(const uint8_t* packed, const float* mean,
                                const float* U, float* out, int M, int K,
                                int N, int ldp, int ldu, int ldo,
                                void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  decode_rotate_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      packed, mean, U, out, M, K, N, ldp, ldu, ldo);
  return (int)cudaGetLastError();
}
