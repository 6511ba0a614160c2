// K1 — fused 2-bit decode + rotation: R[M, N] = decode_centered(packed, mean) @ U
// on Hopper's tensor cores (wgmma, bf16 operands, f32 accumulators).
//
// Replaces janusx_tpu/ops/pallas_kernels.py:decode_rotate_planar (kernel body
// _rotate_kernel, tile decode _decode_tile_planar, padding wrapper
// rotate_block_pallas), in both of its modes.
//
// What bounds it on the H100: at the scan's shapes (M ~ 300k SNP rows per
// launch, K = N = n samples ~ 1.4k) it is a dense product of 2 M K N flops
// against ~M K / 4 packed bytes, far above the card's ridge point, so it is
// bound by arithmetic. In f32 that is the 67 TFLOP/s SIMT pipe (cuBLAS SGEMM,
// the plain version, lives there too); the tensor cores give 989 TFLOP/s in
// bf16, so the design moves the product there without losing f32 accuracy.
//
// The two modes, each the same algorithm as its plain version
// (ops/kernels.py):
// - "highest": R = D U - diag(mean) (V U), with D in {0, 1, 2} the dosage
//   (code 3, missing or pad, -> 0) and V in {0, 1} the valid-sample mask.
//   D and V are exact in bf16, U = U0 + U1 + U2 is split into three bf16
//   pieces once per basis (ops/kernels.py:split_u; the split is exact), and
//   every bf16 x bf16 product is exact in the f32 accumulator: six passes,
//   the counterpart of the TPU's multi-pass Precision.HIGHEST.
// - "high": the reference's bf16x3 of the centered value a = code - mean:
//   a_hi U0 + a_hi U1 + a_lo U0, with a_hi = bf16(a), a_lo = bf16(a - a_hi):
//   three passes into one accumulator.
//
// Design: one 512-thread block owns a 192 x 64 output tile (row and column
// tiles on grid x, no 65,535 limit). Warpgroup 3 is the producer
// (setmaxnreg gives its registers to the consumers): one lane streams the U
// pieces' 64-sample x 64-column tiles, K-major in the 128-byte swizzle, into
// a 4-stage shared-memory ring by TMA, each stage guarded by a "full" and an
// "empty" mbarrier. Warpgroups 0-2 are consumers of 64 rows each. A consumer
// thread holds its two rows' packed bytes for the next 64 samples in
// registers (one 16-byte load per row: the wrapper pads rows to 16 bytes)
// and decodes each 16-sample step straight into wgmma's A-fragment
// registers: a 2-bit code pair picks a bf16 pair out of a 4-entry table by
// one byte permute (prmt), so the decoded block never exists in memory.
// Tables: D and V in "highest"; a_hi and a_lo per row in "high". Per stage
// a warpgroup issues the mode's passes for its four 16-sample steps as
// m64n64k16 wgmmas (A in registers, B from the ring) in one commit group,
// into tile accumulators that start from zero; when they are done it frees
// the stage and adds the tile into its f32 accumulator on the FP32 pipe
// (acc_D - mean * acc_V in "highest"). While one warpgroup waits, decodes
// and promotes, the other two keep the tensor cores busy: with two consumer
// warpgroups the kernel took 12.3 ms at the main path's shape, with three
// 10.6 ms, and 10.4 ms once blocks that run together share their packed
// rows in L2 (H100, "highest"). In the two-warpgroup version, removing the
// decode or the promotion moved neither. The rest of the gap to the bf16
// peak (the passes run at ~70 % of it) is outside both; candidates are the
// short m64n64k16 wgmmas fed from registers and each block's pipeline fill.

// The per-stage promotion is what keeps f32 accuracy: with the tensor
// cores' running sum over all of K the kernel was 7.8e-4 from the f32 plain
// version at n = 1,410, |U| ~ 1; promoted per stage it is 6.6e-5 from the
// f64 product, where the plain version is 3.0e-4 (measured on an H100).
// Three 32-register accumulators per thread (acc, tile D, tile V) fit
// beside the fragments in 160 registers; a 128-column tile would need 192.
// The epilogue stores f32 with ragged M and N masked; samples k >= K meet
// U's zero pad.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int CWG = 3;       // consumer warpgroups, 64 SNP rows each
constexpr int BM = 64 * CWG; // SNP rows per block
constexpr int BN = 64;       // output columns per block (the wgmma n)
constexpr int BK = 64;       // samples per stage: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 4;    // shared-memory ring depth
constexpr int CONSUMERS = 128 * CWG;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
// registers per thread, set by setmaxnreg: the producer gives up what the
// consumers take (3 x 128 x 160 + 128 x 24 <= 65,536)
constexpr int CONSUMER_REGS = 160;
constexpr int PRODUCER_REGS = 24;

// per mode: U pieces per stage
template <bool HIGH> struct Mode {
  static constexpr int NP = HIGH ? 2 : 3;
  static constexpr int TILE_BYTES = BN * BK * 2;  // one piece, one stage
  static constexpr size_t SMEM = size_t(STAGES) * NP * TILE_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
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
__device__ __forceinline__ void keep(uint64_t& x) {
  asm volatile("" : "+l"(x) :: "memory");
}

// B descriptor: K-major tile of BN rows x 128 bytes in the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32 per warpgroup) = a (64 x 16 bf16, registers) * b (16 x 64)
// + (scale ? d : 0)
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t b,
                                    int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// 16 packed bytes (64 samples) of one row from byte kb0 (rows are a
// multiple of 16 bytes long, ops/kernels.py pads them); rows past M read
// as 0xFF (code 3 -> 0)
__device__ __forceinline__ uint4 load_row16(const uint8_t* row, bool ok, int kb0) {
  if (!ok) return make_uint4(~0u, ~0u, ~0u, ~0u);
  return __ldg(reinterpret_cast<const uint4*>(row + kb0));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// byte-permute selectors for the code pairs of A-fragment registers 0 (low
// half) and 2 (high half): with 16 samples in the 32-bit word w (sample s in
// bits 2s), thread t of a quad owns samples 2t, 2t+1 (bits 4t) and 2t+8,
// 2t+9 (bits 16 + 4t); a pair (c0, c1) selects bytes 2c0, 2c0+1, 2c1, 2c1+1
// of a table whose bf16 entry for code c sits at bytes 2c, 2c+1
__device__ __forceinline__ uint32_t selectors(uint32_t w, int t) {
  const uint32_t y = (w >> (4 * t)) & 0x000F000Fu;
  const uint32_t z = (y & 0x00030003u) | ((y & 0x000C000Cu) << 6);
  return z * 0x22u + 0x10101010u;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// "high" tables of one row: a(c) = c - mean for c < 3, a(3) = 0, split
// a_hi = bf16(a), a_lo = bf16(a - a_hi); (lo word: codes 0, 1; hi: 2, 3)
__device__ __forceinline__ void high_tables(float mu, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  uint32_t h[3], l[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = static_cast<float>(c) - mu;
    h[c] = bf16_bits(a);
    l[c] = bf16_bits(a - __bfloat162float(__ushort_as_bfloat16(
                             static_cast<unsigned short>(h[c]))));
  }
  hi[0] = h[0] | (h[1] << 16);
  hi[1] = h[2];
  lo[0] = l[0] | (l[1] << 16);
  lo[1] = l[2];
}

template <bool HIGH>
__global__ void __launch_bounds__(THREADS, 1)
decode_rotate_wgmma(const __grid_constant__ CUtensorMap umap,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ mean, float* __restrict__ out,
                    int M, int K, int N, int ldp, int npad, int ldo, int vec2) {
  using C = Mode<HIGH>;
  constexpr int NA = BN / 2;  // accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const int tid = threadIdx.x;
  const int KT = (K + BK - 1) / BK;
  // blocks in launch order walk a row tile's column tiles first, so blocks
  // that run together share the packed rows in L2 (U's pieces fit in L2)
  const int col_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWG);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warpgroup: one lane drives TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::NP * C::TILE_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load_2d(ring + (s * C::NP + p) * C::TILE_BYTES, &umap, &full[s],
                      kt * BK, p * npad + n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));

  // consumer: warpgroup wg, warp w of it, lane = 4 g + t; rows r0 and r0 + 8
  const int wg = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = m0 + 64 * wg + 16 * w + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < M, ok1 = r1 < M;
  const float mu0 = ok0 ? mean[r0] : 0.0f;
  const float mu1 = ok1 ? mean[r1] : 0.0f;
  const uint8_t* p0 = packed + static_cast<size_t>(ok0 ? r0 : 0) * ldp;
  const uint8_t* p1 = packed + static_cast<size_t>(ok1 ? r1 : 0) * ldp;

  // tables of the two A operands X and Y, for rows r0 and r1
  uint32_t x0[2], x1[2], y0[2], y1[2];
  if (HIGH) {
    high_tables(mu0, x0, y0);
    high_tables(mu1, x1, y1);
  } else {
    // D: 0, 1, 2, 0 and V: 1, 1, 1, 0 in bf16
    x0[0] = x1[0] = 0x3F800000u;
    x0[1] = x1[1] = 0x00004000u;
    y0[0] = y1[0] = 0x3F803F80u;
    y0[1] = y1[1] = 0x00003F80u;
  }

  // The tensor cores sum each stage (64 samples) into tile accumulators,
  // from zero; the f32 pipe then adds the stage into acc with round-to-
  // nearest. Summing all of K in the tensor cores' accumulator alone loses
  // ~1e-3 absolute at n ~ 1.4k and |U| ~ 1 (measured): each wgmma's
  // addition into a large running sum truncates.
  float acc[NA], tx[NA], ty[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = tx[i] = ty[i] = 0.0f;
  uint32_t fr[4][8];  // a stage's A fragments: X regs 0-3, Y regs 4-7

  uint4 n_0 = load_row16(p0, ok0, 0);
  uint4 n_1 = load_row16(p1, ok1, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    const uint4 c_0 = n_0, c_1 = n_1;
    if (kt + 1 < KT) {
      n_0 = load_row16(p0, ok0, (kt + 1) * 16);
      n_1 = load_row16(p1, ok1, (kt + 1) * 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t s0 = selectors(word(c_0, j), t);
      const uint32_t s1 = selectors(word(c_1, j), t);
      fr[j][0] = __byte_perm(x0[0], x0[1], s0);
      fr[j][1] = __byte_perm(x1[0], x1[1], s1);
      fr[j][2] = __byte_perm(x0[0], x0[1], s0 >> 16);
      fr[j][3] = __byte_perm(x1[0], x1[1], s1 >> 16);
      fr[j][4] = __byte_perm(y0[0], y0[1], s0);
      fr[j][5] = __byte_perm(y1[0], y1[1], s1);
      fr[j][6] = __byte_perm(y0[0], y0[1], s0 >> 16);
      fr[j][7] = __byte_perm(y1[0], y1[1], s1 >> 16);
    }
    mbar_wait(&full[s], (kt / STAGES) & 1);
    // every wgmma input is in registers before the fence, so ptxas can keep
    // the stage's wgmmas in flight together
    const uint32_t base = smem_u32(ring + s * C::NP * C::TILE_BYTES);
    uint64_t bd[4][C::NP];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        bd[j][p] = b_desc(base + p * C::TILE_BYTES + 32 * j);
        keep(bd[j][p]);
      }
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sc = j > 0;  // the stage's first pass starts from zero
      if (HIGH) {
        mma(tx, fr[j], bd[j][0], sc);     // a_hi U0
        mma(tx, fr[j], bd[j][1], 1);      // a_hi U1
        mma(tx, fr[j] + 4, bd[j][0], 1);  // a_lo U0
      } else {
        mma(tx, fr[j], bd[j][0], sc);     // D U0
        mma(tx, fr[j], bd[j][1], 1);      // D U1
        mma(tx, fr[j], bd[j][2], 1);      // D U2
        mma(ty, fr[j] + 4, bd[j][0], sc); // V U0
        mma(ty, fr[j] + 4, bd[j][1], 1);  // V U1
        mma(ty, fr[j] + 4, bd[j][2], 1);  // V U2
      }
    }
    wg_commit();
    wg_wait<0>();
    // the wgmmas read fr and write tx, ty asynchronously: the compiler may
    // reuse or read those registers only from here on
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) keep(fr[j][i]);
    if ((tid & 127) == 0) mbar_arrive(&empty[s]);  // the stage is read
    // register 4 jn + 2 h + e holds row r0 (h = 0) or r1 (h = 1)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      keep(tx[i]);
      if (HIGH) {
        acc[i] += tx[i];
      } else {
        keep(ty[i]);
        acc[i] += tx[i] - ((i & 2) ? mu1 : mu0) * ty[i];
      }
    }
  }

  // accumulator layout: register 4 jn + 2 h + e holds row 16 w + g + 8 h,
  // column 8 jn + 2 t + e of the warpgroup's 64 x BN tile
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = n0 + 8 * jn + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? r1 : r0;
      if (row >= M) continue;
      const float v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
      float* o = out + static_cast<size_t>(row) * ldo + col;
      if (vec2 && col + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (col < N) o[0] = v0;
        if (col + 1 < N) o[1] = v1;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder (cuTensorMapEncodeTiled), from the loaded libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <bool HIGH>
int launch(EncodeTiled encode, const uint8_t* packed, const float* mean,
           const void* usplit, float* out, int M, int K, int N, int ldp,
           int npad, int kpad, int ldo, int vec2, cudaStream_t stream) {
  using C = Mode<HIGH>;
  // the pieces as one (3 npad, kpad) bf16 matrix; a box is one stage's tile
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad),
                              static_cast<cuuint64_t>(3) * npad};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad) * 2};
  const cuuint32_t box[2] = {BK, BN};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(usplit), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  auto kernel = decode_rotate_wgmma<HIGH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // one grid axis: rows (M + BM - 1) / BM times column tiles; SNP rows have
  // no 65,535 limit
  const long long blocks =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks));
  kernel<<<grid, THREADS, C::SMEM, stream>>>(map, packed, mean, out, M, K, N,
                                             ldp, npad, ldo, vec2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed (M, ldp) uint8, 16-byte aligned, ldp a multiple of 16, K <= 4 ldp;
// mean (M,) f32; usplit (3, npad, kpad) bf16, the pieces of U transposed
// to K-major and zero-padded (ops/kernels.py:split_u; npad and kpad
// multiples of 64, kpad >= K, npad >= N); out (M, ldo) f32; high = 0 for
// "highest", 1 for "high".
// Returns cudaGetLastError() as an int, or -1 when libcuda's tensor-map
// encoder is missing and -(1000 + CUresult) when it refuses the map.
extern "C" int jx_decode_rotate(const uint8_t* packed, const float* mean,
                                const void* usplit, float* out, int M, int K,
                                int N, int ldp, int npad, int kpad, int ldo,
                                int high, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const EncodeTiled encode = encode_tiled();
  if (!encode) return -1;
  const int vec2 = ldo % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = high ? launch<true> : launch<false>;
  return run(encode, packed, mean, usplit, out, M, K, N, ldp, npad, kpad, ldo,
             vec2, s);
}
