"""Operations, bytes and the card's peaks, for the kernels' roofline shares.

Operations are the algorithm's own, counted from the shapes: the same
count whatever implements them and in whatever precision mode (a kernel
that computes its f32 products as three bf16 pieces does three times the
tensor-core work of the count, and its share says so). Bytes count each
input read once and each output written once. The bound is the larger of
operations over the peak rate and bytes over the peak bandwidth.

Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W): 989 TFLOP/s on the
bf16 tensor cores, 3.35 TB/s of HBM3. A card set below 700 W runs below
them; the run prints the card's power limit beside every share.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: max(ops / peak, bytes / bandwidth)."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def packed_bytes(m: int, n: int) -> int:
    """m SNPs of n samples at 2 bits a genotype."""
    return m * -(-n // 4)


def k1(m: int, n: int, N: int) -> tuple[float, float]:
    """K1 decode + rotate: R (m, N) = decode(packed (m, n)) @ U (n, N).
    Reads the packed rows, the means and U; writes R in f32."""
    ops = 2.0 * m * n * N
    nbytes = packed_bytes(m, n) + m * F32 + n * N * F32 + m * N * F32
    return ops, nbytes


def k2(m: int, n: int, G: int, T: int, p: int) -> tuple[float, float]:
    """K2 λ lattice: per SNP the 1 + T + p grams (g∘g, g∘y_t, g∘x_q)
    against the G grid weights over n samples, then the closed form per
    cell. Reads R (m, n), W (G, n), the T + p rows of YX and the shared
    per-λ rows; writes the (T, m, G) lattice."""
    ops = 2.0 * (1 + T + p) * m * G * n
    sh_rows = 2 * p * p + 2 * p + 3
    nbytes = (m * n + G * n + (T + p) * n + T * sh_rows * G + T * m * G) * F32
    return ops, nbytes


def lm_grams(m: int, n: int, p: int, T: int = 1) -> tuple[float, float]:
    """The LM grams of a GRAMMAR scan: per SNP g'M y (T of them), g'X (p)
    and g'g over n samples from the packed panel, read once; writes two
    f64 values per SNP and trait."""
    ops = 2.0 * n * m * (p + 1 + T)
    nbytes = packed_bytes(m, n) + m * F32 + 2 * m * T * 8
    return ops, nbytes


def share_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """100 x bound / measured time; None when nothing was measured."""
    if seconds <= 0:
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds
