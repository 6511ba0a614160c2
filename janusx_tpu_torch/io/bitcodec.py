"""2-bit genotype codec (host side, vectorized numpy).

Internal packed format: one uint8 per 4 samples, sample ``j`` of a row in
bits ``2*(j % 4)`` (little-endian within the byte, same bit order as PLINK
BED). 2-bit code values are **dosage codes**:

    0, 1, 2 = count of allele1;  3 = missing.

This differs deliberately from PLINK's BED encoding (00=hom A1, 01=missing,
10=het, 11=hom A2 — reference decode LUT src/math/bedmath.rs): dosage codes
make the on-device decode a pure compare+subtract, and byte-level LUTs
translate BED→dosage and apply minor-allele flips without ever unpacking.

Tail padding: rows whose sample count is not a multiple of 4 pad the final
byte with code 3 (missing). Downstream device kernels impute missing to the
per-SNP mean, so padded lanes contribute exactly zero to centered sums —
this is the pad-and-mask convention used by every kernel in the framework.
"""

from __future__ import annotations

import numpy as np

CODE_MISSING = 3

_WEIGHTS = np.array([1, 4, 16, 64], dtype=np.uint8)


def _byte_codes() -> np.ndarray:
    """(256, 4) uint8: the four 2-bit codes of each byte value."""
    b = np.arange(256, dtype=np.uint16)
    return np.stack([(b >> (2 * k)) & 3 for k in range(4)], axis=1).astype(np.uint8)


_BYTE_CODES = _byte_codes()


def byte_lut(code_map: np.ndarray) -> np.ndarray:
    """Build a 256-entry byte translation LUT from a 4-entry 2-bit code map."""
    code_map = np.asarray(code_map, dtype=np.uint8)
    mapped = code_map[_BYTE_CODES]  # (256, 4)
    return (mapped.astype(np.uint16) @ _WEIGHTS.astype(np.uint16)).astype(np.uint8)


# PLINK BED 2-bit values -> dosage codes: 00->2 (hom A1), 01->3 (missing),
# 10->1 (het), 11->0 (hom A2).
BED_TO_DOSAGE_LUT = byte_lut(np.array([2, 3, 1, 0], dtype=np.uint8))
# Dosage codes -> PLINK BED values (inverse map).
DOSAGE_TO_BED_LUT = byte_lut(np.array([3, 2, 0, 1], dtype=np.uint8))
# Minor-allele flip on dosage codes: 0<->2, 1->1, 3->3.
FLIP_LUT = byte_lut(np.array([2, 1, 0, 3], dtype=np.uint8))

# (256, 4) per-byte count of each code value — for packed stats.
_CODE_ONEHOT = np.eye(4, dtype=np.int32)[_BYTE_CODES].sum(axis=1)  # (256, 4)
_CODE_ONEHOT_U8 = _CODE_ONEHOT.astype(np.uint8)


def n_bytes(n_samples: int) -> int:
    return (n_samples + 3) // 4


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack (m, n) uint8 2-bit codes into (m, ceil(n/4)) bytes.

    Tail positions are padded with code 3 (missing).
    """
    codes = np.asarray(codes)
    if codes.ndim == 1:
        return pack_codes(codes[None, :])[0]
    m, n = codes.shape
    nb = n_bytes(n)
    if n % 4:
        pad = np.full((m, nb * 4 - n), CODE_MISSING, dtype=np.uint8)
        codes = np.concatenate([codes.astype(np.uint8), pad], axis=1)
    else:
        codes = codes.astype(np.uint8)
    quads = codes.reshape(m, nb, 4).astype(np.uint16)
    return (quads @ _WEIGHTS.astype(np.uint16)).astype(np.uint8)


def unpack_codes(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """Unpack (m, nb) bytes into (m, n_samples) uint8 codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    if packed.ndim == 1:
        return unpack_codes(packed[None, :], n_samples)[0]
    m = packed.shape[0]
    codes = _BYTE_CODES[packed]  # (m, nb, 4)
    return codes.reshape(m, -1)[:, :n_samples]


def translate(packed: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply a byte LUT to packed data (e.g. BED→dosage, flip)."""
    return lut[packed]


def mask_tail(packed: np.ndarray, n_samples: int,
              copy: bool = True) -> np.ndarray:
    """Force tail-padding positions of the last byte to code 3 (missing).

    Needed after reading PLINK BED, whose pad bits decode to hom-A1.
    Operates in place on a copy and returns it; ``copy=False`` mutates
    the input (use when the caller owns a freshly-allocated buffer —
    e.g. a translate() output — to skip a full-window memcpy on every
    streaming read)."""
    packed = np.asarray(packed, dtype=np.uint8)
    if copy:
        packed = packed.copy()
    rem = n_samples % 4
    if rem == 0 or packed.shape[-1] == 0:
        return packed
    keep_mask = np.uint8((1 << (2 * rem)) - 1)
    pad_bits = np.uint8(0xFF & ~keep_mask)
    packed[..., -1] = (packed[..., -1] & keep_mask) | pad_bits
    return packed


def flip_rows(packed: np.ndarray, flip: np.ndarray) -> np.ndarray:
    """Flip dosage codes (0<->2) for the rows where ``flip`` is True."""
    out = packed.copy()
    out[flip] = FLIP_LUT[packed[flip]]
    return out


def packed_code_counts(packed: np.ndarray) -> np.ndarray:
    """Per-row counts of each code value: (m, 4) int64.

    Assumes tail padding is code 3; subtract the pad count from column 3
    yourself if you need exact missing counts (see :func:`row_stats`).

    One (m, nb) uint8 LUT pass per code — the naive (m, nb, 4) int32
    one-hot gather costs 16x the packed size in transient RAM (10+ GB at
    biobank windows) and is what the windowed low-memory path must avoid.
    """
    out = np.empty((packed.shape[0], 4), np.int64)
    for c in range(4):
        out[:, c] = _CODE_ONEHOT_U8[:, c][packed].sum(axis=1, dtype=np.int64)
    return out


def subset_columns(
    packed: np.ndarray, n_samples: int, sample_idx: np.ndarray, chunk: int = 16384
) -> np.ndarray:
    """Select sample columns from packed rows; returns re-packed codes.

    Equivalent of the reference's SampleSubsetPlan collapse
    (src/math/bedmath.rs SubsetDecodePlan): unpack -> gather -> repack,
    chunked over SNP rows to bound memory.
    """
    sample_idx = np.asarray(sample_idx)
    m = packed.shape[0]
    out = np.empty((m, n_bytes(len(sample_idx))), dtype=np.uint8)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        codes = unpack_codes(packed[s:e], n_samples)[:, sample_idx]
        out[s:e] = pack_codes(codes)
    return out


def row_stats(packed: np.ndarray, n_samples: int):
    """Per-SNP (non_missing, alt_sum, het_count) from packed dosage codes."""
    c = packed_code_counts(packed)
    pad = n_bytes(n_samples) * 4 - n_samples
    missing = c[:, 3] - pad
    non_missing = n_samples - missing
    alt_sum = c[:, 1] + 2 * c[:, 2]
    het = c[:, 1]
    return non_missing, alt_sum, het
