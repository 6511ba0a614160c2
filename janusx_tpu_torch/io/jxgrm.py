"""`.jxgrm` sparse-GRM CSC file format (read/write/mmap).

Byte-compatible with the reference format so sparse GRMs interchange
between toolchains (JanusX src/stats/spgrm.rs:3745
``write_sparse_grm_csc`` + JanusX src/math/cholesky.rs:255-345
mmap validation):

    bytes  0..8    u64 LE  n_samples
    bytes  8..16   u64 LE  nnz
    next           (n_samples+1) x u64 LE   col_ptr
    next           nnz x u32 LE             row_indices  (LOWER triangle,
                                             row >= col within each column)
    next           zero padding to the next 8-byte boundary ("padded"
                   layout; the unpadded "legacy" layout is also accepted
                   on read, cholesky.rs:305-320)
    next           nnz x f64 LE             values

Only the lower triangle (incl. the diagonal) is stored; :func:`read_jxgrm`
returns the symmetrized full matrix by default.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse

HEADER_BYTES = 16
VALUES_ALIGN = 8


def write_jxgrm(path: str, K: scipy.sparse.spmatrix) -> None:
    """Write a symmetric sparse kinship as a lower-triangle `.jxgrm` CSC.

    ``K`` may be the full symmetric matrix or already lower-triangular;
    the upper triangle is dropped either way.
    """
    L = scipy.sparse.tril(K, format="csc")
    L.sort_indices()
    n = L.shape[0]
    if L.shape[0] != L.shape[1]:
        raise ValueError(f"kinship must be square, got {L.shape}")
    nnz = L.nnz
    col_ptr = L.indptr.astype("<u8")
    row_idx = L.indices.astype("<u4")
    values = L.data.astype("<f8")
    row_bytes = nnz * 4
    pad = (-row_bytes) % VALUES_ALIGN
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        # explicit little-endian like the body arrays (np.uint64 is
        # native-endian and would corrupt the header on BE hosts)
        fh.write(np.array([n, nnz], "<u8").tobytes())
        fh.write(col_ptr.tobytes())
        fh.write(row_idx.tobytes())
        if pad:
            fh.write(b"\x00" * pad)
        fh.write(values.tobytes())
    os.replace(tmp, path)


def jxgrm_n_samples(path: str) -> int:
    """n_samples from the header only (cholesky.rs:370)."""
    with open(path, "rb") as fh:
        hdr = fh.read(HEADER_BYTES)
    if len(hdr) < HEADER_BYTES:
        raise ValueError(f"{path}: too short for a .jxgrm header")
    return int(np.frombuffer(hdr, "<u8", count=1)[0])


def read_jxgrm(
    path: str, symmetrize: bool = True, mmap: bool = True
) -> scipy.sparse.csc_matrix:
    """Read a `.jxgrm` file into a scipy CSC matrix.

    Accepts both the padded and the legacy (unpadded) value layouts, with
    the same file-size validation as the reference mmap reader
    (cholesky.rs:283-325).
    """
    size = os.path.getsize(path)
    if size < HEADER_BYTES:
        raise ValueError(f"{path}: too short for a .jxgrm header")
    buf = np.memmap(path, dtype=np.uint8, mode="r") if mmap else np.fromfile(
        path, dtype=np.uint8
    )
    n = int(np.frombuffer(buf[:8], "<u8")[0])
    nnz = int(np.frombuffer(buf[8:16], "<u8")[0])
    col_ptr_off = HEADER_BYTES
    col_ptr_bytes = (n + 1) * 8
    row_off = col_ptr_off + col_ptr_bytes
    row_bytes = nnz * 4
    val_off_legacy = row_off + row_bytes
    val_off_padded = val_off_legacy + ((-val_off_legacy) % VALUES_ALIGN)
    val_bytes = nnz * 8
    if size == val_off_padded + val_bytes:
        val_off = val_off_padded
    elif size == val_off_legacy + val_bytes:
        val_off = val_off_legacy
    else:
        raise ValueError(
            f"{path}: size {size} matches neither legacy "
            f"({val_off_legacy + val_bytes}) nor padded "
            f"({val_off_padded + val_bytes}) .jxgrm layout"
        )
    col_ptr = np.frombuffer(buf[col_ptr_off:row_off].tobytes(), "<u8").astype(np.int64)
    row_idx = np.frombuffer(
        buf[row_off:row_off + row_bytes].tobytes(), "<u4"
    ).astype(np.int32)
    values = np.frombuffer(
        buf[val_off:val_off + val_bytes].tobytes(), "<f8"
    ).astype(np.float64)
    if col_ptr[-1] != nnz:
        raise ValueError(f"{path}: col_ptr[-1]={col_ptr[-1]} != nnz={nnz}")
    # scipy.sparse.csc_matrix does NOT validate indices on construction —
    # a corrupted file with out-of-range row indices or a non-monotonic
    # col_ptr would segfault inside scipy's C kernels on first use
    # (fuzz-found). Validate the CSC structure explicitly first.
    if col_ptr[0] != 0:
        raise ValueError(f"{path}: corrupt col_ptr (col_ptr[0]={col_ptr[0]})")
    if (np.diff(col_ptr) < 0).any():
        raise ValueError(f"{path}: corrupt col_ptr (non-monotonic)")
    if nnz and (row_idx.min() < 0 or row_idx.max() >= n):
        raise ValueError(
            f"{path}: corrupt row indices (range "
            f"[{row_idx.min()}, {row_idx.max()}] outside [0, {n}))"
        )
    L = scipy.sparse.csc_matrix((values, row_idx, col_ptr), shape=(n, n))
    if not symmetrize:
        return L
    D = scipy.sparse.diags(L.diagonal())
    return (L + L.T - D).tocsc()
