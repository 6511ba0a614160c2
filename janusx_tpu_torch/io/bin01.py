"""BIN01 — the JanusX binary 0/1 matrix interchange format.

Byte-compatible with the reference implementation
(JanusX src/io/bincore.rs:7-32, binwriter.rs, binsidecar.rs:3-8):

.bin payload:
    8  bytes  magic ``JXBIN001``
    8  bytes  u64 LE n_rows
    8  bytes  u64 LE n_samples
    8  bytes  u64 LE reserved (0)
    then n_rows rows of ceil(n_samples/8) bytes, one bit per sample,
    LSB-first within each byte (bincore.rs row_bytes, binwriter.rs:236
    ``row_buf[col >> 3] |= 1 << (col & 7)``).

.bin.site sidecar (two modes, binwriter.rs Bin01SiteMode):
  - "kmer" (legacy k-mer binary): header ``JXBSITE1`` + u64 LE n_sites +
    u64 reserved, then per row u16 LE k-mer length + 2-bit packed k-mer
    (A=0 T=1 C=2 G=3, LSB-first pairs — binwriter.rs:385 encode_kmer_2bit).
  - "tsv": plain ``chrom<TAB>pos<TAB>ref<TAB>alt`` text rows, no header.

Used by the k-mer pipeline (presence/absence genotype matrices) and
GARFIELD binary-feature scans.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

BIN01_MAGIC = b"JXBIN001"
BIN01_HEADER_LEN = 32
SITE_MAGIC = b"JXBSITE1"
SITE_HEADER_LEN = 24

_KMER_CODE = {"A": 0, "T": 1, "C": 2, "G": 3}
_KMER_BASE = np.array(list("ATCG"))


def sidecar_path(bin_path: str) -> str:
    """{prefix}.bin.site (reference bincore.rs:128)."""
    prefix = bin_path[:-4] if bin_path.endswith(".bin") else bin_path
    return prefix + ".bin.site"


def encode_kmer_2bit(seq: str) -> bytes:
    out = np.zeros((len(seq) + 3) // 4, np.uint8)
    for i, ch in enumerate(seq.upper()):
        code = _KMER_CODE.get(ch)
        if code is None:
            raise ValueError(f"unsupported base in k-mer: {ch!r}")
        out[i >> 2] |= code << ((i & 3) * 2)
    return out.tobytes()


def decode_kmer_2bit(buf: bytes, length: int) -> str:
    arr = np.frombuffer(buf, np.uint8)
    idx = np.arange(length)
    codes = (arr[idx >> 2] >> ((idx & 3) * 2)) & 3
    return "".join(_KMER_BASE[codes])


class Bin01Writer:
    """Streaming BIN01 writer; ``site_mode`` in {"none", "kmer", "tsv"}."""

    def __init__(self, path: str, n_samples: int, site_mode: str = "none"):
        if n_samples <= 0:
            raise ValueError("BIN01 writer requires n_samples > 0")
        if site_mode not in ("none", "kmer", "tsv"):
            raise ValueError(f"unknown BIN01 site mode: {site_mode}")
        self.path = path
        self.n_samples = n_samples
        self.row_bytes = (n_samples + 7) // 8
        self.site_mode = site_mode
        self.n_rows = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(path, "wb")
        self._fh.write(BIN01_MAGIC)
        # n_rows (patched at finish), n_samples, reserved
        self._fh.write(np.array([0, n_samples, 0], "<u8").tobytes())
        self._sfh = None
        if site_mode == "kmer":
            self._sfh = open(sidecar_path(path), "wb")
            self._sfh.write(SITE_MAGIC)
            self._sfh.write(np.zeros(2, "<u8").tobytes())
        elif site_mode == "tsv":
            self._sfh = open(sidecar_path(path), "wt")

    def write_rows(self, values: np.ndarray, sites=None) -> int:
        """values: (r, n_samples); bit set where value > 0."""
        values = np.asarray(values)
        if values.ndim != 2 or values.shape[1] != self.n_samples:
            raise ValueError(
                f"BIN01 chunk must be (r, {self.n_samples}), got {values.shape}"
            )
        bits = np.packbits(values > 0, axis=1, bitorder="little")
        return self.write_bitrows(bits, sites)

    def write_bitrows(self, bits: np.ndarray, sites=None) -> int:
        bits = np.ascontiguousarray(bits, np.uint8)
        if bits.ndim != 2 or bits.shape[1] != self.row_bytes:
            raise ValueError(
                f"BIN01 packed chunk must be (r, {self.row_bytes}), got {bits.shape}"
            )
        r = bits.shape[0]
        if self.site_mode != "none":
            if sites is None or len(sites) != r:
                raise ValueError(
                    f"site_mode={self.site_mode} needs one site record per row"
                )
        self._fh.write(bits.tobytes())
        if self.site_mode == "kmer":
            for s in sites:
                kmer = s if isinstance(s, str) else str(s)
                self._sfh.write(np.array(len(kmer), "<u2").tobytes())
                self._sfh.write(encode_kmer_2bit(kmer))
        elif self.site_mode == "tsv":
            for s in sites:
                chrom, pos, ref, alt = s
                self._sfh.write(f"{chrom}\t{pos}\t{ref}\t{alt}\n")
        self.n_rows += r
        return r

    def finish(self) -> int:
        self._fh.seek(8)
        self._fh.write(np.array(self.n_rows, "<u8").tobytes())
        self._fh.close()
        if self._sfh is not None:
            if self.site_mode == "kmer":
                self._sfh.seek(8)
                self._sfh.write(
                    np.array(self.n_rows, "<u8").tobytes()
                )
            self._sfh.close()
        return self.n_rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


@dataclass
class Bin01Matrix:
    """mmap-backed BIN01 reader."""

    path: str
    n_rows: int
    n_samples: int
    bits: np.ndarray  # (n_rows, row_bytes) uint8 memmap

    @property
    def m(self) -> int:
        return self.n_rows

    def dense(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Rows [start, stop) as an int8 0/1 matrix (r, n_samples)."""
        stop = self.n_rows if stop is None else min(stop, self.n_rows)
        chunk = np.unpackbits(
            self.bits[start:stop], axis=1, bitorder="little"
        )[:, : self.n_samples]
        return chunk.astype(np.int8)

    def sites(self):
        """Sidecar site records: list of k-mer strings (kmer mode) or
        (chrom, pos, ref, alt) tuples (tsv mode); None if no sidecar."""
        sp = sidecar_path(self.path)
        if not os.path.exists(sp):
            return None
        with open(sp, "rb") as fh:
            head = fh.read(8)
            if head == SITE_MAGIC:
                n = int(np.frombuffer(fh.read(8), "<u8")[0])
                fh.read(8)
                out = []
                for _ in range(n):
                    ln = int(np.frombuffer(fh.read(2), "<u2")[0])
                    out.append(decode_kmer_2bit(fh.read((ln + 3) // 4), ln))
                return out
        out = []
        with open(sp, "rt") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 4:
                    out.append((parts[0], int(parts[1]), parts[2], parts[3]))
        return out


def write_samples(bin_path: str, samples) -> str:
    """{prefix}.bin.id — one sample ID per line (reference gfreader.py:653
    id-sidecar candidates: .bin.id / .id / .fam)."""
    p = sidecar_path(bin_path).replace(".bin.site", ".bin.id")
    with open(p, "wt") as fh:
        for s in samples:
            fh.write(f"{s}\n")
    return p


def read_samples(bin_path: str, n_samples: int | None = None):
    """Sample IDs from .bin.id / .id / .fam next to the .bin file."""
    prefix = bin_path[:-4] if bin_path.endswith(".bin") else bin_path
    for cand in (prefix + ".bin.id", prefix + ".id"):
        if os.path.exists(cand):
            with open(cand) as fh:
                return np.array([ln.split()[0] for ln in fh if ln.strip()],
                                object)
    if os.path.exists(prefix + ".fam"):
        with open(prefix + ".fam") as fh:
            return np.array([ln.split()[1] for ln in fh if ln.strip()], object)
    if n_samples is not None:
        return np.array([f"s{i}" for i in range(n_samples)], object)
    return None


def read_bin01(path: str) -> Bin01Matrix:
    if not os.path.exists(path) and os.path.exists(path + ".bin"):
        path = path + ".bin"
    size = os.path.getsize(path)
    if size < BIN01_HEADER_LEN:
        raise IOError(f"{path}: BIN file too small")
    with open(path, "rb") as fh:
        head = fh.read(BIN01_HEADER_LEN)
    if head[:8] != BIN01_MAGIC:
        raise IOError(f"{path}: invalid BIN magic (expected JXBIN001)")
    n_rows = int(np.frombuffer(head[8:16], "<u8")[0])
    n_samples = int(np.frombuffer(head[16:24], "<u8")[0])
    if n_samples == 0:
        raise IOError(f"{path}: n_samples is zero")
    row_bytes = (n_samples + 7) // 8
    need = BIN01_HEADER_LEN + n_rows * row_bytes
    if size < need:
        raise IOError(f"{path}: BIN payload truncated (have {size}, need {need})")
    bits = np.memmap(path, np.uint8, mode="r", offset=BIN01_HEADER_LEN,
                     shape=(n_rows, row_bytes))
    return Bin01Matrix(path=path, n_rows=n_rows, n_samples=n_samples, bits=bits)
