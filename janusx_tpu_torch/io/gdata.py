"""Core genotype data containers.

Conventions (shared across the whole framework):

- Genotype matrices are **SNP-major**: shape ``(m_snps, n_samples)``
  (reference convention: doc/JanusXcore.md §4.2; SNP-major m x n).
- Dosage values are int8 counts of the ``allele1`` allele: 0, 1, 2;
  missing = -1. After QC packing, allele1 is always the minor allele
  (flip convention: reference src/io/gfreader.rs:1830-1872).
- ``SiteInfo`` columns mirror the reference association TSV prefix:
  chrom, pos, snp, allele0, allele1 (reference src/io/assoc2tsv.rs:45-57).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

MISSING: int = -1


@dataclass
class SiteInfo:
    """Per-SNP metadata arrays (all length m)."""

    chrom: np.ndarray  # object/str array
    pos: np.ndarray  # int64
    snp: np.ndarray  # object/str array (IDs)
    allele0: np.ndarray  # other / major allele
    allele1: np.ndarray  # counted / minor allele

    def __post_init__(self) -> None:
        self.pos = np.asarray(self.pos, dtype=np.int64)
        m = len(self.pos)
        for name in ("chrom", "snp", "allele0", "allele1"):
            arr = np.asarray(getattr(self, name), dtype=object)
            if arr.shape != (m,):
                raise ValueError(f"SiteInfo.{name} length {arr.shape} != {m}")
            setattr(self, name, arr)

    def __len__(self) -> int:
        return len(self.pos)

    def take(self, idx: np.ndarray) -> "SiteInfo":
        return SiteInfo(
            chrom=self.chrom[idx],
            pos=self.pos[idx],
            snp=self.snp[idx],
            allele0=self.allele0[idx],
            allele1=self.allele1[idx],
        )

    def swap_alleles(self, flip: np.ndarray) -> "SiteInfo":
        """Swap allele0/allele1 where ``flip`` is True (minor-allele flip)."""
        a0 = self.allele0.copy()
        a1 = self.allele1.copy()
        a0[flip], a1[flip] = self.allele1[flip], self.allele0[flip]
        return replace(self, allele0=a0, allele1=a1)

    @staticmethod
    def concat(parts: list["SiteInfo"]) -> "SiteInfo":
        return SiteInfo(
            chrom=np.concatenate([p.chrom for p in parts]),
            pos=np.concatenate([p.pos for p in parts]),
            snp=np.concatenate([p.snp for p in parts]),
            allele0=np.concatenate([p.allele0 for p in parts]),
            allele1=np.concatenate([p.allele1 for p in parts]),
        )


@dataclass
class GenotypeData:
    """In-memory SNP-major int8 dosage matrix with metadata.

    This is the lingua franca between file readers and the QC/packing
    stage. Large inputs should go through :func:`iter_genotype_chunks`
    instead of materializing the full matrix.
    """

    genotypes: np.ndarray  # (m, n) int8, -1 missing
    sites: SiteInfo
    samples: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self.genotypes = np.asarray(self.genotypes, dtype=np.int8)
        if self.genotypes.ndim != 2:
            raise ValueError("genotypes must be 2-D (m_snps, n_samples)")
        if len(self.sites) != self.genotypes.shape[0]:
            raise ValueError(
                f"sites ({len(self.sites)}) != genotype rows ({self.genotypes.shape[0]})"
            )
        if self.samples is None:
            self.samples = np.array(
                [str(i) for i in range(self.genotypes.shape[1])], dtype=object
            )
        else:
            self.samples = np.asarray(self.samples, dtype=object)
        if self.samples.shape[0] != self.genotypes.shape[1]:
            raise ValueError("samples length != genotype cols")

    @property
    def m(self) -> int:
        return self.genotypes.shape[0]

    @property
    def n(self) -> int:
        return self.genotypes.shape[1]

    def take_snps(self, idx: np.ndarray) -> "GenotypeData":
        return GenotypeData(self.genotypes[idx], self.sites.take(idx), self.samples)

    def take_samples(self, idx: np.ndarray) -> "GenotypeData":
        return GenotypeData(self.genotypes[:, idx], self.sites, self.samples[idx])
