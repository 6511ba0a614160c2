"""Shared GWAS scan infrastructure: result container, block streaming.

All scans follow the same shape: per-trait analysis samples are selected
(phenotype + covariates non-missing), the packed genotypes are re-prepared
on that subset (stats/flip/QC re-evaluated — reference per-trait prepare,
src/io/gfreader.rs:6784), then SNP blocks stream through a jitted device
step and per-SNP statistics come back to the host for p-value finalization
and async TSV writing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.utils import tsv


@dataclass
class ScanResult:
    """Per-SNP association results with the reference TSV column set."""

    sites: SiteInfo
    af: np.ndarray
    miss: np.ndarray
    beta: np.ndarray
    se: np.ndarray
    pwald: np.ndarray
    plrt: np.ndarray | None = None
    lbd: np.ndarray | None = None  # per-SNP lambda (lmm2 output)
    ml: np.ndarray | None = None
    extras: dict = field(default_factory=dict)
    # named extra per-SNP columns appended after the base schema (lm2 /
    # fvlmm2 interaction stats — reference glm2.rs lm2_header)
    extra_cols: dict | None = None

    @property
    def m(self) -> int:
        return len(self.af)

    @property
    def chisq(self) -> np.ndarray:
        ok = np.isfinite(self.beta) & np.isfinite(self.se) & (self.se > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            z2 = (self.beta / self.se) ** 2
        return np.where(ok, z2, np.nan)

    def schema(self) -> str:
        base = tsv.HEADER_BASIC
        if self.lbd is not None:
            base = tsv.HEADER_LMM2
        elif self.plrt is not None:
            base = tsv.HEADER_PLRT
        if self.extra_cols:
            base += "\t" + "\t".join(self.extra_cols)
        return base

    def write_tsv(self, path: str) -> None:
        # header and row layout both come from (lbd, plrt, extra_cols), so
        # any field combination stays column-aligned
        if self.lbd is not None and self.plrt is None:
            raise ValueError("lmm2 columns need plrt alongside lbd/ml")
        with tsv.AsyncTsvWriter(path, self.schema()) as w:
            block = 100_000
            for s in range(0, self.m, block):
                e = min(s + block, self.m)
                idx = np.arange(s, e)
                w.write(
                    tsv.format_assoc_rows(
                        self.sites.take(idx),
                        self.af[s:e],
                        self.miss[s:e],
                        self.beta[s:e],
                        self.se[s:e],
                        self.pwald[s:e],
                        None if self.plrt is None else self.plrt[s:e],
                        None
                        if self.lbd is None
                        else (self.lbd[s:e], self.ml[s:e]),
                        extras=None if not self.extra_cols else [
                            (k, v[s:e]) for k, v in self.extra_cols.items()
                        ],
                    )
                )

    @staticmethod
    def concat(parts: list["ScanResult"]) -> "ScanResult":
        """Concatenate window/superblock partial results in SNP order."""
        first = parts[0]

        def cat(get):
            vals = [get(p) for p in parts]
            return None if vals[0] is None else np.concatenate(vals)

        extra_cols = None
        if first.extra_cols:
            extra_cols = {
                k: np.concatenate([p.extra_cols[k] for p in parts])
                for k in first.extra_cols
            }
        return ScanResult(
            sites=SiteInfo.concat([p.sites for p in parts]),
            af=np.concatenate([p.af for p in parts]),
            miss=np.concatenate([p.miss for p in parts]),
            beta=np.concatenate([p.beta for p in parts]),
            se=np.concatenate([p.se for p in parts]),
            pwald=np.concatenate([p.pwald for p in parts]),
            plrt=cat(lambda p: p.plrt),
            lbd=cat(lambda p: p.lbd),
            ml=cat(lambda p: p.ml),
            extras=first.extras,
            extra_cols=extra_cols,
        )

    def to_dataframe(self):
        import pandas as pd

        d = {
            "chrom": self.sites.chrom,
            "pos": self.sites.pos,
            "snp": self.sites.snp,
            "allele0": self.sites.allele0,
            "allele1": self.sites.allele1,
            "af": self.af,
            "miss": self.miss,
            "beta": self.beta,
            "se": self.se,
            "chisq": self.chisq,
            "pwald": self.pwald,
        }
        if self.lbd is not None:
            d["lambda"] = self.lbd
            d["ml"] = self.ml
        if self.plrt is not None:
            d["plrt"] = self.plrt
        if self.extra_cols:
            d.update(self.extra_cols)
        return pd.DataFrame(d)


def finalize_invalid(beta, se, pwald, ssq, plrt=None, eps: float = 1e-12):
    """Apply the reference invalid-row rule (src/stats/lmm.rs
    fill_invalid_rotated_assoc_row): SNPs whose rotated sum of squares is
    ~0 (monomorphic in the analysis subset) or with non-finite beta/se get
    beta=se=NaN, p=1."""
    bad = ~(np.isfinite(beta) & np.isfinite(se) & (se > 0)) | (ssq <= eps)
    beta = np.where(bad, np.nan, beta)
    se = np.where(bad, np.nan, se)
    pwald = np.where(bad, 1.0, pwald)
    if plrt is not None:
        plrt = np.where(bad, 1.0, plrt)
    return beta, se, pwald, plrt


def analysis_sample_index(
    y: np.ndarray, covariates: np.ndarray | None = None
) -> np.ndarray:
    """Indices of samples usable for a trait: finite phenotype (+covariates)."""
    keep = np.isfinite(np.asarray(y, dtype=np.float64))
    if covariates is not None:
        keep &= np.all(np.isfinite(np.asarray(covariates, np.float64)), axis=1)
    return np.nonzero(keep)[0]


def iter_blocks(m: int, block: int):
    for s in range(0, m, block):
        yield s, min(s + block, m)


def pad_rows(arr: np.ndarray, rows: int, fill=0):
    """Pad the leading axis to exactly ``rows`` (static shapes for jit)."""
    if arr.shape[0] == rows:
        return arr
    pad = np.full((rows - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
