"""Numeric text / .npy genotype matrix reader (the ``-file`` input mode).

Reference behavior (JanusX src/io/gfcore.rs TxtSnpIter,
doc/JanusXcli.md:42): SNP-major numeric matrix in .txt/.tsv/.csv/.npy,
``{prefix}.id`` sidecar with sample IDs (one per line), optional
``{prefix}.bim`` site sidecar; NA/NaN/NULL/./- tokens = missing (-9
internally); default split on whitespace/comma/semicolon.

Values need not be 0/1/2 — continuous dosages are allowed. When every
value is integral in {0,1,2} (or missing) the int8 dosage path is used;
otherwise a dense float32 matrix is returned for matrix-mode models.
"""

from __future__ import annotations

import os

import numpy as np

from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
from janusx_tpu_torch.io.plink import read_bim

MISSING_F = -9.0


def _default_sites(m: int) -> SiteInfo:
    return SiteInfo(
        chrom=np.array(["N"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"snp{i + 1}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["B"] * m, object),
    )


def _read_id_sidecar(prefix: str, n: int) -> np.ndarray:
    path = prefix + ".id"
    if os.path.exists(path):
        with open(path, "rt") as fh:
            ids = [ln.split()[0] for ln in fh if ln.strip()]
        if len(ids) != n:
            raise ValueError(f"{path}: {len(ids)} ids != {n} matrix columns")
        return np.array(ids, dtype=object)
    return np.array([str(i) for i in range(n)], dtype=object)


def read_txt_matrix(path: str, delimiter: str | None = None):
    """Read a SNP-major numeric matrix. Returns (values f32 (m,n), sites, samples).

    Missing tokens are mapped to -9.0.
    """
    base, ext = os.path.splitext(path)
    if ext == ".npy":
        vals = np.load(path).astype(np.float32)
    else:
        rows = []
        with open(path, "rt") as fh:
            for line in fh:
                if not line.strip():
                    continue
                if delimiter and delimiter != "\\t":
                    toks = [
                        t
                        for t in line.replace(delimiter, " ").split()
                        if t
                    ]
                else:
                    toks = line.replace(",", " ").replace(";", " ").split()
                row = []
                for t in toks:
                    u = t.strip().upper()
                    if u in ("NA", "NAN", "NULL", ".", "-"):
                        row.append(MISSING_F)
                    else:
                        row.append(float(t))
                rows.append(row)
        vals = np.array(rows, dtype=np.float32)
    m, n = vals.shape
    bim_path = base + ".bim"
    sites = read_bim(bim_path) if os.path.exists(bim_path) else _default_sites(m)
    if len(sites) != m:
        raise ValueError(f"{bim_path}: {len(sites)} sites != {m} matrix rows")
    samples = _read_id_sidecar(base, n)
    return vals, sites, samples


def read_txt(path: str, delimiter: str | None = None):
    """Read a text matrix; return GenotypeData if integral 0/1/2, else
    (values, sites, samples) dense tuple."""
    vals, sites, samples = read_txt_matrix(path, delimiter)
    is_missing = (vals == MISSING_F) | ~np.isfinite(vals)
    obs = vals[~is_missing]
    integral = obs.size == 0 or (
        np.all(obs == np.round(obs)) and obs.min() >= 0 and obs.max() <= 2
    )
    if integral:
        geno = np.where(is_missing, np.int8(-1), vals.astype(np.int8))
        return GenotypeData(geno, sites, samples)
    return vals, sites, samples
