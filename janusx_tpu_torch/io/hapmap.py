"""HapMap (.hmp.txt / .hmp.txt.gz) reader.

Replaces the reference's ``HmpSnpIter``/``HmpChunkReader``
(JanusX src/io/gfcore.rs). HapMap layout: 11 metadata columns
(rs#, alleles, chrom, pos, strand, assembly#, center, protLSID, assayLSID,
panelLSID, QCcode) then one two-letter diploid genotype per sample
(e.g. AA, AG; NN or -- = missing; single IUPAC letters accepted for
homozygote/het codes).

Dosage = count of the second allele of the ``alleles`` column (alt), so the
downstream flip convention matches the VCF path.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo

_IUPAC_HET = {
    "R": ("A", "G"),
    "Y": ("C", "T"),
    "S": ("G", "C"),
    "W": ("A", "T"),
    "K": ("G", "T"),
    "M": ("A", "C"),
}

N_META = 11


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _site_alleles(allele_field: str):
    parts = allele_field.replace("/", " ").replace(",", " ").split()
    if len(parts) >= 2:
        return parts[0].upper(), parts[1].upper()
    if len(parts) == 1 and len(parts[0]) == 2:
        return parts[0][0].upper(), parts[0][1].upper()
    return "N", "N"


def _parse_cell(cell: str, ref: str, alt: str) -> int:
    cell = cell.strip().upper()
    if not cell or cell in ("NN", "--", "..", "N", "-", "."):
        return -1
    if len(cell) == 1:
        if cell in _IUPAC_HET:
            pair = _IUPAC_HET[cell]
            if ref in pair and alt in pair:
                return 1
            return -1
        cell = cell + cell
    d = 0
    for ch in cell[:2]:
        if ch == alt:
            d += 1
        elif ch != ref:
            return -1
    return d


def iter_hapmap_chunks(path: str, chunk_snps: int = 4096) -> Iterator[GenotypeData]:
    with _open_text(path) as fh:
        header = fh.readline().rstrip("\n")
        cols = header.split("\t") if "\t" in header else header.split()
        samples = np.array(cols[N_META:], dtype=object)
        n = len(samples)

        def parse(buf: list[str]) -> GenotypeData:
            m = len(buf)
            geno = np.empty((m, n), dtype=np.int8)
            chrom = np.empty(m, object)
            pos = np.empty(m, np.int64)
            snp = np.empty(m, object)
            a0 = np.empty(m, object)
            a1 = np.empty(m, object)
            for i, line in enumerate(buf):
                f = line.rstrip("\n").split("\t") if "\t" in line else line.split()
                if len(f) < N_META + n:
                    raise ValueError(
                        f"malformed HapMap row in {path}: expected "
                        f"{N_META + n} columns ({n} samples), got {len(f)} "
                        f"(row starts {line[:60]!r})"
                    )
                snp[i] = f[0]
                ref, alt = _site_alleles(f[1])
                a0[i], a1[i] = ref, alt
                chrom[i] = f[2]
                try:
                    pos[i] = int(f[3])
                except ValueError:
                    raise ValueError(
                        f"malformed HapMap row in {path}: non-integer pos "
                        f"{f[3]!r} at variant {f[0]!r}"
                    ) from None
                row = geno[i]
                for j in range(n):
                    row[j] = _parse_cell(f[N_META + j], ref, alt)
            return GenotypeData(
                geno, SiteInfo(chrom, pos, snp, a0, a1), samples
            )

        buf: list[str] = []
        for line in fh:
            if not line.strip():
                continue
            buf.append(line)
            if len(buf) >= chunk_snps:
                yield parse(buf)
                buf = []
        if buf:
            yield parse(buf)


def read_hapmap(path: str) -> GenotypeData:
    chunks = list(iter_hapmap_chunks(path))
    if not chunks:
        raise ValueError(f"no variant rows in HapMap file: {path}")
    return GenotypeData(
        np.concatenate([c.genotypes for c in chunks], axis=0),
        SiteInfo.concat([c.sites for c in chunks]),
        chunks[0].samples,
    )
