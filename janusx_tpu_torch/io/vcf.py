"""VCF reader: streaming parse into SNP-major int8 dosage chunks.

Replaces the reference's ``VcfSnpIter``/``VcfChunkReader``
(JanusX src/io/gfcore.rs, gfreader.rs). Pure Python + numpy here;
the hot loop is a per-line GT-prefix dict lookup, which is fast enough to
feed QC/packing for ~10^5-10^6 site files; a C extension hook can replace
``_parse_lines`` without API change.

Genotype encoding: count of ALT alleles (0/1/2), missing -1. Multi-allelic
sites (ALT containing ','): genotypes referring to allele indices > 1 are
treated as missing; the site is kept with the first ALT allele, matching
biallelic-effective behavior. Haploid calls follow the PLINK convention:
'1' codes as dosage 2 (hemizygous ALT counted like hom-diploid), '0' as 0
— allele frequencies on haploid data inherit PLINK's inflation semantics.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo

# GT prefix -> dosage code. Covers phased/unphased diploid and haploid calls.
_GT_MAP: dict[str, int] = {}
for _a in "01.":
    for _b in "01.":
        for _sep in "/|":
            key = _a + _sep + _b
            if _a == "." or _b == ".":
                _GT_MAP[key] = -1
            else:
                _GT_MAP[key] = int(_a) + int(_b)
# haploid
_GT_MAP["0"] = 0
_GT_MAP["1"] = 2
_GT_MAP["."] = -1


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_vcf_samples(path: str) -> np.ndarray:
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\r\n").split("\t")
                return np.array(cols[9:], dtype=object)
            break
    raise ValueError(f"no #CHROM header line found in {path}")


def _parse_lines(lines: list[str], n_samples: int):
    m = len(lines)
    geno = np.empty((m, n_samples), dtype=np.int8)
    chrom = np.empty(m, dtype=object)
    pos = np.empty(m, dtype=np.int64)
    snp = np.empty(m, dtype=object)
    a0 = np.empty(m, dtype=object)
    a1 = np.empty(m, dtype=object)
    gt_map = _GT_MAP
    for i, line in enumerate(lines):
        fields = line.rstrip("\n").split("\t")
        if len(fields) != 9 + n_samples:
            # a ragged line must be a LOUD error: np.empty rows would
            # otherwise keep uninitialized garbage dosages for the
            # missing trailing samples (silent data corruption)
            raise ValueError(
                f"VCF data line has {len(fields)} fields, expected "
                f"{9 + n_samples} (9 fixed + {n_samples} samples): "
                f"{line[:80]!r}...")
        chrom[i] = fields[0]
        pos[i] = int(fields[1])
        sid = fields[2]
        snp[i] = sid if sid != "." else f"{fields[0]}_{fields[1]}"
        ref = fields[3]
        alt = fields[4]
        if "," in alt:
            alt = alt.split(",", 1)[0]
        a0[i] = ref
        a1[i] = alt
        row = geno[i]
        cells = fields[9:]
        for j, cell in enumerate(cells):
            # GT is the first colon-separated field. The 3-char fast path
            # must not fire when a longer token follows (e.g. '0/10' would
            # misparse as '0/1'): require end-of-cell or ':' after it.
            if len(cell) == 3 or (len(cell) > 3 and cell[3] == ":"):
                v = gt_map.get(cell[:3])
            else:
                v = None
            if v is None:
                g2 = cell.split(":", 1)[0].rstrip("\r")
                v = gt_map.get(g2, -1)
            row[j] = v
    sites = SiteInfo(chrom=chrom, pos=pos, snp=snp, allele0=a0, allele1=a1)
    return geno, sites


def iter_vcf_chunks(
    path: str, chunk_snps: int = 4096
) -> Iterator[GenotypeData]:
    """Stream a VCF(.gz) as SNP-major chunks of int8 dosages."""
    samples = read_vcf_samples(path)
    n = len(samples)
    with _open_text(path) as fh:
        buf: list[str] = []
        for line in fh:
            if line.startswith("#"):
                continue
            if not line.strip():
                continue  # blank/trailing lines are not variant records
            buf.append(line)
            if len(buf) >= chunk_snps:
                geno, sites = _parse_lines(buf, n)
                yield GenotypeData(geno, sites, samples)
                buf = []
        if buf:
            geno, sites = _parse_lines(buf, n)
            yield GenotypeData(geno, sites, samples)


def read_vcf(path: str) -> GenotypeData:
    chunks = list(iter_vcf_chunks(path))
    if not chunks:
        samples = read_vcf_samples(path)
        return GenotypeData(
            np.empty((0, len(samples)), dtype=np.int8),
            SiteInfo(
                chrom=np.empty(0, object),
                pos=np.empty(0, np.int64),
                snp=np.empty(0, object),
                allele0=np.empty(0, object),
                allele1=np.empty(0, object),
            ),
            samples,
        )
    return GenotypeData(
        np.concatenate([c.genotypes for c in chunks], axis=0),
        SiteInfo.concat([c.sites for c in chunks]),
        chunks[0].samples,
    )


def count_vcf_sites(path: str) -> int:
    n = 0
    with _open_text(path) as fh:
        for line in fh:
            if not line.startswith("#") and line.strip():
                n += 1
    return n
