"""Unified genotype-file frontend: format detection, inspection, loading.

Replaces the reference's Python ``janusx.gfreader``
(JanusX python/janusx/gfreader/gfreader.py: inspect_genotype_file
:2153, load_genotype_chunks :1755, prepare_bed_2bit_packed :165).

Supported inputs:
- PLINK prefix (``.bed``/``.bim``/``.fam``) — mmap + byte-LUT, no decode
- VCF ``.vcf`` / ``.vcf.gz``
- HapMap ``.hmp.txt`` / ``.hmp.txt.gz``
- numeric matrix ``.txt/.tsv/.csv/.npy`` with ``.id`` sidecar
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from janusx_tpu_torch.io import bitcodec, hapmap, plink, txt, vcf
from janusx_tpu_torch.io.gdata import GenotypeData
from janusx_tpu_torch.io.packed import PackedGenotypes, QcParams, pack_from_codes


@dataclass
class GenotypeFileInfo:
    path: str
    format: str  # "bed" | "vcf" | "hmp" | "txt"
    n_samples: int
    n_snps: int | None  # None when counting requires a full pass and skip_count


def detect_format(path: str) -> tuple[str, str]:
    """Return (format, resolved_path_or_prefix)."""
    p = str(path)
    if p.endswith(".vcf") or p.endswith(".vcf.gz"):
        return "vcf", p
    if p.endswith(".hmp.txt") or p.endswith(".hmp.txt.gz"):
        return "hmp", p
    if p.endswith(".bed"):
        return "bed", p[:-4]
    if any(p.endswith(e) for e in (".txt", ".tsv", ".csv", ".npy")):
        return "txt", p
    # prefix probing
    if os.path.exists(p + ".bed"):
        return "bed", p
    for ext in (".vcf.gz", ".vcf"):
        if os.path.exists(p + ext):
            return "vcf", p + ext
    for ext in (".hmp.txt.gz", ".hmp.txt"):
        if os.path.exists(p + ext):
            return "hmp", p + ext
    for ext in (".txt", ".tsv", ".csv", ".npy"):
        if os.path.exists(p + ext):
            return "txt", p + ext
    raise FileNotFoundError(f"cannot resolve genotype input: {path}")


def inspect_genotype_file(path: str, count_snps: bool = True) -> GenotypeFileInfo:
    fmt, p = detect_format(path)
    if fmt == "bed":
        samples = plink.read_fam(p + ".fam")
        sites = plink.read_bim(p + ".bim")
        return GenotypeFileInfo(p, fmt, len(samples), len(sites))
    if fmt == "vcf":
        samples = vcf.read_vcf_samples(p)
        m = vcf.count_vcf_sites(p) if count_snps else None
        return GenotypeFileInfo(p, fmt, len(samples), m)
    if fmt == "hmp":
        first = next(iter(hapmap.iter_hapmap_chunks(p, chunk_snps=1)), None)
        if first is None:
            raise ValueError(f"no variant rows in HapMap file: {p}")
        # cheap: count lines if requested
        m = None
        if count_snps:
            opener = hapmap._open_text(p)
            with opener as fh:
                m = sum(1 for _ in fh) - 1
        return GenotypeFileInfo(p, fmt, first.n, m)
    vals, sites, samples = txt.read_txt_matrix(p)
    return GenotypeFileInfo(p, fmt, len(samples), len(sites))


def iter_genotype_chunks(
    path: str, chunk_snps: int = 4096
) -> Iterator[GenotypeData]:
    """Stream any supported format as SNP-major int8 chunks."""
    fmt, p = detect_format(path)
    if fmt == "vcf":
        yield from vcf.iter_vcf_chunks(p, chunk_snps)
    elif fmt == "hmp":
        yield from hapmap.iter_hapmap_chunks(p, chunk_snps)
    elif fmt == "bed":
        packed, n, sites, samples = plink.read_bed_packed(p)
        m = packed.shape[0]
        for s in range(0, m, chunk_snps):
            e = min(s + chunk_snps, m)
            codes = bitcodec.unpack_codes(packed[s:e], n)
            geno = codes.astype(np.int8)
            geno[codes == bitcodec.CODE_MISSING] = -1
            yield GenotypeData(geno, sites.take(np.arange(s, e)), samples)
    else:
        g = txt.read_txt(p)
        if not isinstance(g, GenotypeData):
            raise ValueError(
                f"{p}: continuous matrix input has no dosage chunks; "
                "use read_txt_matrix / matrix-mode models"
            )
        m = g.m
        for s in range(0, m, chunk_snps):
            yield g.take_snps(np.arange(s, min(s + chunk_snps, m)))


def load_genotype_file(path: str) -> GenotypeData:
    fmt, p = detect_format(path)
    if fmt == "vcf":
        return vcf.read_vcf(p)
    if fmt == "hmp":
        return hapmap.read_hapmap(p)
    if fmt == "bed":
        return plink.read_plink(p)
    g = txt.read_txt(p)
    if not isinstance(g, GenotypeData):
        raise ValueError(f"{p}: continuous matrix; use read_txt_matrix")
    return g


@dataclass
class RawPacked:
    """Pre-QC packed dosage codes: the reusable on-host master copy.

    Per-trait analyses re-derive QC'd PackedGenotypes from this with their
    own sample subset (stats/flips re-evaluated on the subset, matching the
    reference's per-trait prepare)."""

    packed: np.ndarray  # (m, ceil(n/4)) uint8, unflipped, tail code-3
    n_samples: int
    sites: object
    samples: np.ndarray

    @property
    def m(self) -> int:
        return self.packed.shape[0]

    def prepare(
        self, qc: QcParams | None = None, sample_idx: np.ndarray | None = None
    ) -> PackedGenotypes:
        return pack_from_codes(
            self.packed, self.n_samples, self.sites, self.samples, qc, sample_idx
        )

    def read_window_codes(self, start: int, stop: int) -> np.ndarray:
        """Packed dosage-code rows [start, stop) — WindowedBed duck-type."""
        return self.packed[start:stop]

    def to_raw_packed(self) -> "RawPacked":
        return self


def _load_raw_vcf_native(path: str, chunk_snps: int) -> RawPacked | None:
    """Fast path: C++ GT parser packs 2-bit codes directly (io/native.py)."""
    from janusx_tpu_torch.io import native
    from janusx_tpu_torch.io.gdata import SiteInfo

    if not native.available():
        return None
    samples = vcf.read_vcf_samples(path)
    n = len(samples)
    packed_parts, meta_parts = [], []
    with vcf._open_text(path) as fh:
        buf: list[str] = []

        def flush():
            if not buf:
                return
            out = native.parse_vcf_block(
                "".join(buf).encode(), n, len(buf)
            )
            if out is None:
                raise RuntimeError("native VCF parse failed")
            packed_parts.append(out[0])
            meta_parts.extend(out[1])
            buf.clear()

        for line in fh:
            if line.startswith("#"):
                continue
            buf.append(line)
            if len(buf) >= chunk_snps:
                flush()
        flush()
    if not packed_parts:
        raise ValueError(f"no variants in {path}")
    m = sum(p.shape[0] for p in packed_parts)
    chrom = np.empty(m, object)
    pos = np.empty(m, np.int64)
    snp = np.empty(m, object)
    a0 = np.empty(m, object)
    a1 = np.empty(m, object)
    for i, (c, p_, sid, ref, alt) in enumerate(meta_parts):
        chrom[i] = c
        pos[i] = int(p_)
        snp[i] = sid if sid != "." else f"{c}_{p_}"
        a0[i] = ref
        a1[i] = alt.split(",", 1)[0] if "," in alt else alt
    sites = SiteInfo(chrom=chrom, pos=pos, snp=snp, allele0=a0, allele1=a1)
    return RawPacked(np.concatenate(packed_parts, axis=0), n, sites, samples)


def _tilde_cache_prefix(path: str) -> str:
    """Reference genotype-cache naming: ``~{name}`` PLINK fileset.

    The reference places it beside the source (workflow.py:2431); we
    default to ``$JANUSX_CACHE_DIR`` / ``~/.janusx_tpu/genocache`` keyed by
    the absolute source path (set JX_TPU_CACHE_BESIDE_SOURCE=1 for the
    beside-source behavior) so shared/reference data dirs are never
    written to."""
    import hashlib

    from janusx_tpu_torch import config as _cfg

    if os.environ.get("JX_TPU_CACHE_BESIDE_SOURCE") == "1":
        from janusx_tpu_torch.utils.cache import cache_dir_for

        d = cache_dir_for(path)
    else:
        d = _cfg.cache_dir_override() or os.path.join(
            os.path.expanduser("~"), ".janusx_tpu", "genocache"
        )
        os.makedirs(d, exist_ok=True)
        tag = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:10]
        name = os.path.basename(path)
        for ext in (".vcf.gz", ".vcf", ".hmp.txt.gz", ".hmp.txt", ".txt", ".tsv", ".csv"):
            if name.endswith(ext):
                name = name[: -len(ext)]
                break
        return os.path.join(d, f"~{name}.{tag}")
    name = os.path.basename(path)
    for ext in (".vcf.gz", ".vcf", ".hmp.txt.gz", ".hmp.txt", ".txt", ".tsv", ".csv"):
        if name.endswith(ext):
            name = name[: -len(ext)]
            break
    return os.path.join(d, "~" + name)


def _load_tilde_cache(src_path: str) -> RawPacked | None:
    prefix = _tilde_cache_prefix(src_path)
    bed = prefix + ".bed"
    if not (os.path.exists(bed) and os.path.exists(prefix + ".bim")
            and os.path.exists(prefix + ".fam")):
        return None
    if os.path.getmtime(bed) < os.path.getmtime(src_path):
        return None  # stale
    packed, n, sites, samples = plink.read_bed_packed(prefix)
    return RawPacked(packed, n, sites, samples)


def _write_tilde_cache(src_path: str, raw: RawPacked) -> None:
    prefix = _tilde_cache_prefix(src_path)
    try:
        plink.write_plink(prefix, raw.packed, raw.n_samples, raw.sites, raw.samples)
    except OSError:
        pass


# BED files above this byte size switch to the windowed disk-backed path
# (genotypes never fully resident in host RAM). Override with
# JX_TPU_LOWMEM_BYTES; JX_TPU_LOWMEM=1 forces it for any size.
def _lowmem_threshold() -> int:
    return int(os.environ.get("JX_TPU_LOWMEM_BYTES", 1 << 30))


def load_raw_packed(
    path: str, chunk_snps: int = 8192, use_cache: bool = True,
    low_memory: bool | None = None,
):
    """Load any supported input as pre-QC packed dosage codes.

    Returns RawPacked (in-RAM) or, for large BED filesets (or
    ``low_memory=True``), a disk-backed io.windowed.WindowedBed with the
    same ``.prepare(qc, sample_idx)`` interface — the biobank-scale path
    (reference analog: mmap windowed BED, src/io/gload.rs:1-12).

    Text inputs (VCF/HapMap/TXT) are materialized once into a ``~name``
    PLINK cache (reference tilde-cache contract), so repeat analyses skip
    the parse entirely; a large materialized cache also reloads windowed."""
    fmt, p = detect_format(path)
    if fmt == "bed":
        bed_size = os.path.getsize(p + ".bed")
        if low_memory or (low_memory is None and (
            bed_size > _lowmem_threshold()
            or os.environ.get("JX_TPU_LOWMEM") == "1"
        )):
            from janusx_tpu_torch.io.windowed import WindowedBed

            return WindowedBed(p)
        packed, n, sites, samples = plink.read_bed_packed(p)
        return RawPacked(packed, n, sites, samples)
    if use_cache:
        cprefix = _tilde_cache_prefix(p)
        if all(os.path.exists(cprefix + ext) for ext in (".bed", ".bim", ".fam")) \
                and os.path.getmtime(cprefix + ".bed") >= os.path.getmtime(p):
            # same low-memory policy as a direct BED fileset: explicit
            # flag wins, otherwise size threshold / env knob
            cache_size = os.path.getsize(cprefix + ".bed")
            if low_memory or (low_memory is None and (
                cache_size > _lowmem_threshold()
                or os.environ.get("JX_TPU_LOWMEM") == "1"
            )):
                from janusx_tpu_torch.io.windowed import WindowedBed

                return WindowedBed(cprefix)
        cached = _load_tilde_cache(p)
        if cached is not None:
            return cached
    if fmt == "vcf":
        raw = _load_raw_vcf_native(p, chunk_snps)
        if raw is not None:
            if use_cache:
                _write_tilde_cache(p, raw)
            return raw
    from janusx_tpu_torch.io.gdata import SiteInfo

    parts, site_parts, samples = [], [], None
    for chunk in iter_genotype_chunks(p, chunk_snps):
        codes = np.where(
            chunk.genotypes < 0,
            np.uint8(bitcodec.CODE_MISSING),
            chunk.genotypes.astype(np.uint8),
        )
        parts.append(bitcodec.pack_codes(codes))
        site_parts.append(chunk.sites)
        samples = chunk.samples
    if not parts:
        raise ValueError(f"no variants in {p}")
    raw = RawPacked(
        np.concatenate(parts, axis=0),
        len(samples),
        SiteInfo.concat(site_parts),
        samples,
    )
    if use_cache:
        _write_tilde_cache(p, raw)
    return raw


def prepare_packed(
    path: str,
    qc: QcParams | None = None,
    chunk_snps: int = 8192,
    sample_idx: np.ndarray | None = None,
) -> PackedGenotypes:
    """One-pass load + QC + minor-allele flip + 2-bit pack of any input.

    The TPU-native analog of the reference's ``prepare_bed_2bit_packed``
    (src/io/gfreader.rs:7029). PLINK input takes the byte-LUT fast path
    (never unpacked); other formats stream through int8 chunks.
    """
    return load_raw_packed(path, chunk_snps).prepare(qc, sample_idx)
