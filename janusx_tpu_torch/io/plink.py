"""PLINK 1.x BED/BIM/FAM reader/writer.

Replaces the reference's ``BedSnpIter``/``BedMmapReader``/``PlinkStreamWriter``
(JanusX src/io/gfcore.rs, gwriter.rs). Reading a BED file is a
memmap + one byte-LUT translation into the internal dosage-code packing —
no per-genotype unpacking ever happens on the host.

BED layout: 3 magic bytes (0x6c 0x1b 0x01 = SNP-major), then m rows of
ceil(n/4) bytes. BIM columns: chrom, snp, cM, pos, A1 (counted), A2.
FAM columns: fid, iid, pat, mat, sex, pheno — sample ID = iid.
"""

from __future__ import annotations

import os

import numpy as np

from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo

BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


def read_fam(path: str) -> np.ndarray:
    ids = []
    with open(path, "rt") as fh:
        for line in fh:
            f = line.split()
            if f:
                ids.append(f[1] if len(f) > 1 else f[0])
    return np.array(ids, dtype=object)


def read_bim(path: str) -> SiteInfo:
    chrom, snp, pos, a1, a2 = [], [], [], [], []
    with open(path, "rt") as fh:
        for lineno, line in enumerate(fh, 1):
            f = line.split()
            if not f:
                continue
            if len(f) < 6:
                raise ValueError(
                    f"{path}:{lineno}: malformed .bim row (need 6 columns, "
                    f"got {len(f)}: {line.rstrip()[:60]!r})"
                )
            chrom.append(f[0])
            snp.append(f[1])
            try:
                pos.append(int(f[3]))
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: non-integer bp position {f[3]!r}"
                ) from None
            a1.append(f[4])
            a2.append(f[5])
    return SiteInfo(
        chrom=np.array(chrom, object),
        pos=np.array(pos, np.int64),
        snp=np.array(snp, object),
        allele0=np.array(a2, object),  # A2 = other allele
        allele1=np.array(a1, object),  # A1 = counted allele
    )


def read_bed_packed(prefix: str, mmap: bool = True):
    """Read a PLINK fileset into (packed_dosage_codes, n_samples, sites, samples).

    The returned packed array uses the internal dosage-code convention with
    code-3 tail padding (see janusx_tpu.io.bitcodec).
    """
    samples = read_fam(prefix + ".fam")
    sites = read_bim(prefix + ".bim")
    n = len(samples)
    m = len(sites)
    nb = bitcodec.n_bytes(n)
    path = prefix + ".bed"
    size = os.path.getsize(path)
    if size != 3 + m * nb:
        raise ValueError(
            f"{path}: size {size} != 3 + {m} snps * {nb} bytes (SNP-major expected)"
        )
    with open(path, "rb") as fh:
        magic = fh.read(3)
    if magic != BED_MAGIC:
        raise ValueError(f"{path}: bad magic {magic.hex()} (need SNP-major v1 BED)")
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=3, shape=(m, nb))
    packed = bitcodec.translate(np.asarray(raw), bitcodec.BED_TO_DOSAGE_LUT)
    packed = bitcodec.mask_tail(packed, n)
    return packed, n, sites, samples


def read_plink(prefix: str) -> GenotypeData:
    packed, n, sites, samples = read_bed_packed(prefix)
    codes = bitcodec.unpack_codes(packed, n)
    geno = codes.astype(np.int8)
    geno[codes == bitcodec.CODE_MISSING] = -1
    return GenotypeData(geno, sites, samples)


def write_plink(
    prefix: str,
    packed: np.ndarray,
    n_samples: int,
    sites: SiteInfo,
    samples: np.ndarray,
) -> None:
    """Write internal packed dosage codes out as a PLINK fileset."""
    bed = bitcodec.translate(packed, bitcodec.DOSAGE_TO_BED_LUT)
    # zero the pad bits (PLINK convention: pad with 00)
    rem = n_samples % 4
    if rem and bed.shape[-1]:
        keep = np.uint8((1 << (2 * rem)) - 1)
        bed[..., -1] &= keep
    with open(prefix + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(np.ascontiguousarray(bed).tobytes())
    with open(prefix + ".bim", "wt") as fh:
        for i in range(len(sites)):
            fh.write(
                f"{sites.chrom[i]}\t{sites.snp[i]}\t0\t{sites.pos[i]}"
                f"\t{sites.allele1[i]}\t{sites.allele0[i]}\n"
            )
    with open(prefix + ".fam", "wt") as fh:
        for s in samples:
            fh.write(f"{s}\t{s}\t0\t0\t0\t-9\n")


def write_plink_genotypes(prefix: str, gdata: GenotypeData) -> None:
    codes = np.where(
        gdata.genotypes < 0,
        np.uint8(bitcodec.CODE_MISSING),
        gdata.genotypes.astype(np.uint8),
    )
    write_plink(
        prefix, bitcodec.pack_codes(codes), gdata.n, gdata.sites, gdata.samples
    )
