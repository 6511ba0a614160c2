"""Streaming genotype writers: VCF and HapMap output.

Replaces the reference's VcfStreamWriter/HmpStreamWriter
(JanusX src/io/gwriter.rs, vcfout.rs). PLINK output lives in
janusx_tpu.io.plink (byte-LUT path).
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

from janusx_tpu_torch.io.gdata import GenotypeData

_GT = {0: "0/0", 1: "0/1", 2: "1/1", -1: "./."}

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """Minimal BGZF text writer: gzip members with the 'BC' extra field and
    the 28-byte EOF marker, so tabix/bcftools/GATK accept the .vcf.gz
    (plain gzip output is rejected with 'was not BGZF compressed')."""

    _MAX_PAYLOAD = 65280  # conventional BGZF uncompressed block cap

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, text: str):
        self._buf += text.encode()
        while len(self._buf) >= self._MAX_PAYLOAD:
            self._flush_block(bytes(self._buf[: self._MAX_PAYLOAD]))
            del self._buf[: self._MAX_PAYLOAD]

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        # BSIZE = total block length - 1; block = header(12) + extra(6)
        # + compressed payload + crc(4) + isize(4)
        bsize = len(comp) + 26 - 1
        self._fh.write(
            b"\x1f\x8b\x08\x04" + b"\x00" * 5 + b"\xff"  # gzip hdr, FEXTRA
            + struct.pack("<H", 6)  # XLEN
            + b"BC" + struct.pack("<HH", 2, bsize)
            + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
        )

    def close(self):
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_out(path: str):
    if str(path).endswith(".vcf.gz"):
        return BgzfWriter(path)  # indexable by the standard toolchain
    if str(path).endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "wt")


def write_vcf(path: str, gdata: GenotypeData) -> None:
    with _open_out(path) as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("##source=janusx-tpu\n")
        for c in dict.fromkeys(gdata.sites.chrom):
            fh.write(f"##contig=<ID={c}>\n")
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fh.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(str(s) for s in gdata.samples)
            + "\n"
        )
        s = gdata.sites
        for i in range(gdata.m):
            gts = "\t".join(_GT[int(v)] for v in gdata.genotypes[i])
            fh.write(
                f"{s.chrom[i]}\t{s.pos[i]}\t{s.snp[i]}\t{s.allele0[i]}"
                f"\t{s.allele1[i]}\t.\t.\t.\tGT\t{gts}\n"
            )


def write_hapmap(path: str, gdata: GenotypeData) -> None:
    with _open_out(path) as fh:
        fh.write(
            "rs#\talleles\tchrom\tpos\tstrand\tassembly#\tcenter\tprotLSID\t"
            "assayLSID\tpanelLSID\tQCcode\t"
            + "\t".join(str(s) for s in gdata.samples)
            + "\n"
        )
        s = gdata.sites
        for i in range(gdata.m):
            a0, a1 = str(s.allele0[i]), str(s.allele1[i])
            cells = []
            for v in gdata.genotypes[i]:
                if v < 0:
                    cells.append("NN")
                elif v == 0:
                    cells.append(a0 + a0)
                elif v == 1:
                    cells.append(a0 + a1)
                else:
                    cells.append(a1 + a1)
            fh.write(
                f"{s.snp[i]}\t{a0}/{a1}\t{s.chrom[i]}\t{s.pos[i]}\t+\t.\t.\t.\t.\t.\t.\t"
                + "\t".join(cells)
                + "\n"
            )


def write_txt(path: str, gdata: GenotypeData) -> None:
    """SNP-major numeric matrix + .id / .bim sidecars (the -file format)."""
    base = path
    for ext in (".txt", ".tsv", ".csv"):
        if path.endswith(ext):
            base = path[: -len(ext)]
            break
    g = gdata.genotypes.astype(np.int64)
    with open(path, "wt") as fh:
        for i in range(gdata.m):
            fh.write(
                " ".join("NA" if v < 0 else str(v) for v in g[i]) + "\n"
            )
    with open(base + ".id", "wt") as fh:
        for s in gdata.samples:
            fh.write(f"{s}\n")
    s = gdata.sites
    with open(base + ".bim", "wt") as fh:
        for i in range(gdata.m):
            fh.write(
                f"{s.chrom[i]}\t{s.snp[i]}\t0\t{s.pos[i]}\t{s.allele1[i]}\t{s.allele0[i]}\n"
            )
