"""Genotype / phenotype IO: VCF, PLINK, HapMap, TXT readers and writers.

TPU-first equivalents of the reference's Rust IO layer
(JanusX src/io/gfcore.rs, gfreader.rs, gload.rs): all readers
produce SNP-major int8 dosage chunks (0/1/2, -1 missing) which are QC'd,
minor-allele-flipped and packed to 2-bit device buffers by
:mod:`janusx_tpu.io.packed`.
"""

from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
from janusx_tpu_torch.io.packed import PackedGenotypes, pack_genotypes
from janusx_tpu_torch.io.pheno import load_phenotype, load_covariates
from janusx_tpu_torch.io.gfreader import (
    inspect_genotype_file,
    load_genotype_file,
    iter_genotype_chunks,
)

__all__ = [
    "GenotypeData",
    "SiteInfo",
    "PackedGenotypes",
    "pack_genotypes",
    "load_phenotype",
    "load_covariates",
    "inspect_genotype_file",
    "load_genotype_file",
    "iter_genotype_chunks",
]
