"""`jx` dispatcher of the port: ``python -m janusx_tpu_torch.cli.main
<module> ...`` and its sub-entries (``kmerge``, ``kstats``, ``gblupbench``,
``bayesbench``, ``garfieldbench``): every module, sub-entry and alias of
the reference's dispatcher."""

from __future__ import annotations

import importlib
import sys

from janusx_tpu_torch import __version__

_MODULES: dict[str, tuple[str, str]] = {
    "gwas": ("janusx_tpu_torch.cli.gwas", "GWAS scans: lm/lmm/lmm2/fvlmm/splmm/farmcpu"),
    "gs": ("janusx_tpu_torch.cli.gs", "Genomic selection: BLUP/GBLUP/rrBLUP/Bayes"),
    "grm": ("janusx_tpu_torch.cli.grm", "Genomic relationship matrix"),
    "pca": ("janusx_tpu_torch.cli.pca", "Principal components (eigh or randomized SVD)"),
    "gstats": ("janusx_tpu_torch.cli.gstats", "Per-site / per-sample genotype statistics"),
    "sim": ("janusx_tpu_torch.cli.sim", "Simulate genotypes + phenotypes"),
    "gformat": ("janusx_tpu_torch.cli.gformat", "Convert genotype files across formats"),
    "postgwas": ("janusx_tpu_torch.cli.postgwas", "Manhattan/QQ plots + annotation"),
    "reml": ("janusx_tpu_torch.cli.reml", "Variance components / BLUE / BLUP"),
    "fastpop": ("janusx_tpu_torch.cli.fastpop", "ADMIXTURE-style ancestry inference"),
    "tree": ("janusx_tpu_torch.cli.tree", "Neighbor-joining phylogeny from genotypes"),
    "gmerge": ("janusx_tpu_torch.cli.gmerge", "Merge genotype panels"),
    "env": ("janusx_tpu_torch.cli.env", "List JX_* expert environment knobs"),
    "postgs": ("janusx_tpu_torch.cli.postgs", "GS CV plots + metric tables"),
    "hybrid": ("janusx_tpu_torch.cli.hybrid", "F1 hybrid performance prediction"),
    "view": ("janusx_tpu_torch.cli.view", "Inspect genotype/matrix artifacts"),
    "refcheck": ("janusx_tpu_torch.cli.refcheck", "Input consistency checks"),
    "ggval": ("janusx_tpu_torch.cli.ggval", "End-to-end install validation (simulate + run + check)"),
    "fvlmm2": ("janusx_tpu_torch.cli.fvlmm2", "G-by-E joint interaction scan (= jx gwas -fvlmm2)"),
    "treeplot": ("janusx_tpu_torch.cli.treeplot", "Render a Newick tree"),
    "gspredict": ("janusx_tpu_torch.cli.gspredict", "Predict gebv from a saved .jxmodel.npz"),
    "garfield": ("janusx_tpu_torch.cli.garfield", "Logic-rule (epistasis) association search"),
    "postgarfield": ("janusx_tpu_torch.cli.postgarfield", "GARFIELD rule plots"),
    "benchmark": ("janusx_tpu_torch.cli.benchmark", "Time core kernels on simulated data"),
    "bsa": ("janusx_tpu_torch.cli.bsa", "Bulked-segregant analysis preprocessing"),
    "postbsa": ("janusx_tpu_torch.cli.postbsa", "BSA thresholds (CI/G' FDR) + genome plots"),
    "webui": ("janusx_tpu_torch.cli.webui", "Local web UI: history dashboard + job manager"),
    "kmer": ("janusx_tpu_torch.cli.kmer", "Count k-mers per sample (native C++)"),
    "fastq2vcf": ("janusx_tpu_torch.cli.fastq2vcf", "Reads-to-variants pipeline (external tools)"),
    "fastq2count": ("janusx_tpu_torch.cli.fastq2count",
                    "RNA-seq reads-to-counts pipeline (external tools)"),
}

# secondary entry points living inside a module file
_SUBENTRY = {
    "kmerge": ("janusx_tpu_torch.cli.kmer", "kmerge_main", "Merge k-mer counts to a presence matrix"),
    "kstats": ("janusx_tpu_torch.cli.kmer", "kstats_main", "K-mer count statistics"),
    "gblupbench": ("janusx_tpu_torch.cli.benchmark", "gblupbench_main",
                   "GBLUP/rrBLUP route timing + accuracy benchmark"),
    "bayesbench": ("janusx_tpu_torch.cli.benchmark", "bayesbench_main",
                   "Bayes A/B/Cpi vs BLUP chain benchmark"),
    "garfieldbench": ("janusx_tpu_torch.cli.benchmark", "garfieldbench_main",
                      "Planted-epistasis recovery power benchmark"),
}

_ALIASES = {"simulation": "sim", "adamixture": "fastpop"}


def _help() -> str:
    lines = [f"janusx_tpu_torch {__version__} — PyTorch/CUDA port of janusx-tpu",
             "", "usage: jx <module> [options]", "", "modules:"]
    lines += [f"  {name:<10} {desc}" for name, (_, desc) in _MODULES.items()]
    lines += [f"  {name:<10} {desc}" for name, (_, _fn, desc) in _SUBENTRY.items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_help())
        return 0
    if argv[0] in ("-V", "--version", "version"):
        print(__version__)
        return 0
    name = _ALIASES.get(argv[0], argv[0])
    if name in _SUBENTRY:
        modpath, fn, _desc = _SUBENTRY[name]
        return int(getattr(importlib.import_module(modpath), fn)(argv[1:]) or 0)
    entry = _MODULES.get(name)
    if entry is None:
        print(f"unknown module: {argv[0]}\n\n{_help()}", file=sys.stderr)
        return 2
    return int(importlib.import_module(entry[0]).main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
