"""Shared CLI argument groups (reference: script/_common/cli_args.py)."""

from __future__ import annotations

import argparse
import logging
import os
import sys


def add_genotype_args(p: argparse.ArgumentParser, required: bool = True):
    g = p.add_argument_group("Genotype input (select exactly one)")
    g.add_argument("-bfile", "--bfile", type=str, help="PLINK prefix (.bed/.bim/.fam)")
    g.add_argument("-vcf", "--vcf", type=str, help="VCF file (.vcf/.vcf.gz)")
    g.add_argument("-hmp", "--hmp", type=str, help="HapMap file (.hmp.txt[.gz])")
    g.add_argument("-file", "--file", type=str, help="numeric matrix (.txt/.tsv/.csv/.npy)")
    return g


def resolve_genotype(args) -> str:
    chosen = [v for v in (args.bfile, args.vcf, args.hmp, args.file) if v]
    if len(chosen) != 1:
        raise SystemExit("specify exactly one of -bfile/-vcf/-hmp/-file")
    return chosen[0]


def resolve_genotype_optional(args) -> str | None:
    """First genotype input given, or None (optional-genotype CLIs)."""
    return next((v for v in (args.bfile, args.vcf, args.hmp, args.file) if v), None)


def add_pheno_args(p: argparse.ArgumentParser, required: bool = True):
    g = p.add_argument_group("Phenotype")
    g.add_argument("-p", "--pheno", type=str, required=required, help="phenotype file")
    g.add_argument(
        "-n", "--ncol", type=str, default=None,
        help="trait selector: zero-based indices (excluding ID column) or names, comma-separated",
    )
    return g


def parse_traits(spec: str | None):
    if not spec:
        return None
    return [t.strip() for t in str(spec).split(",") if t.strip()]


def add_qc_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("Variant QC")
    g.add_argument("-maf", "--maf", type=float, default=0.02, help="min minor-allele frequency")
    g.add_argument("-geno", "--geno", type=float, default=0.05, help="max per-SNP missing rate")
    g.add_argument("-het", "--het", type=float, default=1.0, help="max heterozygosity rate (1.0 = off)")
    return g


def add_mem_arg(p: argparse.ArgumentParser):
    """Reference-compatible `-mem GB` host-memory budget (e.g. `-mem
    0.128` in the reference's SparseLMM RSS benchmarks, doc/release/
    v1.0.27.md). Maps onto the windowed disk-backed genotype path."""
    p.add_argument(
        "-mem", "--mem", "-memory", "--memory", type=float, default=None,
        metavar="GB",
        help="host memory budget in GB: inputs whose packed size exceeds "
             "half the budget stream from disk in windows sized to fit",
    )
    return p


def apply_mem_budget(args) -> None:
    """Translate -mem into the lowmem env knobs (read by io.gfreader)."""
    mem = getattr(args, "mem", None)
    if mem is None:
        return
    budget = int(float(mem) * (1 << 30))
    # stream anything bigger than half the budget; the other half is
    # working space (decode buffers, results)
    os.environ["JX_TPU_LOWMEM_BYTES"] = str(max(budget // 2, 1 << 20))
    os.environ["JX_TPU_MEM_BUDGET_BYTES"] = str(budget)


def add_compat_thread_arg(p: argparse.ArgumentParser):
    """Accept the reference's thread-count spellings as advisory no-ops:
    XLA and the host BLAS manage their own pools here (sized at import),
    so the only job of these flags is keeping reference command lines
    from erroring on an unknown option."""
    p.add_argument("-t", "-thread", "--thread", "-threads", "--threads",
                   dest="threads", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


def add_compat_flags(p: argparse.ArgumentParser, specs, group=None):
    """Register reference flags whose mechanism has no analog here.

    They are accepted so drop-in reference command lines never error,
    and loudly warn-logged when explicitly set (see warn_ignored_compat).
    `specs` is an iterable of (options, kwargs, reason) where `options`
    is one option string or a tuple of spellings. The registered default
    is the "not explicitly set" sentinel (None unless given; False for
    store_true).
    """
    target = group if group is not None else p
    reg = getattr(p, "_jx_compat_flags", None)
    if reg is None:
        reg = p._jx_compat_flags = []
    for options, kwargs, reason in specs:
        if isinstance(options, str):
            options = (options,)
        kw = dict(kwargs)
        kw.setdefault("help", argparse.SUPPRESS)
        if kw.get("action") == "store_true":
            kw.setdefault("default", False)
        else:
            kw.setdefault("default", None)
        action = target.add_argument(*options, **kw)
        reg.append((action.dest, kw["default"], options[0], reason))
    return p


def warn_ignored_compat(p: argparse.ArgumentParser, args, logger=None) -> int:
    """Warn-log every compat flag the user explicitly set; returns count.

    The reference pattern this replaces: silent SUPPRESS'd no-ops. Every
    accepted-but-unwired flag must go through here so no flag is ever
    swallowed without a log line."""
    log = logger or logging.getLogger("janusx_tpu.cli")
    n = 0
    for dest, default, opt, reason in getattr(p, "_jx_compat_flags", ()):
        val = getattr(args, dest, default)
        if val != default:
            log.warning(
                "flag %s=%r accepted for reference drop-in compatibility "
                "but IGNORED here: %s", opt, val, reason)
            n += 1
    return n


def add_out_args(p: argparse.ArgumentParser, default_prefix: str):
    g = p.add_argument_group("Output")
    g.add_argument("-o", "--out", type=str, default=".", help="output directory")
    g.add_argument("-prefix", "--prefix", type=str, default=default_prefix, help="output file prefix")
    g.add_argument("-v", "--verbose", action="store_true", default=False)
    return g


def out_prefix(args) -> str:
    os.makedirs(args.out, exist_ok=True)
    return os.path.join(args.out, args.prefix)


def setup_logging(verbose: bool, prefix: str | None = None, module: str = "jx"):
    level = logging.DEBUG if verbose else logging.INFO
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if prefix:
        handlers.append(logging.FileHandler(f"{prefix}.{module}.log", mode="w"))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )
