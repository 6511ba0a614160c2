"""`jx gwas` for the port: the reference CLI surface (build_parser is a
copy of janusx_tpu/cli/gwas.py's), running the ported ``-lmm`` route.
Flags that select a route not ported yet raise NotImplementedError."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx gwas", dev: bool = False) -> argparse.ArgumentParser:
    def _dev(text):
        # hidden flags surface with `-h -dev` (reference show_dev_help)
        return text if dev else argparse.SUPPRESS

    p = argparse.ArgumentParser(prog=prog, description="GWAS scans (TPU-native)")
    common.add_genotype_args(p)
    common.add_pheno_args(p)
    m = p.add_argument_group("Models (select at least one)")
    m.add_argument("-lm", "--lm", action="store_true", help="linear model scan")
    m.add_argument("-lm2", "--lm2", action="store_true", help=argparse.SUPPRESS)
    m.add_argument("-fvlmm2", "--fvlmm2", action="store_true", help=argparse.SUPPRESS)
    m.add_argument("-lmm", "--lmm", action="store_true", help="exact per-SNP REML LMM (GEMMA-like)")
    m.add_argument("-lmm2", "--lmm2", action="store_true", help="LMM + ML/LRT columns")
    m.add_argument("-fvlmm", "--fvlmm", action="store_true", help="fixed-lambda LMM scan (EMMAX-like)")
    m.add_argument(
        "-splmm", "--splmm", nargs="?", const=0.05, type=float, default=None,
        metavar="CUTOFF", help="sparse-GRM GRAMMAR-gamma scan (default cutoff 0.05)",
    )
    m.add_argument(
        "-splmm-approx", "--splmm-approx", dest="splmm", nargs="?", const=0.05,
        type=float, help=argparse.SUPPRESS,
    )
    m.add_argument(
        "-splmm-exact", "--splmm-exact", dest="splmm_exact", nargs="?",
        const=0.05, type=float, default=None, metavar="CUTOFF",
        help="sparse-GRM exact fixed-V scan (spectral route)",
    )
    m.add_argument(
        "-lowrank", "--lowrank", nargs="?", const=4096, type=int, default=None,
        metavar="Q",
        help="FaST-LMM low-rank exact scan: kinship from Q SNPs (default 4096)",
    )
    m.add_argument("-farmcpu", "--farmcpu", action="store_true", help="FarmCPU multi-locus scan")
    # reference parity: -fastlmm was removed upstream with a redirect
    # (workflow.py:6930-6934); -lowrank is the replacement route
    m.add_argument("-fastlmm", "--fastlmm", action="store_true",
                   help=argparse.SUPPRESS)
    # -fast was likewise removed upstream (workflow.py parse_args:
    # "removed; use model-specific routes")
    m.add_argument("-fast", "--fast", action="store_true",
                   help=argparse.SUPPRESS)
    m.add_argument("-frgwas", "--frgwas", action="store_true", help=_dev("unified FarmCPU route with r2 merging"))
    m.add_argument("-algwas", "--algwas", action="store_true", help=_dev("adaptive-lasso GWAS (stage1 EBIC lasso + stage2 scan)"))
    common.add_qc_args(p)
    o = p.add_argument_group("Model options")
    o.add_argument("-q", "--qcov", type=int, default=0, help="number of GRM PCs as covariates")
    o.add_argument("-c", "--cov", type=str, default=None, help="covariate file")
    o.add_argument("-gk", "--grm-method", type=int, default=1, choices=(1, 2), help="GRM: 1=centered 2=standardized")
    o.add_argument("-force-model", "--force-model", action="store_true", help="disable the LMM->LM auto-switch")
    o.add_argument("-scan-method", "--scan-method", type=str, default="grid", choices=("grid", "brent"), help=_dev("lmm lambda search kernel"))
    o.add_argument(
        "-gmodel", "--genetic-model", type=str, default="add",
        choices=("add", "dom", "rec", "het"),
        help="genetic model for -lowrank (reference fastlmm route)",
    )
    o.add_argument("-global", "--global", dest="global_stats",
                   action="store_true",
                   help=_dev("reuse full-sample row stats for trait subsets"))
    # hidden reference aliases: strict per-trait re-preparation is our
    # default; accepting the flags keeps reference command lines drop-in
    # (they force global_stats off)
    o.add_argument("-strict-train", "--strict-train", "-strict-trait",
                   "--strict-trait", dest="strict_train",
                   action="store_true", help=argparse.SUPPRESS)
    o.add_argument("-lowrank-prune", "--lowrank-prune", action="store_true",
                   help="LD-prune the -lowrank kinship SNPs before selection")
    o.add_argument("-spk", "--grm-sparse", dest="grm_sparse", type=str,
                   default="1",
                   help="sparse GRM for -splmm/-splmm-exact: 1 (centered), "
                        "2 (standardized), or a precomputed .spgrm/.jxgrm path")
    o.add_argument("-bimrange", "--bimrange", action="append", default=None,
                   metavar="CHR:START-END",
                   help="restrict only the final scan to region(s) "
                        "(Mb by default, large integers are bp); "
                        "GRM/PCA still use the full genotype")
    o.add_argument("-trait-level", "--trait-level", action="store_true",
                   help="also write one combined multi-trait TSV "
                        "({prefix}.traitlevel.assoc.tsv)")
    o.add_argument("--farmcpu-iter", type=int, default=10, help=_dev("FarmCPU max iterations"))
    o.add_argument("--farmcpu-threshold", type=float, default=None,
                   help=_dev("FarmCPU stage1 threshold (default 1/m)"))
    o.add_argument("--farmcpu-qtn-bound", type=int, default=None,
                   help=_dev("FarmCPU QTN count cap"))
    o.add_argument("--farmcpu-nbin", type=int, default=5,
                   help=_dev("FarmCPU nbin denominator for the candidate "
                             "grid (default 5)"))
    o.add_argument("--farmcpu-bin-size", type=str,
                   default="500000,5000000,50000000",
                   help=_dev("FarmCPU bin-size CSV ladder"))
    q = p.add_argument_group("QTN-search panel (FarmCPU/ALGWAS stage 1)")
    q.add_argument("-qvcf", "--qtn-vcf", type=str, default=None, help=_dev("QTN-search VCF panel"))
    q.add_argument("-qhmp", "--qtn-hmp", type=str, default=None, help=_dev("QTN-search HapMap panel"))
    q.add_argument("-qbfile", "--qtn-bfile", type=str, default=None,
                   help="alternate panel for the FarmCPU/ALGWAS stage-1 QTN "
                        "search; other models ignore it")
    q.add_argument("-qfile", "--qtn-file", type=str, default=None, help=_dev("QTN-search matrix panel"))
    common.add_mem_arg(p)
    common.add_out_args(p, default_prefix="jx")
    return p


# model flags, and option flags whose route is not ported yet
_UNPORTED_MODELS = ("lm", "lm2", "fvlmm2", "lmm2", "fvlmm", "farmcpu",
                    "frgwas", "algwas", "fastlmm", "fast")
_UNPORTED_OPTIONS = ("splmm", "splmm_exact", "lowrank", "global_stats",
                     "bimrange", "trait_level", "qtn_vcf", "qtn_hmp",
                     "qtn_bfile", "qtn_file")


def main(argv=None) -> int:
    import sys

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    dev = "-dev" in raw_argv or "--dev" in raw_argv
    raw_argv = [a for a in raw_argv if a not in ("-dev", "--dev")]
    args = build_parser(dev=dev).parse_args(raw_argv)
    unported = [f for f in _UNPORTED_MODELS if getattr(args, f)]
    unported += [f for f in _UNPORTED_OPTIONS if getattr(args, f) not in (None, False)]
    if unported:
        raise NotImplementedError(
            f"janusx_tpu_torch gwas: {unported} not ported yet (only -lmm "
            "with -c/-q covariates is; see ROADMAP queue 1)")
    if not args.lmm:
        raise SystemExit("select -lmm (the only model janusx_tpu_torch runs yet)")
    common.apply_mem_budget(args)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gwas")

    from janusx_tpu_torch.workflows.gwas import GwasConfig, run_gwas

    cfg = GwasConfig(
        genotype=common.resolve_genotype(args),
        phenotype=args.pheno,
        out_prefix=prefix,
        models=("lmm",),
        traits=common.parse_traits(args.ncol),
        covariates=args.cov,
        n_pcs=args.qcov,
        maf=args.maf,
        geno=args.geno,
        het=args.het,
        grm_method=args.grm_method,
        force_model=args.force_model,
        scan_method=args.scan_method,
    )
    for r in run_gwas(cfg):
        print(
            f"{r.trait}\t{r.model}\tn={r.n_samples}\tm={r.n_snps}\t"
            f"lambda_null={r.lambda_null:.6g}\t{r.seconds:.2f}s\t"
            f"{r.tsv_path}"
        )
    return 0
