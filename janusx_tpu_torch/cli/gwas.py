"""`jx gwas` for the port: the reference CLI surface (build_parser is a
copy of janusx_tpu/cli/gwas.py's) and its main, running every route of
janusx_tpu's: -lm, -lmm, -lmm2, -fvlmm, -lm2, -fvlmm2, -splmm, -splmm-exact
(with -spk 1|2|FILE), -lowrank (with -gmodel and -lowrank-prune),
-farmcpu, -frgwas and -algwas, with -trait-level, -bimrange, -global and
the -q* QTN panels."""

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


def main(argv=None) -> int:
    import sys

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    dev = "-dev" in raw_argv or "--dev" in raw_argv
    raw_argv = [a for a in raw_argv if a not in ("-dev", "--dev")]
    args = build_parser(dev=dev).parse_args(raw_argv)
    if args.fastlmm:
        raise SystemExit(
            "-fastlmm has been removed (reference workflow.py:6930): use "
            "-lowrank [Q] for the FaST-LMM low-rank route, or -fvlmm for "
            "the fixed-lambda scan")
    if args.fast:
        raise SystemExit(
            "-fast has been removed (reference parse_args): use "
            "model-specific routes (-fvlmm, -splmm, -lowrank)")
    if args.farmcpu_nbin < 1:
        raise SystemExit("--farmcpu-nbin must be >= 1.")
    if getattr(args, "strict_train", False):
        # strict per-trait re-preparation is the default here; the flag
        # just forces -global off for reference drop-in command lines
        args.global_stats = False
    # the reference's model order (janusx_tpu/cli/gwas.py:138-162)
    models = [m for m in ("lm", "lm2", "fvlmm2", "lmm", "lmm2", "fvlmm") if getattr(args, m)]
    models += [m for m, on in (("splmm", args.splmm is not None),
                               ("splmm-exact", args.splmm_exact is not None),
                               ("lowrank", args.lowrank is not None),
                               ("farmcpu", args.farmcpu), ("frgwas", args.frgwas),
                               ("algwas", args.algwas)) if on]
    if not models:
        raise SystemExit("select at least one model (-lm/-lmm/-lmm2/-fvlmm/-splmm/-farmcpu)")
    common.apply_mem_budget(args)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gwas")

    from janusx_tpu_torch.workflows.gwas import GwasConfig, run_gwas

    cfg = GwasConfig(
        genotype=common.resolve_genotype(args),
        phenotype=args.pheno,
        out_prefix=prefix,
        models=tuple(models),
        traits=common.parse_traits(args.ncol),
        covariates=args.cov,
        n_pcs=args.qcov,
        maf=args.maf,
        geno=args.geno,
        het=args.het,
        grm_method=args.grm_method,
        force_model=args.force_model,
        splmm_cutoff=(
            args.splmm if args.splmm is not None
            else args.splmm_exact if args.splmm_exact is not None
            else 0.05
        ),
        # -splmm 0.01 -splmm-exact 0.2 in one run: each route keeps its own
        # cutoff (the reference carries one cutoff per splmm run config)
        splmm_exact_cutoff=args.splmm_exact,
        lowrank_snps=(args.lowrank if args.lowrank is not None else 4096),
        genetic_model=args.genetic_model,
        global_stats=args.global_stats,
        lowrank_ld_prune=args.lowrank_prune,
        sparse_grm=args.grm_sparse,
        scan_ranges=tuple(args.bimrange or ()),
        scan_method=args.scan_method,
        trait_level=args.trait_level,
        farmcpu_iter=args.farmcpu_iter,
        farmcpu_threshold=args.farmcpu_threshold,
        farmcpu_qtn_bound=args.farmcpu_qtn_bound,
        farmcpu_nbin=args.farmcpu_nbin,
        farmcpu_bin_sizes=tuple(
            int(float(x)) for x in args.farmcpu_bin_size.split(",") if x.strip()
        ),
        qtn_genotype=(args.qtn_vcf or args.qtn_hmp or args.qtn_bfile
                      or args.qtn_file),
    )
    runs = run_gwas(cfg)
    for r in runs:
        print(
            f"{r.trait}\t{r.model}\tn={r.n_samples}\tm={r.n_snps}\t"
            f"{r.seconds:.2f}s\t{r.tsv_path or '-'}"
        )
    return 0
