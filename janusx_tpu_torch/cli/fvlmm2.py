"""`jx fvlmm2` — joint FvLMM recheck of user-specified SNP combinations.

Reference: python/janusx/script/fvlmm2.py — `-i pairs.txt` holds one
interaction expression per line (snp1&snp2, snp1|snp2, snp1*snp2,
snp1^snp2, `!` negation on literals); each combo plus both literals is
tested JOINTLY at the trait's null λ:
y = covariates + SNP1 + SNP2 + combo + Zu + e. Output per trait:
{prefix}.{trait}.fvlmm2.tsv with the reference compact schema (chrom,
pos, combo_id, combo_af, unit_name, beta/se/p_combo_joint,
p_combo_joint_fdr, p_lit1_joint, p_lit2_joint) plus a
{prefix}.fvlmm2.skip table of unparseable/unresolvable rows.

Without `-i` the old forwarding behavior stands: args pass through to
`jx gwas -fvlmm2` (the per-SNP G×C joint scan), so both spellings keep
working.

The port's copy of janusx_tpu/cli/fvlmm2.py writes both tables without
pandas, byte for byte as pandas' ``to_csv(sep="\t", index=False)`` writes
them (``_write_table``); the rest is the reference's.
"""

from __future__ import annotations

import argparse
import logging

from janusx_tpu_torch.cli import common

log = logging.getLogger("janusx_tpu.fvlmm2")

TSV_COLUMNS = ["chrom", "pos", "combo_id", "combo_af", "unit_name",
               "beta_combo_joint", "se_combo_joint", "p_combo_joint",
               "p_combo_joint_fdr", "p_lit1_joint", "p_lit2_joint"]


def build_parser(prog="jx fvlmm2") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="joint FvLMM recheck of SNP-combination "
        "expressions (y = cov + SNP1 + SNP2 + combo + Zu + e)")
    common.add_genotype_args(p, required=True)
    common.add_pheno_args(p, required=True)
    p.add_argument("-i", "--interaction", type=str, required=True,
                   help="interaction file: one expression per line "
                        "(snp1&snp2 | snp1|snp2 | snp1*snp2 | snp1^snp2; "
                        "'!' negates a literal)")
    p.add_argument("-c", "--cov", type=str, default=None,
                   help="covariate file (ID + numeric columns)")
    p.add_argument("-k", "--grm", type=str, default=None,
                   help="precomputed GRM .npy (default: build + cache)")
    common.add_qc_args(p)
    p.add_argument("--batch-size", type=int, default=4096,
                   help="interaction rows per device dispatch")
    p.add_argument("--n-tests", type=int, default=0,
                   help="total hypothesis count for the BH-FDR of "
                        "p_combo_joint (0 = number of tested rows)")
    common.add_out_args(p, default_prefix="jx")
    return p


def _write_table(path: str, columns: list, rows: list, float_format=None) -> None:
    """``pd.DataFrame(rows)[columns].to_csv(path, sep="\t", index=False,
    float_format=float_format)`` without pandas: the csv module with
    pandas' settings (minimal quoting, "\n" line ends), NaN as an empty
    field, floats through ``float_format`` (else str), every other value
    as str."""
    import csv

    def cell(v):
        if isinstance(v, float):
            if v != v:
                return ""
            return float_format % v if float_format else str(v)
        return str(v)

    with open(path, "w", newline="") as fh:
        out = csv.writer(fh, delimiter="\t", lineterminator="\n",
                         quoting=csv.QUOTE_MINIMAL)
        out.writerow(columns)
        out.writerows([cell(r[c]) for c in columns] for r in rows)


def _combo_main(argv) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "fvlmm2")

    import numpy as np

    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.combo import (
        bh_adjust, build_name_map, fvlmm_joint_combo_scan,
        parse_interaction_file,
    )
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.scan_common import analysis_sample_index

    raw = load_raw_packed(common.resolve_genotype(args))
    ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
    y_all, _ = ph.align(raw.samples)
    qc = QcParams(maf=args.maf, geno=args.geno, het=args.het)
    cov_all = None
    if args.cov:
        from janusx_tpu_torch.io.pheno import load_phenotype as _lp

        cov_all, _ = _lp(args.cov).align(raw.samples)
    if args.grm:
        K_full = np.load(args.grm)
        if K_full.shape[0] != len(raw.samples):
            raise SystemExit(
                f"-k GRM is {K_full.shape[0]}x{K_full.shape[1]} but the "
                f"genotype panel has {len(raw.samples)} samples")
    else:
        K_full = grm_from_packed(raw.prepare(qc))

    saved = []
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        keep = analysis_sample_index(y)
        if cov_all is not None:
            keep = keep[np.all(np.isfinite(cov_all[keep]), axis=1)]
        pg = raw.prepare(qc, sample_idx=keep)
        name_map = build_name_map(pg.sites)
        specs, skipped = parse_interaction_file(args.interaction, name_map)
        if skipped:
            skip_path = f"{prefix}.fvlmm2.skip"
            _write_table(skip_path, list(skipped[0]), skipped)
            log.warning("skipped %d interaction rows -> %s",
                        len(skipped), skip_path)
        if not specs:
            raise SystemExit("no valid interaction expressions remain "
                             "after variant lookup/filtering")
        log.info("trait %s: %d interaction rows against %d active "
                 "variants (skipped %d)", trait, len(specs), pg.m,
                 len(skipped))
        basis = eigh_grm(K_full[np.ix_(keep, keep)], diag_ridge=1e-6)
        cov = None if cov_all is None else cov_all[keep]
        rows, null = fvlmm_joint_combo_scan(
            pg, basis, y[keep], cov, specs, batch_size=args.batch_size)
        fdr = bh_adjust(
            np.array([r["p_combo_joint"] for r in rows]),
            n_tests=(args.n_tests if args.n_tests > 0 else None))
        for r, q in zip(rows, fdr):
            r["p_combo_joint_fdr"] = float(q)
        path = f"{prefix}.{trait}.fvlmm2.tsv"
        _write_table(path, TSV_COLUMNS, rows, float_format="%.6g")
        saved.append(path)
        log.info("trait %s: lambda_null=%.4g, %d rows -> %s",
                 trait, null.lbd, len(rows), path)
        print(path)
    return 0


def main(argv=None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if "-i" in args or "--interaction" in args:
        return _combo_main(args)
    # legacy spelling: forward to the per-SNP G×C joint route
    from janusx_tpu_torch.cli.gwas import main as gwas_main

    if "-fvlmm2" not in args and "--fvlmm2" not in args:
        args = ["-fvlmm2"] + args
    return gwas_main(args)
