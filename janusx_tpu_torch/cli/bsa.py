"""`jx bsa` — bulked-segregant analysis (reference: src/stats/bsa.rs +
script/postbsa.py).

Two input modes:

- depth-column mode (default): a TSV with columns chrom, pos, and
  ALT/REF depths of the two bulks (alt1 ref1 alt2 ref2 — names
  configurable via -cols).
- bulk-prefix mode (-b1/-b2, reference postbsa semantics): a TSV with
  CHROM, POS and per-bulk {bulk}.DP / {bulk}.AD (+ optional {bulk}.GQ)
  columns; the reference's depth/GQ/total-DP/depth-difference/
  allele-frequency filter chain runs before the statistics."""

from __future__ import annotations

import argparse
import logging

from janusx_tpu_torch.cli import common

log = logging.getLogger("janusx_tpu.bsa")


def add_filter_args(p: argparse.ArgumentParser) -> None:
    """Reference postbsa locus-filter flags (script/postbsa.py:1691-1730)."""
    p.add_argument("-minDP", "--min-dp", dest="min_dp", type=int, default=15,
                   help="minimum per-bulk DP (prefix mode; default 15)")
    p.add_argument("-minGQ", "--min-gq", dest="min_gq", type=int, default=90,
                   help="minimum per-bulk GQ when GQ columns exist (default 90)")
    p.add_argument("-totalDP", "--total-dp", dest="total_dp", type=str,
                   default="30:300",
                   help="total-depth range lo:hi across both bulks")
    p.add_argument("-depthDifference", "--depth-difference",
                   dest="depth_difference", type=int, default=150,
                   help="max |DP1-DP2| between bulks")
    p.add_argument("-refAlleleFreq", "--ref-allele-freq",
                   dest="ref_allele_freq", type=float, default=0.2,
                   help="drop sites with both bulk SNP-indexes < f or "
                        "both > 1-f (uninformative); f in [0, 0.5]")


def parse_total_dp(s: str) -> tuple:
    parts = s.replace(",", ":").split(":")
    if len(parts) != 2:
        raise SystemExit("-totalDP needs lo:hi, e.g. 30:300")
    return (int(parts[0]), int(parts[1]))


def build_parser(prog="jx bsa") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="BSA Δ-SNP index / ED / G' scan")
    p.add_argument("-i", "--input", type=str, required=True,
                   help="depth table TSV")
    p.add_argument("-b1", "--bulk1", type=str, default=None,
                   help="bulk-1 column prefix ({b1}.DP/{b1}.AD[/.GQ] mode)")
    p.add_argument("-b2", "--bulk2", type=str, default=None,
                   help="bulk-2 column prefix")
    p.add_argument("-win", "--window", type=int, default=1_000_000,
                   help="smoothing window (bp)")
    p.add_argument("-min-depth", "--min-depth", type=int, default=10,
                   help="per-bulk depth floor (depth-column mode)")
    p.add_argument("-cols", "--cols", type=str,
                   default="chrom,pos,alt1,ref1,alt2,ref2",
                   help="column names in order chrom,pos,alt1,ref1,alt2,ref2 "
                        "(depth-column mode)")
    add_filter_args(p)
    common.add_out_args(p, default_prefix="bsa")
    return p


def load_bulk_prefixed(df, b1: str, b2: str, args):
    """Prefix-mode loader: AD parse (last comma field = ALT depth, as the
    reference does for multi-field AD strings), filter chain, then
    (chrom, pos, alt1, ref1, alt2, ref2) arrays."""
    import numpy as np

    from janusx_tpu_torch.models.bsa import filter_bulk_depths

    cpos = "POS" if "POS" in df.columns else "pos"
    cchr = "CHROM" if "CHROM" in df.columns else "chrom"
    need = [cchr, cpos] + [f"{b}.{s}" for b in (b1, b2) for s in ("DP", "AD")]
    missing = [c for c in need if c not in df.columns]
    if missing:
        raise SystemExit(f"missing columns: {missing}")

    def _ad(col):
        s = df[col].astype(str).str.rsplit(",", n=1).str[-1]
        import pandas as pd
        return pd.to_numeric(s, errors="coerce").fillna(0).to_numpy(float)

    dp1 = df[f"{b1}.DP"].to_numpy(float)
    dp2 = df[f"{b2}.DP"].to_numpy(float)
    ad1, ad2 = _ad(f"{b1}.AD"), _ad(f"{b2}.AD")
    gq1 = df[f"{b1}.GQ"].to_numpy(float) if f"{b1}.GQ" in df.columns else None
    gq2 = df[f"{b2}.GQ"].to_numpy(float) if f"{b2}.GQ" in df.columns else None
    fr = filter_bulk_depths(
        dp1, ad1, dp2, ad2, gq1, gq2,
        min_dp=args.min_dp, min_gq=args.min_gq,
        total_dp=parse_total_dp(args.total_dp),
        depth_difference=args.depth_difference,
        ref_allele_freq=args.ref_allele_freq,
    )
    for label, before, after in fr.stages:
        log.info("filter %s: %d -> %d", label, before, after)
    if fr.n_kept == 0:
        raise SystemExit("no loci remain after DP/GQ/frequency filtering")
    k = fr.keep
    chrom = df[cchr].to_numpy()[k]
    pos = df[cpos].to_numpy(np.int64)[k]
    return (chrom, pos, ad1[k], dp1[k] - ad1[k], ad2[k], dp2[k] - ad2[k])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "bsa")
    if (args.bulk1 is None) != (args.bulk2 is None):
        raise SystemExit("-b1 and -b2 must be given together")

    import pandas as pd

    from janusx_tpu_torch.models.bsa import bsa_analysis

    df = pd.read_csv(args.input, sep="\t")
    if args.bulk1:
        chrom, pos, a1, r1, a2, r2 = load_bulk_prefixed(
            df, args.bulk1, args.bulk2, args)
        min_depth = 0  # the reference filter chain already applied
    else:
        cols = [c.strip() for c in args.cols.split(",")]
        if len(cols) != 6:
            raise SystemExit("-cols needs 6 names: chrom,pos,alt1,ref1,alt2,ref2")
        missing = [c for c in cols if c not in df.columns]
        if missing:
            raise SystemExit(f"missing columns: {missing}")
        chrom, pos = df[cols[0]].to_numpy(), df[cols[1]].to_numpy()
        a1, r1 = df[cols[2]].to_numpy(), df[cols[3]].to_numpy()
        a2, r2 = df[cols[4]].to_numpy(), df[cols[5]].to_numpy()
        min_depth = args.min_depth
    res = bsa_analysis(chrom, pos, a1, r1, a2, r2,
                       window_bp=args.window, min_depth=min_depth)
    out = pd.DataFrame(
        {
            "chrom": res.chrom, "pos": res.pos,
            "snp_index1": res.snp_index1, "snp_index2": res.snp_index2,
            "delta_snp_index": res.delta, "ED": res.ed,
            "G": res.g_stat, "Gprime": res.g_prime,
        }
    )
    path = prefix + ".bsa.tsv"
    out.to_csv(path, sep="\t", index=False, float_format="%.6g")
    print(path)
    return 0
