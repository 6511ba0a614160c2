"""`jx garfield` — logic-rule (epistasis) association search
(reference: src/garfield/ + script/garfield CLI)."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx garfield") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="AND/XOR logic-rule search")
    common.add_genotype_args(p)
    common.add_pheno_args(p)
    common.add_qc_args(p)
    o = p.add_argument_group("Search")
    o.add_argument("-depth", "--depth", type=int, default=2, help="max rule depth")
    o.add_argument("-beam", "--beam", type=int, default=64, help="beam width")
    o.add_argument("-perm", "--perm", type=int, default=100, help="permutations")
    o.add_argument("-grm", "--grm-residualize", action="store_true",
                   help="residualize on the GRM (mixed-model residuals)")
    o.add_argument("-seed", "--seed", type=int, default=0)
    o.add_argument("-binary", "--binary", action="store_true",
                   help="force binary-trait MCC scoring (auto-detected for 0/1 traits)")
    o.add_argument("-preselect", "--preselect", type=int, default=0,
                   help="ML feature pre-selection: keep top-K markers before the beam")
    o.add_argument("-bin", "--bin", type=str, default=None, metavar="PATH",
                   help="search a BIN01 0/1 feature matrix (k-mer presence) "
                   "instead of genotype hom-alt indicators")
    o.add_argument("-windows", "--windows", type=float, default=None, metavar="KB",
                   help="window-restricted scans of this size in kb")
    o.add_argument("-w", "--window", dest="window_args", nargs="*",
                   default=None, metavar=("EXT", "STEP"),
                   help="window scan, reference spelling: EXT kb and "
                   "optional STEP kb (EXT also extends -g gene spans)")
    o.add_argument("-g", "--genefile", type=str, default=None, metavar="FILE",
                   help="gene / gene-set scan: one gene name per line "
                   "(optional 2nd column = set id groups genes into one "
                   "scan unit); needs -gff (reference -g)")
    o.add_argument("-gff", "--gff3", dest="gff", type=str, default=None,
                   help="GFF3 annotation (for -g gene spans)")
    o.add_argument("-layer", "--layer", type=int, default=None,
                   help="alias of -depth (reference -layer; default 2)")
    o.add_argument("-width", "--width", type=int, default=None,
                   help="unified width: sets the beam width AND the ML "
                   "preselect top-k (reference -width)")
    o.add_argument("-topk", "--topk", type=int, default=None,
                   help="top rules kept per scan unit (reference -topk)")
    o.add_argument("-lmaf", "--lmaf", type=float, default=None,
                   help="min frequency of a logic/pseudo-SNP indicator "
                   "(maps to the rule support floor: ceil(lmaf * n); "
                   "reference -lmaf, auto = 30/n)")
    o.add_argument("-engine", "--engine", type=str.upper,
                   choices=("CORR", "RF", "GBDT"), default="CORR",
                   help="ML engine for the preselect screen "
                   "(reference -engine; CORR is the univariate+pair "
                   "screen, RF/GBDT use sklearn importances)")
    # reference dev/compat flags accepted for drop-in command lines:
    # whole-genome is the default scan mode here, XOR gates are always in
    # the beam, and row stats are computed once per trait
    for names in (("-wg", "--whole-genome"), ("-global", "--global"),
                  ("-no-clean", "--no-clean"), ("-nf-xor", "--nf-xor"),
                  ("--xor-search",), ("-dev", "--dev")):
        o.add_argument(*names, action="store_true", help=argparse.SUPPRESS,
                       dest="compat_" + names[-1].strip("-").replace("-", "_"))
    o.add_argument("-gain", "--gain-layer", dest="gain_layer", type=int,
                   default=None, help=argparse.SUPPRESS)
    # --max-pick is the reference's own -layer compat alias (functional)
    o.add_argument("--max-pick", dest="layer_compat", type=int,
                   default=None, help=argparse.SUPPRESS)
    # reference dev shims whose mechanism has no analog here — accepted
    # and warn-logged (never silently swallowed)
    common.add_compat_flags(p, [
        ("--scan-mode",
         {"choices": ("window", "gene", "genepair", "geneset",
                      "wholegenome")},
         "the scan mode is selected directly by -w (window), -g (gene/"
         "gene-set) or -bin; whole-genome is the default"),
        ("--fold", {"type": int},
         "no CV-fold stage exists in this search; permutation maxT is "
         "the calibration"),
        ("--prior-not", {"type": float},
         "NOT literals carry no prior reweighting here; the beam scores "
         "them on equal footing"),
        ("--feature-source", {"choices": ("bin", "mbin")},
         "features come from the packed hom-alt bitplanes (use -bin for "
         "a BIN01 matrix input)"),
        ("--raw-design", {"action": "store_true"},
         "the design matrix is always the raw 0/1 indicators here"),
        (("-simbench", "--simbench"), {"type": str},
         "use `jx garfieldbench` for the planted-gate benchmark"),
    ], group=o)
    o.add_argument("-pm", "--permutation", dest="perm_quantile", type=str,
                   default=None,
                   help="permutation-null significance threshold: gev "
                        "(Gumbel fit at q=0.99), gNN/gNN.N (GEV at NN%%), "
                        "qNN (empirical quantile), or a float in (0,1); "
                        "adds a `sig` column to the rule TSVs")
    o.add_argument("-m", "--meff", type=int, default=None,
                   help="effective test count for FDR correction of the "
                        "rule p-values (adds a `pfdr` column; default "
                        "uses the rule count)")
    o.add_argument("-bimrange", "--bimrange", action="append", default=None,
                   help="restrict the scan to chr:start-end ranges "
                   "(repeatable)")
    common.add_compat_thread_arg(p)
    common.add_out_args(p, default_prefix="garfield")
    return p


def _main_bin(args, prefix: str, pm=None) -> int:
    """Rule search over a BIN01 0/1 feature matrix (k-mer presence bits —
    reference garfield window/bin scans, src/lib.rs:751-767)."""
    import numpy as np

    from janusx_tpu_torch.io import bin01
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.garfield import (
        garfield_scan_features,
        rule_null_threshold,
    )
    from janusx_tpu_torch.models.scan_common import analysis_sample_index

    bm = bin01.read_bin01(args.bin)
    samples = bin01.read_samples(bm.path, bm.n_samples)
    sites = bm.sites()
    names = np.array(
        [
            (s if isinstance(s, str) else f"{s[0]}:{s[1]}")
            for s in (sites or [])
        ]
        + [f"b{i}" for i in range(len(sites or []), bm.n_rows)],
        object,
    )
    ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
    y_all, _ = ph.align(samples)
    dense = bm.dense()
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        keep = analysis_sample_index(y)
        B = dense[:, keep]
        ttype = "binary" if args.binary else "auto"
        res = garfield_scan_features(
            B, y[keep], depth=args.depth, beam=args.beam, n_perm=args.perm,
            seed=args.seed, trait_type=ttype, preselect=args.preselect,
        )
        thr = (rule_null_threshold(res.perm_max_scores, *pm)
               if pm is not None else None)
        path = f"{prefix}.{trait}.garfield.bin.tsv"
        with open(path, "wt") as fh:
            fh.write("rule\tdepth\tsupport\tscore\tpperm"
                     + ("\tsig" if thr is not None else "") + "\n")
            for ru, pv in zip(res.rules, res.pvalues):
                fh.write(
                    f"{ru.describe(names)}\t{len(ru.snps)}\t{ru.support}"
                    f"\t{ru.score:.6g}\t{pv:.4g}"
                    + (f"\t{int(ru.score >= thr)}" if thr is not None else "")
                    + "\n"
                )
        best = res.rules[0] if res.rules else None
        if best:
            print(f"{trait}\ttop: {best.describe(names)}\t"
                  f"score={best.score:.4g}\tp={res.pvalues[0]:.4g}\t{path}")
        else:
            print(f"{trait}\tno rules\t{path}")
    return 0


def _engine_preselect(pg, y, engine: str, top_k: int, seed: int):
    """RF/GBDT feature-importance screen over hom-alt indicators."""
    import numpy as np

    B = (pg.dosages() == 2).astype(np.float32)
    if engine == "RF":
        from sklearn.ensemble import RandomForestRegressor

        mdl = RandomForestRegressor(n_estimators=200, random_state=seed,
                                    n_jobs=-1)
    else:
        from sklearn.ensemble import HistGradientBoostingRegressor

        mdl = HistGradientBoostingRegressor(random_state=seed)
    mdl.fit(B.T, y)
    if hasattr(mdl, "feature_importances_"):
        imp = mdl.feature_importances_
    else:  # HistGBDT: permutation-free proxy via split counts is not
        # exposed — use univariate |corr| fallback weighted by prediction
        from sklearn.inspection import permutation_importance

        imp = permutation_importance(
            mdl, B.T, y, n_repeats=3, random_state=seed
        ).importances_mean
    return np.sort(np.argsort(imp)[::-1][: min(top_k, len(imp))])


def _main_genes(args, prefix, trait, pg, y, K, ttype, depth, beam,
                preselect, min_support, window_kb):
    """-g gene / gene-set scans: each gene's span (± EXT kb from -w)
    is one scan unit; a 2-column file groups genes into sets scanned
    jointly (reference -g FILE semantics + -gff spans)."""
    import numpy as np

    from janusx_tpu_torch.models.garfield import garfield_scan
    from janusx_tpu_torch.utils.gff import GffIndex

    if not args.gff:
        raise SystemExit("-g needs -gff for gene spans")
    gi = GffIndex.from_file(args.gff)
    by_name = {g.name: g for genes in gi.by_chrom.values() for g in genes}
    units: dict[str, list] = {}
    with open(args.genefile) as fh:
        for line in fh:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            units.setdefault(toks[1] if len(toks) > 1 else toks[0],
                             []).append(toks[0])
    ext = int((window_kb or 0) * 1000)
    chrom = pg.sites.chrom.astype(str)
    pos = np.asarray(pg.sites.pos, np.int64)
    path = f"{prefix}.{trait}.garfield.genes.tsv"
    n_units = 0
    with open(path, "wt") as fh:
        fh.write("unit\tgenes\tn_snps\trule\tdepth\tsupport\tscore\tpperm\n")
        for unit, genes in units.items():
            mask = np.zeros(pg.m, bool)
            found = []
            for gname in genes:
                g = by_name.get(gname)
                if g is None:
                    continue
                found.append(gname)
                mask |= ((chrom == str(g.chrom)) & (pos >= g.start - ext)
                         & (pos <= g.end + ext))
            rows = np.nonzero(mask)[0]
            if len(rows) < 2:
                continue
            n_units += 1
            res = garfield_scan(
                pg, y, K=K, depth=depth, beam=beam, n_perm=args.perm,
                seed=args.seed, trait_type=ttype, preselect=preselect,
                min_support=min_support, top_rules=(args.topk or 3),
                snp_subset=rows,
            )
            for ru, pv in zip(res.rules, res.pvalues):
                fh.write(
                    f"{unit}\t{','.join(found)}\t{len(rows)}\t"
                    f"{ru.describe(pg.sites.snp)}\t{len(ru.snps)}\t"
                    f"{ru.support}\t{ru.score:.6g}\t{pv:.4g}\n"
                )
    print(f"{trait}\t{n_units} gene units\t{path}")
    return path


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "garfield")
    common.warn_ignored_compat(parser, args)

    import numpy as np

    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.garfield import (
        garfield_scan,
        parse_pm_spec,
        rule_null_threshold,
        write_garfield_tsv,
    )
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.scan_common import analysis_sample_index

    pm = (parse_pm_spec(args.perm_quantile)
          if args.perm_quantile is not None else None)
    if args.bin:
        return _main_bin(args, prefix, pm)
    raw = load_raw_packed(common.resolve_genotype(args))
    ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
    y_all, _ = ph.align(raw.samples)
    qc = QcParams(maf=args.maf, geno=args.geno, het=args.het)
    outputs = []
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        keep = analysis_sample_index(y)
        pg = raw.prepare(qc, sample_idx=keep)
        if args.bimrange:
            from janusx_tpu_torch.workflows.gwas import _range_mask

            idx = _range_mask(pg.sites, args.bimrange)
            if idx.size == 0:
                raise SystemExit("no markers inside -bimrange")
            pg = pg.take_snps(idx)
        K = grm_from_packed(pg) if args.grm_residualize else None
        ttype = "binary" if args.binary else "auto"
        layer = (args.layer if args.layer is not None
                 else args.layer_compat)  # --max-pick = reference alias
        depth = layer if layer is not None else args.depth
        beam = args.width if args.width is not None else args.beam
        preselect = (args.width if args.width is not None
                     else args.preselect)
        min_support = (max(int(np.ceil(args.lmaf * len(keep))), 1)
                       if args.lmaf is not None else 5)
        window_kb, step_kb = args.windows, None
        if args.window_args is not None:
            window_kb = (float(args.window_args[0])
                         if args.window_args else 500.0)
            if len(args.window_args) > 1:
                step_kb = float(args.window_args[1])
        if args.genefile:
            # one gene-scan TSV per trait — do NOT return here, or every
            # trait after the first is silently skipped
            outputs.append(_main_genes(
                args, prefix, trait, pg, y[keep], K, ttype,
                depth, beam, preselect, min_support, window_kb))
            continue
        if window_kb:
            from janusx_tpu_torch.models.garfield import garfield_window_scan

            wins = garfield_window_scan(
                pg, y[keep], window_kb=window_kb, step_kb=step_kb, K=K,
                depth=depth, beam=beam, n_perm=args.perm, seed=args.seed,
                trait_type=ttype, preselect=preselect,
                top_per_window=(args.topk or 3),
            )
            path = f"{prefix}.{trait}.garfield.windows.tsv"
            with open(path, "wt") as fh:
                fh.write("chrom\tstart\tend\trule\tdepth\tsupport\tscore"
                         "\tpperm" + ("\tsig" if pm is not None else "")
                         + "\n")
                for c, s, e, r in wins:
                    # -pm: per-window permutation-null threshold (each
                    # window is its own calibrated scan unit)
                    wthr = (rule_null_threshold(r.perm_max_scores, *pm)
                            if pm is not None else None)
                    for ru, pv in zip(r.rules, r.pvalues):
                        fh.write(
                            f"{c}\t{s}\t{e}\t{ru.describe(pg.sites.snp)}\t"
                            f"{len(ru.snps)}\t{ru.support}\t{ru.score:.6g}"
                            f"\t{pv:.4g}"
                            + (f"\t{int(ru.score >= wthr)}"
                               if wthr is not None else "") + "\n"
                        )
            outputs.append(path)
            print(f"{trait}\t{len(wins)} windows\t{path}")
            continue
        snp_subset = None
        if args.engine != "CORR" and preselect:
            # sklearn importance screens (reference -engine RF/GBDT,
            # src/ml/engine.rs): rank hom-alt indicators by ensemble
            # feature importance, then beam-search the top slice
            snp_subset = _engine_preselect(
                pg, y[keep], args.engine, preselect, args.seed)
            preselect = 0
        res = garfield_scan(
            pg, y[keep], K=K, depth=depth, beam=beam,
            n_perm=args.perm, seed=args.seed, trait_type=ttype,
            preselect=preselect, min_support=min_support,
            top_rules=(args.topk or 50), snp_subset=snp_subset,
        )
        thr = None
        if pm is not None:
            thr = rule_null_threshold(res.perm_max_scores, *pm)
            n_sig = sum(1 for ru in res.rules if ru.score >= thr)
            print(f"{trait}\t-pm {args.perm_quantile}: {pm[0]} threshold "
                  f"= {thr:.6g} ({n_sig}/{len(res.rules)} rules significant)")
        path = f"{prefix}.{trait}.garfield.tsv"
        write_garfield_tsv(path, res, pg.sites, score_threshold=thr,
                           meff=args.meff)
        outputs.append(path)
        best = res.rules[0] if res.rules else None
        if best:
            print(
                f"{trait}\ttop: {best.describe(pg.sites.snp)}\t"
                f"score={best.score:.4g}\tp={res.pvalues[0]:.4g}\t{path}"
            )
    return 0
