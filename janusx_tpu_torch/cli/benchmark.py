"""`jx benchmark` — built-in performance benchmarks on simulated data
(reference: script/benchmark.py, gblupbench.py, bayesbench.py)."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx benchmark") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Time core kernels on simulated data")
    p.add_argument("-dev", "--dev", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("-nind", "--nind", type=int, default=2000)
    p.add_argument("-nsnp", "--nsnp", type=int, default=50_000)
    p.add_argument("-modules", "--modules", type=str,
                   default="grm,lmm,fvlmm,splmm,gblup,bayesa",
                   help="comma-separated: "
                        "grm,pca,lm,lmm,fvlmm,splmm,gblup,bayesa,farmcpu")
    p.add_argument("-repeats", "--repeats", type=int, default=3)
    p.add_argument("-seed", "--seed", type=int, default=0)
    f = p.add_argument_group(
        "FarmCPU benchmark (reference script/benchmark.py — its rMVP "
        "comparison harness; the internal cross-check here compares the "
        "raw -farmcpu route against the unified -frgwas route)")
    f.add_argument("--kernels", type=str, default="janusx",
                   help="comma list; 'janusx' runs here, 'rmvp' needs the "
                        "external R engine and is warn-skipped")
    f.add_argument("--check", action="store_true",
                   help="with modules=farmcpu: also run the unified route "
                        "and report pseudo-QTN overlap between the routes")
    f.add_argument("--pseudo-qtn-match", type=str, default="exact",
                   choices=("exact", "ld"),
                   help="overlap rule for --check: exact index match, or "
                        "LD r^2 >= --pseudo-qtn-ld-r2")
    f.add_argument("--pseudo-qtn-ld-r2", type=float, default=0.7)
    f.add_argument("--force-pseudo-qtn-cap", type=int, default=None,
                   help="override the pseudo-QTN cap in both routes (raw: "
                        "the QTN bound; unified: the merge cap)")
    f.add_argument("--topk", type=int, default=100,
                   help="top-k SNP table size written per scan")
    f.add_argument("-q", "--qcov", type=int, default=0,
                   help="number of PCA covariates for the scans")
    f.add_argument("--farmcpu-iter", type=int, default=30)
    f.add_argument("--farmcpu-threshold", type=float, default=None)
    f.add_argument("--farmcpu-nbin", type=int, default=5)
    f.add_argument("--farmcpu-bound", type=int, default=None)
    f.add_argument("--farmcpu-bin-size", type=str,
                   default="500000,5000000,50000000")
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident; no chunked decode stage"),
        (("-mmap-limit", "--mmap-limit"), {"action": "store_true"},
         "no mmap decode path; use -mem for the windowed disk-backed route"),
        ("--keep-temp", {"action": "store_true"},
         "no temporary files are written"),
        ("--rmvp-reuse-cache", {"action": "store_true"},
         "the external rMVP engine is not bundled"),
        ("--rmvp-debug-seqqtn", {"action": "store_true"},
         "the external rMVP engine is not bundled"),
    ])
    common.add_out_args(p, default_prefix="bench")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "benchmark")
    common.warn_ignored_compat(parser, args)
    kernels = [t.strip().lower() for t in args.kernels.split(",") if t.strip()]
    if "rmvp" in kernels:
        import logging

        logging.getLogger("janusx_tpu.cli").warning(
            "--kernels rmvp: the external rMVP R engine is not bundled; "
            "running the janusx kernel only (reference comparison archive: "
            "scripts/benchmark.sh)")

    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.sim import simulate_genotypes, simulate_phenotype

    modules = [m.strip().lower() for m in args.modules.split(",") if m.strip()]
    gd = simulate_genotypes(args.nind, args.nsnp, seed=args.seed)
    sim = simulate_phenotype(gd, n_qtl=100, h2=0.5, seed=args.seed)
    y = sim.phenotypes[:, 0]
    pg = pack_genotypes(gd, QcParams())
    results = []

    def timeit(name, fn, unit_count=None, unit="SNPs"):
        fn()  # warm (compile)
        ts = []
        for _ in range(args.repeats):
            t0 = time.monotonic()
            fn()
            ts.append(time.monotonic() - t0)
        best = min(ts)
        row = {"module": name, "seconds": round(best, 4)}
        if unit_count:
            row["rate"] = round(unit_count / best, 1)
            row["unit"] = f"{unit}/s"
        results.append(row)
        print(f"{name}\t{best:.3f}s" + (f"\t{row.get('rate', ''):,} {unit}/s" if unit_count else ""))

    K = basis = None
    if {"grm", "lmm", "fvlmm", "splmm", "gblup", "pca"} & set(modules):
        timeit("grm", lambda: grm_from_packed(pg), pg.m)
        K = grm_from_packed(pg)
    if {"lmm", "fvlmm"} & set(modules):
        basis = eigh_grm(K, diag_ridge=1e-6)
    if "pca" in modules:
        from janusx_tpu_torch.models.pca import rsvd_pca

        timeit("pca_rsvd", lambda: rsvd_pca(pg, n_pc=10))
    if "lm" in modules:
        from janusx_tpu_torch.models.lm import lm_scan

        timeit("lm_scan", lambda: lm_scan(pg, y), pg.m)
    if "lmm" in modules:
        from janusx_tpu_torch.models.lmm import lmm_scan

        null = lmm_scan(pg, basis, y)[1]
        timeit("lmm_scan", lambda: lmm_scan(pg, basis, y, null=null), pg.m)
    if "fvlmm" in modules:
        from janusx_tpu_torch.models.fvlmm import fvlmm_scan

        timeit("fvlmm_scan", lambda: fvlmm_scan(pg, basis, y), pg.m)
    if "splmm" in modules:
        from janusx_tpu_torch.models.splmm import splmm_grammar_scan

        timeit("splmm_scan", lambda: splmm_grammar_scan(pg, K, y), pg.m)
    if "gblup" in modules:
        from janusx_tpu_torch.gs.blup import fit_gblup

        train = np.arange(int(pg.n * 0.8))
        timeit("gblup_fit", lambda: fit_gblup(K, y, train))
    if "bayesa" in modules:
        from janusx_tpu_torch.gs.bayes import bayes_fit

        var = 2 * pg.af * (1 - pg.af)
        inv = np.where(var > 0, 1 / np.sqrt(var), 0.0)
        Z = (pg.centered() * inv[:, None]).T.astype(np.float32)
        timeit("bayesa_fit_400it", lambda: bayes_fit(Z, y, "BayesA"))
    if "farmcpu" in modules:
        # reference script/benchmark.py harness: FarmCPU timing +
        # pseudo-QTN cross-check (vs rMVP there; vs the unified -frgwas
        # route here — 49/49 exact parity is the reference's own bar,
        # doc/release/v1.0.26.md:49)
        from janusx_tpu_torch.models.farmcpu import farmcpu_scan, farmcpu_unified_scan

        cov = None
        if args.qcov > 0:
            from janusx_tpu_torch.models.pca import rsvd_pca

            _, pcs = rsvd_pca(pg, n_pc=args.qcov)
            cov = np.asarray(pcs, np.float64)
        fc_kw = dict(
            covariates=cov, p_threshold=args.farmcpu_threshold,
            max_loops=args.farmcpu_iter, nbin=args.farmcpu_nbin,
        )
        bins = tuple(int(float(x)) for x in args.farmcpu_bin_size.split(",")
                     if x.strip())
        t0 = time.monotonic()
        raw_bound = (args.force_pseudo_qtn_cap
                     if args.force_pseudo_qtn_cap else args.farmcpu_bound)
        raw = farmcpu_scan(pg, y, window_sizes=bins,
                           qtn_bound=raw_bound, **fc_kw)
        sec = time.monotonic() - t0
        results.append({"module": "farmcpu", "seconds": round(sec, 4),
                        "qtns": [int(i) for i in raw.qtns],
                        "loops": raw.loops})
        print(f"farmcpu\t{sec:.3f}s\t{len(raw.qtns)} pseudo-QTNs "
              f"({raw.loops} loops)")
        order = np.argsort(raw.result.pwald)[: args.topk]
        with open(prefix + f".farmcpu.top{args.topk}.tsv", "wt") as fh:
            fh.write("snp\tchrom\tpos\tpwald\n")
            for i in order:
                fh.write(f"{pg.sites.snp[i]}\t{pg.sites.chrom[i]}\t"
                         f"{pg.sites.pos[i]}\t{raw.result.pwald[i]:.4e}\n")
        if args.check:
            t0 = time.monotonic()
            uni = farmcpu_unified_scan(
                pg, y, covariates=cov, p_threshold=args.farmcpu_threshold,
                max_loops=args.farmcpu_iter, nbin=args.farmcpu_nbin,
                qtn_bound=args.farmcpu_bound,
                **({"qtn_cap": args.force_pseudo_qtn_cap}
                   if args.force_pseudo_qtn_cap else {}),
            )
            sec_u = time.monotonic() - t0
            a, b = set(map(int, raw.qtns)), set(map(int, uni.qtns))
            if args.pseudo_qtn_match == "exact":
                overlap = len(a & b)
            else:
                # LD-aware overlap: a raw QTN counts if some unified QTN
                # tags it at r^2 >= threshold
                thr = args.pseudo_qtn_ld_r2
                X = pg.centered()
                overlap = 0
                for i in a:
                    for j in b:
                        xi, xj = X[i], X[j]
                        denom = xi.std() * xj.std()
                        r = (np.mean(xi * xj) / denom) if denom > 0 else 0.0
                        if r * r >= thr:
                            overlap += 1
                            break
            results.append({"module": "farmcpu_check",
                            "seconds": round(sec_u, 4),
                            "raw_qtns": len(a), "unified_qtns": len(b),
                            "overlap": overlap,
                            "match": args.pseudo_qtn_match})
            print(f"farmcpu_check\t{sec_u:.3f}s\toverlap {overlap}/"
                  f"{max(len(a), 1)} ({args.pseudo_qtn_match})")

    with open(prefix + ".benchmark.json", "wt") as fh:
        json.dump(
            {"n": pg.n, "m": pg.m, "results": results}, fh, indent=2
        )
    print(prefix + ".benchmark.json")
    return 0


def _bench_problem(nind, nsnp, h2, seed, test_frac=0.2):
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models.sim import simulate_genotypes, simulate_phenotype

    gd = simulate_genotypes(nind, nsnp, seed=seed)
    sim = simulate_phenotype(gd, n_qtl=max(20, nsnp // 100), h2=h2, seed=seed)
    y = sim.phenotypes[:, 0]
    pg = pack_genotypes(gd, QcParams())
    n_test = int(nind * test_frac)
    return pg, y, np.arange(nind - n_test), np.arange(nind - n_test, nind), sim


def gblupbench_main(argv=None) -> int:
    """`jx gblupbench` — GBLUP/rrBLUP route benchmark: CV timing + holdout
    accuracy per route (reference: script/gblupbench.py)."""
    p = argparse.ArgumentParser(prog="jx gblupbench")
    p.add_argument("-dev", "--dev", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-nind", "--nind", type=int, default=2000)
    p.add_argument("-nsnp", "--nsnp", type=int, default=20_000)
    p.add_argument("-h2", "--h2", type=float, default=0.5)
    p.add_argument("-cv", "--cv", type=int, default=5)
    p.add_argument("--run-folds", type=int, default=None,
                   help="how many CV folds to execute (default: all); "
                        "remaining folds are skipped")
    p.add_argument("--engines", type=str, default="gblup,rrblup_pcg",
                   help="comma list: gblup,rrblup_pcg")
    p.add_argument("--check", action="store_true",
                   help="cross-check the two routes: assert the holdout "
                        "predictions of GBLUP and rrBLUP-PCG correlate")
    p.add_argument("-limit-predtrain", "--limit-predtrain", "-limit-train",
                   "--limit-train", dest="limit_predtrain", type=int,
                   default=None, help="subsample the training set")
    p.add_argument("-limit-mem", "--limit-mem", type=float, default=None,
                   metavar="GB", help="host memory budget (see -mem)")
    p.add_argument("-seed", "--seed", type=int, default=0)
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident; no chunked decode stage"),
        ("--keep-temp", {"action": "store_true"},
         "no temporary files are written"),
    ])
    common.add_out_args(p, default_prefix="gblupbench")
    args = p.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gblupbench")
    common.warn_ignored_compat(p, args)
    if args.limit_mem is not None:
        args.mem = args.limit_mem
        common.apply_mem_budget(args)

    from janusx_tpu_torch.gs.blup import fit_gblup, fit_gblup_cg, predict_gblup
    from janusx_tpu_torch.gs.kfold import KFold
    from janusx_tpu_torch.gs.metrics import regression_metrics
    from janusx_tpu_torch.models.grm import grm_from_packed

    pg, y, train, test, _ = _bench_problem(args.nind, args.nsnp, args.h2,
                                           args.seed)
    if args.limit_predtrain is not None and len(train) > args.limit_predtrain:
        rng = np.random.default_rng(args.seed)
        train = np.sort(rng.choice(train, size=args.limit_predtrain,
                                   replace=False))
    engines = {"gblup": "GBLUP", "rrblup_pcg": "rrBLUP-PCG",
               "rrblup-pcg": "rrBLUP-PCG", "rrblup": "rrBLUP-PCG"}
    routes = []
    for tok in args.engines.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok not in engines:
            raise SystemExit(f"--engines: unknown {tok!r} "
                             f"(choose from gblup,rrblup_pcg)")
        if engines[tok] not in routes:
            routes.append(engines[tok])
    t0 = time.monotonic()
    K = grm_from_packed(pg)
    t_grm = time.monotonic() - t0
    rows = []
    test_preds = {}
    print(f"n={pg.n} m={pg.m} grm={t_grm:.2f}s")
    print("route\tcv_s\tfit_s\tcv_r\ttest_r")
    for route in routes:
        kf = KFold(args.cv, shuffle=True, random_state=args.seed)
        t0 = time.monotonic()
        rs = []
        folds = list(kf.split(len(train)))
        if args.run_folds is not None:
            folds = folds[: max(args.run_folds, 1)]
        for tr, va in folds:
            if route == "GBLUP":
                mdl = fit_gblup(K, y, train[tr])
                pv = predict_gblup(mdl, K, train[va])
            else:
                mdl0 = fit_gblup(K, y, train[tr])
                alpha, beta0 = fit_gblup_cg(K, y, train[tr], mdl0.lbd)
                pv = K[np.ix_(train[va], train[tr])] @ alpha + beta0[0]
            rs.append(regression_metrics(y[train[va]], pv)["pearson"])
        cv_s = time.monotonic() - t0
        t0 = time.monotonic()
        if route == "GBLUP":
            mdl = fit_gblup(K, y, train)
            pv = predict_gblup(mdl, K, test)
        else:
            mdl0 = fit_gblup(K, y, train)
            alpha, beta0 = fit_gblup_cg(K, y, train, mdl0.lbd)
            pv = K[np.ix_(test, train)] @ alpha + beta0[0]
        fit_s = time.monotonic() - t0
        test_preds[route] = pv
        test_r = regression_metrics(y[test], pv)["pearson"]
        rows.append({"route": route, "cv_seconds": round(cv_s, 3),
                     "fit_seconds": round(fit_s, 3),
                     "cv_pearson": round(float(np.mean(rs)), 4),
                     "test_pearson": round(float(test_r), 4)})
        print(f"{route}\t{cv_s:.2f}\t{fit_s:.2f}\t{np.mean(rs):.3f}\t{test_r:.3f}")
    if args.check and len(test_preds) >= 2:
        # cross-route sanity: the two solvers answer the same problem
        pa, pb = (test_preds[r] for r in routes[:2])
        rr = float(np.corrcoef(pa, pb)[0, 1])
        print(f"check\t{routes[0]} vs {routes[1]} holdout corr={rr:.4f}")
        if not rr > 0.95:
            raise SystemExit(f"--check FAILED: route predictions diverge "
                             f"(corr={rr:.4f})")
    with open(prefix + ".gblupbench.json", "wt") as fh:
        json.dump({"n": pg.n, "m": pg.m, "grm_seconds": round(t_grm, 3),
                   "routes": rows}, fh, indent=2)
    print(prefix + ".gblupbench.json")
    return 0


def bayesbench_main(argv=None) -> int:
    """`jx bayesbench` — Bayes A/B/Cpi vs BLUP: chain timing, holdout
    accuracy, and multi-chain R-hat convergence diagnostics
    (reference: script/bayesbench.py kernel/convergence/compare)."""
    p = argparse.ArgumentParser(prog="jx bayesbench")
    common.add_genotype_args(p, required=False)
    p.add_argument("-p", "--pheno", type=str, default=None,
                   help="phenotype table (real-data mode; else simulated)")
    p.add_argument("-n", "--ncol", "--trait", dest="ncol", type=str,
                   default=None, help="trait selector for -p")
    p.add_argument("-nind", "--nind", "--n-samples", dest="nind", type=int,
                   default=1500)
    p.add_argument("-nsnp", "--nsnp", "--n-snps", dest="nsnp", type=int,
                   default=10_000)
    p.add_argument("-h2", "--h2", type=float, default=0.5)
    p.add_argument("--methods", type=str, default="BayesA,BayesB,BayesCpi",
                   help="comma list from BayesA,BayesB,BayesCpi")
    p.add_argument("-iters", "--iters", "--n-iter", dest="iters", type=int,
                   default=2000)
    p.add_argument("-burnin", "--burnin", type=int, default=500)
    p.add_argument("-thin", "--thin", type=int, default=5)
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("--repeat", type=int, default=1,
                   help="repeat count per method (best time reported)")
    p.add_argument("--train-size", type=int, default=None,
                   help="training sample size (default: 1 - test-frac)")
    p.add_argument("--test-frac", type=float, default=0.2,
                   help="held-out test fraction")
    p.add_argument("--split-seed", type=int, default=None,
                   help="train/test split seed (default: --seed)")
    p.add_argument("--max-snps", type=int, default=None,
                   help="random cap on active SNPs after QC")
    g = p.add_argument_group("Prior hyperparameters (BGLR-rule defaults)")
    g.add_argument("--r2", type=float, default=0.5,
                   help="fixed R2 prior: S0_b derives from it")
    g.add_argument("--counts", type=float, default=10.0,
                   help="prior counts for the inclusion probability")
    g.add_argument("--prob-in", type=float, default=0.5,
                   help="prior inclusion probability (BayesB/Cpi)")
    g.add_argument("--df0-b", type=float, default=5.0)
    g.add_argument("--df0-e", type=float, default=5.0)
    c = p.add_argument_group("Convergence diagnostics (multi-chain)")
    c.add_argument("--chains", type=int, default=1,
                   help=">1 runs independent chains and reports split R-hat "
                        "on the global parameters (mu, var_e)")
    c.add_argument("--chain-seeds", type=str, default=None,
                   help="comma list of explicit chain seeds")
    c.add_argument("--rhat-threshold", type=float, default=1.05)
    c.add_argument("--stable-min-kept", type=int, default=100,
                   help="minimum kept posterior samples per chain before "
                        "stability can be declared")
    c.add_argument("--top-k-beta", type=int, default=20,
                   help="consensus top-k posterior-mean beta rows to report")
    c.add_argument("--top-beta-cutoffs", type=str, default="100,1000",
                   help="comma list of top-|beta| cutoffs for cross-chain "
                        "concordance")
    common.add_compat_flags(p, [
        ("--builtin", {"choices": ("wheat",)},
         "the BGLR wheat dataset is not bundled; use real -bfile/-p inputs"),
        ("--rscript", {"type": str},
         "no R reference engines are bundled (BGLR/HiBayes comparisons "
         "run from scripts/benchmark archives)"),
        ("--reference", {"type": str},
         "no R reference engines are bundled"),
        ("--cache-input", {"action": "store_true"},
         "inputs load through the standard packed cache already"),
        ("--row-block", {"type": str},
         "the block-MVN sampler picks its own block size"),
        ("--snp-block-size", {"type": int},
         "prediction runs as one device matmul here"),
        ("--sample-chunk-size", {"type": int},
         "prediction runs as one device matmul here"),
        ("--shape0", {"type": float},
         "marker-variance prior is parameterized by --r2/--df0-b "
         "(scaled-inv-chi2), not shape/rate"),
        ("--rate0", {"type": float},
         "marker-variance prior is parameterized by --r2/--df0-b"),
        ("--s0-b", {"type": float},
         "S0_b derives from --r2 via the BGLR rule"),
        ("--s0-e", {"type": float},
         "S0_e derives from --r2 via the BGLR rule"),
        ("--parallel-chains", {"type": int},
         "chains run sequentially on the single visible chip"),
        ("--plot-top-k-beta", {"type": int},
         "no beta-trace figure is rendered; traces land in the JSON"),
        ("--global-only", {"action": "store_true"},
         "global-parameter traces are always recorded (no second rerun "
         "is needed)"),
    ])
    common.add_out_args(p, default_prefix="bayesbench")
    args = p.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "bayesbench")
    common.warn_ignored_compat(p, args)

    from janusx_tpu_torch.gs.bayes import bayes_fit
    from janusx_tpu_torch.gs.blup import fit_gblup, predict_gblup
    from janusx_tpu_torch.gs.metrics import regression_metrics
    from janusx_tpu_torch.models.grm import grm_from_packed

    geno = common.resolve_genotype_optional(args)
    split_seed = args.seed if args.split_seed is None else args.split_seed
    if geno is not None:
        # real-data mode (reference compare-path inputs)
        from janusx_tpu_torch.io.gfreader import prepare_packed
        from janusx_tpu_torch.io.packed import QcParams
        from janusx_tpu_torch.io.pheno import load_phenotype

        pg = prepare_packed(geno, QcParams())
        if args.pheno is None:
            raise SystemExit("real-data mode needs -p PHENO")
        ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
        vals, _ = ph.align(pg.samples)
        y = vals[:, 0]
        obs = np.nonzero(np.isfinite(y))[0]
        rng = np.random.default_rng(split_seed)
        perm = rng.permutation(obs)
        n_test = max(1, int(len(obs) * args.test_frac))
        test, train = perm[:n_test], np.sort(perm[n_test:])
        if args.train_size is not None:
            train = np.sort(rng.choice(train, size=min(args.train_size,
                                                       len(train)),
                                       replace=False))
        y = np.nan_to_num(y)
    else:
        pg, y, train, test, _ = _bench_problem(args.nind, args.nsnp, args.h2,
                                               args.seed,
                                               test_frac=args.test_frac)
        if args.train_size is not None:
            rng = np.random.default_rng(split_seed)
            train = np.sort(rng.choice(train, size=min(args.train_size,
                                                       len(train)),
                                       replace=False))
    if args.max_snps is not None and args.max_snps > 0 and pg.m > args.max_snps:
        rng = np.random.default_rng(split_seed + 1)
        keep = np.sort(rng.choice(pg.m, size=args.max_snps, replace=False))
        pg = pg.take_snps(keep)
    var = 2 * pg.af * (1 - pg.af)
    inv = np.where(var > 0, 1 / np.sqrt(var), 0.0)
    Z = (pg.centered() * inv[:, None]).T.astype(np.float32)
    methods = [t.strip() for t in args.methods.split(",") if t.strip()]
    bad = [t for t in methods if t not in ("BayesA", "BayesB", "BayesCpi")]
    if bad:
        raise SystemExit(f"--methods: unknown {bad}")
    prior_kw = dict(r2=args.r2, df0_b=args.df0_b, df0_e=args.df0_e,
                    prob_in=args.prob_in, counts=args.counts)
    chain_seeds = ([int(t) for t in args.chain_seeds.split(",") if t.strip()]
                   if args.chain_seeds else
                   [args.seed + 101 * c for c in range(args.chains)])
    if len(chain_seeds) != args.chains:
        raise SystemExit("--chain-seeds count must match --chains")
    n_kept = max(0, (args.iters - args.burnin) // max(args.thin, 1))
    if args.chains > 1 and n_kept < args.stable_min_kept:
        print(f"warning: only {n_kept} kept samples/chain < "
              f"--stable-min-kept {args.stable_min_kept}; R-hat unreliable")
    rows = []
    print(f"n={pg.n} m={pg.m} iters={args.iters}(burn {args.burnin}) "
          f"chains={args.chains}")
    print("method\tfit_s\ttest_r" + ("\trhat_mu\trhat_ve" if args.chains > 1
                                     else ""))
    K = grm_from_packed(pg)
    t0 = time.monotonic()
    mdl = fit_gblup(K, y, train)
    pv = predict_gblup(mdl, K, test)
    sec = time.monotonic() - t0
    r = regression_metrics(y[test], pv)["pearson"]
    rows.append({"method": "BLUP", "fit_seconds": round(sec, 3),
                 "test_pearson": round(float(r), 4)})
    print(f"BLUP\t{sec:.2f}\t{r:.3f}")
    cutoffs = [int(t) for t in args.top_beta_cutoffs.split(",") if t.strip()]
    for method in methods:
        secs, beta = [], None
        chain_betas, chain_traces = [], []
        for rep in range(max(args.repeat, 1)):
            for cs in chain_seeds:
                t0 = time.monotonic()
                beta, mu, tr = bayes_fit(
                    Z[train], y[train], method, args.iters, args.burnin,
                    args.thin, cs, return_trace=True, **prior_kw)
                secs.append(time.monotonic() - t0)
                if rep == 0:
                    chain_betas.append(beta)
                    chain_traces.append(tr[args.burnin:])
        sec = min(secs)
        pv = mu + Z[test] @ beta
        r = regression_metrics(y[test], pv)["pearson"]
        row = {"method": method, "fit_seconds": round(sec, 3),
               "test_pearson": round(float(r), 4)}
        line = f"{method}\t{sec:.2f}\t{r:.3f}"
        if args.chains > 1:
            rhat_mu = _split_rhat(np.stack([t[:, 0] for t in chain_traces]))
            rhat_ve = _split_rhat(np.stack([t[:, 1] for t in chain_traces]))
            stable = (max(rhat_mu, rhat_ve) <= args.rhat_threshold
                      and n_kept >= args.stable_min_kept)
            # consensus top-k: SNPs in every chain's top-k |beta|
            topk = [set(np.argsort(-np.abs(b))[:args.top_k_beta].tolist())
                    for b in chain_betas]
            consensus = sorted(set.intersection(*topk))
            conc = {}
            for cut in cutoffs:
                tops = [set(np.argsort(-np.abs(b))[:cut].tolist())
                        for b in chain_betas]
                inter = len(set.intersection(*tops))
                conc[str(cut)] = round(inter / max(cut, 1), 4)
            row.update(rhat_mu=round(rhat_mu, 4), rhat_ve=round(rhat_ve, 4),
                       stable=bool(stable),
                       consensus_topk=[int(i) for i in consensus],
                       topk_concordance=conc)
            line += f"\t{rhat_mu:.3f}\t{rhat_ve:.3f}"
        rows.append(row)
        print(line)
    with open(prefix + ".bayesbench.json", "wt") as fh:
        json.dump({"n": pg.n, "m": pg.m, "iters": args.iters,
                   "chains": args.chains, "methods": rows}, fh, indent=2)
    print(prefix + ".bayesbench.json")
    return 0


def _split_rhat(chains: np.ndarray) -> float:
    """Split R-hat (Gelman-Rubin) over (n_chains, n_samples) draws of one
    scalar parameter — the reference bayesbench convergence statistic."""
    c, n = chains.shape
    half = n // 2
    if half < 2:
        return float("nan")
    halves = np.concatenate([chains[:, :half], chains[:, half:2 * half]])
    m, n2 = halves.shape
    means = halves.mean(axis=1)
    B = n2 * np.var(means, ddof=1)
    W = np.mean(np.var(halves, axis=1, ddof=1))
    if W <= 0:
        return 1.0
    var_plus = (n2 - 1) / n2 * W + B / n2
    return float(np.sqrt(var_plus / W))


def garfieldbench_main(argv=None) -> int:
    """`jx garfieldbench` — planted-AND-gate recovery power + search timing
    (reference: script/garfieldbench.py — plant a k-way AND gate under
    af/LD/het constraints, run the GARFIELD search, score hits on the
    top-K rules with exact or LD-proxy matching)."""
    p = argparse.ArgumentParser(prog="jx garfieldbench")
    common.add_genotype_args(p, required=False)
    p.add_argument("-nind", "--nind", type=int, default=500,
                   help="simulated samples (ignored with a genotype input)")
    p.add_argument("-nsnp", "--nsnp", type=int, default=2000,
                   help="simulated SNPs; with a genotype input this is the "
                        "reference's meaning: GARFIELD beam width")
    p.add_argument("-pve", "--pve", type=float, default=0.4,
                   help="polygenic/background PVE of the simulated trait")
    p.add_argument("-ve", "--ve", type=float, default=1.0,
                   help="residual variance of the simulated trait")
    p.add_argument("-reps", "--reps", "--n-runs", dest="reps", type=int,
                   default=5, help="benchmark runs")
    p.add_argument("-beam", "--beam", type=int, default=64,
                   help="GARFIELD beam width (simulated-genotype mode)")
    p.add_argument("-m", "--max-pick", dest="max_pick", type=int, default=2,
                   help="GARFIELD max literals per rule (search depth)")
    p.add_argument("-maf", "--maf", type=float, default=0.02)
    p.add_argument("-geno", "--geno", type=float, default=0.05)
    a = p.add_argument_group("Planted AND gate")
    a.add_argument("--and-k-min", type=int, default=2)
    a.add_argument("--and-k-max", type=int, default=2)
    a.add_argument("--and-ld-max", type=float, default=0.3,
                   help="max pairwise r^2 among gate members")
    a.add_argument("--and-af-min", type=float, default=0.02,
                   help="min gate (AND-term) frequency")
    a.add_argument("--and-af-max", type=float, default=0.90,
                   help="max gate frequency")
    a.add_argument("--and-het-max", type=float, default=0.05,
                   help="max member-site heterozygosity")
    a.add_argument("--and-target-pve", type=float, default=0.45,
                   help="PVE of the planted gate term")
    a.add_argument("--and-max-iter", type=int, default=200,
                   help="max attempts to sample a gate meeting constraints")
    h = p.add_argument_group("Hit scoring")
    h.add_argument("--top-k-hit", type=int, default=10,
                   help="hit criterion searches the top-K rules")
    h.add_argument("--hit-mode", choices=("all", "all-ld"), default="all-ld",
                   help="all: every planted site exact; all-ld: LD proxies "
                        "at r^2 >= --hit-ld-r2 count")
    h.add_argument("--hit-ld-r2", type=float, default=0.8)
    h.add_argument("--top-k-validate", type=int, default=20,
                   help="re-score this many top rules on the held-out "
                        "validation fraction")
    h.add_argument("--val-frac", type=float, default=0.25,
                   help="validation sample fraction (0 disables)")
    p.add_argument("-seed", "--seed", type=int, default=0)
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident; no chunked extraction"),
        ("--region-flank-mb", {"type": float},
         "the search runs over the full panel here, not a causal region "
         "extraction"),
        (("-windows", "--windows"), {"type": int},
         "no per-window simulation stage; the full panel is the region"),
        ("--feature-source", {"choices": ("bin", "mbin")},
         "features come from the packed hom-alt bitplanes directly"),
        (("-ext", "--extension"), {"type": int},
         "global search here; window extension lives in `jx garfield`"),
        (("-step", "--step"), {"type": int},
         "global search here; window step lives in `jx garfield`"),
        ("--dynamic-window-from-causal", {"action": "store_true"},
         "global search here; no window geometry to adjust"),
        ("--no-dynamic-window-from-causal", {"action": "store_true"},
         "global search here; no window geometry to adjust"),
    ])
    common.add_out_args(p, default_prefix="garfieldbench")
    args = p.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "garfieldbench")
    common.warn_ignored_compat(p, args)

    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models.garfield import garfield_scan
    from janusx_tpu_torch.models.sim import simulate_genotypes

    geno = common.resolve_genotype_optional(args)
    beam = args.beam
    pg0 = None
    if geno is not None:
        from janusx_tpu_torch.io.gfreader import prepare_packed

        pg0 = prepare_packed(geno, QcParams(maf=args.maf, geno=args.geno))
        beam = args.nsnp  # reference -nsnp semantics in genotype mode
    rng = np.random.default_rng(args.seed)
    rows = []
    print("rep\tk\trecovered\tvalidated\tseconds")
    hits = val_hits = 0
    for rep in range(args.reps):
        if pg0 is None:
            gd = simulate_genotypes(args.nind, args.nsnp, maf_low=0.2,
                                    seed=args.seed + rep)
            pg = pack_genotypes(gd, QcParams(maf=0.0, geno=1.0))
        else:
            pg = pg0
        hom = (pg.dosages() == 2).astype(np.float64)  # (m, n)
        het_rate = (pg.dosages() == 1).mean(axis=1)
        n = pg.n
        # sample a k-way AND gate under the af/het/LD constraints
        k = int(rng.integers(args.and_k_min, args.and_k_max + 1))
        members = None
        for _ in range(args.and_max_iter):
            cand = rng.choice(pg.m, size=k, replace=False)
            if (het_rate[cand] > args.and_het_max).any():
                continue
            term = hom[cand].prod(axis=0)
            af_gate = term.mean()
            if not (args.and_af_min <= af_gate <= args.and_af_max):
                continue
            ok = True
            for ai in range(k):
                for bi in range(ai + 1, k):
                    xa, xb = hom[cand[ai]], hom[cand[bi]]
                    sd = xa.std() * xb.std()
                    r = (np.mean((xa - xa.mean()) * (xb - xb.mean())) / sd
                         if sd > 0 else 1.0)
                    if r * r > args.and_ld_max:
                        ok = False
            if ok and term.std() > 0:
                members = [int(c) for c in cand]
                break
        if members is None:
            print(f"{rep}\t{k}\tSKIP(no gate met constraints)")
            continue
        term = hom[members].prod(axis=0)
        term = (term - term.mean()) / term.std()
        gv = term * np.sqrt(args.and_target_pve)
        if args.pve > 0:
            beff = rng.normal(size=pg.m)
            bgv = pg.centered().T @ beff
            bgv = (bgv - bgv.mean()) / max(bgv.std(), 1e-12)
            gv = gv + bgv * np.sqrt(args.pve)
        y = gv + rng.normal(size=n) * np.sqrt(args.ve)
        # train/validation split (reference --val-frac/--top-k-validate)
        n_val = int(n * args.val_frac) if args.val_frac > 0 else 0
        perm = rng.permutation(n)
        val, tr = perm[:n_val], np.sort(perm[n_val:])
        t0 = time.monotonic()
        if n_val > 0:
            from janusx_tpu_torch.io.packed import subset_samples_keep_stats

            pg_tr = subset_samples_keep_stats(pg, tr)
            res = garfield_scan(pg_tr, y[tr], depth=args.max_pick,
                                beam=beam, n_perm=20, seed=rep,
                                top_rules=max(args.top_k_hit,
                                              args.top_k_validate))
        else:
            res = garfield_scan(pg, y, depth=args.max_pick, beam=beam,
                                n_perm=20, seed=rep,
                                top_rules=max(args.top_k_hit,
                                              args.top_k_validate))
        sec = time.monotonic() - t0

        def _is_hit(rule_snps) -> bool:
            rs = set(int(s) for s in rule_snps)
            for msite in members:
                if msite in rs:
                    continue
                if args.hit_mode == "all":
                    return False
                tagged = False
                for s in rs:
                    xa, xb = hom[msite], hom[s]
                    sd = xa.std() * xb.std()
                    r = (np.mean((xa - xa.mean()) * (xb - xb.mean())) / sd
                         if sd > 0 else 0.0)
                    if r * r >= args.hit_ld_r2:
                        tagged = True
                        break
                if not tagged:
                    return False
            return True

        top = res.rules[: args.top_k_hit]
        got = any(_is_hit(rl.snps) for rl in top)
        hits += int(got)
        validated = False
        if n_val > 0 and res.rules:
            # re-score top rules on the held-out fraction
            yv = y[val]
            yv = (yv - yv.mean()) / max(yv.std(), 1e-12)
            best_v = -np.inf
            best_rule = None
            for rl in res.rules[: args.top_k_validate]:
                b = hom[rl.snps[0]][val]
                rv = (1.0 - b) if rl.ops[0] == "NOT" else b
                for op, s in zip(rl.ops[1:], rl.snps[1:]):
                    b = hom[s][val]
                    if op == "AND":
                        rv = rv * b
                    elif op == "ANDN":
                        rv = rv * (1.0 - b)
                    else:  # XOR
                        rv = np.abs(rv - b)
                if rv.std() <= 0:
                    continue
                score = abs(float(np.corrcoef(rv, yv)[0, 1]))
                if score > best_v:
                    best_v, best_rule = score, rl
            validated = best_rule is not None and _is_hit(best_rule.snps)
            val_hits += int(validated)
        rows.append({"rep": rep, "k": k, "members": members,
                     "recovered": bool(got), "validated": bool(validated),
                     "seconds": round(sec, 3)})
        print(f"{rep}\t{k}\t{got}\t{validated}\t{sec:.2f}")
    n_done = max(len(rows), 1)
    print(f"power: {hits}/{len(rows)}"
          + (f"\tvalidated: {val_hits}/{len(rows)}" if args.val_frac > 0
             else ""))
    with open(prefix + ".garfieldbench.json", "wt") as fh:
        json.dump({"n": args.nind, "m": args.nsnp,
                   "target_pve": args.and_target_pve,
                   "power": hits / n_done, "validated_power":
                   (val_hits / n_done if args.val_frac > 0 else None),
                   "reps": rows}, fh, indent=2)
    print(prefix + ".garfieldbench.json")
    return 0
