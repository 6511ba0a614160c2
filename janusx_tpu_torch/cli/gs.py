"""`jx gs` — genomic selection (port of janusx_tpu/cli/gs.py; reference:
janusx.gs.workflow CLI). The parser is the reference's, source for source."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common

_METHOD_FLAGS = [
    ("BLUP", "auto-dispatch GBLUP/rrBLUP by n/m regime"),
    ("GBLUP", "additive GBLUP"),
    ("GBLUPd", "dominance-kernel GBLUP"),
    ("GBLUPad", "additive+dominance GBLUP"),
    ("rrBLUP", "ridge-regression BLUP (marker effects)"),
    ("BayesA", "Bayesian marker model, per-marker variance"),
    ("BayesB", "Bayesian variable selection"),
    ("BayesCpi", "Bayesian variable selection, shared variance"),
    ("RF", "random forest"),
    ("ET", "extra trees"),
    ("GBDT", "histogram gradient boosting"),
    ("ENET", "elastic net"),
    ("SVM", "RBF support-vector regression"),
    ("XGB", "XGBoost (optional dependency)"),
]


def build_parser(prog="jx gs") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Genomic selection (TPU-native)")
    common.add_genotype_args(p)
    common.add_pheno_args(p)
    m = p.add_argument_group("Models")
    for name, help_ in _METHOD_FLAGS:
        m.add_argument(
            f"-{name}", f"--{name}", dest=f"m_{name}", action="store_true", help=help_
        )
    # reference hidden alias for the additive+dominance kernel model
    m.add_argument("-adBLUP", "--adBLUP", dest="m_GBLUPad",
                   action="store_true", help=argparse.SUPPRESS)
    common.add_qc_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-model", "--model", type=str, default=None,
                   help="comma list of methods (alternative to the flags), "
                        "e.g. -model BLUP,BayesA,RF")
    o.add_argument("-cv", "--cv", type=int, default=5, help="CV folds (0 disables)")
    o.add_argument("--model-select", type=str, default="per-trait",
                   choices=("per-trait", "global"),
                   help="cross-method selection scope: best per trait, or one "
                        "globally best method across all traits")
    o.add_argument("--model-select-metric", type=str, default="pearson",
                   choices=("pearson", "spearman", "r2", "rmse", "nrmse"),
                   help="metric for cross-method selection (default pearson)")
    o.add_argument("-ldprune", "--ldprune", nargs=3, default=None,
                   metavar=("WIN", "STEP", "R2"),
                   help="LD-prune markers before GS")
    o.add_argument("-debug", "--debug", action="store_true",
                   help="print backend/device/thread diagnostics")
    o.add_argument("-seed", "--seed", type=int, default=42)
    o.add_argument("-effect", "--effect", action="store_true", help="export marker-effect TSVs")
    o.add_argument("-save-model", "--save-model", action="store_true",
                   help="export portable .jxmodel.npz marker-effect models")
    o.add_argument("--bayes-iters", type=int, default=400)
    o.add_argument("--bayes-burnin", type=int, default=200)
    o.add_argument(
        "-select", "--select", nargs="*", default=None, metavar="TARGET",
        help="enable the TOP multi-trait bundle: rank candidates toward a "
        "target profile. No values = best observed value per trait ('max'); "
        "else one raw-scale value per trait, or a file with one row of "
        "k values (reference --select)",
    )
    o.add_argument("--top-l2", type=float, default=1e-3)
    o.add_argument("--top-max-iter", type=int, default=50)
    o.add_argument("--ml-params", type=str, default=None, metavar="K=V[,K=V]",
                   help="explicit hyperparameters for the sklearn/xgboost "
                        "ML methods (e.g. n_estimators=512,max_depth=8); "
                        "wins over --ml-tune")
    o.add_argument("--ml-tune", action="store_true",
                   help="coarse hyperparameter search on the TRAINING fold "
                        "before fitting each ML method (the reference MLGS "
                        "auto-tuning stage, pyBLUP/ml.py)")
    o.add_argument("--top-tol", type=float, default=1e-6,
                   help="TOP Newton convergence tolerance")
    o.add_argument("--top-mode", type=str, default="auto",
                   choices=("auto", "exact-newton", "exact-bfgs",
                            "quasi-newton", "minibatch-adam"),
                   help="TOP solver; every mode runs the damped exact-Newton "
                        "fit here (the listwise objective is small and "
                        "convex enough that minibatching never pays)")
    r = p.add_argument_group(
        "rrBLUP solver (the applicable subset of the reference --rrblup-* "
        "ladder; Adam hyperparameters have no analog in the exact/PCG "
        "solvers and are accepted + warn-logged)"
    )
    r.add_argument("--rrblup-solver", choices=("auto", "exact", "pcg", "adamw"),
                   default="auto",
                   help="BLUP auto-dispatch override (adamw = reference-only "
                        "solver, routed to PCG here)")
    r.add_argument("--rrblup-lambda", type=float, default=None,
                   help="fixed ridge λ for the PCG route (skips the HE "
                   "pre-fit value)")
    r.add_argument("--rrblup-lambda-auto", choices=("on", "off"), default="on",
                   help="off = use --rrblup-lambda verbatim (reference "
                        "default 1.0) instead of the HE pre-fit λ")
    r.add_argument("--rrblup-lambda-scale", type=str, default="equation",
                   help="'equation' (reference default, the HE pre-fit λ as "
                        "derived), or a number scaling the pre-fit λ; the "
                        "reference's 'mean-loss' normalization applies only "
                        "to its Adam objective and is warn-ignored")
    r.add_argument("--rrblup-exact-max-markers", type=int, default=None,
                   help="marker cutoff for the exact route in auto dispatch")
    r.add_argument("--rrblup-auto-pcg-min-n", type=int, default=None,
                   help="train-sample count at or above which auto dispatch "
                        "picks the PCG route")
    r.add_argument("--rrblup-snp-block-size", type=int, default=None,
                   help="streamed SNP block size for marker-effect kernels")
    r.add_argument("--rrblup-pcg-tol", type=float, default=None)
    r.add_argument("--rrblup-pcg-maxiter", "--rrblup-pcg-max-iter",
                   dest="rrblup_pcg_maxiter", type=int, default=None)
    o.add_argument(
        "-hash", "--hash", nargs="*", default=None, metavar=("DIM", "SEED"),
        help="signed feature hashing before GS (count-sketch of the marker "
        "matrix). No values = dim 2048, seed 520 (reference --hash)",
    )
    # reference hidden spellings of the hash knobs
    o.add_argument("-hash-dim", "--hash-dim", type=int, default=None,
                   help=argparse.SUPPRESS)
    o.add_argument("-hash-seed", "--hash-seed", type=int, default=None,
                   help=argparse.SUPPRESS)
    o.add_argument("-hash-raw", "--hash-raw", action="store_true",
                   help=argparse.SUPPRESS)
    o.add_argument("-pcd", "--pcd", action="store_true",
                   help="PCA-reduce the ML feature matrix before fitting "
                   "(reference -pcd)")
    o.add_argument("-limit-predtrain", "--limit-predtrain", "-limit-train",
                   "--limit-train", dest="limit_predtrain", type=int,
                   default=None, help=argparse.SUPPRESS)
    # accepted-for-drop-in reference dev flags with no analog here: each
    # is registered through the compat machinery and warn-logged when
    # explicitly set (never silently swallowed).
    _ADAM = ("tunes the reference's minibatch-Adam rrBLUP solver; the "
             "exact/PCG solvers here have no learning rate, epochs, "
             "minibatches, early stopping, or grid trials")
    _INT = {"type": int}
    _FLT = {"type": float}
    common.add_compat_flags(p, [
        (("-batchsize", "--batchsize", "--rrblup-batch-size"),
         {"dest": "rrblup_batch_size", "type": int}, _ADAM),
        (("-force-fast", "--force-fast"), {"action": "store_true"}, _ADAM),
        (("-strict-cv", "--strict-cv"), {"action": "store_true"},
         "strict per-fold context re-preparation is always on here"),
        ("--rrblup-exact-backend",
         {"choices": ("auto", "snp", "fast")},
         "one exact spectral backend exists here (no snp/fast split)"),
        ("--rrblup-lr", _FLT, _ADAM), ("--rrblup-epochs", _INT, _ADAM),
        ("--rrblup-batch-threads", _INT, _ADAM),
        ("--rrblup-beta1", _FLT, _ADAM), ("--rrblup-beta2", _FLT, _ADAM),
        ("--rrblup-eps", _FLT, _ADAM),
        ("--rrblup-seed", _INT,
         "the exact/PCG rrBLUP solvers are deterministic; the global "
         "-seed controls CV fold shuffling"),
        ("--rrblup-auto-min-cells", _INT, _ADAM),
        ("--rrblup-log-every", _INT, _ADAM),
        ("--rrblup-sample-chunk-size", _INT, _ADAM),
        ("--rrblup-pve-mode", {"choices": ("lambda", "trainvar")},
         "PVE is reported from the REML/HE variance components directly"),
        ("--rrblup-auto-grid", {"choices": ("on", "off")}, _ADAM),
        ("--rrblup-grid-size", _INT, _ADAM),
        ("--rrblup-grid-min-samples", _INT, _ADAM),
        ("--rrblup-grid-trial-epochs", _INT, _ADAM),
        ("--rrblup-grid-switch-min-improve", _FLT, _ADAM),
        ("--rrblup-grid-reuse-cv", {"choices": ("on", "off")}, _ADAM),
        ("--rrblup-grid-seed", _INT, _ADAM),
        ("--rrblup-es-val-frac", _FLT, _ADAM),
        ("--rrblup-es-val-min", _INT, _ADAM),
        ("--rrblup-es-min-train", _INT, _ADAM),
        ("--rrblup-es-patience", _INT, _ADAM),
        ("--rrblup-es-warmup", _INT, _ADAM),
        ("--rrblup-es-min-delta", _FLT, _ADAM),
        ("--rrblup-pcg-std-eps", _FLT,
         "the PCG route here solves on the precomputed kernel; marker "
         "standardization uses exact per-site variances"),
        ("--rrblup-he-thread-policy", {"type": str},
         "XLA and the host BLAS size their own thread pools"),
        ("--rrblup-lambda-subsample-n", _INT,
         "the HE λ pre-fit streams the full sample cheaply here"),
        ("--rrblup-lambda-subsample-repeats", _INT,
         "the HE λ pre-fit streams the full sample cheaply here"),
        ("--rrblup-lambda-subsample-seed", _INT,
         "the HE λ pre-fit streams the full sample cheaply here"),
        ("--packed-lmm-auto", {"choices": ("on", "off")},
         "a single resident packed route serves all sizes here"),
        ("--packed-lmm-auto-min-cells", _INT,
         "a single resident packed route serves all sizes here"),
        ("--bayes-r2-cv-reuse", {"choices": ("on", "off")},
         "CV metrics are always computed from out-of-fold predictions"),
        ("--bayes-r2-subsample-min-n", _INT,
         "CV metrics are computed exactly (vectorized, no subsampling)"),
        ("--bayes-r2-subsample-n", _INT,
         "CV metrics are computed exactly (vectorized, no subsampling)"),
        ("--bayes-r2-subsample-max-n", _INT,
         "CV metrics are computed exactly (vectorized, no subsampling)"),
        ("--bayes-r2-subsample-repeats", _INT,
         "CV metrics are computed exactly (vectorized, no subsampling)"),
        ("--bayes-r2-subsample-seed", _INT,
         "CV metrics are computed exactly (vectorized, no subsampling)"),
        ("--top-exact-threshold", _INT,
         "the TOP fit always runs the exact damped-Newton solver"),
        ("--top-batch-size", _INT,
         "the TOP fit always runs the exact damped-Newton solver"),
        ("--top-epochs", _INT,
         "the TOP fit always runs the exact damped-Newton solver"),
        ("--top-lr", _FLT,
         "the TOP fit always runs the exact damped-Newton solver"),
        ("--top-seed", _INT, "the exact TOP fit is deterministic"),
    ], group=o)
    o.add_argument("--top-calibration", choices=("linear", "none", "addmean"),
                   default="linear",
                   help="per-trait prediction calibration before TOP "
                        "ranking: OLS of observed on predicted (linear, "
                        "default), mean shift (addmean), or raw (none)")
    common.add_compat_thread_arg(p)
    common.add_mem_arg(p)
    common.add_out_args(p, default_prefix="jxgs")
    return p


def _parse_select(tokens):
    """-select → None | 'max' | list of floats (possibly read from a file)."""
    if tokens is None:
        return None
    if len(tokens) == 0:
        return "max"
    if len(tokens) == 1:
        tok = tokens[0]
        if tok.lower() == "max":
            return "max"
        import os

        if os.path.isfile(tok):
            import numpy as np

            vals = np.loadtxt(tok, ndmin=2)
            return [float(v) for v in vals[0]]
    return [float(t) for t in tokens]


def _parse_lambda_scale(raw: str) -> tuple[float, str | None]:
    """--rrblup-lambda-scale: 'equation' → 1.0 (the HE pre-fit λ as
    derived); a number → scale factor (extension); 'mean-loss' →
    reference Adam-only normalization, ignored with a warning."""
    if raw is None or raw == "equation":
        return 1.0, None
    if raw == "mean-loss":
        return 1.0, ("--rrblup-lambda-scale=mean-loss normalizes the "
                     "reference's Adam loss; the HE-derived λ is used here")
    try:
        return float(raw), None
    except ValueError:
        raise SystemExit(
            f"--rrblup-lambda-scale: expected 'equation', 'mean-loss' or a "
            f"number, got {raw!r}")


def _parse_ml_params(spec: str | None) -> dict | None:
    """'n_estimators=512,max_depth=None,learning_rate=0.05' -> typed dict
    (int/float/bool/None literals coerced, everything else kept str)."""
    if not spec:
        return None
    out: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise SystemExit(f"--ml-params: expected K=V, got {item!r}")
        k, v = item.split("=", 1)
        vl = v.strip()
        low = vl.lower()
        if low == "none":
            val = None
        elif low in ("true", "false"):
            val = low == "true"
        else:
            try:
                val = int(vl)
            except ValueError:
                try:
                    val = float(vl)
                except ValueError:
                    val = vl
        out[k.strip()] = val
    return out or None


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    common.apply_mem_budget(args)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gs")
    methods = tuple(n for n, _ in _METHOD_FLAGS if getattr(args, f"m_{n}"))
    if args.model:
        known = {n for n, _ in _METHOD_FLAGS}
        alias = {"adBLUP": "GBLUPad"}
        listed = tuple(alias.get(t.strip(), t.strip())
                       for t in args.model.split(",") if t.strip())
        bad = [t for t in listed if t not in known]
        if bad:
            raise SystemExit(f"unknown -model methods: {bad} (known: {sorted(known)})")
        methods = tuple(dict.fromkeys(methods + listed))
    if not methods:
        methods = ("BLUP",)

    from janusx_tpu_torch import config as _cfg
    from janusx_tpu_torch.gs.workflow import GsConfig, run_gs

    dev = _cfg.resolve_device()  # fail before any work when no device fits
    if args.debug:
        import os as _os

        import torch

        print(f"device={dev} torch={torch.__version__} cuda={torch.version.cuda} "
              f"cards={torch.cuda.device_count()}")
        print(f"OMP={_os.environ.get('OMP_NUM_THREADS', 'auto')}")
    _cfg.set_full_f32_matmul()

    import logging

    _gs_log = logging.getLogger("janusx_tpu.gs")
    common.warn_ignored_compat(parser, args, _gs_log)
    lambda_scale, scale_warn = _parse_lambda_scale(args.rrblup_lambda_scale)
    if scale_warn:
        _gs_log.warning(scale_warn)
    rr_solver = args.rrblup_solver
    if rr_solver == "adamw":
        _gs_log.warning("--rrblup-solver=adamw is the reference's minibatch "
                        "solver; routing to the PCG solver here")
        rr_solver = "pcg"
    if args.top_mode not in ("auto", "exact-newton"):
        _gs_log.warning("--top-mode=%s: the TOP fit here always runs the "
                        "exact damped-Newton solver", args.top_mode)
    cfg = GsConfig(
        genotype=common.resolve_genotype(args),
        phenotype=args.pheno,
        out_prefix=prefix,
        methods=methods,
        traits=common.parse_traits(args.ncol),
        cv=args.cv,
        maf=args.maf,
        geno=args.geno,
        het=args.het,
        seed=args.seed,
        export_effects=args.effect,
        save_models=args.save_model,
        bayes_iters=args.bayes_iters,
        bayes_burnin=args.bayes_burnin,
        select=_parse_select(args.select),
        top_l2=args.top_l2,
        top_max_iter=args.top_max_iter,
        ml_params=_parse_ml_params(args.ml_params),
        ml_tune=args.ml_tune,
        hash_dim=(args.hash_dim if args.hash_dim is not None else
                  None if args.hash is None else
                  int(args.hash[0]) if args.hash else _cfg.knob("JX_TPU_HASH_DIM")),
        hash_seed=(args.hash_seed if args.hash_seed is not None else
                   int(args.hash[1]) if args.hash and len(args.hash) > 1
                   else _cfg.knob("JX_TPU_HASH_SEED")),
        hash_standardize=not args.hash_raw,
        pcd=args.pcd,
        limit_predtrain=args.limit_predtrain,
        select_metric=args.model_select_metric,
        model_select=args.model_select,
        top_tol=args.top_tol,
        top_calibration=args.top_calibration,
        rrblup_solver=rr_solver,
        rrblup_lambda=args.rrblup_lambda,
        rrblup_lambda_auto=(args.rrblup_lambda_auto != "off"),
        rrblup_lambda_scale=lambda_scale,
        rrblup_exact_max_markers=args.rrblup_exact_max_markers,
        rrblup_auto_pcg_min_n=args.rrblup_auto_pcg_min_n,
        rrblup_pcg_tol=args.rrblup_pcg_tol,
        rrblup_pcg_maxiter=args.rrblup_pcg_maxiter,
        ldprune=tuple(args.ldprune) if args.ldprune else None,
        **({"block": args.rrblup_snp_block_size}
           if args.rrblup_snp_block_size else {}),
    )
    results, summary = run_gs(cfg)
    for trait, per_method in summary["traits"].items():
        for mm, info in per_method.items():
            cv = info.get("cv", {})
            print(
                f"{trait}\t{mm}\t{info.get('route', mm)}\t"
                f"r={cv.get('pearson', float('nan')):.3f}\t"
                f"R2={cv.get('r2', float('nan')):.3f}"
            )
    return 0
