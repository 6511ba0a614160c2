"""Genomic-selection workflow: CV, fit, predict, artifacts.

Mirrors the reference flow (JanusX python/janusx/gs/workflow.py
docstring): per trait, train = samples with phenotype, test = missing;
k-fold CV on the training set per method (Pearson/Spearman/R2/... per
fold), refit on full training set, predict the test set; outputs
{prefix}.{trait}.gebv.tsv (index = test sample IDs, one column per
method, %.4f) and a summary JSON.

Methods: BLUP (auto-dispatch GBLUP vs rrBLUP by n/m regime —
gs/workflow.py:251,19506), GBLUP, rrBLUP (same predictions, exports
marker effects), Bayes A/B/Cpi (device Gibbs, janusx_tpu.gs.bayes),
RF/ET/GBDT/ENET/SVM via scikit-learn on the standardized matrix.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

from janusx_tpu_torch import config
from janusx_tpu_torch.gs.blup import fit_gblup, marker_effects, predict_gblup
from janusx_tpu_torch.gs.kfold import KFold
from janusx_tpu_torch.gs.metrics import regression_metrics
from janusx_tpu_torch.io.gfreader import load_raw_packed
from janusx_tpu_torch.io.packed import QcParams
from janusx_tpu_torch.io.pheno import load_phenotype
from janusx_tpu_torch.models.grm import grm_denominator, grm_from_packed

log = logging.getLogger("janusx_tpu.gs")

ML_METHODS = {"RF", "ET", "GBDT", "ENET", "SVM", "XGB"}
BAYES_METHODS = {"BayesA", "BayesB", "BayesCpi"}


@dataclass
class GsConfig:
    genotype: str
    phenotype: str
    out_prefix: str = "./jx_gs"
    methods: tuple[str, ...] = ("BLUP",)
    traits: list | None = None
    cv: int = 5
    maf: float = config.DEFAULT_MAF
    geno: float = config.DEFAULT_GENO
    het: float = config.DEFAULT_HET
    seed: int = 42
    block: int = config.DEFAULT_SNP_BLOCK
    write_outputs: bool = True
    export_effects: bool = False
    bayes_iters: int = 400
    bayes_burnin: int = 200
    bayes_thin: int = 1
    save_models: bool = False  # export portable marker-effect .jxmodel.npz
    # TOP bundle selection: None = off; "max" = rank toward best observed
    # profile; else a (k,) raw-scale target vector (reference --select,
    # gs/workflow.py:19811 top_requested)
    select: object = None
    top_l2: float = 1e-3
    top_max_iter: int = 50
    # signed feature hashing before GS (reference -hash, dim=2048 seed=520)
    hash_dim: int | None = None
    hash_seed: int = 520
    hash_standardize: bool = True  # reference -hash-raw flips this off
    # -limit-predtrain N: subsample the training set to N for fits
    # (reference hidden dev flag; deterministic under cfg.seed)
    limit_predtrain: int | None = None
    # -pcd: PCA-reduce the ML feature matrix before fitting
    pcd: bool = False
    # cross-method selection metric (reference --model-select-metric)
    select_metric: str = "pearson"
    # selection scope (reference --model-select): best method per trait,
    # or one globally best method across all traits
    model_select: str = "per-trait"
    # TOP Newton convergence tolerance (reference --top-tol)
    top_tol: float = 1e-6
    # TOP prediction calibration (reference --top-calibration)
    top_calibration: str = "linear"
    # LD-prune markers before GS (reference -ldprune WIN STEP R2)
    ldprune: tuple | None = None
    # rrBLUP solver knobs (the applicable subset of the reference's
    # --rrblup-* ladder; its Adam hyperparameters have no analog here —
    # the exact/PCG solvers have no learning rate or epochs)
    rrblup_solver: str = "auto"  # auto | exact | pcg (BLUP auto-dispatch)
    rrblup_lambda: float | None = None  # fixed λ for the PCG route
    # reference --rrblup-lambda-auto: when False, rrblup_lambda (default
    # 1.0) is used verbatim instead of the HE pre-fit λ
    rrblup_lambda_auto: bool = True
    rrblup_lambda_scale: float = 1.0  # scales the HE pre-fit λ
    rrblup_exact_max_markers: int | None = None  # exact-route m cutoff
    # reference --rrblup-auto-pcg-min-n: train-sample count at or above
    # which auto dispatch picks the PCG route
    rrblup_auto_pcg_min_n: int | None = None
    rrblup_pcg_tol: float | None = None
    rrblup_pcg_maxiter: int | None = None
    # ML-route hyperparameters: explicit overrides (win) or coarse
    # training-fold tuning like the reference MLGS search (pyBLUP/ml.py)
    ml_params: dict | None = None
    ml_tune: bool = False


@dataclass
class MethodRunResult:
    method: str
    route: str
    fold_metrics: list[dict]
    cv_mean: dict
    test_pred: np.ndarray
    fit_seconds: float
    cv_seconds: float
    model_info: dict = field(default_factory=dict)
    oof_pred: np.ndarray | None = None  # out-of-fold CV predictions on train


def _dispatch_blup_route(n_train: int, m: int, cfg=None) -> str:
    solver = getattr(cfg, "rrblup_solver", "auto") if cfg is not None else "auto"
    if solver == "exact":
        return "rrBLUP(exact)"
    if solver == "pcg":
        return "rrBLUP(PCG)"
    min_n = getattr(cfg, "rrblup_auto_pcg_min_n", None) if cfg is not None else None
    if min_n is not None and n_train >= min_n:
        return "rrBLUP(PCG)"
    if n_train <= config.knob("JX_TPU_GBLUP_MAX_N"):
        return "GBLUP(add)"
    exact_max = (
        getattr(cfg, "rrblup_exact_max_markers", None) if cfg is not None else None
    )
    if exact_max is None:
        exact_max = config.knob("JX_TPU_RRBLUP_EXACT_MAX_M")
    if m <= exact_max:
        return "rrBLUP(exact)"
    return "rrBLUP(PCG)"


# Coarse hyperparameter spaces for the ML tuner — the compacted version
# of the reference MLGS coarse search stage (pyBLUP/ml.py:613-683; its
# fine multicenter stage refines around the winner, which on GS-size
# panels moved the OOF score less than fold noise in our measurements).
# ENET self-tunes alpha via ElasticNetCV's internal grid.
_ML_TUNE_SPACE: dict = {
    "RF": {"n_estimators": [128, 256, 512], "max_depth": [None, 8, 16]},
    "ET": {"n_estimators": [128, 256, 512], "max_depth": [None, 8, 16]},
    "GBDT": {"learning_rate": [0.03, 0.05, 0.10], "max_depth": [None, 4, 8]},
    "XGB": {"learning_rate": [0.03, 0.05, 0.10], "max_depth": [2, 4, 6]},
    "SVM": {"C": [0.5, 1.0, 2.0, 4.0, 8.0]},
    "ENET": {},
}


def tune_ml_params(method: str, X, y, seed: int, n_iter: int = 6,
                   inner_cv: int = 3) -> dict:
    """Pick hyperparameters for one ML method by inner-CV Pearson on the
    TRAINING data (reference _tune_ml_method_once semantics: tuning sees
    only the training fold; the outer CV stays unbiased). Samples up to
    ``n_iter`` deduplicated candidates from the coarse space."""
    space = _ML_TUNE_SPACE.get(method, {})
    if not space:
        return {}
    rng = np.random.default_rng(seed)
    keys = sorted(space)
    cands: list[dict] = [{}]  # the library default always competes
    seen = {()}
    for _ in range(4 * n_iter):
        if len(cands) >= n_iter + 1:
            break
        c = {k: space[k][rng.integers(len(space[k]))] for k in keys}
        sig = tuple(sorted((k, str(v)) for k, v in c.items()))
        if sig not in seen:
            seen.add(sig)
            cands.append(c)
    n = len(y)
    idx = rng.permutation(n)
    folds = np.array_split(idx, max(2, inner_cv))
    best_params, best_score = {}, -np.inf
    for params in cands:
        preds = np.full(n, np.nan)
        try:
            for f in folds:
                tr = np.setdiff1d(idx, f)
                mdl = _ml_model(method, seed, params)
                mdl.fit(X[tr], y[tr])
                preds[f] = mdl.predict(X[f])
            score = float(np.corrcoef(preds, y)[0, 1])
        except Exception:
            continue
        if np.isfinite(score) and score > best_score:
            best_score, best_params = score, params
    return best_params


def _ml_model(method: str, seed: int, params: dict | None = None):
    mdl = _ml_model_base(method, seed)
    if params:
        try:
            mdl.set_params(**params)
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad --ml-params for {method}: {e}") from e
    return mdl


def _ml_model_base(method: str, seed: int):
    if method == "RF":
        from sklearn.ensemble import RandomForestRegressor

        return RandomForestRegressor(n_estimators=300, random_state=seed, n_jobs=-1)
    if method == "ET":
        from sklearn.ensemble import ExtraTreesRegressor

        return ExtraTreesRegressor(n_estimators=300, random_state=seed, n_jobs=-1)
    if method == "GBDT":
        from sklearn.ensemble import HistGradientBoostingRegressor

        return HistGradientBoostingRegressor(random_state=seed)
    if method == "ENET":
        from sklearn.linear_model import ElasticNetCV

        return ElasticNetCV(cv=3, random_state=seed, n_jobs=-1)
    if method == "SVM":
        from sklearn.svm import SVR

        return SVR(kernel="rbf", C=1.0)
    if method == "XGB":
        try:
            from xgboost import XGBRegressor
        except ImportError as e:
            raise RuntimeError(
                "XGB requires the optional xgboost package (pip install xgboost)"
            ) from e
        return XGBRegressor(n_estimators=400, random_state=seed, n_jobs=-1)
    raise ValueError(f"unknown ML method {method}")


def _run_kernel_method(
    K, y, train, predict_sets, covariates=None, basis=None
):
    """Fit GBLUP on `train`, predict each index set in predict_sets."""
    model = fit_gblup(K, y, train, covariates, basis=basis)
    preds = [predict_gblup(model, K, idx, covariates) for idx in predict_sets]
    return model, preds


def run_gs(cfg: GsConfig):
    t_start = time.monotonic()
    # pure config validation FIRST: a typo'd metric or malformed select
    # target must fail before hours of CV, not after (the CLI is shielded
    # by argparse choices; the in-memory API is not)
    if cfg.select_metric not in ("pearson", "spearman", "r2", "mse", "mae",
                                 "rmse", "nrmse"):
        raise ValueError(f"unknown select_metric {cfg.select_metric!r}")
    if cfg.select is not None and isinstance(cfg.select, str) \
            and cfg.select != "max":
        raise ValueError("select target must be 'max' or a k-vector")
    qc = QcParams(maf=cfg.maf, geno=cfg.geno, het=cfg.het)
    raw = load_raw_packed(cfg.genotype)
    pg = raw.prepare(qc)
    if cfg.ldprune:
        from janusx_tpu_torch.models.ldprune import ld_prune

        win, step, r2 = cfg.ldprune
        keep_snps = ld_prune(pg, window=int(win), step=int(step),
                             r2_threshold=float(r2))
        log.info("-ldprune %s %s %s: %d -> %d markers",
                 win, step, r2, pg.m, len(keep_snps))
        pg = pg.take_snps(keep_snps)
    m = pg.m
    ph = load_phenotype(cfg.phenotype).select(cfg.traits)
    y_all, matched = ph.align(pg.samples)
    log.info("GS: %d SNPs x %d samples, traits=%s", m, pg.n, ph.traits)

    kernel_methods = ("BLUP", "GBLUP", "rrBLUP", "GBLUPd", "GBLUPad")
    needs_kernel = any(mm in kernel_methods for mm in cfg.methods)
    needs_ml = any(mm in ML_METHODS for mm in cfg.methods) or any(
        mm in BAYES_METHODS for mm in cfg.methods
    )
    H = None
    if cfg.hash_dim:
        # signed-sketch compression: D-dim hashed features replace the m
        # markers for every downstream model (reference -hash flow,
        # gs/workflow.py:17720 _hash_packed_for_gs)
        from janusx_tpu_torch.models.hashing import signed_hash_features

        H, hscale, hkept = signed_hash_features(
            pg, n_buckets=cfg.hash_dim, seed=cfg.hash_seed, block=cfg.block,
            standardize=cfg.hash_standardize,
        )
        log.info("signed hash: %d SNPs -> %d buckets (scale=%.4g%s)",
                 hkept, cfg.hash_dim, hscale,
                 "" if cfg.hash_standardize else ", raw dosages")
        summary_hash = {"dim": cfg.hash_dim, "seed": cfg.hash_seed,
                        "kept_snps": hkept, "scale": hscale,
                        "raw": not cfg.hash_standardize}
        if any(mm in ("GBLUPd", "GBLUPad") for mm in cfg.methods):
            raise ValueError("-hash does not support dominance kernels")
        if cfg.export_effects or cfg.save_models:
            import dataclasses

            log.warning("-hash: marker effects are not back-projectable "
                        "from hashed features; effect export disabled")
            # local copy — run_gs must not mutate the caller's config
            cfg = dataclasses.replace(
                cfg, export_effects=False, save_models=False)
    from janusx_tpu_torch.workflows.gwas import resolve_mesh

    mesh = resolve_mesh(None)
    if mesh is not None:
        log.info("device mesh: %d devices on the 'snp' axis", mesh.devices.size)
    K = None
    if needs_kernel:
        K = (H @ H.T).astype(np.float64) if H is not None else grm_from_packed(
            pg, method=1, block=cfg.block, mesh=mesh
        )
    Kd = (
        grm_from_packed(pg, method=3, block=cfg.block, mesh=mesh)
        if any(mm in ("GBLUPd", "GBLUPad") for mm in cfg.methods)
        else None
    )
    denom = grm_denominator(pg, method=1)

    Xml = None
    if needs_ml:
        if H is not None:
            Xml = H
        else:
            # sample-major STANDARDIZED matrix (reference Bayes convention:
            # standardized additive Z, src/stats/bayes.rs:3-5)
            var = 2.0 * pg.af * (1.0 - pg.af)
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
            Xml = (pg.centered() * inv_sd[:, None]).T.astype(np.float32)  # (n, m)
        if cfg.pcd and Xml is not None:
            # -pcd: PCA scores replace the marker features for the ML
            # models (reference gs -pcd dimensionality reduction)
            q = min(100, Xml.shape[0] - 1, Xml.shape[1])
            Xc = Xml - Xml.mean(axis=0, keepdims=True)
            U, S, _ = np.linalg.svd(Xc, full_matrices=False)
            Xml = (U[:, :q] * S[:q]).astype(np.float32)
            log.info("-pcd: ML features reduced to %d PC scores", q)
            if cfg.save_models and any(
                    mm in BAYES_METHODS for mm in cfg.methods):
                import dataclasses

                log.warning("-pcd: Bayes coefficients live in PC space, "
                            "not marker space; .jxmodel export disabled")
                cfg = dataclasses.replace(cfg, save_models=False)

    if cfg.write_outputs:
        os.makedirs(
            os.path.dirname(os.path.abspath(cfg.out_prefix)) or ".", exist_ok=True
        )
    all_results: dict[str, dict[str, MethodRunResult]] = {}
    summary: dict = {"traits": {}, "methods": list(cfg.methods), "m_snps": m}
    if cfg.hash_dim:
        summary["hash"] = summary_hash
    # per-trait full-length prediction/truth columns for the TOP bundle
    top_traits: list[str] = []
    top_pred_cols: list[np.ndarray] = []
    top_true_cols: list[np.ndarray] = []
    top_sel_methods: list[str] = []
    trait_ctx: dict[str, tuple] = {}  # trait -> (train, test, y)
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        train = np.nonzero(np.isfinite(y))[0]
        test = np.nonzero(~np.isfinite(y))[0]
        if cfg.limit_predtrain and len(train) > cfg.limit_predtrain:
            rng_lim = np.random.default_rng(cfg.seed)
            train = np.sort(rng_lim.choice(
                train, size=cfg.limit_predtrain, replace=False))
            log.info("trait %s: -limit-predtrain subsampled train to %d",
                     trait, len(train))
        if len(train) < max(cfg.cv, 10):
            log.warning("trait %s: too few training samples, skipped", trait)
            continue
        log.info("trait %s: train=%d test=%d", trait, len(train), len(test))
        # streamed HE variance-component pre-fit (never forms K; reference
        # he_pcg_bed VC pre-fit, gs/workflow.py:5980 -> src/stats/he.rs)
        try:
            from janusx_tpu_torch.models.he import he_streamed

            he = he_streamed(pg, y, sample_idx=train,
                             probes=config.knob("JX_TPU_HE_PROBES"),
                             seed=cfg.seed)
            log.info("trait %s: HE pre-fit h2=%.3f (vg=%.4g ve=%.4g%s)",
                     trait, he.h2, he.vg, he.ve,
                     "" if he.boundary == "interior" else f", {he.boundary}")
            summary.setdefault("he_prefit", {})[str(trait)] = {
                "h2": round(he.h2, 4), "vg": he.vg, "ve": he.ve,
                "boundary": he.boundary,
            }
            he_lbd = he.ve / he.vg if he.vg > 1e-12 else None
        except Exception as e:  # pre-fit is advisory, never fatal
            log.warning("trait %s: HE pre-fit failed: %s", trait, e)
            he_lbd = None
        trait_res: dict[str, MethodRunResult] = {}
        for method in cfg.methods:
            res = _run_single_method(
                cfg, method, K, Xml, pg, denom, y, train, test, trait, Kd=Kd,
                he_lbd=he_lbd,
            )
            trait_res[method] = res
        all_results[str(trait)] = trait_res

        if cfg.write_outputs and len(test) > 0:
            path = f"{cfg.out_prefix}.{trait}.gebv.tsv"
            with open(path, "wt") as fh:
                fh.write("\t" + "\t".join(trait_res.keys()) + "\n")
                for j, sidx in enumerate(test):
                    row = "\t".join(
                        f"{trait_res[mm].test_pred[j]:.4f}" for mm in trait_res
                    )
                    fh.write(f"{pg.samples[sidx]}\t{row}\n")
        if cfg.write_outputs and any(
            r.oof_pred is not None for r in trait_res.values()
        ):
            # out-of-fold CV predictions on the train set: the artifact
            # `jx postgs -oof` uses for pred-vs-obs plots
            path = f"{cfg.out_prefix}.{trait}.oof.tsv"
            with open(path, "wt") as fh:
                fh.write("\tobserved\t" + "\t".join(trait_res.keys()) + "\n")
                for j, sidx in enumerate(train):
                    row = "\t".join(
                        f"{trait_res[mm].oof_pred[j]:.4f}"
                        if trait_res[mm].oof_pred is not None else ""
                        for mm in trait_res
                    )
                    fh.write(f"{pg.samples[sidx]}\t{y[sidx]:.6g}\t{row}\n")
        trait_ctx[str(trait)] = (train, test, y.copy())
        summary["traits"][str(trait)] = {
            mm: {
                "route": r.route,
                "cv": r.cv_mean,
                "folds": r.fold_metrics,
                "fit_seconds": round(r.fit_seconds, 3),
                "cv_seconds": round(r.cv_seconds, 3),
                **r.model_info,
            }
            for mm, r in trait_res.items()
        }
    # cross-method selection (reference --model-select{,-metric} /
    # _select_top_method_for_trait, gs/workflow.py:935): best CV metric
    # per trait, or — model_select="global" — the one method with the
    # best mean metric across all traits applied everywhere
    metric = cfg.select_metric
    if metric not in ("pearson", "spearman", "r2", "mse", "mae", "rmse",
                      "nrmse"):
        raise ValueError(f"unknown select_metric {metric!r}")
    sign = -1.0 if metric in ("mse", "mae", "rmse", "nrmse") else 1.0

    def _sel_score(r: MethodRunResult) -> float:
        return sign * r.cv_mean.get(metric, float("nan"))

    sel_by_trait: dict[str, str | None] = {}
    if getattr(cfg, "model_select", "per-trait") == "global":
        agg: dict[str, float] = {}
        for mm in cfg.methods:
            vals = [_sel_score(tr[mm]) for tr in all_results.values()
                    if mm in tr and np.isfinite(_sel_score(tr[mm]))]
            if vals:
                agg[mm] = float(np.mean(vals))
        best_global = max(agg, key=agg.get) if agg else None
        sel_by_trait = {t: best_global for t in all_results}
        if best_global is not None:
            log.info("--model-select global: %s (mean %s=%.4f across %d "
                     "traits)", best_global, metric,
                     sign * agg[best_global], len(all_results))
    else:
        for t, tr in all_results.items():
            best_method, best_r = None, -np.inf
            for mm, r in tr.items():
                rv = _sel_score(r)
                if np.isfinite(rv) and rv > best_r:
                    best_r, best_method = rv, mm
            sel_by_trait[t] = best_method
    for t in all_results:
        best_method = sel_by_trait.get(t)
        summary.setdefault("selected_method", {})[t] = best_method
        if best_method is None or best_method not in all_results[t]:
            continue
        res = all_results[t][best_method]
        train, test, yv = trait_ctx[t]
        col = np.full(pg.n, np.nan)
        if res.oof_pred is not None:
            col[train] = res.oof_pred
        if len(test) and res.test_pred.size == len(test):
            col[test] = res.test_pred
        top_traits.append(t)
        top_pred_cols.append(col)
        top_true_cols.append(yv)
        top_sel_methods.append(best_method)
    if cfg.select is not None and len(top_traits) >= 2:
        _run_top_bundle(
            cfg, pg.samples, top_traits, np.column_stack(top_true_cols),
            np.column_stack(top_pred_cols), top_sel_methods, summary,
        )
    elif cfg.select is not None:
        log.warning("TOP bundle needs >=2 traits with results; skipped")
    summary["total_seconds"] = round(time.monotonic() - t_start, 3)
    if cfg.write_outputs:
        with open(f"{cfg.out_prefix}.gs.summary.json", "wt") as fh:
            json.dump(summary, fh, indent=2)
        from janusx_tpu_torch.utils.history import record_run

        record_run("gs", cfg.out_prefix,
                   {"methods": list(cfg.methods), "genotype": cfg.genotype},
                   [f"{cfg.out_prefix}.gs.summary.json"],
                   summary["total_seconds"])
    return all_results, summary


def _cv_mean(fold_metrics: list) -> dict:
    out = {}
    if fold_metrics:
        for k in ("pearson", "spearman", "r2", "mse", "mae", "rmse", "nrmse"):
            vals = [fm[k] for fm in fold_metrics if np.isfinite(fm.get(k, np.nan))]
            out[k] = float(np.mean(vals)) if vals else float("nan")
    return out


def _run_single_method(cfg, method, K, Xml, pg, denom, y, train, test, trait,
                       Kd=None, he_lbd=None):
    route = method
    info: dict = {}
    t0 = time.monotonic()
    fold_metrics = []
    oof = np.full(len(train), np.nan)
    # cv=0/1 disables cross-validation (the CLI documents 0 as "disables")
    folds = (list(KFold(cfg.cv, shuffle=True, random_state=cfg.seed)
                  .split(len(train))) if cfg.cv >= 2 else [])

    if method in ("GBLUPd", "GBLUPad"):
        from janusx_tpu_torch.gs.blup import fit_gblup_kernels, predict_gblup_kernels

        Ks = {"dom": Kd} if method == "GBLUPd" else {"add": K, "dom": Kd}
        route = "GBLUP(d)" if method == "GBLUPd" else "GBLUP(ad)"
        for fold, (tr_loc, va_loc) in enumerate(folds):
            tf = time.monotonic()
            mdl = fit_gblup_kernels(Ks, y, train[tr_loc])
            pv = predict_gblup_kernels(mdl, Ks, train[va_loc])
            oof[va_loc] = pv
            mets = regression_metrics(y[train[va_loc]], pv)
            mets.update(fold=fold, elapsed_sec=round(time.monotonic() - tf, 3))
            fold_metrics.append(mets)
        cv_secs = time.monotonic() - t0
        t1 = time.monotonic()
        mdl = fit_gblup_kernels(Ks, y, train)
        test_pred = (
            predict_gblup_kernels(mdl, Ks, test) if len(test) else np.empty(0)
        )
        info.update(sigma2=mdl.sigma2, h2=mdl.h2)
        fit_secs = time.monotonic() - t1
    elif method in ("BLUP", "GBLUP", "rrBLUP"):
        route = (
            _dispatch_blup_route(len(train), pg.m, cfg)
            if method == "BLUP" else method
        )
        # λ for the PCG route: explicit --rrblup-lambda wins, else the HE
        # pre-fit scaled by --rrblup-lambda-scale (reference knob ladder)
        lbd_fixed = getattr(cfg, "rrblup_lambda", None)
        if not getattr(cfg, "rrblup_lambda_auto", True) and lbd_fixed is None:
            # --rrblup-lambda-auto off: use the reference's default fixed
            # λ=1.0 instead of the HE pre-fit
            lbd_fixed = 1.0
        pcg_lbd = (
            lbd_fixed if lbd_fixed is not None
            else None if he_lbd is None
            else he_lbd * getattr(cfg, "rrblup_lambda_scale", 1.0)
        )
        pcg_kw = {
            "tol": getattr(cfg, "rrblup_pcg_tol", None),
            "max_iter": getattr(cfg, "rrblup_pcg_maxiter", None),
        }
        if route == "rrBLUP(PCG)" and pcg_lbd is None:
            pcg_lbd = (cfg.rrblup_lambda
                       if getattr(cfg, "rrblup_lambda", None) is not None
                       else 1.0)
            log.warning(
                "trait %s: HE pre-fit unavailable for the rrBLUP(PCG) "
                "route; using fixed lambda=%.3g (--rrblup-lambda to "
                "control) instead of falling back to the O(n^3) eigh "
                "path at this scale", trait, pcg_lbd)
        if route == "rrBLUP(PCG)":
            # large-n route: Jacobi-PCG solves of (K_tt + λI) at the HE
            # pre-fit λ — no per-fold O(n^3) eigendecomposition
            # (reference rrblup_pcg_bed regime, gs/workflow.py:19506)
            from janusx_tpu_torch.gs.blup import fit_gblup_cg

            info["lambda_pcg"] = float(pcg_lbd)
            for fold, (tr_loc, va_loc) in enumerate(folds):
                tf = time.monotonic()
                alpha, beta0 = fit_gblup_cg(K, y, train[tr_loc], pcg_lbd,
                                            **pcg_kw)
                pv = K[np.ix_(train[va_loc], train[tr_loc])] @ alpha + beta0[0]
                oof[va_loc] = pv
                mets = regression_metrics(y[train[va_loc]], pv)
                mets.update(fold=fold,
                            elapsed_sec=round(time.monotonic() - tf, 3))
                fold_metrics.append(mets)
            cv_secs = time.monotonic() - t0
            t1 = time.monotonic()
            alpha, beta0 = fit_gblup_cg(K, y, train, pcg_lbd, **pcg_kw)
            test_pred = (K[np.ix_(test, train)] @ alpha + beta0[0]
                         if len(test) else np.empty(0))
            # effect export must not silently disappear when auto-dispatch
            # picks the PCG route at scale (the eigh route exports these)
            if cfg.write_outputs and (cfg.export_effects or cfg.save_models):
                alpha_full = np.zeros(pg.n)
                alpha_full[train] = alpha
                eff = marker_effects(pg, alpha_full, denom)
                info["n_effects"] = len(eff)
                if cfg.export_effects:
                    _write_effects(
                        f"{cfg.out_prefix}.{trait}.{method}.effect.tsv",
                        pg, eff)
                if cfg.save_models:
                    from janusx_tpu_torch.gs.model_io import save_marker_model

                    save_marker_model(
                        f"{cfg.out_prefix}.{trait}.{method}.jxmodel.npz",
                        pg.sites, eff, pg.mean, float(beta0[0]), method,
                        {"trait": str(trait), "lambda": float(pcg_lbd)},
                    )
            fit_secs = time.monotonic() - t1
            return MethodRunResult(
                method=method, route=route, fold_metrics=fold_metrics,
                cv_mean=_cv_mean(fold_metrics), test_pred=test_pred,
                fit_seconds=fit_secs, cv_seconds=cv_secs, model_info=info,
                oof_pred=oof,
            )
        # folds are independent host-only work (LAPACK eigh + Brent REML,
        # both GIL-releasing) — run them concurrently. The per-fold eigh
        # chain IS the CV wall clock: 5x dsyevd(1128) measures 1.38 s
        # (0.71 s in f32) on this 4-vCPU box, so the knob JX_TPU_GS_EIGH32
        # trades the f64 spectrum for ssyevd when CV speed matters more
        # than the last ~1e-5 of lambda precision. A partitioned-inverse
        # one-eigh variant was measured 4x SLOWER (Brent needs ~30
        # O(n_v^2 n) evaluations per fold vs one ~3n_t^3 eigh — break-even
        # is ~9 evaluations), so per-fold eigh it stays.
        def _one_fold(args):
            fold, (tr_loc, va_loc) = args
            tf = time.monotonic()
            model, (pv,) = _run_kernel_method(K, y, train[tr_loc], [train[va_loc]])
            mets = regression_metrics(y[train[va_loc]], pv)
            mets.update(fold=fold, elapsed_sec=round(time.monotonic() - tf, 3),
                        pve=model.pve)
            return fold, va_loc, pv, mets

        if folds:
            from concurrent.futures import ThreadPoolExecutor

            workers = min(len(folds), os.cpu_count() or 4)
            with ThreadPoolExecutor(max_workers=workers) as ex:
                # ex.map preserves input order -> fold_metrics stay ordered
                for _fold, va_loc, pv, mets in ex.map(_one_fold, enumerate(folds)):
                    oof[va_loc] = pv
                    fold_metrics.append(mets)
        cv_secs = time.monotonic() - t0
        t1 = time.monotonic()
        model, preds = _run_kernel_method(
            K, y, train, [test] if len(test) else []
        )
        test_pred = preds[0] if preds else np.empty(0)
        info.update(lambda_=model.lbd, vg=model.vg, ve=model.ve, pve=model.pve)
        want_effects = cfg.write_outputs and (
            cfg.export_effects or cfg.save_models
            or (method == "rrBLUP" and cfg.hash_dim is None)
        )
        if want_effects:
            eff = marker_effects(pg, _alpha_full(model, pg.n), denom)
            info["n_effects"] = len(eff)
            if cfg.write_outputs and cfg.export_effects:
                _write_effects(
                    f"{cfg.out_prefix}.{trait}.{method}.effect.tsv", pg, eff
                )
            if cfg.write_outputs and cfg.save_models:
                from janusx_tpu_torch.gs.model_io import save_marker_model

                save_marker_model(
                    f"{cfg.out_prefix}.{trait}.{method}.jxmodel.npz",
                    pg.sites, eff, pg.mean, float(model.beta[0]), method,
                    {"trait": str(trait), "lambda": model.lbd,
                     "vg": model.vg, "ve": model.ve},
                )
        fit_secs = time.monotonic() - t1
    elif method in BAYES_METHODS:
        from janusx_tpu_torch.gs.bayes import bayes_fit_predict

        test_pred, fold_metrics, info = bayes_fit_predict(
            cfg, method, Xml, y, train, test, folds
        )
        oof = info.pop("oof_pred", oof)
        cv_secs = time.monotonic() - t0
        fit_secs = info.pop("fit_seconds", 0.0)
        if cfg.write_outputs and cfg.save_models and "beta_std" in info:
            from janusx_tpu_torch.gs.model_io import save_marker_model

            var = 2.0 * pg.af * (1.0 - pg.af)
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
            save_marker_model(
                f"{cfg.out_prefix}.{trait}.{method}.jxmodel.npz",
                pg.sites, info.pop("beta_std") * inv_sd, pg.mean,
                info.get("mu", 0.0), method, {"trait": str(trait)},
            )
        else:
            info.pop("beta_std", None)
    elif method in ML_METHODS:
        X = Xml
        ml_params = dict(getattr(cfg, "ml_params", None) or {})
        if not ml_params and getattr(cfg, "ml_tune", False):
            # reference _tune_ml_method_once: tuning sees only TRAIN data
            ml_params = tune_ml_params(method, X[train], y[train], cfg.seed)
            log.info("gs %s tuned params: %s", method, ml_params or "default")
        if ml_params:
            info["ml_params"] = {k: v for k, v in ml_params.items()}
        for fold, (tr_loc, va_loc) in enumerate(folds):
            tf = time.monotonic()
            mdl = _ml_model(method, cfg.seed, ml_params)
            mdl.fit(X[train[tr_loc]], y[train[tr_loc]])
            pv = mdl.predict(X[train[va_loc]])
            oof[va_loc] = pv
            mets = regression_metrics(y[train[va_loc]], pv)
            mets.update(fold=fold, elapsed_sec=round(time.monotonic() - tf, 3))
            fold_metrics.append(mets)
        cv_secs = time.monotonic() - t0
        t1 = time.monotonic()
        mdl = _ml_model(method, cfg.seed, ml_params)
        mdl.fit(X[train], y[train])
        test_pred = mdl.predict(X[test]) if len(test) else np.empty(0)
        fit_secs = time.monotonic() - t1
    else:
        raise ValueError(f"unknown GS method: {method}")

    cv_mean = _cv_mean(fold_metrics)
    return MethodRunResult(
        method=method, route=route, fold_metrics=fold_metrics, cv_mean=cv_mean,
        test_pred=np.asarray(test_pred), fit_seconds=fit_secs, cv_seconds=cv_secs,
        model_info=info, oof_pred=oof,
    )


def _run_top_bundle(cfg, samples, traits, y_true, y_pred, sel_methods, summary):
    """Fit the TOP trait-ordered ranking model from out-of-fold CV
    predictions and rank candidates toward the selection target.

    Reference flow: gs/workflow.py:23260 (top_fit_model from OOF
    predictions), weights TSV + .gs.TOP.jxmodel bundle + rank output
    (src/stats/top.rs listwise objective)."""
    from janusx_tpu_torch.gs.metrics import regression_metrics
    from janusx_tpu_torch.gs.top import top_fit, top_rank

    valid = np.isfinite(y_pred).all(axis=1)
    fit_rows = valid & np.isfinite(y_true).any(axis=1)
    if fit_rows.sum() < 2:
        log.warning("TOP: fewer than 2 samples with observed phenotypes; skipped")
        return
    if (~valid).sum():
        log.warning("TOP: dropped %d rows with non-finite predictions",
                    int((~valid).sum()))
    model = top_fit(
        y_true[fit_rows], y_pred[fit_rows], traits=traits,
        l2=cfg.top_l2, max_iter=cfg.top_max_iter,
        tol=getattr(cfg, "top_tol", 1e-6),
        calibration=getattr(cfg, "top_calibration", "linear"),
    )
    log.info("TOP weights: %s (loss=%.4f, %d iters%s)",
             ", ".join(f"{t}={w:.3f}" for t, w in zip(traits, model.weights)),
             model.loss, model.n_iter, "" if model.converged else ", NOT converged")

    k = len(traits)
    rows = []
    for i, trait in enumerate(traits):
        obs = np.isfinite(y_true[:, i])
        both = obs & np.isfinite(y_pred[:, i])
        mets = (regression_metrics(y_true[both, i], y_pred[both, i])
                if both.sum() >= 3 else {})
        rows.append({
            "trait": trait,
            "observed_n": int(obs.sum()),
            "missing_n": int(len(samples) - obs.sum()),
            "selected_gs_model": sel_methods[i],
            "weight": float(model.weights[i]),
            "pearson": float(mets.get("pearson", np.nan)),
            "spearman": float(mets.get("spearman", np.nan)),
            "r2": float(mets.get("r2", np.nan)),
            "warning": "LOW_OBSERVED_N" if 0 < obs.sum() < 20 else "",
        })

    target = cfg.select
    if isinstance(target, str) and target != "max":
        raise ValueError("select target must be 'max' or a k-vector")
    if not isinstance(target, str):
        target = np.asarray(target, np.float64).reshape(-1)
        if target.size != k:
            raise ValueError(
                f"select target has {target.size} values, expected {k} "
                f"(traits: {', '.join(traits)})"
            )
    if isinstance(target, str):
        # "max" = best OBSERVED value per trait (GsConfig doc / reference
        # --select max) — NOT the max of the prediction matrix, whose
        # zero-filled invalid rows could fabricate the target profile
        score_target = np.array([
            np.nanmax(y_true[:, j])
            if np.isfinite(y_true[:, j]).any()
            else float(np.max(y_pred[valid, j]))
            for j in range(k)
        ])
    else:
        score_target = target
    scores = top_rank(model, np.where(valid[:, None], y_pred, 0.0),
                      score_target)
    scores = np.where(valid, scores, -np.inf)
    order = np.argsort(-scores)

    summary["top"] = {
        "traits": traits,
        "weights": [float(w) for w in model.weights],
        "selected_gs_model": dict(zip(traits, sel_methods)),
        "loss": model.loss,
        "n_iter": model.n_iter,
        "converged": model.converged,
        "target": ("max" if isinstance(target, str) else
                   [float(v) for v in target]),
        "n_fit": int(fit_rows.sum()),
        # prediction calibration actually applied (reference
        # --top-calibration; recorded so the ranking is reproducible)
        "calibration": {
            "mode": getattr(cfg, "top_calibration", "linear"),
            "intercept": [float(v) for v in model.cal_intercept],
            "slope": [float(v) for v in model.cal_slope],
        },
    }
    if not cfg.write_outputs:
        return
    wpath = f"{cfg.out_prefix}.gs.TOP.weights.tsv"
    cols = list(rows[0].keys())
    with open(wpath, "wt") as fh:
        fh.write("\t".join(cols) + "\n")
        for r in rows:
            fh.write("\t".join(
                f"{r[c]:.6g}" if isinstance(r[c], float) else str(r[c])
                for c in cols) + "\n")
    rpath = f"{cfg.out_prefix}.gs.TOP.rank.tsv"
    with open(rpath, "wt") as fh:
        fh.write("rank\tsample\tscore\t" + "\t".join(
            f"pred_{t}" for t in traits) + "\n")
        rank = 0
        for idx in order:
            if not np.isfinite(scores[idx]):
                continue
            rank += 1
            preds = "\t".join(f"{y_pred[idx, j]:.4f}" for j in range(k))
            fh.write(f"{rank}\t{samples[idx]}\t{scores[idx]:.6f}\t{preds}\n")
    np.savez(
        f"{cfg.out_prefix}.gs.TOP.jxmodel.npz",
        method="GS_TOP_BUNDLE",
        traits=np.asarray(traits),
        weights=model.weights,
        true_mean=model.true_mean,
        true_sd=model.true_sd,
        selected_models=np.asarray(sel_methods),
        target=(np.asarray("max") if isinstance(target, str) else target),
        # the ranking applies this calibration BEFORE scoring: without it
        # a loaded bundle cannot reproduce .gs.TOP.rank.tsv
        cal_intercept=model.cal_intercept,
        cal_slope=model.cal_slope,
    )
    log.info("TOP bundle written: %s, %s", wpath, rpath)


def _alpha_full(model, n: int) -> np.ndarray:
    alpha = np.zeros(n)
    alpha[model.train_idx] = model.alpha
    return alpha


def _write_effects(path: str, pg, eff: np.ndarray) -> None:
    with open(path, "wt") as fh:
        fh.write("chrom\tpos\tsnp\tallele0\tallele1\teffect\n")
        s = pg.sites
        for i in range(len(eff)):
            fh.write(
                f"{s.chrom[i]}\t{s.pos[i]}\t{s.snp[i]}\t{s.allele0[i]}"
                f"\t{s.allele1[i]}\t{eff[i]:.6g}\n"
            )
