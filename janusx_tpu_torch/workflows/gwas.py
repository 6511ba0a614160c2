"""GWAS pipeline orchestration for ``jx gwas -lmm`` (port of the LMM route
of janusx_tpu/workflows/gwas.py):

  load genotype -> QC/pack -> GRM (all genotyped samples, full-set QC)
  -> optional PCs -> per trait: subset samples (pheno+cov non-missing),
  re-prepare the packed subset, eigh(K_subset + 1e-6 I), LMM->LM switch
  test (unless force_model), null REML fit, scan, TSV + summary.

Only the exact LMM (grid method) is ported. Any other model, and a switch
to LM, raise NotImplementedError: nothing falls through to another route.
Each stage's wall seconds go into the run summary (``stages``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import fit_null_reml_host
from janusx_tpu_torch.core.spectral import eigh_grm
from janusx_tpu_torch.io.gfreader import load_raw_packed
from janusx_tpu_torch.io.packed import QcParams
from janusx_tpu_torch.io.pheno import load_covariates, load_phenotype
from janusx_tpu_torch.models import lmm as lmm_mod
from janusx_tpu_torch.models.scan_common import ScanResult, analysis_sample_index
from janusx_tpu_torch.utils.progress import stage

log = logging.getLogger("janusx_tpu_torch.gwas")


@dataclass
class GwasConfig:
    """The LMM subset of janusx_tpu's GwasConfig."""

    genotype: str
    phenotype: str
    out_prefix: str = "./jx_out"
    models: tuple[str, ...] = ("lmm",)
    traits: list | None = None  # indices or names; None = all
    covariates: str | None = None  # covariate file
    n_pcs: int = 0
    maf: float = config.DEFAULT_MAF
    geno: float = config.DEFAULT_GENO
    het: float = config.DEFAULT_HET
    grm_method: int = 1
    force_model: bool = False
    block: int = config.DEFAULT_SNP_BLOCK
    scan_method: str = config.knob("JX_TPU_SCAN_METHOD")


@dataclass
class TraitRunResult:
    trait: str
    model: str
    result: ScanResult
    n_samples: int
    n_snps: int
    lambda_null: float | None = None
    switch_lrt_p: float | None = None
    tsv_path: str = ""
    seconds: float = 0.0
    stages: dict = field(default_factory=dict)  # per-trait stage seconds


def lmm_to_lm_switch_p(basis, y, covariates) -> float:
    """Boundary LRT p for H0: Va = 0 (mixed null vs OLS null), the
    reference's rule (workflow.py:848 + src/stats/gwas_unified.rs:121-175):
    stat = 2*(ML_lmm0 - ML_lm0), p = 0.5*chi2_sf_df1(stat); switch to LM
    when p >= 0.05. Host null fit."""
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = np.ones((n, 1), dtype=np.float64)
    if covariates is not None:
        X = np.concatenate([X, np.asarray(covariates, np.float64)], axis=1)
    null, _, _ = fit_null_reml_host(basis.S, basis.U.T @ X, basis.U.T @ y)
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    rss = float(np.sum((y - X @ beta) ** 2))
    ml_lm = -0.5 * n * (np.log(2.0 * np.pi * rss / n) + 1.0)
    stat = 2.0 * (null.ml - ml_lm)
    stat = max(stat, 0.0) if np.isfinite(stat) else 0.0
    p = 0.5 * float(jstats.chi2_sf_df1(np.asarray(stat)))
    if not np.isfinite(p):
        p = 1.0
    return min(max(p, np.finfo(np.float64).tiny), 1.0)


@contextlib.contextmanager
def _timed(stages: dict, key: str, label: str):
    t0 = time.monotonic()
    with stage(label, log):
        yield
    stages[key] = stages.get(key, 0.0) + time.monotonic() - t0


def run_gwas(cfg: GwasConfig) -> list[TraitRunResult]:
    t0 = time.monotonic()
    other = [m for m in cfg.models if m != "lmm"]
    if other:
        raise NotImplementedError(
            f"models {other} are not ported to janusx_tpu_torch yet (only "
            "-lmm is; see ROADMAP queue 1)")
    config.set_full_f32_matmul()
    config.resolve_device()  # fail before any work when no device fits
    stages: dict = {}
    qc = QcParams(maf=cfg.maf, geno=cfg.geno, het=cfg.het)
    with _timed(stages, "load", "load genotypes"):
        raw = load_raw_packed(cfg.genotype)
    log.info("genotype: %d SNPs x %d samples", raw.m, raw.n_samples)
    ph = load_phenotype(cfg.phenotype).select(cfg.traits)
    y_all, matched = ph.align(raw.samples)
    if not matched.any():
        raise ValueError("no phenotype sample IDs match the genotype samples")
    cov_all = (
        load_covariates(cfg.covariates, raw.samples) if cfg.covariates else None
    )

    from janusx_tpu_torch.utils.cache import load_or_build_grm, load_or_build_pcs

    with _timed(stages, "qc", "QC/pack (full sample set)"):
        pg_full = raw.prepare(qc)
    with _timed(stages, "grm", "GRM"):
        K = load_or_build_grm(
            cfg.genotype, pg_full, cfg.maf, cfg.geno, method=cfg.grm_method,
            block=cfg.block,
        )
    pcs_full = None
    if cfg.n_pcs > 0:
        pcs_full = load_or_build_pcs(
            cfg.genotype, K, raw.samples, cfg.maf, cfg.geno, cfg.n_pcs,
            method=cfg.grm_method,
        )

    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_prefix)) or ".", exist_ok=True)
    out: list[TraitRunResult] = []
    summary = []
    # traits with identical analysis-sample masks share the subset + basis
    prep_cache: dict = {}
    for ti, trait in enumerate(ph.traits):
        y = y_all[:, ti]
        cov_parts = [c for c in (pcs_full, cov_all) if c is not None]
        cov_full = np.concatenate(cov_parts, axis=1) if cov_parts else None
        keep = analysis_sample_index(y, cov_full)
        if len(keep) < 10:
            log.warning("trait %s: only %d usable samples, skipping", trait, len(keep))
            continue
        y_t = y[keep]
        cov_t = None if cov_full is None else cov_full[keep]
        ts: dict = {}
        entry = prep_cache.get(keep.tobytes())
        if entry is None:
            if len(keep) == raw.n_samples:
                pg_t = pg_full  # all samples kept: identical to pg_full
            else:
                with _timed(ts, "subset_qc", f"prepare subset ({trait})"):
                    pg_t = raw.prepare(qc, sample_idx=keep)
            with _timed(ts, "eigh", f"eigh ({trait})"):
                basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
            entry = prep_cache[keep.tobytes()] = (pg_t, basis)
        pg_t, basis = entry
        log.info("trait %s: n=%d m=%d models=%s", trait, len(keep), pg_t.m,
                 cfg.models)
        t1 = time.monotonic()
        switch_p = None
        if not cfg.force_model:
            switch_p = lmm_to_lm_switch_p(basis, y_t, cov_t)
            if switch_p >= 0.05:
                raise NotImplementedError(
                    f"trait {trait}: null LRT p={switch_p:.3g} >= 0.05 would "
                    "switch lmm -> lm, and the LM scan is not ported yet "
                    "(ROADMAP queue 1, item 13); pass -force-model to keep LMM")
            log.info("trait %s: null LRT p=%.3g < 0.05, keeping lmm", trait, switch_p)
        with _timed(ts, "null_fit", f"null REML fit ({trait})"):
            null = lmm_mod.fit_null(basis, y_t, cov_t)
        log.info("trait %s: lambda_null=%.6g", trait, null.lbd)
        with _timed(ts, "scan", f"LMM scan ({trait})"):
            res, null = lmm_mod.lmm_scan(pg_t, basis, y_t, cov_t, block=cfg.block,
                                         null=null, method=cfg.scan_method)
        secs = time.monotonic() - t1
        tsv_path = f"{cfg.out_prefix}.{trait}.LMM.assoc.tsv"
        with _timed(ts, "tsv", f"write TSV ({trait})"):
            res.write_tsv(tsv_path)
        out.append(TraitRunResult(
            trait=str(trait), model="lmm", result=res,
            n_samples=len(keep), n_snps=pg_t.m, lambda_null=null.lbd,
            switch_lrt_p=switch_p, tsv_path=tsv_path, seconds=secs, stages=ts,
        ))
        summary.append({
            "trait": str(trait), "model": "lmm", "requested": "lmm",
            "n": len(keep), "m": pg_t.m, "seconds": round(secs, 3),
            "lambda_null": null.lbd, "tsv": tsv_path, "stages": ts,
        })
    with open(f"{cfg.out_prefix}.gwas.summary.json", "wt") as fh:
        json.dump({"runs": summary, "stages": stages,
                   "total_seconds": round(time.monotonic() - t0, 3)},
                  fh, indent=2)
    return out
