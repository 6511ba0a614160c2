"""GWAS pipeline orchestration of ``jx gwas`` (port of
janusx_tpu/workflows/gwas.py):

  load genotype -> QC/pack -> GRM (all genotyped samples, full-set QC;
  only when a dense-GRM model or PCs ask for it) and/or the thresholded
  sparse GRM (band-streamed with a .jxgrm cache, or a precomputed -spk
  file aligned by its .id sidecar) -> optional PCs -> [-trait-level: one
  batched scan per model over the traits sharing a sample mask] -> per
  trait: subset samples (pheno+cov non-missing), re-prepare the packed
  subset (or keep the full-set stats under -global), eigh(K_subset + 1e-6
  I) or the low-rank kinship basis, per model the LMM->LM switch test
  (unless force_model), scan, TSV -> combined trait-level TSVs, summary,
  run history.

Models: see MODELS. With more than one device (``n_devices``, capped by
``JX_TPU_DEVICES``) the GRM and every scan run SNP-sharded over a device
mesh (parallel.mesh), as janusx_tpu's do. Each stage's wall seconds go
into the run summary (``stages``: the shared stages at the top level,
each run's own under it).
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
from janusx_tpu_torch.io.packed import QcParams, subset_samples_keep_stats
from janusx_tpu_torch.io.pheno import load_covariates, load_phenotype
from janusx_tpu_torch.models import fvlmm as fvlmm_mod
from janusx_tpu_torch.models import lm as lm_mod
from janusx_tpu_torch.models import lmm as lmm_mod
from janusx_tpu_torch.models.scan_common import ScanResult, analysis_sample_index
from janusx_tpu_torch.utils import trace
from janusx_tpu_torch.utils.progress import stage

log = logging.getLogger("janusx_tpu_torch.gwas")

MODELS = ("lm", "lmm", "lmm2", "fvlmm", "lm2", "fvlmm2", "farmcpu", "frgwas",
          "splmm", "splmm-exact", "lowrank", "algwas")
_MIXED = ("lmm", "lmm2", "fvlmm")
_SPARSE = ("splmm", "splmm-exact")
_TAGS = {"lm": "LM", "lmm": "LMM", "lmm2": "LMM2", "fvlmm": "FvLMM",
         "splmm": "SparseLMM", "splmm-exact": "SparseLMM2",
         "farmcpu": "FarmCPU", "frgwas": "FarmCPU", "algwas": "ALGWAS",
         "lm2": "LM2", "fvlmm2": "FvLMM2", "lowrank": "FaSTLMM"}


@dataclass
class GwasConfig:
    """janusx_tpu's GwasConfig."""

    genotype: str
    phenotype: str
    out_prefix: str = "./jx_out"
    models: tuple[str, ...] = ("lmm",)  # see MODELS
    traits: list | None = None  # indices or names; None = all
    covariates: str | None = None  # covariate file
    n_pcs: int = 0
    maf: float = config.DEFAULT_MAF
    geno: float = config.DEFAULT_GENO
    het: float = config.DEFAULT_HET
    grm_method: int = 1
    force_model: bool = False
    block: int = config.DEFAULT_SNP_BLOCK
    write_tsv: bool = True
    splmm_cutoff: float = config.knob("JX_TPU_SPARSE_CUTOFF")  # reference default 0.05 (workflow.py:6701)
    # -splmm-exact's own cutoff (None = splmm_cutoff); the reference keeps
    # one cutoff per run config, so the two routes may differ in one run
    splmm_exact_cutoff: float | None = None
    lowrank_snps: int = 4096  # kinship SNPs for the -lowrank FaST-LMM route
    # -global: reuse the full-sample row-stat pass for trait subsets
    # instead of strict-train re-preparation (reference workflow.py:6895)
    global_stats: bool = False
    genetic_model: str = "add"  # add|dom|rec|het (fastlmm_lowrank.rs)
    lowrank_ld_prune: bool = False  # LD-prune the kinship SNP picks
    scan_method: str = config.knob("JX_TPU_SCAN_METHOD")  # lmm lambda search: "grid" | "brent"
    # -spk: sparse-GRM source for the splmm routes — "1" centered,
    # "2" standardized, or a precomputed .jxgrm/.spgrm path
    # (reference workflow.py -spk/--grm-sparse)
    sparse_grm: str = "1"
    # -bimrange chr:start-end (repeatable): restrict only the final scan;
    # GRM/PCA/covariate prep still use the full genotype
    scan_ranges: tuple = ()
    # --farmcpu-* dev knobs (reference parse_args)
    farmcpu_iter: int = 10
    farmcpu_threshold: float | None = None
    farmcpu_qtn_bound: int | None = None
    farmcpu_nbin: int = 5
    farmcpu_bin_sizes: tuple = (500_000, 5_000_000, 50_000_000)
    # -trait-level: batched scans of the traits that share a sample mask,
    # and combined multi-trait TSVs beside the per-trait files
    trait_level: bool = False
    # -qvcf/-qhmp/-qbfile/-qfile: alternate QTN-search panel for the
    # FarmCPU/ALGWAS stage-1 selection (reference dev flags)
    qtn_genotype: str | None = None
    use_cache: bool = True  # GRM npy+id cache with reference naming
    # devices over the 'snp' mesh axis: None = all local devices (mesh is
    # skipped when only 1 is available), 1 = force single-device
    n_devices: int | None = None


@dataclass
class TraitRunResult:
    trait: str
    model: str  # model actually run (after any LMM->LM switch)
    requested_model: str
    result: ScanResult
    n_samples: int
    n_snps: int
    lambda_null: float | None = None
    switch_lrt_p: float | None = None
    tsv_path: str | None = None
    seconds: float = 0.0
    stages: dict = field(default_factory=dict)  # this run's stage seconds


def lmm_to_lm_switch_p(basis, y, covariates) -> float:
    """Boundary LRT p for H0: Va = 0 (mixed null vs OLS null), the
    reference's rule (workflow.py:848 + src/stats/gwas_unified.rs:121-175):
    stat = 2*(ML_lmm0 - ML_lm0), p = 0.5*chi2_sf_df1(stat); switch to LM
    when p >= 0.05. Host null fit."""
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = lm_mod.design_matrix(n, covariates)
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


def _range_mask(sites, ranges) -> np.ndarray:
    """Indices of SNPs inside any -bimrange spec (chr:start-end or
    chr:start:end; values < 1e5 are Mb, larger are bp — reference
    workflow.py -bimrange help)."""
    chrom = np.asarray(sites.chrom, dtype=object).astype(str)
    pos = np.asarray(sites.pos, np.int64)
    mask = np.zeros(len(pos), bool)
    for spec in ranges:
        txt = str(spec).strip()
        if ":" not in txt:
            raise ValueError(f"-bimrange wants chr:start-end, got {spec!r}")
        c, rest = txt.split(":", 1)
        sep = ":" if ":" in rest else "-"
        a_s, b_s = rest.split(sep, 1)
        a, b = float(a_s), float(b_s)
        # Mb by default; large values treated as bp
        lo = int(a * 1e6) if a < 1e5 else int(a)
        hi = int(b * 1e6) if b < 1e5 else int(b)
        mask |= (chrom == c.strip()) & (pos >= lo) & (pos <= hi)
    return np.nonzero(mask)[0]


@contextlib.contextmanager
def _timed(stages: dict, key: str, label: str):
    """The stage ``label`` logged and its seconds added to ``stages[key]``
    (the run summary's); a profiled run shows it as the span ``key``."""
    t0 = time.monotonic()
    with stage(label, log), trace.span(key):
        yield
    stages[key] = stages.get(key, 0.0) + time.monotonic() - t0


def _check_models(models) -> None:
    for m in models:
        if m not in MODELS:
            raise ValueError(f"unknown model: {m}")
    if "farmcpu" in models and "frgwas" in models:
        # reference parity (assoc/workflow.py:6979): both share the FarmCPU
        # TSV tag, so running both would overwrite one output
        raise ValueError("only one of farmcpu / frgwas may be requested")


def _sparse_grms(cfg: GwasConfig, samples, pg_full, stages: dict):
    """The -splmm routes' thresholded GRMs on all genotyped samples:
    (K for -splmm, K for -splmm-exact when its own cutoff differs, else
    None). Built band by band with a .jxgrm cache (reference
    _ensure_splmm_sparse_grm, workflow_model_packed.py:807), or read from
    a precomputed -spk file whose .id sidecar aligns its rows to the
    genotype samples (janusx_tpu/workflows/gwas.py:214-279)."""
    from janusx_tpu_torch.utils.cache import _read_id_column, load_or_build_sparse_grm

    if cfg.sparse_grm not in ("1", "2"):
        from janusx_tpu_torch.io.jxgrm import read_jxgrm

        with _timed(stages, "sparse_grm", "sparse GRM (precomputed)"):
            Ksp = read_jxgrm(cfg.sparse_grm).tocsr()
        id_candidates = [cfg.sparse_grm + ".id",
                         os.path.splitext(cfg.sparse_grm)[0] + ".id"]
        id_path = next((c for c in id_candidates if os.path.exists(c)), None)
        if id_path is not None:
            grm_ids = _read_id_column(id_path)
            if len(grm_ids) != Ksp.shape[0]:
                raise ValueError(f"-spk id sidecar has {len(grm_ids)} ids, GRM dim "
                                 f"{Ksp.shape[0]}")
            pos = {g: i for i, g in enumerate(grm_ids)}
            missing = [str(s_) for s_ in samples if str(s_) not in pos]
            if missing:
                raise ValueError(f"{len(missing)} genotype samples absent from the "
                                 f"-spk GRM ids, e.g. {missing[:3]}")
            perm = np.array([pos[str(s_)] for s_ in samples])
            if not np.array_equal(perm, np.arange(len(perm))):
                Ksp = Ksp[perm][:, perm].tocsr()
        elif Ksp.shape[0] != len(samples):
            raise ValueError(f"-spk GRM has {Ksp.shape[0]} samples, genotype has "
                             f"{len(samples)} (and no .id sidecar to align by)")
        else:
            log.warning("-spk GRM has no .id sidecar: assuming its rows "
                        "already match the genotype sample order")
        return Ksp, None
    sp_method = 2 if cfg.sparse_grm == "2" else cfg.grm_method

    def build(cutoff, label):
        with _timed(stages, "sparse_grm", label):
            return load_or_build_sparse_grm(
                cfg.genotype, pg_full, cfg.maf, cfg.geno, cutoff, method=sp_method,
                block=cfg.block, use_cache=cfg.use_cache)

    Ksp = build(cfg.splmm_cutoff, "sparse GRM (band-streamed)")
    exact_cut = _exact_cutoff(cfg)
    if "splmm-exact" in cfg.models and exact_cut != cfg.splmm_cutoff:
        return Ksp, build(exact_cut, "sparse GRM (exact-route cutoff)")
    return Ksp, None


def _exact_cutoff(cfg: GwasConfig) -> float:
    return cfg.splmm_cutoff if cfg.splmm_exact_cutoff is None else cfg.splmm_exact_cutoff


def resolve_mesh(n_devices: int | None):
    """The production device mesh: all local devices on the 'snp' axis
    (None when that degenerates to a single device). JX_TPU_DEVICES caps
    the count when the caller does not."""
    from janusx_tpu_torch.parallel import mesh as mesh_mod

    avail = len(mesh_mod.visible_devices())
    if n_devices is None:
        n_devices = config.knob("JX_TPU_DEVICES")
    nd = avail if n_devices is None else min(n_devices, avail)
    if nd <= 1:
        return None
    return mesh_mod.make_mesh(nd)


def run_gwas(cfg: GwasConfig) -> list[TraitRunResult]:
    t0 = time.monotonic()
    _check_models(cfg.models)
    config.set_full_f32_matmul()
    config.resolve_device()  # fail before any work when no device fits
    stages: dict = {}
    qc = QcParams(maf=cfg.maf, geno=cfg.geno, het=cfg.het)
    mesh = resolve_mesh(cfg.n_devices)
    if mesh is not None:
        log.info("device mesh: %d devices on the 'snp' axis", mesh.devices.size)
    with _timed(stages, "load", "load genotypes"):
        raw = load_raw_packed(cfg.genotype)
        qraw = load_raw_packed(cfg.qtn_genotype) if cfg.qtn_genotype else None
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
    K = None
    if cfg.n_pcs > 0 or any(m in _MIXED + ("fvlmm2",) for m in cfg.models):
        with _timed(stages, "grm", "GRM"):
            K = load_or_build_grm(
                cfg.genotype, pg_full, cfg.maf, cfg.geno, method=cfg.grm_method,
                block=cfg.block, use_cache=cfg.use_cache, mesh=mesh,
            )
    # sparse-only model sets never build the dense n² GRM
    Ksp, Ksp_exact = (_sparse_grms(cfg, raw.samples, pg_full, stages)
                      if any(m in _SPARSE for m in cfg.models) else (None, None))
    pcs_full = None
    if cfg.n_pcs > 0:
        pcs_full = load_or_build_pcs(
            cfg.genotype, K, raw.samples, cfg.maf, cfg.geno, cfg.n_pcs,
            method=cfg.grm_method, use_cache=cfg.use_cache,
        )
    cov_parts = [c for c in (pcs_full, cov_all) if c is not None]
    cov_full = np.concatenate(cov_parts, axis=1) if cov_parts else None

    def subset(keep, st: dict, trait):
        """The packed genotypes of an analysis-sample subset."""
        if cfg.global_stats and len(keep) < raw.n_samples:
            with _timed(st, "subset_qc", f"subset columns, global stats ({trait})"):
                return subset_samples_keep_stats(pg_full, keep)
        if len(keep) == raw.n_samples:
            return pg_full  # all samples kept: identical to pg_full
        with _timed(st, "subset_qc", f"prepare subset ({trait})"):
            return raw.prepare(qc, sample_idx=keep)

    def ranged(entry):
        """-bimrange: restrict only the scan; GRM/PCA used the full set."""
        if "pg_ranges" not in entry:
            entry["ranges_idx"] = _range_mask(entry["pg"].sites, cfg.scan_ranges)
            entry["pg_ranges"] = entry["pg"].take_snps(entry["ranges_idx"])
        return entry["pg_ranges"]

    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_prefix)) or ".", exist_ok=True)
    out: list[TraitRunResult] = []
    summary = []
    # traits with identical analysis-sample masks share the prepared subset
    # and eigenbasis (common case: fully-observed multi-trait tables)
    prep_cache: dict = {}
    # -trait-level: batch the traits that share a sample mask into one scan
    # per model (decode + rotation amortized across traits — reference
    # trait-level fast path, janusx_tpu/workflows/gwas.py:295-372)
    batched: dict = {}  # (trait, model) -> ScanResult, or (ScanResult, NullFit)
    batchable = [m for m in cfg.models if m in ("lm",) + _MIXED]
    if cfg.trait_level and batchable and len(ph.traits) > 1:
        groups: dict = {}
        for ti, trait in enumerate(ph.traits):
            keep = analysis_sample_index(y_all[:, ti], cov_full)
            if len(keep) >= 10:
                groups.setdefault(keep.tobytes(), []).append((ti, trait, keep))
        for mask_key, members in groups.items():
            if len(members) < 2:
                continue
            keep = members[0][2]
            entry = prep_cache[mask_key] = {
                "pg": subset(keep, stages, "trait-level batch"), "basis": None}
            pg_b = entry["pg"]
            if cfg.scan_ranges:
                pg_b = ranged(entry)
                if pg_b.m == 0:
                    continue
            cov_b = None if cov_full is None else cov_full[keep]
            if "lm" in batchable:
                Yb = np.stack([y_all[keep, ti] for ti, *_ in members], axis=1)
                with _timed(stages, "batch_lm", f"trait-level lm batch ({len(members)} traits)"):
                    res_b = lm_mod.lm_scan_multi(pg_b, Yb, cov_b, block=cfg.block,
                                                 mesh=mesh)
                for (_, trait, _), r in zip(members, res_b):
                    batched[(str(trait), "lm")] = r
            mixed = [m for m in _MIXED if m in batchable]
            if cfg.scan_method != "grid":
                # lmm_scan_multi is grid-only; -scan-method brent keeps the
                # per-trait path for the LMMs
                mixed = [m for m in mixed if m == "fvlmm"]
            if not mixed:
                continue
            with _timed(stages, "eigh", "eigh (trait-level batch)"):
                entry["basis"] = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
            mem = members
            if not cfg.force_model:
                # the LMM->LM switch is per trait: batch only the traits
                # that keep the mixed model
                mem = [mm for mm in members if lmm_to_lm_switch_p(
                    entry["basis"], y_all[keep, mm[0]], cov_b) < 0.05]
            if len(mem) < 2:
                continue
            Yb = np.stack([y_all[keep, ti] for ti, *_ in mem], axis=1)
            for model_b in mixed:
                with _timed(stages, f"batch_{model_b}",
                            f"trait-level {model_b} batch ({len(mem)} traits)"):
                    if model_b == "fvlmm":
                        res_b, nulls_b = fvlmm_mod.fvlmm_scan_multi(
                            pg_b, entry["basis"], Yb, cov_b, block=cfg.block, mesh=mesh)
                    else:
                        res_b, nulls_b = lmm_mod.lmm_scan_multi(
                            pg_b, entry["basis"], Yb, cov_b, block=cfg.block,
                            lmm2=(model_b == "lmm2"), mesh=mesh)
                for (_, trait, _), r, nl in zip(mem, res_b, nulls_b):
                    batched[(str(trait), model_b)] = (r, nl)

    for ti, trait in enumerate(ph.traits):
        keep = analysis_sample_index(y_all[:, ti], cov_full)
        if len(keep) < 10:
            log.warning("trait %s: only %d usable samples, skipping", trait, len(keep))
            continue
        y_t = y_all[keep, ti]
        cov_t = None if cov_full is None else cov_full[keep]
        ts: dict = {}  # this trait's preparation stages, given to its first run
        entry = prep_cache.get(keep.tobytes())
        if entry is None:
            entry = prep_cache[keep.tobytes()] = {"pg": subset(keep, ts, trait),
                                                  "basis": None}
        pg_t = entry["pg"]
        if qraw is not None and "pg_qtn" not in entry:
            qpos = {str(s_): i for i, s_ in enumerate(qraw.samples)}
            want = [str(raw.samples[i]) for i in keep]
            missing = [w for w in want if w not in qpos]
            if missing:
                raise ValueError(
                    f"{len(missing)} analysis samples absent from the "
                    f"QTN-search panel, e.g. {missing[:3]}")
            entry["pg_qtn"] = qraw.prepare(
                qc, sample_idx=np.array([qpos[w] for w in want]))
        if cfg.scan_ranges:
            pg_t = ranged(entry)
            if pg_t.m == 0:
                log.warning("trait %s: no SNPs inside -bimrange, skipping", trait)
                continue
        log.info("trait %s: n=%d m=%d models=%s", trait, len(keep), pg_t.m, cfg.models)

        def get_basis(st):
            if entry["basis"] is None:
                with _timed(st, "eigh", f"eigh ({trait})"):
                    entry["basis"] = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
            return entry["basis"]

        for model in cfg.models:
            t1 = time.monotonic()
            rs, ts = ts, {}  # rs: this run's stages
            requested = model
            switch_p = None
            lbd_null = None
            if model in _MIXED and not cfg.force_model:
                switch_p = lmm_to_lm_switch_p(get_basis(rs), y_t, cov_t)
                if switch_p >= 0.05:
                    log.info("trait %s: null LRT p=%.3g >= 0.05, switching %s -> lm",
                             trait, switch_p, model)
                    model = "lm"
                else:
                    log.info("trait %s: null LRT p=%.3g < 0.05, keeping %s",
                             trait, switch_p, model)
            if model == "lowrank":
                # FaST-LMM: kinship from q SNP columns, its basis cached per
                # sample mask and made from the full SNP set even under
                # -bimrange (the restriction is scan-only); the dense n² GRM
                # is never formed
                from janusx_tpu_torch.models import fastlmm as fl

                if entry.get("lrb") is None:
                    with _timed(rs, "lowrank_basis", f"low-rank kinship basis ({trait})"):
                        entry["lrb"] = fl.lowrank_basis_from_snps(
                            entry["pg"], q=cfg.lowrank_snps, method=cfg.grm_method,
                            ld_prune=cfg.lowrank_ld_prune)
                rot_lr = fl.make_rotated_lr(entry["lrb"], y_t, cov_t)
                null = None
                if not cfg.force_model:
                    with _timed(rs, "null_fit", f"low-rank null fit ({trait})"):
                        switch_p, null = fl.lowrank_switch_p(rot_lr)
                    if switch_p >= 0.05:
                        log.info("trait %s: null LRT p=%.3g >= 0.05, switching "
                                 "lowrank -> lm", trait, switch_p)
                        model = "lm"
            key = (str(trait), model)
            basis = get_basis(rs) if model in _MIXED + ("fvlmm2",) else None
            if model in ("lmm", "lmm2") and key not in batched:
                with _timed(rs, "null_fit", f"null REML fit ({trait})"):
                    null = lmm_mod.fit_null(basis, y_t, cov_t)
            with _timed(rs, "scan", f"{model} scan ({trait})"):
                if model == "lm":
                    if requested == "lm" and key in batched:
                        res = batched[key]
                    else:
                        res = lm_mod.lm_scan(pg_t, y_t, cov_t, block=cfg.block,
                                             mesh=mesh)
                elif model in _MIXED and key in batched:
                    res, null = batched[key]
                    lbd_null = null.lbd
                elif model == "fvlmm":
                    res, null = fvlmm_mod.fvlmm_scan(pg_t, basis, y_t, cov_t,
                                                     block=cfg.block, mesh=mesh)
                    lbd_null = null.lbd
                elif model in ("lmm", "lmm2"):
                    res, null = lmm_mod.lmm_scan(
                        pg_t, basis, y_t, cov_t, block=cfg.block,
                        lmm2=(model == "lmm2"), null=null, method=cfg.scan_method,
                        mesh=mesh)
                    lbd_null = null.lbd
                elif model == "lowrank":
                    res, null = fl.fastlmm_scan(
                        pg_t, entry["lrb"], y_t, cov_t, block=cfg.block,
                        model=cfg.genetic_model, rot=rot_lr, null=null, mesh=mesh)
                    lbd_null = null.lbd
                elif model == "splmm":
                    from janusx_tpu_torch.models.splmm import splmm_grammar_scan

                    res, info = splmm_grammar_scan(
                        pg_t, Ksp[keep][:, keep].tocsc(), y_t, cov_t,
                        cutoff=cfg.splmm_cutoff, block=cfg.block, mesh=mesh)
                    lbd_null = info["lambda_null"]
                elif model == "splmm-exact":
                    from janusx_tpu_torch.models.splmm import splmm_exact_scan

                    Ksp_e = Ksp if Ksp_exact is None else Ksp_exact
                    res, info = splmm_exact_scan(
                        pg_t, Ksp_e[keep][:, keep].tocsc(), y_t, cov_t,
                        cutoff=_exact_cutoff(cfg), block=cfg.block, mesh=mesh)
                    lbd_null = info["lambda_null"]
                elif model == "algwas":
                    from janusx_tpu_torch.models.algwas import algwas_scan

                    res = algwas_scan(pg_t, y_t, cov_t, block=cfg.block,
                                      pg_qtn=entry.get("pg_qtn"), mesh=mesh).result
                elif model in ("farmcpu", "frgwas"):
                    from janusx_tpu_torch.models import farmcpu as fc

                    kw = dict(block=cfg.block, p_threshold=cfg.farmcpu_threshold,
                              max_loops=cfg.farmcpu_iter,
                              window_sizes=tuple(cfg.farmcpu_bin_sizes),
                              qtn_bound=cfg.farmcpu_qtn_bound, nbin=cfg.farmcpu_nbin,
                              mesh=mesh)
                    if model == "farmcpu":
                        res = fc.farmcpu_scan(pg_t, y_t, cov_t,
                                              pg_qtn=entry.get("pg_qtn"), **kw).result
                    else:
                        res = fc.farmcpu_unified_scan(pg_t, y_t, cov_t, **kw).result
                else:  # lm2 / fvlmm2
                    # interaction covariate = LAST covariate column (reference
                    # hidden G-by-C routes, src/stats/glm2.rs / fvlmm2.rs)
                    from janusx_tpu_torch.models.gxe import gxe_scan

                    if cov_t is None or cov_t.shape[1] == 0:
                        raise ValueError(f"{model} needs a covariate (-c/-q) for "
                                         "the interaction term")
                    res, null2 = gxe_scan(
                        pg_t, y_t, cov_t[:, -1], cov_t[:, :-1] if cov_t.shape[1] > 1 else None,
                        basis=basis,
                        block=cfg.block, mesh=mesh)
                    lbd_null = None if null2 is None else null2.lbd
            secs = time.monotonic() - t1
            tsv_path = None
            if cfg.write_tsv:
                tag = _TAGS[requested if requested != model and model == "lm" else model]
                tsv_path = f"{cfg.out_prefix}.{trait}.{tag}.assoc.tsv"
                with _timed(rs, "tsv", f"write TSV ({trait}, {tag})"):
                    res.write_tsv(tsv_path)
            out.append(TraitRunResult(
                trait=str(trait), model=model, requested_model=requested, result=res,
                n_samples=len(keep), n_snps=pg_t.m, lambda_null=lbd_null,
                switch_lrt_p=switch_p, tsv_path=tsv_path, seconds=secs, stages=rs,
            ))
            summary.append({
                "trait": str(trait), "model": model, "requested": requested,
                "n": len(keep), "m": pg_t.m, "seconds": round(secs, 3),
                "lambda_null": lbd_null, "tsv": tsv_path, "stages": rs,
            })
    if cfg.write_tsv and cfg.trait_level:
        with _timed(stages, "traitlevel_tsv", "trait-level combined TSVs"):
            _write_trait_level(cfg.out_prefix, out)
    if cfg.write_tsv:
        with open(f"{cfg.out_prefix}.gwas.summary.json", "wt") as fh:
            json.dump({"runs": summary, "stages": stages,
                       "total_seconds": round(time.monotonic() - t0, 3)},
                      fh, indent=2)
        from janusx_tpu_torch.utils.history import record_run

        record_run("gwas", cfg.out_prefix,
                   {"models": list(cfg.models), "genotype": cfg.genotype},
                   [r.tsv_path for r in out if r.tsv_path],
                   round(time.monotonic() - t0, 3))
    return out


def _write_trait_level(prefix: str, runs: list[TraitRunResult]) -> None:
    """-trait-level: combined multi-trait TSVs with leading `trait` and
    `model` columns. Runs are grouped by output schema (lmm2 carries extra
    plrt/lambda/ml columns) so every file is rectangular; the first schema
    keeps the plain name, extra schemas get a model suffix
    (janusx_tpu/workflows/gwas.py:622-644)."""
    by_header: dict = {}
    for r in runs:
        if not r.tsv_path or not os.path.exists(r.tsv_path):
            continue
        with open(r.tsv_path) as src:
            hdr = src.readline()
        by_header.setdefault(hdr, []).append(r)
    for gi, (hdr, runs_h) in enumerate(by_header.items()):
        tag = "" if gi == 0 else f".{runs_h[0].model}"
        path = f"{prefix}.traitlevel{tag}.assoc.tsv"
        with open(path, "wt") as fh:
            fh.write("trait\tmodel\t" + hdr)
            for r in runs_h:
                with open(r.tsv_path) as src:
                    src.readline()
                    for line in src:
                        fh.write(f"{r.trait}\t{r.model}\t" + line)
        log.info("trait-level combined TSV: %s", path)
