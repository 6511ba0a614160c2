"""FarmCPU: iterative fixed-effect / random-effect multi-locus GWAS.

Functional re-implementation of the reference's raw ``-farmcpu`` route
(JanusX src/stats/farmcpu.rs:1-70 algorithm doc; rMVP-compatible
semantics, 49/49 QTN parity documented in doc/release/v1.0.26.md):

  iterate t = 0, 1, ...:
    1. FEM: conditional LM scan of every marker with the current
       pseudo-QTN genotypes appended to the covariates (device scan —
       same residualized machinery as `-lm`).
    2. Candidate bins: for each (window_bp, n_lead) grid pair, bin markers
       by genomic window, keep the best marker per window, take the top
       n_lead leads.
    3. REM: score each candidate lead set by the REML likelihood of an
       intercept-only mixed model whose kinship is built from the lead
       markers only (low-rank spectral — q x q eigenproblem, q = #leads).
    4. Select the argmin set, apply the significance threshold and the
       |r| > 0.7 redundancy rule against retained QTNs.
    5. Stop when the QTN set repeats (fixed point or 2-cycle) or the loop
       cap is reached.
  Final: FEM scan with the converged QTN set; pseudo-QTN rows report
  beta, se and p of their own coefficients in the joint background model
  (rMVP reports a pseudo-QTN's estimate from the final model).

This module began as a line-for-line copy of janusx_tpu/models/farmcpu.py
and is port-owned now, for three changes the copy could not take: the
spans of its host stages (``farmcpu``, ``fc_*``); one stable order of a
loop's p-values for all of its candidate lead sets (``_lead_sets``; the
copy sorted once per (window, count) pair, 15 full sorts a loop at the
defaults), sorted only as far as the walks reach, which gives the same
sets bit for bit; and the pseudo-QTN rows' beta and se, which the copy
took from a scan in which the marker is one of its own covariates, so
that g'M_X g was rounding error and beta and se were noise or NaN. The selection (every loop's QTN set, the final set and
the loop count) is held equal to the JAX package's by
tests/test_torch_farmcpu.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.lm import lm_scan, student_t_p_two_sided, design_matrix
from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.utils import trace

log = logging.getLogger("janusx_tpu.farmcpu")

WINDOW_SIZES = (500_000, 5_000_000, 50_000_000)  # rMVP bin.size ladder
DEFAULT_NBIN = 5  # reference --farmcpu-nbin default (workflow.py:6842)
LEAD_COUNTS = (10, 20, 30, 40, 50)  # legacy fixed ladder (tests/bench refs)
MAX_LOOPS = 10


def _default_qb(n: int) -> int:
    """Reference QTNbound default when --farmcpu-qtn-bound is unset
    (farmcpu.rs:4340-4352): max(1, floor(sqrt(n / log10 n)))."""
    if n <= 2:
        return 1
    den = np.log10(n)
    if not np.isfinite(den) or den <= 0:
        return 1
    return max(int(np.floor(np.sqrt(n / den))), 1)


def _lead_count_grid(qb: int, nbin: int) -> tuple[int, ...]:
    """Candidate lead-count grid for the REM selection stage.

    Reference semantics (src/stats/farmcpu.rs:4354-4358): ``nbin`` is the
    grid denominator — the grid is the nbin evenly spaced counts
    step=qb//nbin up to qb. The default (qb=50, nbin=5) gives
    (10, 20, 30, 40, 50)."""
    qb = max(int(qb), 1)
    step = max(qb // max(int(nbin), 1), 1)
    vals = tuple(range(step, qb + 1, step))
    return vals or (qb,)
LD_REDUNDANCY_R = 0.7
_KEY_STRIDE = 10_000_000_000  # _pos_key's chromosome stride
_WALK_CHUNK = 256  # first chunk of a lead walk; later chunks double
_HEAD = 4096  # markers of a loop's p order sorted before the walks


@trace.spanned("fc_map")
def _pos_key(pgq) -> np.ndarray:
    """Chromosome-major composite position key (stride 1e10, mirrored by
    _lead_sets' bin decomposition) — single definition for both routes.
    Chromosome ids follow first appearance; they are looked up once per run
    of equal labels rather than once per site."""
    chrom = np.asarray(pgq.sites.chrom)
    pos = np.asarray(pgq.sites.pos).astype(np.int64)
    new_run = np.ones(len(chrom), dtype=bool)
    new_run[1:] = chrom[1:] != chrom[:-1]
    starts = np.flatnonzero(new_run)
    labels = chrom[starts].tolist()
    chrom_ids = {c: i for i, c in enumerate(dict.fromkeys(labels))}
    run_ids = np.array([chrom_ids[c] for c in labels], dtype=np.int64)
    return np.repeat(run_ids, np.diff(np.append(starts, len(chrom)))) * _KEY_STRIDE + pos


def _stable_head(pvals: np.ndarray, k: int) -> np.ndarray:
    """The start of ``np.argsort(pvals, kind="stable")`` down to its k-th
    marker, ties with it included, from one partition and a sort of those
    markers alone; the whole order when fewer than k p-values are finite."""
    if len(pvals) > k:
        cut = np.partition(pvals, k - 1)[k - 1]
        if not np.isnan(cut):
            head = np.flatnonzero(pvals <= cut)
            return head[np.argsort(pvals[head], kind="stable")]
    return np.argsort(pvals, kind="stable")


def _walk(order: np.ndarray, bins: np.ndarray, k: int) -> np.ndarray:
    """The first k markers of ``order`` in distinct bins (fewer if the
    order runs out); ``bins[j]`` is the bin of marker ``order[j]``."""
    seen: set = set()
    leads: list = []
    start, chunk = 0, _WALK_CHUNK
    while len(leads) < k and start < len(order):
        for i, b in zip(order[start:start + chunk].tolist(),
                        bins[start:start + chunk].tolist()):
            if b not in seen:
                seen.add(b)
                leads.append(i)
                if len(leads) == k:
                    break
        start, chunk = start + chunk, 2 * chunk
    return np.array(leads, dtype=np.int64)


@trace.spanned("fc_bins")
def _lead_sets(pos_key: np.ndarray, pvals: np.ndarray, windows, lead_counts) -> dict:
    """Every candidate lead set of a loop, keyed (window, count): the best
    marker of each of the ``count`` most significant ``window``-bins.

    That set is the first ``count`` distinct bins met walking the markers
    in stable p order, so one stable order serves every window, one walk
    per window to the largest count finds its leads, and each count's set
    is a prefix of them, sorted. The order is sorted only as far as its
    first ``_HEAD`` markers (``_stable_head``); should a walk run past them,
    the walks are made again over the whole order. A window with fewer bins
    than a count gives all its bins. Windows never straddle chromosomes:
    the bin id is (chrom, pos//window) rather than pos_key//window, which
    merges a chromosome tail with the next head whenever window does not
    divide the 1e10 key stride."""
    k_max = max(lead_counts)

    def walks(order):  # the bins of the ordered markers only
        key = pos_key[order]
        chrom_part, within = key // _KEY_STRIDE * (1 << 40), key % _KEY_STRIDE
        return [_walk(order, chrom_part + within // win, k_max) for win in windows]

    order = _stable_head(pvals, _HEAD)
    leads = walks(order)
    if len(order) < len(pvals) and min(len(w) for w in leads) < k_max:
        leads = walks(np.argsort(pvals, kind="stable"))
    return {(win, nb): np.sort(w[:nb]) for win, w in zip(windows, leads) for nb in lead_counts}


@trace.spanned("fc_rem")
def _rem_score(Zq: np.ndarray, y: np.ndarray) -> float:
    """-REML loglik of y ~ N(1μ, vg K_q + ve I), K_q = Zq'Zq/q (low rank).

    Uses the thin SVD of Zq (q markers x n samples): the nonzero spectrum
    comes from a q x q eigenproblem, so scoring is O(n q^2).
    """
    q, n = Zq.shape
    if q == 0:
        return np.inf
    y = y - y.mean()
    Gq = Zq @ Zq.T / q  # (q, q)
    s, V = np.linalg.eigh(Gq)
    keep = s > 1e-10
    s = s[keep]
    U = (Zq.T @ V[:, keep]) / np.sqrt(np.maximum(s * q, 1e-30))  # (n, r) orthonormal
    yu = U.T @ y
    yy = float(y @ y)
    r_rank = len(s)

    def neg_reml(log10_lbd):
        lbd = 10.0 ** log10_lbd
        # V = s_i + lbd on the r-dim subspace, lbd elsewhere
        w = 1.0 / (s + lbd)
        quad = float(yu @ (w * yu)) + (yy - float(yu @ yu)) / lbd
        if quad <= 0:
            return 1e8
        logdet = float(np.log(s + lbd).sum()) + (n - r_rank) * np.log(lbd)
        return 0.5 * ((n - 1) * np.log(quad) + logdet)

    import scipy.optimize

    res = scipy.optimize.minimize_scalar(
        neg_reml, bounds=(-5, 5), method="bounded", options={"xatol": 1e-3}
    )
    return float(res.fun)


def _best_lead_set(pg, sets: dict, windows, lead_counts, y: np.ndarray) -> np.ndarray:
    """The candidate lead set of least -REML (``_rem_score``), the first in
    window then count order on a tie; empty if every set is. A loop's sets
    share most of their markers (each count's set is a prefix of its
    window's), so their union is decoded once and each set scored on its
    rows of it."""
    pool = np.unique(np.concatenate([sets[key] for key in sets]))
    Z = _decode_rows(pg, pool)
    best_score = np.inf
    best = np.array([], dtype=np.int64)
    for win in windows:
        for nb in lead_counts:
            leads = sets[win, nb]
            if len(leads) == 0:
                continue
            score = _rem_score(Z[np.searchsorted(pool, leads)], y)
            if score < best_score:
                best_score, best = score, leads
    return best


@dataclass
class FarmcpuResult:
    result: ScanResult
    qtns: np.ndarray  # indices of final pseudo-QTNs
    loops: int
    # per-loop selected QTN sets (after threshold/prune/bound, in loop
    # order, including the converged repeat) — selection-dynamics trace
    # for the independent cross-check suite (tests/test_farmcpu_independent.py)
    loop_sets: list = None


@trace.spanned("farmcpu")
def farmcpu_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    p_threshold: float | None = None,
    qtn_threshold: float = 0.01,
    max_loops: int = MAX_LOOPS,
    block: int = config.DEFAULT_SNP_BLOCK,
    window_sizes=WINDOW_SIZES,
    lead_counts=None,
    qtn_bound: int | None = None,
    nbin: int = DEFAULT_NBIN,
    pg_qtn: PackedGenotypes | None = None,
    mesh=None,
) -> FarmcpuResult:
    """pg_qtn (reference -qbfile/-qvcf/...): an alternate panel for the
    stage-1 QTN search loop; the final reported scan still runs on the
    main panel. `qtns` then indexes the QTN panel.

    ``mesh``: jax.sharding.Mesh with a 'snp' axis — every inner FEM scan
    (the O(m) work of each iteration) SNP-shards across the mesh exactly
    like the flagship `-lmm` route; the reference runs these under its
    full rayon/BLAS thread plan (src/stats/farmcpu.rs:1-68)."""
    y = np.asarray(y, np.float64).reshape(-1)
    if nbin < 1:
        raise ValueError("--farmcpu-nbin must be >= 1")
    if lead_counts is None:
        # reference --farmcpu-nbin: candidate-grid denominator over the
        # qtn-bound ceiling; the ceiling defaults to sqrt(n / log10 n)
        # like the reference (farmcpu.rs:4340-4358)
        lead_counts = _lead_count_grid(qtn_bound or _default_qb(len(y)), nbin)
    pgq = pg if pg_qtn is None else pg_qtn
    if pgq.n != pg.n:
        raise ValueError("QTN-search panel sample count differs from the main panel")
    n = pg.n
    m = pgq.m
    if p_threshold is None:
        p_threshold = 1.0 / m  # reference default when unset
        # (workflow_model_farmcpu.py:1184: 1 / tested_SNP_count)

    pos_key = _pos_key(pgq)  # chromosome-major composite ordering

    qtns = np.array([], dtype=np.int64)
    history = []
    loop_sets: list = []
    pvals = None
    loop = -1  # max_loops=0 -> final scan only
    for loop in range(max_loops):
        cov = covariates
        if len(qtns):
            Zq = _decode_rows(pgq, qtns)  # (q, n): never densify all m rows
            cov_q = Zq.T
            cov = cov_q if cov is None else np.concatenate([cov, cov_q], axis=1)
        res = lm_scan(pgq, y, cov, block=block, mesh=mesh)
        pvals = res.pwald.copy()
        if len(qtns):
            pvals[qtns] = _qtn_pvalues(pgq, y, covariates, qtns)[2]
        if loop == 0 and np.nanmin(pvals) >= p_threshold:
            log.info("farmcpu: no marker passes threshold %.3g", p_threshold)
            if pg_qtn is not None:
                res = lm_scan(pg, y, covariates, block=block, mesh=mesh)
            return FarmcpuResult(result=res, qtns=qtns, loops=loop + 1,
                                 loop_sets=loop_sets)

        # REM bin-size/lead-count selection: the grid is scored on the
        # UNFILTERED per-window lead sets; the qtn-threshold rule applies
        # to the winning set afterwards, with carried QTNs kept
        # (farmcpu.rs:832 select_lead_indices has no p cut;
        # farmcpu_raw_prepare_seq_qtn:899-911 filters the union with
        # keep_saved=true)
        sets = _lead_sets(pos_key, pvals, window_sizes, lead_counts)
        best_leads = _best_lead_set(pgq, sets, window_sizes, lead_counts, y)
        best_leads = best_leads[pvals[best_leads] < qtn_threshold]
        cand = np.unique(np.concatenate([qtns, best_leads]))
        # redundancy removal: |r| > 0.7 keeps the more significant marker
        cand = _prune_correlated(pgq, cand, pvals, LD_REDUNDANCY_R)
        if qtn_bound is not None and len(cand) > qtn_bound:
            # QTNbound override: keep the most significant (reference
            # --farmcpu-qtn-bound)
            cand = cand[np.argsort(pvals[cand])[:qtn_bound]]
            cand = np.sort(cand)
        key = tuple(cand.tolist())
        loop_sets.append(key)
        if np.array_equal(cand, qtns) or key in history:
            qtns = cand  # fixed point or 2-cycle -> converged
            break
        history.append(key)
        qtns = cand
        log.info("farmcpu loop %d: %d pseudo-QTNs", loop + 1, len(qtns))

    # final scan with converged QTN set (always on the MAIN panel)
    cov = covariates
    if len(qtns):
        cov_q = _decode_rows(pgq, qtns).T
        cov = cov_q if cov is None else np.concatenate([cov, cov_q], axis=1)
    final = lm_scan(pg, y, cov, block=block, mesh=mesh)
    if len(qtns) and pg_qtn is None:
        # pseudo-QTN rows: their coefficients in the joint background
        # model (in the scan each is one of its own covariates)
        final.beta[qtns], final.se[qtns], final.pwald[qtns] = _qtn_pvalues(
            pg, y, covariates, qtns)
    return FarmcpuResult(result=final, qtns=qtns, loops=loop + 1,
                         loop_sets=loop_sets)


@trace.spanned("fc_decode")
def _decode_rows(pg: PackedGenotypes, idx: np.ndarray) -> np.ndarray:
    """Batched centered decode of the requested SNP rows (one take_snps
    pass — the per-row loop this replaces cost O(q) full decode pipeline
    invocations per REM scoring round)."""
    idx = np.asarray(idx, dtype=np.int64)
    if len(idx) == 0:
        return np.empty((0, pg.n))
    return pg.take_snps(idx).centered()


@trace.spanned("fc_qtn_p")
def _qtn_pvalues(pg, y, covariates, qtns) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """beta, se and p of the pseudo-QTN coefficients in the joint background
    model (rMVP behavior: QTN rows report their covariate t-tests)."""
    Zq = _decode_rows(pg, qtns)
    n = pg.n
    X = design_matrix(n, covariates)
    Xf = np.concatenate([X, Zq.T], axis=1)
    k = Xf.shape[1]
    df = n - k
    if df <= 0:
        return np.full(len(qtns), np.nan), np.full(len(qtns), np.nan), np.ones(len(qtns))
    XtX = Xf.T @ Xf + 1e-10 * np.eye(k)
    Cinv = np.linalg.inv(XtX)
    beta = Cinv @ (Xf.T @ y)
    resid = y - Xf @ beta
    sigma2 = float(resid @ resid) / df
    se = np.sqrt(np.maximum(sigma2 * np.diag(Cinv), 1e-300))
    t = beta / se
    pv = student_t_p_two_sided(t, df)
    j = X.shape[1]
    return beta[j:], se[j:], pv[j:]


def _corr_matrix(pg, idx: np.ndarray) -> np.ndarray:
    """Pearson correlation matrix of the decoded rows in ``idx``."""
    Z = _decode_rows(pg, idx)
    Zs = Z - Z.mean(axis=1, keepdims=True)
    norms = np.sqrt((Zs * Zs).sum(axis=1))
    norms[norms == 0] = 1.0
    Zn = Zs / norms[:, None]
    return Zn @ Zn.T


@trace.spanned("fc_prune")
def _prune_correlated(pg, cand, pvals, r_cut):
    if len(cand) <= 1:
        return cand
    R = _corr_matrix(pg, cand)
    order = np.argsort(pvals[cand], kind="stable")
    keep = []
    for i in order:
        if all(abs(R[i, j]) <= r_cut for j in keep):
            keep.append(i)
    return np.sort(cand[np.array(keep, dtype=np.int64)])


# ---------------------------------------------------------------------------
# Unified route (`-frgwas`): r^2 window merging + seen-set masking + local
# stage2 re-scans (reference farmcpu.rs:44-68 algorithm doc).

STAGE1_MERGE_R2 = 0.8  # farmcpu.rs:2031
FINAL_MERGE_R2 = 0.5  # farmcpu.rs:2043
FINAL_WINDOW_BP = min(WINDOW_SIZES)  # farmcpu_final_window_bp


def _find(parent, a):
    while parent[a] != a:
        parent[a] = parent[parent[a]]
        a = parent[a]
    return a


def _merged_groups(
    pg, qtn_idx: np.ndarray, window_bp: int, r2_thr: float,
    merge_overlapping: bool,
) -> list[np.ndarray]:
    """Union-find groups of QTNs on the same chromosome joined by
    r^2 >= r2_thr (and, optionally, by +-window_bp overlap) —
    build_farmcpu_final_windows semantics."""
    k = len(qtn_idx)
    if k == 0:
        return []
    parent = list(range(k))
    chrom = pg.sites.chrom[qtn_idx]
    pos = pg.sites.pos[qtn_idx]
    R2 = _corr_matrix(pg, qtn_idx) ** 2
    for a in range(k):
        for b in range(a + 1, k):
            if chrom[a] != chrom[b]:
                continue
            joined = R2[a, b] >= r2_thr
            if merge_overlapping and not joined:
                joined = (pos[a] - window_bp <= pos[b] + window_bp) and (
                    pos[b] - window_bp <= pos[a] + window_bp
                )
            if joined:
                ra, rb = _find(parent, a), _find(parent, b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    groups: dict = {}
    for j in range(k):
        groups.setdefault(_find(parent, j), []).append(j)
    return [np.asarray(g, np.int64) for g in groups.values()]


def _merge_qtns(
    pg, qtn_idx: np.ndarray, scores: dict, window_bp: int, r2_thr: float,
    merge_overlapping: bool, cap: int,
) -> np.ndarray:
    """One best-score representative per merged group, capped at ``cap``
    (farmcpu_prune_qtn_by_merged_windows)."""
    if len(qtn_idx) == 0:
        return qtn_idx
    reps = []
    for g in _merged_groups(pg, qtn_idx, window_bp, r2_thr, merge_overlapping):
        members = qtn_idx[g]
        sc = np.array([scores.get(int(i), 1.0) for i in members])
        reps.append((float(sc.min()), int(members[int(np.argmin(sc))])))
    reps.sort()
    return np.sort(np.array([i for _, i in reps[:cap]], dtype=np.int64))


def farmcpu_unified_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    p_threshold: float | None = None,
    max_loops: int = MAX_LOOPS,
    qtn_cap: int = 150,
    block: int = config.DEFAULT_SNP_BLOCK,
    qtn_bound: int | None = None,
    nbin: int = DEFAULT_NBIN,
    window_sizes=WINDOW_SIZES,
    mesh=None,
) -> FarmcpuResult:
    """The `-frgwas` unified FarmCPU route (farmcpu.rs:44-68):

    stage1 per loop: FEM scan on the current background; REM grid pick of
    the lead set FROM UNMASKED markers (every pseudo-QTN ever selected is
    masked out of later candidate selection); union with the carried set;
    strict r^2 >= 0.8 merge to one representative per group. Converges on
    set fixed point / 2-cycle / nothing unmasked passing tau.
    stage2: relaxed r^2 >= 0.5 + overlapping-window merge, final scan,
    then per merged window a LOCAL conditional re-scan with that window's
    QTNs dropped from the background — window rows (incl. the pseudo-QTNs
    inside) report the local refit statistics."""
    y = np.asarray(y, np.float64).reshape(-1)
    if nbin < 1:
        raise ValueError("--farmcpu-nbin must be >= 1")
    lead_counts = _lead_count_grid(qtn_bound or _default_qb(len(y)), nbin)
    m = pg.m
    if p_threshold is None:
        p_threshold = 1.0 / m  # reference default: 1 / tested_SNP_count
        # (workflow_model_farmcpu.py:1184) — tau gates loop continuation

    pos_key = _pos_key(pg)  # chromosome-major composite ordering

    qtns = np.array([], dtype=np.int64)
    seen: set = set()
    best_score: dict = {}
    history = []
    loop = -1  # max_loops=0 -> final scan only
    for loop in range(max_loops):
        cov = covariates
        if len(qtns):
            cov_q = _decode_rows(pg, qtns).T
            cov = cov_q if cov is None else np.concatenate([cov, cov_q], axis=1)
        res = lm_scan(pg, y, cov, block=block, mesh=mesh)
        femp = res.pwald.copy()
        if len(qtns):
            femp[qtns] = _qtn_pvalues(pg, y, covariates, qtns)[2]
        masked = femp.copy()
        if seen:
            masked[np.fromiter(seen, dtype=np.int64)] = 1.0
        if np.nanmin(masked) >= p_threshold:
            log.info("frgwas loop %d: no unmasked marker passes tau", loop + 1)
            break

        # reference select_lead_indices (farmcpu.rs:832) applies NO p cut:
        # the REM likelihood alone picks the lead set; tau only gates loop
        # continuation (checked above)
        sets = _lead_sets(pos_key, masked, window_sizes, lead_counts)
        opt_lead = _best_lead_set(pg, sets, window_sizes, lead_counts, y)
        union = np.unique(np.concatenate([qtns, opt_lead]))
        for i in union:
            s = femp[i] if np.isfinite(femp[i]) else 1.0
            best_score[int(i)] = min(best_score.get(int(i), 1.0), float(s))
        nxt = _merge_qtns(
            pg, union, best_score, FINAL_WINDOW_BP, STAGE1_MERGE_R2,
            merge_overlapping=False, cap=qtn_cap,
        )
        seen.update(int(i) for i in nxt)
        key = tuple(nxt.tolist())
        if np.array_equal(nxt, qtns) or key in history:
            qtns = nxt
            break
        history.append(key)
        qtns = nxt
        log.info("frgwas loop %d: %d pseudo-QTNs", loop + 1, len(qtns))

    # final relaxed merge (r^2 >= 0.5 + window overlap, farmcpu.rs:58)
    qtns = _merge_qtns(
        pg, qtns, best_score, FINAL_WINDOW_BP, FINAL_MERGE_R2,
        merge_overlapping=True, cap=qtn_cap,
    )

    cov = covariates
    if len(qtns):
        cov_q = _decode_rows(pg, qtns).T
        cov = cov_q if cov is None else np.concatenate([cov, cov_q], axis=1)
    final = lm_scan(pg, y, cov, block=block, mesh=mesh)
    if len(qtns):
        # stage2 merged-window local re-scans (these windows cover every
        # pseudo-QTN, so a separate conditional refit of the QTN rows here
        # would be overwritten immediately)
        groups = _merged_groups(
            pg, qtns, FINAL_WINDOW_BP, FINAL_MERGE_R2, merge_overlapping=True
        )
        for g in groups:
            members = qtns[g]
            wchrom = pg.sites.chrom[members[0]]
            lo = int(pg.sites.pos[members].min()) - FINAL_WINDOW_BP
            hi = int(pg.sites.pos[members].max()) + FINAL_WINDOW_BP
            rows = np.nonzero(
                (pg.sites.chrom == wchrom)
                & (pg.sites.pos >= lo)
                & (pg.sites.pos <= hi)
            )[0]
            if len(rows) == 0:
                continue
            local_bg = np.setdiff1d(qtns, members)
            cov_l = covariates
            if len(local_bg):
                cov_b = _decode_rows(pg, local_bg).T
                cov_l = cov_b if cov_l is None else np.concatenate(
                    [cov_l, cov_b], axis=1
                )
            res_l = lm_scan(pg.take_snps(rows), y, cov_l, block=block,
                            mesh=mesh)
            final.beta[rows] = res_l.beta
            final.se[rows] = res_l.se
            final.pwald[rows] = res_l.pwald
    return FarmcpuResult(result=final, qtns=qtns, loops=loop + 1)
