"""Bulked-segregant analysis preprocessing.

Replaces the reference BSA module (JanusX src/stats/bsa.rs:
Δ-SNP index and G' statistics; python/janusx/script/postbsa.py:
depth/GQ/frequency filter chain, Euclidean-distance statistic, stepped
sliding-window smoothing). Input: per-site ALT/REF allele depths of
two bulks. Outputs SNP-index per bulk, ΔSNP-index, the G statistic,
ED, tricube-smoothed G' and stepped window means (Magwene et al. 2011).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BsaResult:
    chrom: np.ndarray
    pos: np.ndarray
    snp_index1: np.ndarray
    snp_index2: np.ndarray
    delta: np.ndarray
    g_stat: np.ndarray
    g_prime: np.ndarray
    ed: np.ndarray | None = None


def snp_index(alt: np.ndarray, ref: np.ndarray) -> np.ndarray:
    tot = alt + ref
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(tot > 0, alt / tot, np.nan)


def g_statistic(alt1, ref1, alt2, ref2) -> np.ndarray:
    """Standard BSA G statistic (2*sum obs*ln(obs/exp) over the 2x2 table)."""
    obs = np.stack([alt1, ref1, alt2, ref2], axis=1).astype(np.float64)
    n = obs.sum(axis=1, keepdims=True)
    row1 = (obs[:, 0] + obs[:, 1])[:, None]
    row2 = (obs[:, 2] + obs[:, 3])[:, None]
    col_alt = (obs[:, 0] + obs[:, 2])[:, None]
    col_ref = (obs[:, 1] + obs[:, 3])[:, None]
    exp = np.concatenate(
        [row1 * col_alt, row1 * col_ref, row2 * col_alt, row2 * col_ref], axis=1
    ) / np.maximum(n, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where((obs > 0) & (exp > 0), obs * np.log(obs / exp), 0.0)
    return 2.0 * terms.sum(axis=1)


def ed_statistic(idx1: np.ndarray, idx2: np.ndarray) -> np.ndarray:
    """Per-site Euclidean distance between bulk allele-frequency vectors
    (Hill et al. 2013). For a biallelic site the frequency vectors are
    (i, 1-i), so ED = sqrt((i2-i1)^2 + ((1-i2)-(1-i1))^2) = sqrt(2)|i2-i1|
    — reference: script/postbsa.py ED column. Raise to the -ed power
    (default 4) before window smoothing to sharpen linked peaks."""
    return np.sqrt(2.0) * np.abs(np.asarray(idx2, float) - np.asarray(idx1, float))


@dataclass
class DepthFilterResult:
    """Keep-mask plus per-stage (label, kept_before, kept_after) audit."""

    keep: np.ndarray
    stages: list = field(default_factory=list)

    @property
    def n_kept(self) -> int:
        return int(self.keep.sum())


def filter_bulk_depths(
    dp1, ad1, dp2, ad2,
    gq1=None, gq2=None,
    *,
    min_dp: int = 15,
    min_gq: int = 90,
    total_dp: tuple = (30, 300),
    depth_difference: int = 150,
    ref_allele_freq: float = 0.2,
) -> DepthFilterResult:
    """Reference postbsa locus filter chain (script/postbsa.py:818-873):
    per-bulk DP >= minDP, per-bulk GQ >= minGQ, total DP in [lo, hi],
    |DP1-DP2| <= depthDifference, and the allele-frequency filter that
    drops sites where BOTH bulk SNP-indexes sit below ref_allele_freq or
    both above 1-ref_allele_freq (uninformative/homozygous in both bulks).

    GQ arrays are optional (depth-only tables skip that stage). Filters
    compose as one boolean mask — each per-row predicate is independent,
    so the sequential drops in the reference equal this conjunction; the
    stage audit reproduces the reference's per-stage kept counts."""
    dp1, dp2 = np.asarray(dp1, float), np.asarray(dp2, float)
    ad1, ad2 = np.asarray(ad1, float), np.asarray(ad2, float)
    stages: list = []
    keep = np.ones(len(dp1), bool)

    def _stage(label, pred):
        nonlocal keep
        before = int(keep.sum())
        keep = keep & pred
        stages.append((label, before, int(keep.sum())))

    _stage(f"bulk1.DP>=minDP({min_dp})", dp1 >= min_dp)
    _stage(f"bulk2.DP>=minDP({min_dp})", dp2 >= min_dp)
    if gq1 is not None:
        _stage(f"bulk1.GQ>=minGQ({min_gq})", np.asarray(gq1, float) >= min_gq)
    if gq2 is not None:
        _stage(f"bulk2.GQ>=minGQ({min_gq})", np.asarray(gq2, float) >= min_gq)
    tot = dp1 + dp2
    _stage(f"totalDP>=min({total_dp[0]})", tot >= total_dp[0])
    _stage(f"totalDP<=max({total_dp[1]})", tot <= total_dp[1])
    _stage(f"|DPdiff|<=depthDifference({depth_difference})",
           np.abs(dp1 - dp2) <= depth_difference)
    with np.errstate(divide="ignore", invalid="ignore"):
        i1 = np.where(dp1 > 0, ad1 / dp1, np.nan)
        i2 = np.where(dp2 > 0, ad2 / dp2, np.nan)
    both_low = (i1 < ref_allele_freq) & (i2 < ref_allele_freq)
    both_high = (i1 > 1 - ref_allele_freq) & (i2 > 1 - ref_allele_freq)
    _stage(f"refAlleleFreq({ref_allele_freq})", ~(both_low | both_high))
    return DepthFilterResult(keep=keep, stages=stages)


@dataclass
class BsaWindows:
    """Stepped sliding-window smooth of the per-SNP BSA tracks
    (reference: script/postbsa.py compute_smooth_df)."""

    chrom: np.ndarray
    center: np.ndarray
    n_snps: np.ndarray
    index1: np.ndarray
    index2: np.ndarray
    delta: np.ndarray
    ed_power: np.ndarray
    g_prime: np.ndarray


def _window_nanmean(values, lo, hi):
    """Prefix-sum nan-mean of values over [lo, hi) index windows."""
    v = np.asarray(values, float)
    finite = np.isfinite(v)
    cs = np.concatenate([[0.0], np.cumsum(np.where(finite, v, 0.0))])
    ck = np.concatenate([[0], np.cumsum(finite.astype(np.int64))])
    cnt = ck[hi] - ck[lo]
    out = np.full(len(lo), np.nan)
    ok = cnt > 0
    out[ok] = (cs[hi] - cs[lo])[ok] / cnt[ok]
    return out, cnt


def bsa_windows(
    res: BsaResult,
    window_bp: int = 1_000_000,
    step_bp: int | None = None,
    ed_power: int = 4,
) -> BsaWindows:
    """Window centers every step_bp (default window/2) per chromosome;
    each center averages SNP-index / Δ / ED^power over ±window/2 and
    tricube-weights G into G'. Windows holding fewer than
    max(5, window_bp*1e-4) SNPs are dropped, as are chromosomes shorter
    than one window — reference: compute_smooth_df (postbsa.py:909-986)."""
    if step_bp is None:
        step_bp = window_bp // 2
    half = window_bp / 2.0
    min_snps = max(5, int(window_bp * 1e-4))
    ed = res.ed if res.ed is not None else ed_statistic(res.snp_index1,
                                                        res.snp_index2)
    edp = np.power(np.asarray(ed, float), ed_power)
    chrom = np.asarray(res.chrom).astype(str)
    pos = np.asarray(res.pos, np.float64)
    out: dict[str, list] = {k: [] for k in (
        "chrom", "center", "n", "i1", "i2", "d", "edp", "gp")}
    for c in dict.fromkeys(chrom):
        sel = np.nonzero(chrom == c)[0]
        order = np.argsort(pos[sel], kind="stable")
        sel = sel[order]
        p = pos[sel]
        if len(p) == 0 or p[-1] - p[0] < window_bp:
            continue
        centers = np.arange(p[0] + step_bp, p[-1], step_bp, dtype=np.float64)
        if centers.size == 0:
            continue
        lo = np.searchsorted(p, centers - half, side="left")
        hi = np.searchsorted(p, centers + half, side="right")
        valid = (hi - lo) >= min_snps
        if not valid.any():
            continue
        cols = {}
        for key, vals in (("i1", res.snp_index1[sel]),
                          ("i2", res.snp_index2[sel]),
                          ("d", res.delta[sel]), ("edp", edp[sel])):
            m, _ = _window_nanmean(vals, lo, hi)
            m[~valid] = np.nan
            cols[key] = m
        gp = _tricube_at_centers(p, np.asarray(res.g_stat, float)[sel],
                                 centers, half)
        gp[~valid] = np.nan
        keepw = valid
        out["chrom"].append(np.repeat(c, keepw.sum()))
        out["center"].append(centers[keepw])
        out["n"].append((hi - lo)[keepw])
        for key in ("i1", "i2", "d", "edp"):
            out[key].append(cols[key][keepw])
        out["gp"].append(gp[keepw])
    if not out["chrom"]:
        empty = np.empty(0)
        return BsaWindows(np.empty(0, dtype=str), empty,
                          np.empty(0, np.int64), empty, empty, empty,
                          empty, empty)
    cat = {k: np.concatenate(v) for k, v in out.items()}
    return BsaWindows(
        chrom=cat["chrom"], center=cat["center"], n_snps=cat["n"],
        index1=cat["i1"], index2=cat["i2"], delta=cat["d"],
        ed_power=cat["edp"], g_prime=cat["gp"],
    )


def _tricube_at_centers(pos, g, centers, half):
    """Tricube-weighted mean of g at arbitrary window centers."""
    finite = np.isfinite(g)
    out = np.full(centers.size, np.nan)
    if not finite.any():
        return out
    pv, gv = pos[finite], g[finite]
    lo = np.searchsorted(pv, centers - half, side="left")
    hi = np.searchsorted(pv, centers + half, side="right")
    for k in range(centers.size):
        if hi[k] <= lo[k]:
            continue
        d = np.abs(pv[lo[k]:hi[k]] - centers[k]) / max(half, 1.0)
        w = (1 - np.minimum(d, 1.0) ** 3) ** 3
        ws = w.sum()
        if ws > 0:
            out[k] = float(w @ gv[lo[k]:hi[k]]) / ws
    return out


def tricube_smooth(
    chrom: np.ndarray, pos: np.ndarray, values: np.ndarray, window_bp: int
) -> np.ndarray:
    """Per-chromosome tricube-weighted local mean (G' smoothing)."""
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos, np.float64)
    out = np.full(len(values), np.nan)
    half = window_bp / 2.0
    for c in dict.fromkeys(chrom):
        sel = np.nonzero(chrom == c)[0]
        p = pos[sel]
        v = values[sel]
        order = np.argsort(p)
        p, v, sel_o = p[order], v[order], sel[order]
        lo = np.searchsorted(p, p - half, side="left")
        hi = np.searchsorted(p, p + half, side="right")
        for k in range(len(p)):
            idx = slice(lo[k], hi[k])
            d = np.abs(p[idx] - p[k]) / max(half, 1.0)
            w = (1 - np.minimum(d, 1.0) ** 3) ** 3
            vv = v[idx]
            ok = np.isfinite(vv) & (w > 0)
            if ok.any():
                out[sel_o[k]] = np.average(vv[ok], weights=w[ok])
    return out


def bsa_analysis(
    chrom, pos, alt1, ref1, alt2, ref2,
    window_bp: int = 1_000_000,
    min_depth: int = 10,
    gprime: bool = True,
) -> BsaResult:
    """Per-SNP BSA tracks. gprime=False skips the per-SNP tricube G'
    (prefix/postbsa mode evaluates G' at stepped window centers instead,
    via bsa_windows — the reference never computes a per-SNP G' there)."""
    chrom = np.asarray(chrom)
    pos = np.asarray(pos, np.int64)
    alt1, ref1, alt2, ref2 = (
        np.asarray(a, np.float64) for a in (alt1, ref1, alt2, ref2)
    )
    ok = (alt1 + ref1 >= min_depth) & (alt2 + ref2 >= min_depth)
    i1 = np.where(ok, snp_index(alt1, ref1), np.nan)
    i2 = np.where(ok, snp_index(alt2, ref2), np.nan)
    # reference convention: Delta.SNPindex(bulk2-bulk1) (bsa.rs:226,282)
    delta = i2 - i1
    g = np.where(ok, g_statistic(alt1, ref1, alt2, ref2), np.nan)
    gp = (tricube_smooth(chrom, pos, g, window_bp) if gprime
          else np.full(len(g), np.nan))
    return BsaResult(
        chrom=chrom, pos=pos, snp_index1=i1, snp_index2=i2, delta=delta,
        g_stat=g, g_prime=gp, ed=ed_statistic(i1, i2),
    )
