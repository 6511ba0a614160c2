"""Haplotype phenotype-distribution plots with groupwise significance.

Reference: JanusX python/janusx/bioplotkit/haplotype.py (1,882 LoC)
— phenotype distributions across haplotype groups with:
  continuous mode: Welch's t (2 groups) / Tukey HSD (>=3) + compact-letter
  display; binomial mode: Fisher's exact (2) / chi-square omnibus +
  Holm-corrected pairwise Fisher (>=3), Wilson score CIs.
Re-implemented on scipy only (Tukey HSD via scipy.stats.studentized_range
— statsmodels is not a dependency here).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HaplotypeGroups:
    codes: np.ndarray  # (n,) group index, -1 = unassigned
    names: list  # group label per index (allele strings)
    counts: np.ndarray


def haplotype_groups(
    genotypes: np.ndarray, alleles=None, min_group: int = 5
) -> HaplotypeGroups:
    """Group samples by their joint genotype at the chosen SNP rows.

    genotypes: (k, n) dosage codes (0/1/2; negative = missing). Groups
    with fewer than ``min_group`` samples are dropped (-1)."""
    G = np.asarray(genotypes)
    if G.ndim == 1:
        G = G[None, :]
    k, n = G.shape
    keys = [tuple(G[:, j]) for j in range(n)]
    valid = [all(c >= 0 for c in key) for key in keys]
    uniq: dict = {}
    for j, key in enumerate(keys):
        if valid[j]:
            uniq.setdefault(key, []).append(j)
    kept = {key: idx for key, idx in uniq.items() if len(idx) >= min_group}
    order = sorted(kept, key=lambda key: -len(kept[key]))

    def label(key):
        if alleles is None:
            return "/".join(str(int(c)) for c in key)
        out = []
        for c, (a0, a1) in zip(key, alleles):
            out.append({0: a0 + a0, 1: a0 + a1, 2: a1 + a1}.get(int(c), "??"))
        return "|".join(out)

    codes = np.full(n, -1, np.int32)
    names = []
    for gi, key in enumerate(order):
        codes[kept[key]] = gi
        names.append(label(key))
    counts = np.array([len(kept[key]) for key in order])
    return HaplotypeGroups(codes=codes, names=names, counts=counts)


def welch_t(a: np.ndarray, b: np.ndarray) -> float:
    from scipy import stats

    return float(stats.ttest_ind(a, b, equal_var=False).pvalue)


def tukey_hsd_pvalues(groups: list) -> np.ndarray:
    """Pairwise Tukey-HSD p-value matrix via the studentized range
    distribution (equivalent to statsmodels pairwise_tukeyhsd)."""
    from scipy.stats import studentized_range

    g = len(groups)
    ns = np.array([len(x) for x in groups])
    means = np.array([np.mean(x) for x in groups])
    df = int(ns.sum() - g)
    sse = sum(((np.asarray(x) - m) ** 2).sum() for x, m in zip(groups, means))
    mse = sse / max(df, 1)
    P = np.ones((g, g))
    for i in range(g):
        for j in range(i + 1, g):
            se = np.sqrt(mse / 2.0 * (1.0 / ns[i] + 1.0 / ns[j]))
            q = abs(means[i] - means[j]) / max(se, 1e-300)
            p = float(studentized_range.sf(q, g, df))
            P[i, j] = P[j, i] = min(max(p, 0.0), 1.0)
    return P


def compact_letters(P: np.ndarray, alpha: float = 0.05) -> list:
    """Compact letter display: groups sharing a letter are NOT
    significantly different (insert-and-absorb algorithm)."""
    g = P.shape[0]
    sets: list = []
    for i in range(g):
        placed = False
        for s in sets:
            if all(P[i, j] >= alpha for j in s):
                s.add(i)
                placed = True
        if not placed:
            new = {i}
            # ABSORB: earlier groups not significantly different from i
            # must share the new letter too, else the display claims a
            # significant difference the test never found
            for j in range(i):
                if P[i, j] >= alpha and all(P[j, k] >= alpha for k in new):
                    new.add(j)
            sets.append(new)
    # repair: every NS pair must share a set (greedy absorb can miss one
    # when an earlier absorbee blocks it); extend each missing pair into
    # a maximal mutually-NS set
    for i in range(g):
        for j in range(i + 1, g):
            if P[i, j] >= alpha and not any(i in s and j in s for s in sets):
                new = {i, j}
                for k in range(g):
                    if k not in new and all(P[k, x] >= alpha for x in new):
                        new.add(k)
                sets.append(new)
    # drop subsets
    sets = [s for s in sets if not any(s < t for t in sets)]
    letters = ["" for _ in range(g)]
    for li, s in enumerate(sets):
        ch = chr(ord("a") + li)
        for i in s:
            letters[i] += ch
    return letters


def holm_adjust(ps: list) -> list:
    order = np.argsort(ps)
    m = len(ps)
    out = [0.0] * m
    running = 0.0
    for rank, i in enumerate(order):
        running = max(running, (m - rank) * ps[i])
        out[i] = min(running, 1.0)
    return out


def wilson_ci(k: int, n: int, z: float = 1.959963984540054):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    den = 1 + z * z / n
    center = (p + z * z / (2 * n)) / den
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(center - half, 0.0), min(center + half, 1.0))


def plot_haplotype(
    y: np.ndarray,
    groups: HaplotypeGroups,
    out_path: str,
    mode: str = "continuous",  # continuous | binomial
    title: str | None = None,
    alpha: float = 0.05,
) -> dict:
    """Violin/box (continuous) or proportion-bar (binomial) plot per
    haplotype group with significance annotations. Returns the stats
    (pairwise p-values, letters) used for the annotation."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats as sp_stats

    y = np.asarray(y, np.float64)
    g = len(groups.names)
    if g < 2:
        raise ValueError("need >= 2 haplotype groups to plot")
    samples = [y[(groups.codes == i) & np.isfinite(y)] for i in range(g)]
    result: dict = {"groups": groups.names,
                    "counts": [int(len(s)) for s in samples]}
    fig, ax = plt.subplots(figsize=(max(4.0, 1.2 * g + 1.5), 4.0))
    if mode == "continuous":
        if g == 2:
            p = welch_t(samples[0], samples[1])
            P = np.array([[1.0, p], [p, 1.0]])
            result["test"] = "welch_t"
        else:
            P = tukey_hsd_pvalues(samples)
            result["test"] = "tukey_hsd"
        letters = compact_letters(P, alpha)
        result["pairwise_p"] = P.tolist()
        result["letters"] = letters
        vp = ax.violinplot(samples, showmeans=False, showextrema=False)
        for body in vp["bodies"]:
            body.set_alpha(0.5)
        ax.boxplot(samples, widths=0.18, showfliers=False)
        tops = [np.max(s) if len(s) else 0.0 for s in samples]
        span = (max(tops) - min(min(s) if len(s) else 0 for s in samples)) or 1
        for i, (s, letter) in enumerate(zip(samples, letters)):
            ax.text(i + 1, tops[i] + 0.05 * span, letter, ha="center",
                    fontsize=11, fontweight="bold")
        ax.set_ylabel("phenotype")
    elif mode == "binomial":
        ks = np.array([int(np.nansum(s)) for s in samples])
        ns = np.array([len(s) for s in samples])
        if g == 2:
            table = [[ks[0], ns[0] - ks[0]], [ks[1], ns[1] - ks[1]]]
            p = float(sp_stats.fisher_exact(table).pvalue)
            result["test"] = "fisher_exact"
            result["p"] = p
            letters = ["a", "b" if p < alpha else "a"]
        else:
            table = np.array([ks, ns - ks]).T
            chi = sp_stats.chi2_contingency(table, correction=False)
            result["test"] = "chi2+holm_fisher"
            result["omnibus_p"] = float(chi.pvalue)
            raw = []
            pairs = [(i, j) for i in range(g) for j in range(i + 1, g)]
            for i, j in pairs:
                t = [[ks[i], ns[i] - ks[i]], [ks[j], ns[j] - ks[j]]]
                raw.append(float(sp_stats.fisher_exact(t).pvalue))
            adj = holm_adjust(raw) if chi.pvalue < alpha else [1.0] * len(raw)
            P = np.ones((g, g))
            for (i, j), p in zip(pairs, adj):
                P[i, j] = P[j, i] = p
            result["pairwise_p"] = P.tolist()
            letters = compact_letters(P, alpha)
        result["letters"] = letters
        props = np.where(ns > 0, ks / np.maximum(ns, 1), 0.0)
        cis = [wilson_ci(int(k), int(n)) for k, n in zip(ks, ns)]
        err = np.array([[p - lo, hi - p] for p, (lo, hi) in zip(props, cis)]).T
        ax.bar(np.arange(1, g + 1), props, width=0.6, alpha=0.7)
        ax.errorbar(np.arange(1, g + 1), props, yerr=err, fmt="none",
                    ecolor="black", capsize=3)
        for i, letter in enumerate(letters):
            ax.text(i + 1, min(props[i] + err[1][i] + 0.04, 1.05), letter,
                    ha="center", fontsize=11, fontweight="bold")
        ax.set_ylabel("case proportion")
        ax.set_ylim(0, 1.1)
    else:
        raise ValueError("mode must be continuous|binomial")
    labels = [f"{nm}\n(n={c})" for nm, c in zip(groups.names, result["counts"])]
    ax.set_xticks(np.arange(1, g + 1))
    ax.set_xticklabels(labels, fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return result
