"""Manhattan and QQ plots for association results.

Replaces the reference bioplotkit Manhattan/QQ plotting
(JanusX python/janusx/bioplotkit/manhanden.py, stat.py;
exact beta-distribution QQ confidence bands as in
src/stats/plot.rs qq_band_beta_logp_exact).
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from scipy import stats as sp_stats  # noqa: E402

_PALETTE = ["#4C72B0", "#DD8452"]


def manhattan_plot(
    chrom: np.ndarray,
    pos: np.ndarray,
    pvals: np.ndarray,
    out_path: str,
    sig_line: float | None = None,
    title: str | None = None,
    dpi: int = 150,
    ylim=None,
    ratio: float | None = None,
    palette=None,
    scatter_size: float | None = None,
    alpha: float | None = None,
    marker: str | None = None,
    gap_ratio: float | None = None,
    annotate=None,
) -> None:
    """Genome-wide Manhattan. Reference-style controls: ``ratio`` =
    width/height aspect, ``palette`` = per-chromosome colors (cmap or
    ';'-list; default 2-color alternation), ``gap_ratio`` = the -interval
    chromosome-gap fraction (gap = ratio * median chrom length / 10),
    ``annotate`` = [(chrom, pos, label)] hit callouts (-anno)."""
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos, np.float64)
    with np.errstate(divide="ignore"):
        logp = -np.log10(np.clip(np.asarray(pvals, np.float64), 1e-300, 1.0))
    order_chr = list(dict.fromkeys(chrom))
    if palette is not None:
        from janusx_tpu_torch.plots.structure import resolve_palette

        colors = resolve_palette(palette, len(order_chr))
    else:
        colors = [_PALETTE[i % 2] for i in range(len(order_chr))]
    width = 11.0
    fig, ax = plt.subplots(
        figsize=(width, width / ratio if ratio else 3.6))
    s_pt = 4 if scatter_size is None else scatter_size
    gap_fixed = None
    if gap_ratio is not None:
        spans = [pos[chrom == c].max() - pos[chrom == c].min()
                 for c in order_chr if (chrom == c).any()]
        gap_fixed = float(gap_ratio) * float(np.median(spans)) / 10.0
    offset = 0.0
    ticks, labels = [], []
    starts = {}
    for i, c in enumerate(order_chr):
        sel = chrom == c
        x = pos[sel] - pos[sel].min() + offset
        starts[c] = offset - pos[sel].min() if len(x) else offset
        ax.scatter(x, logp[sel], s=s_pt, c=[colors[i]], rasterized=True,
                   lw=0, alpha=alpha, marker=marker or "o")
        ticks.append(offset + (x.max() - offset) / 2 if len(x) else offset)
        labels.append(c)
        gap = (gap_fixed if gap_fixed is not None
               else (pos[sel].max() - pos[sel].min()) * 0.02)
        offset = (x.max() if len(x) else offset) + gap + 1
    if sig_line is None:
        m = max(len(pvals), 1)
        sig_line = 0.05 / m
    if annotate:
        for (ac, ap, lab) in annotate:
            ac = str(ac)
            if ac in starts and lab:
                sel = chrom == ac
                pv = np.asarray(pvals, np.float64)[sel]
                pp = pos[sel]
                j = np.argmin(np.abs(pp - float(ap)))
                ax.annotate(str(lab),
                            (starts[ac] + pp[j],
                             -np.log10(max(pv[j], 1e-300))),
                            textcoords="offset points", xytext=(2, 4),
                            fontsize=7)
    ax.axhline(-np.log10(sig_line), color="red", ls="--", lw=0.8)
    ax.set_xticks(ticks)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_xlabel("Chromosome")
    ax.set_ylabel(r"$-\log_{10}(p)$")
    if ylim is not None:
        ax.set_ylim(*ylim)
    if title:
        ax.set_title(title)
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def qq_plot(
    pvals: np.ndarray,
    out_path: str,
    title: str | None = None,
    band: bool = True,
    dpi: int = 150,
    ylim=None,
    ratio: float | None = None,
    scatter_size: float | None = None,
    alpha: float | None = None,
    marker: str | None = None,
) -> float:
    """QQ plot with exact beta-distribution confidence band; returns the
    genomic-inflation factor lambda_GC."""
    p = np.asarray(pvals, np.float64)
    p = p[np.isfinite(p) & (p > 0) & (p <= 1)]
    p = np.sort(p)
    m = len(p)
    if m == 0:
        raise ValueError("no valid p-values")
    exp = -np.log10((np.arange(1, m + 1) - 0.5) / m)
    obs = -np.log10(p)
    chi2 = sp_stats.chi2.isf(p, df=1)
    lambda_gc = float(np.median(chi2) / sp_stats.chi2.ppf(0.5, df=1))

    fig, ax = plt.subplots(
        figsize=(4.2 * (ratio if ratio else 1.0), 4.2)
        if ratio else (4.2, 4.2))
    if band:
        ranks = np.arange(1, m + 1)
        lo = -np.log10(sp_stats.beta.ppf(0.975, ranks, m - ranks + 1))
        hi = -np.log10(sp_stats.beta.ppf(0.025, ranks, m - ranks + 1))
        ax.fill_between(exp, lo, hi, color="#cccccc", alpha=0.5, lw=0)
    lim = max(exp.max(), obs.max()) * 1.05
    ax.plot([0, lim], [0, lim], color="red", lw=0.8)
    ax.scatter(exp, obs, s=5 if scatter_size is None else scatter_size,
               c=_PALETTE[0], rasterized=True, lw=0, alpha=alpha,
               marker=marker or "o")
    ax.set_xlabel(r"Expected $-\log_{10}(p)$")
    ax.set_ylabel(r"Observed $-\log_{10}(p)$")
    if ylim is not None:
        ax.set_ylim(*ylim)
    label = title or ""
    ax.set_title(f"{label} $\\lambda_{{GC}}$={lambda_gc:.3f}".strip())
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return lambda_gc


def manhattan_merge_plot(
    panels: list,
    out_path: str,
    sig_line: float | None = None,
    ylim=None,
    dpi: int = 150,
) -> None:
    """One merged figure of stacked Manhattan panels sharing the
    chromosome axis (reference `-manh-merge`). ``panels`` is a list of
    (tag, chrom, pos, pvals)."""
    union: list = []
    spans: dict = {}
    for _, chrom, pos, _ in panels:
        chrom = np.asarray(chrom).astype(str)
        pos = np.asarray(pos, np.float64)
        for c in dict.fromkeys(chrom):
            hi = float(pos[chrom == c].max())
            spans[c] = max(spans.get(c, 0.0), hi)
            if c not in union:
                union.append(c)
    gap = 0.02 * float(np.median(list(spans.values()))) + 1
    offsets, ticks = {}, []
    off = 0.0
    for c in union:
        offsets[c] = off
        ticks.append(off + spans[c] / 2)
        off += spans[c] + gap

    T = len(panels)
    fig, axes = plt.subplots(T, 1, figsize=(11, 2.6 * T), sharex=True,
                             squeeze=False)
    for row, (tag, chrom, pos, pvals) in enumerate(panels):
        ax = axes[row, 0]
        chrom = np.asarray(chrom).astype(str)
        pos = np.asarray(pos, np.float64)
        with np.errstate(divide="ignore"):
            logp = -np.log10(np.clip(np.asarray(pvals, np.float64),
                                     1e-300, 1.0))
        for i, c in enumerate(union):
            sel = chrom == c
            if not sel.any():
                continue
            ax.scatter(pos[sel] + offsets[c], logp[sel], s=4,
                       c=_PALETTE[i % 2], rasterized=True, lw=0)
        sig = sig_line if sig_line is not None else 0.05 / max(len(pvals), 1)
        ax.axhline(-np.log10(sig), color="red", ls="--", lw=0.8)
        ax.set_ylabel(r"$-\log_{10}(p)$")
        ax.set_title(tag, fontsize=9, loc="left")
        if ylim is not None:
            ax.set_ylim(*ylim)
        ax.spines[["top", "right"]].set_visible(False)
    axes[-1, 0].set_xticks(ticks)
    axes[-1, 0].set_xticklabels(union, fontsize=8)
    axes[-1, 0].set_xlabel("Chromosome")
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def qq_merge_plot(
    panels: list,
    out_path: str,
    band: bool = True,
    ylim=None,
    dpi: int = 150,
) -> dict:
    """Overlaid QQ curves for several GWAS files on one axes (reference
    `-qq-merge`); the confidence band follows the largest panel. Returns
    {tag: lambda_GC}."""
    fig, ax = plt.subplots(figsize=(4.6, 4.6))
    lams: dict = {}
    m_max, drawn_band = 0, False
    cleaned = []
    for tag, pvals in panels:
        p = np.asarray(pvals, np.float64)
        p = np.sort(p[np.isfinite(p) & (p > 0) & (p <= 1)])
        cleaned.append((tag, p))
        m_max = max(m_max, len(p))
    lim = 1.0
    for i, (tag, p) in enumerate(cleaned):
        m = len(p)
        if m == 0:
            continue
        exp = -np.log10((np.arange(1, m + 1) - 0.5) / m)
        obs = -np.log10(p)
        if band and not drawn_band and m == m_max:
            ranks = np.arange(1, m + 1)
            lo = -np.log10(sp_stats.beta.ppf(0.975, ranks, m - ranks + 1))
            hi = -np.log10(sp_stats.beta.ppf(0.025, ranks, m - ranks + 1))
            ax.fill_between(exp, lo, hi, color="#cccccc", alpha=0.5, lw=0)
            drawn_band = True
        chi2 = sp_stats.chi2.isf(p, df=1)
        lam = float(np.median(chi2) / sp_stats.chi2.ppf(0.5, df=1))
        lams[tag] = lam
        color = f"C{i % 10}"
        ax.scatter(exp, obs, s=5, c=color, rasterized=True, lw=0,
                   label=f"{tag} ($\\lambda$={lam:.3f})")
        lim = max(lim, exp.max() * 1.05, obs.max() * 1.05)
    ax.plot([0, lim], [0, lim], color="red", lw=0.8)
    ax.set_xlabel(r"Expected $-\log_{10}(p)$")
    ax.set_ylabel(r"Observed $-\log_{10}(p)$")
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.legend(fontsize=7, frameon=False)
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return lams


def circular_manhattan(
    rings: list,
    out_path: str,
    sig_line: float | None = None,
    direction: str = "out",
    dpi: int = 170,
    chords: list | None = None,
    gap_ratio: float | None = None,
    lw: float | None = None,
) -> None:
    """Circular (Circos-style) Manhattan: one concentric ring per GWAS
    file, chromosomes as arcs (reference `-circle` with -circle-in/-out
    direction control). ``rings`` is a list of (tag, chrom, pos, pvals),
    outermost first. ``chords`` = [(chrom1, pos1, chrom2, pos2, [label])]
    interaction pairs drawn as bezier chords through the center
    (reference -interact); ``gap_ratio`` scales the inter-chromosome gap
    (-circle-interval); ``lw`` sets ring/threshold line width
    (-circle-lw)."""
    union: list = []
    spans: dict = {}
    for _, chrom, pos, _ in rings:
        chrom = np.asarray(chrom).astype(str)
        pos = np.asarray(pos, np.float64)
        for c in dict.fromkeys(chrom):
            spans[c] = max(spans.get(c, 0.0), float(pos[chrom == c].max()))
            if c not in union:
                union.append(c)
    total = sum(spans.values())
    gap_rad = 2.0 * np.pi * 0.01 * (1.0 if gap_ratio is None
                                    else 2.0 * float(gap_ratio))
    arc = 2.0 * np.pi - gap_rad * len(union)
    theta0, starts = 0.0, {}
    for c in union:
        starts[c] = theta0
        theta0 += arc * spans[c] / total + gap_rad

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="polar")
    ax.set_theta_zero_location("N")
    ax.set_theta_direction(-1)
    n_rings = len(rings)
    r_lo0, band_w, band_gap = 0.35, 0.55 / max(n_rings, 1), 0.04
    for ridx, (tag, chrom, pos, pvals) in enumerate(rings):
        chrom = np.asarray(chrom).astype(str)
        pos = np.asarray(pos, np.float64)
        with np.errstate(divide="ignore"):
            logp = -np.log10(np.clip(np.asarray(pvals, np.float64),
                                     1e-300, 1.0))
        top = np.percentile(logp, 99.9) * 1.3 + 1e-9
        logp = np.minimum(logp, top)
        r_lo = r_lo0 + ridx * band_w
        w = band_w - band_gap
        for i, c in enumerate(union):
            sel = chrom == c
            if not sel.any():
                continue
            th = starts[c] + arc * (pos[sel] / total)
            frac = logp[sel] / top
            if direction == "in":
                r = r_lo + w * (1.0 - frac)
            else:
                r = r_lo + w * frac
            ax.scatter(th, r, s=2.5, c=_PALETTE[i % 2], rasterized=True,
                       lw=0)
        sig = sig_line if sig_line is not None else 0.05 / max(len(pvals), 1)
        sfrac = min(-np.log10(sig) / top, 1.0)
        rs = r_lo + w * (1.0 - sfrac if direction == "in" else sfrac)
        ax.plot(np.linspace(0, 2 * np.pi, 256), np.full(256, rs),
                color="red", ls="--", lw=lw or 0.6)
        ax.text(0.0, r_lo + w + 0.01, tag, fontsize=6, ha="center")
    for c in union:
        mid = starts[c] + arc * spans[c] / total / 2.0
        ax.text(mid, r_lo0 + n_rings * band_w + 0.05, c, fontsize=8,
                ha="center", va="center")
    if chords:
        for ch in chords:
            c1, p1, c2, p2 = str(ch[0]), float(ch[1]), str(ch[2]), float(ch[3])
            if c1 not in starts or c2 not in starts:
                continue
            t1 = starts[c1] + arc * (p1 / total)
            t2 = starts[c2] + arc * (p2 / total)
            r0 = r_lo0 - 0.02
            # quadratic bezier through the center in cartesian space
            x1, y1 = r0 * np.cos(t1), r0 * np.sin(t1)
            x2, y2 = r0 * np.cos(t2), r0 * np.sin(t2)
            t = np.linspace(0, 1, 60)
            bx = (1 - t) ** 2 * x1 + t ** 2 * x2
            by = (1 - t) ** 2 * y1 + t ** 2 * y2
            ax.plot(np.arctan2(by, bx), np.hypot(bx, by),
                    color="#C44E52", lw=lw or 0.9, alpha=0.8)
    ax.set_ylim(0, r_lo0 + n_rings * band_w + 0.12)
    ax.axis("off")
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
